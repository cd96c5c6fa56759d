"""Hot-embedding cache with a staleness bound tied to τ-delta pushes
(copy of ``repro/gnnserve/cache.py`` on the port's exchange client; rows
are held on the host as numpy arrays).

A cached row is valid exactly while the embedding server hasn't
accepted a delta for it: every :meth:`EmbeddingServer.write` bumps the
row's version counter, and every cache access revalidates its held
versions through one conditional pull
(:meth:`ExchangeClient.pull_versioned`).  A fresh row therefore costs 8
version bytes on the wire instead of ``hidden × bytes_per_scalar`` row
bytes; a row invalidated by a training push is re-pulled in the same
RPC.  There is no TTL and no guessing — the version check *is* the
invalidation path.

Eviction is LRU over (layer, gid) row entries, bounded by
``capacity_rows``.
"""

from __future__ import annotations

import collections

import numpy as np

from repro_torch.exchange.client import ExchangeClient
from repro_torch.obsv.metrics import REGISTRY

# process-wide mirrors of the per-cache attribute counters; tests that
# build several caches keep reading the exact per-instance attributes
_HITS = REGISTRY.counter("pt_gnnserve.cache.hits")
_MISSES = REGISTRY.counter("pt_gnnserve.cache.misses")
_STALE = REGISTRY.counter("pt_gnnserve.cache.stale_refreshes")
_EVICTIONS = REGISTRY.counter("pt_gnnserve.cache.evictions")


class HotEmbeddingCache:
    def __init__(self, exchange: ExchangeClient, *,
                 capacity_rows: int = 100_000):
        if capacity_rows < 1:
            raise ValueError(f"capacity_rows must be >= 1, got {capacity_rows}")
        self.ex = exchange
        self.capacity_rows = capacity_rows
        # (layer, gid) -> [version, row]; insertion order = LRU order
        self._rows: collections.OrderedDict[tuple[int, int], list] = \
            collections.OrderedDict()
        # stats
        self.hits = 0            # rows served without row bytes on the wire
        self.misses = 0          # rows never seen before
        self.stale_refreshes = 0  # held rows invalidated by a push
        self.pull_time = 0.0     # modelled seconds spent on row bytes
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._rows)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses + self.stale_refreshes
        return self.hits / total if total else 0.0

    def reset_stats(self) -> None:
        """Zero the counters without touching cached rows, to separate
        warm-fill transients from steady state."""
        self.hits = self.misses = self.stale_refreshes = 0
        self.evictions = 0
        self.pull_time = 0.0

    def stats(self) -> dict:
        return {
            "rows": len(self._rows),
            "capacity_rows": self.capacity_rows,
            "hits": self.hits,
            "misses": self.misses,
            "stale_refreshes": self.stale_refreshes,
            "hit_rate": self.hit_rate,
            "evictions": self.evictions,
            "pull_time_s": self.pull_time,
        }

    def get(self, global_ids: np.ndarray, layer: int
            ) -> tuple[np.ndarray, np.ndarray]:
        """The h^``layer`` rows for ``global_ids`` plus their (post-
        validation) versions.  Every call revalidates: the returned rows
        are guaranteed current as of this call's server round-trip."""
        gids = np.asarray(global_ids, np.int64)
        n = len(gids)
        hidden = self.ex.hidden
        if n == 0:
            return np.zeros((0, hidden), np.float32), np.zeros(0, np.int64)
        keys = [(layer, int(g)) for g in gids]
        have = np.fromiter(
            (self._rows[k][0] if k in self._rows else -1 for k in keys),
            np.int64, n)
        ver, stale, vals, t = self.ex.pull_versioned(gids, have, [layer])
        self.pull_time += t
        out = np.empty((n, hidden), np.float32)
        fresh = np.ones(n, bool)
        fresh[stale] = False
        for i in np.nonzero(fresh)[0]:
            out[i] = self._rows[keys[i]][1]
        # one device -> host copy per call; rows are held on the host
        rows = vals[0].cpu().numpy()
        for j, i in enumerate(stale):
            out[i] = rows[j]
        # account + refresh under one pass: stale entries get the new
        # (version, row); every touched key moves to the LRU tail
        n_hits = int(fresh.sum())
        n_miss = int((have[stale] < 0).sum())
        n_stale = int((have[stale] >= 0).sum())
        self.hits += n_hits
        self.misses += n_miss
        self.stale_refreshes += n_stale
        _HITS.inc(n_hits)
        _MISSES.inc(n_miss)
        _STALE.inc(n_stale)
        for j, i in enumerate(stale):
            self._rows[keys[i]] = [int(ver[i]), rows[j].copy()]
        for k in keys:
            self._rows.move_to_end(k)
        while len(self._rows) > self.capacity_rows:
            self._rows.popitem(last=False)
            self.evictions += 1
            _EVICTIONS.inc()
        return out, ver
