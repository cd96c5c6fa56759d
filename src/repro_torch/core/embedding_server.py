"""In-memory embedding server (the paper's Redis KV store) on the device.

Port of ``repro/core/embedding_server.py`` in its device-table mode.  It
stores the h^1..h^{L-1} embeddings of every registered vertex in one
table per layer, keyed by global vertex id.  The server only ever sees
(vertex id → embedding vector); raw features (h^0) are never registered.

Tables are torch tensors of shape (capacity, hidden) on ``device``, with
no lane padding, and grow by capacity doubling.  The global-id → row map
(``_gid2row``, dense, -1 = unregistered) and the per-row version
counters (``_ver``) stay on the host.  Unlike the JAX server, whose
arrays are immutable, the port updates its tables **in place**: a write
or a fused int8 push apply stores into the existing buffer.

:meth:`gather_quantized` / :meth:`write_quantized` are the fused
pull-response / push-apply surface: gather + int8 encode and int8 decode
+ scatter run as one kernel each on the card (``repro_torch.kernels``),
bit-identical to gather→encode and decode→write.

Row versions: every write bumps the rows' counters, so a serving cache
revalidates a held row for 8 bytes (:meth:`versions`,
:meth:`gather_if_stale`) instead of re-pulling it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops

_MIN_CAPACITY = 256


class EmbeddingServer:
    def __init__(self, num_layers: int, hidden: int, *,
                 device: str = "cuda"):
        if num_layers < 2:
            raise ValueError("embedding sharing needs L >= 2")
        self.L = num_layers
        self.hidden = hidden
        self.device = torch.device(device)
        #: dense gid → row map (-1 = unregistered)
        self._gid2row = np.full(0, -1, np.int64)
        self._next_row = 0                     # rows handed out so far
        self._cap = 0                          # allocated rows per table
        self._bufs = [torch.zeros((0, hidden), dtype=torch.float32,
                                  device=self.device)
                      for _ in range(num_layers - 1)]
        self._ver = np.zeros(0, np.int64)      # per-row write counter
        self._reallocs = 0                     # growth events (O(log n))

    # -- registration ------------------------------------------------------

    def _ensure_capacity(self, rows: int) -> None:
        """Capacity-doubling growth: amortized O(1) per registered row."""
        if rows <= self._cap:
            return
        new_cap = max(_MIN_CAPACITY, self._cap)
        while new_cap < rows:
            new_cap *= 2
        grown = []
        for buf in self._bufs:
            g = torch.zeros((new_cap, self.hidden), dtype=torch.float32,
                            device=self.device)
            g[: self._next_row] = buf[: self._next_row]
            grown.append(g)
        self._bufs = grown
        ver = np.zeros(new_cap, np.int64)
        ver[: self._next_row] = self._ver[: self._next_row]
        self._ver = ver
        self._cap = new_cap
        self._reallocs += 1

    def _ensure_gid_map(self, max_gid: int) -> None:
        if max_gid < len(self._gid2row):
            return
        grown = np.full(max(max_gid + 1, 2 * len(self._gid2row), 16),
                        -1, np.int64)
        grown[: len(self._gid2row)] = self._gid2row
        self._gid2row = grown

    def register(self, global_ids: np.ndarray) -> None:
        """Make rows for vertices whose embeddings will be shared; new ids
        get consecutive rows in ascending id order."""
        uniq = np.unique(np.asarray(global_ids, np.int64))
        if len(uniq) == 0:
            return
        if uniq[0] < 0:
            raise ValueError(f"negative vertex id {uniq[0]}")
        self._ensure_gid_map(int(uniq[-1]))
        new = uniq[self._gid2row[uniq] < 0]
        if len(new) == 0:
            return
        base = self._next_row
        self._ensure_capacity(base + len(new))
        self._gid2row[new] = base + np.arange(len(new), dtype=np.int64)
        self._next_row = base + len(new)

    @property
    def num_embeddings_stored(self) -> int:
        """Vertices registered × (L-1) layer tables (Fig. 2a marker)."""
        return int((self._gid2row >= 0).sum()) * (self.L - 1)

    def _rows(self, global_ids: np.ndarray) -> np.ndarray:
        gids = np.asarray(global_ids, np.int64)
        if len(gids) == 0:
            return np.zeros(0, np.int64)
        m = self._gid2row
        if len(m):
            safe = np.clip(gids, 0, len(m) - 1)
            rows = np.where((gids >= 0) & (gids < len(m)), m[safe], -1)
        else:
            rows = np.full(len(gids), -1, np.int64)
        if np.all(rows >= 0):
            return rows
        missing = [int(g) for g in gids[rows < 0]]
        shown = ", ".join(str(g) for g in missing[:8])
        if len(missing) > 8:
            shown += f", ... ({len(missing) - 8} more)"
        raise KeyError(
            f"{len(missing)} unregistered vertex id(s) in a request "
            f"of {len(global_ids)} (gids: {shown}); this server has "
            f"{int((m >= 0).sum())} registered rows — register() vertices "
            "before write/gather")

    def _index(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(rows).to(self.device)

    def _empty(self, sel) -> list[torch.Tensor]:
        return [torch.zeros((0, self.hidden), dtype=torch.float32,
                            device=self.device) for _ in sel]

    def _sel(self, layers) -> list[int]:
        return list(range(1, self.L)) if layers is None else list(layers)

    # -- storage surface (used by the transports) ---------------------------

    def write(self, global_ids: np.ndarray,
              layer_values: list) -> None:
        """Raw store of h^1..h^{L-1} rows (tensors or arrays), in place."""
        if len(layer_values) != self.L - 1:
            raise ValueError(f"{len(layer_values)} layer blocks for "
                             f"{self.L - 1} tables")
        if len(global_ids) == 0:
            return
        rows = self._rows(global_ids)
        idx = self._index(rows)
        for buf, vals in zip(self._bufs, layer_values):
            buf[idx] = torch.as_tensor(vals, dtype=torch.float32) \
                .to(self.device)
        self._ver[rows] += 1

    def gather(self, global_ids: np.ndarray,
               layers: list[int] | None = None) -> list[torch.Tensor]:
        """Raw read of the selected layer tables (1-indexed ``layers``;
        ``None`` = all L-1) as tensors on the server's device."""
        sel = self._sel(layers)
        if len(global_ids) == 0:
            return self._empty(sel)
        idx = self._index(self._rows(global_ids))
        return [self._bufs[l - 1][idx] for l in sel]

    def load_rows(self, global_ids: np.ndarray, versions: np.ndarray,
                  layer_rows: list[np.ndarray]) -> None:
        """Fill rows from a snapshot (ids, version counters, one (n,
        hidden) block per layer) — e.g. of a JAX server, so both sides
        can start from the same published state."""
        gids = np.asarray(global_ids, np.int64)
        self.register(gids)
        rows = self._rows(gids)
        idx = self._index(rows)
        for buf, vals in zip(self._bufs, layer_rows):
            buf[idx] = torch.as_tensor(np.asarray(vals, np.float32)) \
                .to(self.device)
        self._ver[rows] = np.asarray(versions, np.int64)

    # -- fused surface (gather + encode, decode + scatter) ------------------

    def gather_quantized(self, global_ids: np.ndarray,
                         layers: list[int] | None = None
                         ) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Pull response in wire form: one (values int8 (n, hidden),
        scales fp32 (n, 1)) pair per selected layer, gathered and encoded
        by one kernel straight off the resident table."""
        sel = self._sel(layers)
        if len(global_ids) == 0:
            return [(torch.zeros((0, self.hidden), dtype=torch.int8,
                                 device=self.device),
                     torch.zeros((0, 1), dtype=torch.float32,
                                 device=self.device)) for _ in sel]
        idx = ops.row_index(self._rows(global_ids), self._cap, self.device,
                            check=True)
        return [ops.gather_quantize(self._bufs[l - 1], idx) for l in sel]

    def write_quantized(self, global_ids: np.ndarray,
                        layer_payloads: list[tuple]) -> None:
        """Push apply straight from wire form: one decode + scatter
        kernel per layer table, in place."""
        if len(layer_payloads) != self.L - 1:
            raise ValueError(f"{len(layer_payloads)} layer payloads for "
                             f"{self.L - 1} tables")
        if len(global_ids) == 0:
            return
        rows = self._rows(global_ids)
        idx = ops.row_index(rows, self._cap, self.device, check=False)
        for buf, (v, s) in zip(self._bufs, layer_payloads):
            ops.dequant_scatter_(buf, idx, v, s)
        self._ver[rows] += 1

    def versions(self, global_ids: np.ndarray) -> np.ndarray:
        """Current write counters for ``global_ids`` (one per row: a
        write always touches all L-1 layers of a row together)."""
        if len(global_ids) == 0:
            return np.zeros(0, np.int64)
        return self._ver[self._rows(global_ids)].copy()

    def gather_if_stale(
        self, global_ids: np.ndarray, have_versions: np.ndarray,
        layers: list[int] | None = None,
    ) -> tuple[np.ndarray, np.ndarray, list[torch.Tensor]]:
        """Conditional gather (If-None-Match): current versions for all
        requested rows, row values only where ``have_versions`` is out of
        date (-1 = never seen).  Returns ``(versions, stale_pos,
        layer_values)`` with ``layer_values[j]`` in ``stale_pos`` order."""
        sel = self._sel(layers)
        if len(global_ids) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64), \
                self._empty(sel)
        rows = self._rows(global_ids)
        ver = self._ver[rows].copy()
        stale = np.nonzero(ver != np.asarray(have_versions, np.int64))[0]
        idx = self._index(rows[stale])
        vals = [self._bufs[l - 1][idx] for l in sel]
        return ver, stale.astype(np.int64), vals
