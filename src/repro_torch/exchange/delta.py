"""Delta pushes + error feedback: client-side state that shapes pushes.

Copy of ``repro/exchange/delta.py`` (the row forms, and the weight
wire's leaf form :class:`LeafErrorFeedback`).  The state lives on
the host in numpy, as the JAX client keeps it, so the τ selection and
the residuals are bit-identical to the JAX package's; a push with τ or
error feedback on copies its rows to the host once.

As federated training converges, most push-node embeddings barely change
round-over-round, yet the seed pushes the full table every round.  Each
client keeps a *shadow* of the raw fp32 values it last pushed; a row is
re-pushed only when its relative L2 change across all shared layers
exceeds a threshold τ:

    ||new_row − shadow_row||₂  >  τ · max(||shadow_row||₂, ε)

τ = 0 keeps full-push numerics bit-exactly (rows with literally zero
change are skipped, and a deterministic codec re-encodes an unchanged
row to the identical wire value, so the server state is identical);
τ > 0 trades a bounded staleness for push bytes that shrink as training
converges.  Rows never pushed before are always selected.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-12


class GidRowTable:
    """Per-gid (layers, hidden) fp32 row storage with capacity-doubling
    growth (amortized O(1) per new id, like EmbeddingServer.register).
    The shared substrate of :class:`DeltaTracker` (shadow rows) and
    :class:`ErrorFeedback` (residual rows)."""

    def __init__(self, num_layers_shared: int, hidden: int):
        self.layers = num_layers_shared
        self.hidden = hidden
        self._slot: dict[int, int] = {}             # gid -> row
        self._buf = np.zeros((0, num_layers_shared, hidden), np.float32)

    @property
    def _live(self) -> np.ndarray:
        """View of the allocated (non-headroom) rows."""
        return self._buf[: len(self._slot)]

    def _rows(self, gids: np.ndarray, *, create: bool) -> np.ndarray:
        """Row indices for ``gids``; unseen ids get fresh zero rows when
        ``create``, else -1."""
        if create:
            new = [int(g) for g in gids if int(g) not in self._slot]
            if new:
                base = len(self._slot)
                if base + len(new) > len(self._buf):
                    cap = max(16, len(self._buf))
                    while cap < base + len(new):
                        cap *= 2
                    buf = np.zeros((cap, self.layers, self.hidden),
                                   np.float32)
                    buf[:base] = self._buf[:base]
                    self._buf = buf
                for i, g in enumerate(new):
                    self._slot[g] = base + i
        return np.fromiter((self._slot.get(int(g), -1) for g in gids),
                           np.int64, count=len(gids))


class DeltaTracker(GidRowTable):
    """Per-client shadow of last-pushed rows, keyed by global vertex id."""

    def __init__(self, threshold: float, num_layers_shared: int, hidden: int):
        if threshold < 0.0:
            raise ValueError(f"delta threshold must be >= 0, got {threshold}")
        super().__init__(num_layers_shared, hidden)
        self.tau = float(threshold)
        # telemetry: (selected, total) row counts per select() call
        self.history: list[tuple[int, int]] = []

    @property
    def _shadow(self) -> np.ndarray:
        return self._live

    def select(self, gids: np.ndarray, layer_values: list[np.ndarray]
               ) -> np.ndarray:
        """Selection only: boolean mask of rows worth pushing.  Allocates
        no shadow slots and never mutates row state — call :meth:`commit`
        when the push lands, so an abandoned plan leaves unseen rows
        still "never pushed" (and therefore still always selected).
        ``history`` records one (selected, total) entry per planning
        pass, applied or not.

        ``layer_values[l]`` is (n, hidden) fp32 aligned with ``gids``."""
        if len(layer_values) != self.layers:
            raise ValueError(f"{len(layer_values)} layer blocks for "
                             f"{self.layers} shared layers")
        if len(gids) == 0:
            return np.zeros(0, bool)
        rows_all = self._rows(gids, create=False)
        known = rows_all >= 0
        sel = ~known                       # never-pushed rows always go
        if known.any():
            stacked = np.stack(
                [np.asarray(v, np.float32)[known] for v in layer_values],
                axis=1)                    # (n_known, layers, hidden)
            old = self._shadow[rows_all[known]]
            n = len(old)
            delta = np.linalg.norm((stacked - old).reshape(n, -1), axis=1)
            ref = np.linalg.norm(old.reshape(n, -1), axis=1)
            sel[known] = delta > self.tau * np.maximum(ref, _EPS)
        self.history.append((int(sel.sum()), len(gids)))
        return sel

    def commit(self, gids: np.ndarray,
               layer_values: list[np.ndarray]) -> None:
        """Refresh the shadow for rows that actually reached the server
        (raw pre-codec values, aligned with ``gids``)."""
        if len(gids) == 0:
            return
        stacked = np.stack([np.asarray(v, np.float32) for v in layer_values],
                           axis=1)
        rows = self._rows(gids, create=True)   # may grow/rebind _buf
        self._buf[rows] = stacked

    @property
    def total_selected(self) -> int:
        return sum(s for s, _ in self.history)

    @property
    def total_rows(self) -> int:
        return sum(n for _, n in self.history)


class ErrorFeedback(GidRowTable):
    """EF-SGD-style residual accumulator for lossy wire codecs.

    A lossy codec (fp16/int8) rounds every pushed row; without
    correction the rounding error is *re-applied* every round and the
    server's converged embeddings stay biased by up to one quantization
    step.  Error feedback folds the previous push's residual into the
    next push before encoding:

        compensated = raw + residual
        wire        = encode(compensated)
        residual'   = compensated − decode(wire)

    so the error is carried forward instead of dropped, and the
    *time-averaged* server value tracks the true fp32 embedding."""

    def compensate(self, gids: np.ndarray,
                   layer_values: list[np.ndarray]) -> list[np.ndarray]:
        """raw rows + carried residual (unseen ids carry zero).  Pure
        read — residuals change only on :meth:`commit`."""
        if len(gids) == 0:
            return [np.asarray(v, np.float32) for v in layer_values]
        rows = self._rows(gids, create=False)
        known = rows >= 0
        out = []
        for l, v in enumerate(layer_values):
            v = np.array(v, np.float32, copy=True)
            if known.any():
                v[known] += self._buf[rows[known], l]
            out.append(v)
        return out

    def commit(self, gids: np.ndarray, compensated: list[np.ndarray],
               decoded: list[np.ndarray]) -> None:
        """Store ``compensated − decoded`` for rows whose push landed."""
        if len(gids) == 0:
            return
        rows = self._rows(gids, create=True)
        for l in range(self.layers):
            self._buf[rows, l] = (np.asarray(compensated[l], np.float32)
                                  - np.asarray(decoded[l], np.float32))

    @property
    def max_abs_residual(self) -> float:
        return float(np.abs(self._live).max()) if len(self._slot) else 0.0


class LeafErrorFeedback:
    """:class:`ErrorFeedback`, leaf-list form: the weight wire's EF (copy
    of ``repro/exchange/delta.py``'s).

    The weight plane's unit of exchange is a whole leaf list (one model
    delta per client per round), so the residual is a parallel list of
    host arrays.  Same contract as the row form:

        compensated = delta + residual
        wire        = encode(compensated)
        residual'   = compensated − decode(wire)
    """

    def __init__(self):
        self._res: list[np.ndarray] | None = None

    def compensate(self, leaves) -> list[np.ndarray]:
        """delta leaves + carried residual (zero before the first
        commit).  Pure read — residuals change only on :meth:`commit`."""
        if self._res is None:
            return [np.asarray(l, np.float32) for l in leaves]
        return [np.asarray(l, np.float32) + r
                for l, r in zip(leaves, self._res)]

    def commit(self, compensated, decoded) -> None:
        """Store ``compensated − decoded`` once the push landed."""
        self._res = [np.asarray(c, np.float32) - np.asarray(d, np.float32)
                     for c, d in zip(compensated, decoded)]

    def reset(self) -> None:
        """Drop the carry (a re-joined worker starts from a fresh model,
        so the old residual no longer corresponds to anything shipped)."""
        self._res = None

    @property
    def max_abs_residual(self) -> float:
        if not self._res:
            return 0.0
        return max(float(np.abs(r).max()) if r.size else 0.0
                   for r in self._res)
