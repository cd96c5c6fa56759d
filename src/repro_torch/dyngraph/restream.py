"""Incremental re-partitioning for grown graphs.

Port of ``repro/dyngraph/restream.py`` (numpy only): the same
partitions and cuts.

Two pieces, both chunk-vectorized in the style of
``graphstore/partition_stream.ldg_partition``:

* :func:`admit` — new vertices arrive in id order and are placed
  against the *current* per-part loads without touching existing
  assignments: LDG scoring (``|N(v) ∩ P_i| · (1 − |P_i|/cap)``) or
  Fennel's marginal cost (``|N(v) ∩ P_i| − α·γ·|P_i|^{γ−1}`` with the
  standard ``α = m·k^{γ−1}/n^γ``), seeded jitter for ties, ranked
  admission under the capacity bound and water-fill for the leftovers.

* :func:`restream_pass` — one warm pass over *all* assignments
  (Stanton's restreaming LDG): every vertex is re-scored against the
  loads frozen at chunk start and moved when another part strictly
  beats its current one under the capacity bound.  A pass only ever
  reduces the number of cut edges it can see, which is where the
  ≥15 % edge-cut recovery over admit-only placement comes from.

Everything is deterministic in ``(graph, part, config)`` — fed workers
in different processes admit identically and never exchange partition
state.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs.partition import _water_fill, ranks_within
from repro_torch.graphstore.partition_stream import iter_edge_chunks


@dataclasses.dataclass(frozen=True)
class RestreamConfig:
    method: str = "ldg"             # "ldg" | "fennel"
    passes: int = 0                 # warm restreaming passes per event
    slack: float = 1.05
    gamma: float = 1.5              # Fennel load exponent
    seed: int = 0
    chunk_vertices: int = 1 << 16


def _scores(counts: np.ndarray, sizes: np.ndarray, cap: int,
            cfg: RestreamConfig, alpha: float,
            jitter: np.ndarray) -> np.ndarray:
    if cfg.method == "fennel":
        penalty = alpha * cfg.gamma * np.power(
            np.maximum(sizes, 1).astype(np.float64), cfg.gamma - 1.0)
        return counts - penalty[None, :] + jitter[None, :]
    penalty = np.maximum(0.0, 1.0 - sizes / cap)
    return counts * penalty[None, :] + jitter[None, :]


def _fennel_alpha(g, k: int, cfg: RestreamConfig) -> float:
    n = max(1, int(g.num_vertices))
    m = max(1, int(g.num_edges))
    return m * float(k) ** (cfg.gamma - 1.0) / float(n) ** cfg.gamma


def admit(g, part: np.ndarray, k: int,
          cfg: RestreamConfig = RestreamConfig()) -> np.ndarray:
    """Extend ``part`` (over the first ``len(part)`` vertices of ``g``)
    to all of ``g``'s vertices; existing entries are never moved."""
    v_old, v_new = len(part), int(g.num_vertices)
    out = np.full(v_new, -1, dtype=np.int32)
    out[:v_old] = part
    if v_new == v_old:
        return out
    cap = int(np.ceil(v_new / k) * cfg.slack)
    sizes = np.bincount(part[part >= 0], minlength=k).astype(np.int64)
    jitter = np.random.default_rng(cfg.seed).random(k) * 1e-9
    alpha = _fennel_alpha(g, k, cfg)

    for lo in range(v_old, v_new, cfg.chunk_vertices):
        hi = min(lo + cfg.chunk_vertices, v_new)
        B = hi - lo
        ptr = np.asarray(g.indptr[lo: hi + 1]).astype(np.int64)
        e_src = np.asarray(g.indices[ptr[0]: ptr[-1]]).astype(np.int64)
        e_dst_local = np.repeat(np.arange(B, dtype=np.int64),
                                np.diff(ptr))
        src_part = out[e_src]
        known = src_part >= 0
        counts = np.bincount(
            e_dst_local[known] * k + src_part[known],
            minlength=B * k).reshape(B, k)
        scores = _scores(counts, sizes, cap, cfg, alpha, jitter)
        best = np.argmax(scores, axis=1)
        has_affinity = counts[np.arange(B), best] > 0

        idx = np.nonzero(has_affinity)[0]
        taken = np.zeros(B, dtype=bool)
        if len(idx):
            dest = best[idx]
            ok = ranks_within(dest) < np.maximum(0, cap - sizes)[dest]
            taken[idx[ok]] = True
        out[lo:hi][taken] = best[taken].astype(np.int32)
        sizes += np.bincount(best[taken], minlength=k)

        rest = np.nonzero(~taken)[0]
        if len(rest):
            fills = _water_fill(sizes, len(rest))
            recv = np.argsort(sizes, kind="stable")
            out[lo:hi][rest] = np.repeat(
                recv, fills[recv]).astype(np.int32)
            sizes += fills
    return out


def restream_pass(g, part: np.ndarray, k: int,
                  cfg: RestreamConfig = RestreamConfig()) -> np.ndarray:
    """One warm re-assignment pass over every vertex."""
    v = int(g.num_vertices)
    out = np.asarray(part, dtype=np.int32).copy()
    cap = int(np.ceil(v / k) * cfg.slack)
    sizes = np.bincount(out, minlength=k).astype(np.int64)
    jitter = np.random.default_rng(cfg.seed).random(k) * 1e-9
    alpha = _fennel_alpha(g, k, cfg)

    for lo in range(0, v, cfg.chunk_vertices):
        hi = min(lo + cfg.chunk_vertices, v)
        B = hi - lo
        ptr = np.asarray(g.indptr[lo: hi + 1]).astype(np.int64)
        e_src = np.asarray(g.indices[ptr[0]: ptr[-1]]).astype(np.int64)
        e_dst_local = np.repeat(np.arange(B, dtype=np.int64),
                                np.diff(ptr))
        counts = np.bincount(
            e_dst_local * k + out[e_src],
            minlength=B * k).reshape(B, k)
        scores = _scores(counts, sizes, cap, cfg, alpha, jitter)
        cur = out[lo:hi].astype(np.int64)
        best = np.argmax(scores, axis=1)
        # move only on a strict *affinity* gain: score gains alone are
        # dominated by the load penalty and make batched moves thrash
        ar = np.arange(B)
        want = (best != cur) & (counts[ar, best] > counts[ar, cur])

        idx = np.nonzero(want)[0]
        if len(idx):
            dest = best[idx]
            ok = ranks_within(dest) < np.maximum(0, cap - sizes)[dest]
            moved = idx[ok]
            sizes += np.bincount(best[moved], minlength=k)
            sizes -= np.bincount(cur[moved], minlength=k)
            out[lo:hi][moved] = best[moved].astype(np.int32)
    return out


def repartition(g, part: np.ndarray, k: int,
                cfg: RestreamConfig = RestreamConfig()) -> np.ndarray:
    """Admit new vertices, then run the configured warm passes."""
    out = admit(g, part, k, cfg)
    for _ in range(max(0, int(cfg.passes))):
        out = restream_pass(g, out, k, cfg)
    return out


def edge_cut_stream(g, part: np.ndarray,
                    chunk_edges: int = 1 << 21) -> int:
    """Chunked ``edge_cut`` that never materializes the merged edge
    array — works on stores and overlays alike."""
    part = np.asarray(part)
    cut = 0
    for lo, hi in iter_edge_chunks(g, chunk_edges):
        ptr = np.asarray(g.indptr[lo: hi + 1]).astype(np.int64)
        e_src = np.asarray(g.indices[ptr[0]: ptr[-1]]).astype(np.int64)
        e_dst = np.repeat(np.arange(lo, hi, dtype=np.int64),
                          np.diff(ptr))
        cut += int((part[e_src] != part[e_dst]).sum())
    return cut
