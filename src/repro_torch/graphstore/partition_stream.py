"""Single-pass streaming partitioner (LDG) + streaming shard extraction.

Port of ``repro/graphstore/partition_stream.py`` (numpy only).

``ldg_partition`` is a chunk-vectorized Linear Deterministic Greedy
streaming partitioner (Stanton & Kliot): vertices arrive in id order in
blocks, each block scores every candidate part as

    |N(v) ∩ P_i| · (1 − |P_i| / cap)

against the partition state frozen at block start (the restreaming-LDG
BSP relaxation — what makes the block assignable with one argmax
instead of a per-vertex Python loop), admits winners under per-part
capacity by ranked admission, and water-fills the rest (vertices with
no assigned neighbours yet) onto the least-loaded parts.  One pass over
the CSR, O(V + chunk·k) memory: the partitioner never sees more than a
block of the edge array, so it runs unchanged over a million-vertex
mmap store.

``stream_client_shards`` replaces the O(E)-materializing halo/boundary
extraction of ``make_client_shards`` for stores: it streams CSR blocks,
scatters each client's in-edges (and reciprocal push candidates) into
per-client accumulators, and hands them to the *same*
``assemble_shard`` the in-memory path uses — output bit-identical,
peak memory bounded by the shard sizes requested, not the graph.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.graphs.partition import (ClientShard, _water_fill,
                                          assemble_shard,
                                          make_client_shards, ranks_within)


def ldg_partition(g, k: int, *, seed: int = 0, slack: float = 1.05,
                  chunk_vertices: int = 1 << 16) -> np.ndarray:
    """Streaming LDG over ``g``'s CSR (an in-memory ``Graph`` or an mmap
    ``GraphStore``).  Deterministic for a ``(graph, k, seed,
    chunk_vertices)`` key; ``slack`` bounds every part at
    ``ceil(V/k)·slack`` vertices."""
    n = g.num_vertices
    cap = int(np.ceil(n / k) * slack)
    part = np.full(n, -1, dtype=np.int32)
    sizes = np.zeros(k, dtype=np.int64)
    rng = np.random.default_rng(seed)
    # seeded per-part jitter breaks score ties without biasing part 0
    jitter = rng.random(k) * 1e-9

    for lo in range(0, n, chunk_vertices):
        hi = min(lo + chunk_vertices, n)
        B = hi - lo
        ptr = np.asarray(g.indptr[lo: hi + 1]).astype(np.int64)
        e_src = np.asarray(g.indices[ptr[0]: ptr[-1]]).astype(np.int64)
        e_dst_local = np.repeat(np.arange(B, dtype=np.int64),
                                np.diff(ptr))
        src_part = part[e_src]
        known = src_part >= 0
        counts = np.bincount(
            e_dst_local[known] * k + src_part[known],
            minlength=B * k).reshape(B, k)
        penalty = np.maximum(0.0, 1.0 - sizes / cap)
        scores = counts * penalty[None, :] + jitter[None, :]
        best = np.argmax(scores, axis=1)
        has_affinity = counts[np.arange(B), best] > 0

        # ranked admission against the frozen sizes: part p accepts at
        # most (cap - sizes[p]) of this block's affinity winners, in
        # block order
        idx = np.nonzero(has_affinity)[0]
        admit = np.zeros(B, dtype=bool)
        if len(idx):
            dest = best[idx]
            ok = ranks_within(dest) < np.maximum(0, cap - sizes)[dest]
            admit[idx[ok]] = True
        part[lo:hi][admit] = best[admit].astype(np.int32)
        sizes += np.bincount(best[admit], minlength=k)

        # the rest (no assigned neighbours, or their part was full)
        # water-fill onto the least-loaded parts
        rest = np.nonzero(~admit)[0]
        if len(rest):
            fills = _water_fill(sizes, len(rest))
            recv = np.argsort(sizes, kind="stable")
            part[lo:hi][rest] = np.repeat(
                recv, fills[recv]).astype(np.int32)
            sizes += fills
    return part


def iter_edge_chunks(g, chunk_edges: int):
    """Yield ``(lo, hi)`` vertex ranges whose in-edge lists stay near
    ``chunk_edges`` — edge-budgeted so a power-law hub range cannot
    blow the per-chunk working set the way fixed vertex strides do."""
    indptr = g.indptr
    V = g.num_vertices
    lo = 0
    while lo < V:
        hi = int(np.searchsorted(indptr, int(indptr[lo]) + chunk_edges,
                                 side="right")) - 1
        hi = min(max(hi, lo + 1), V)
        yield lo, hi
        lo = hi


def stream_client_shards(
    g,
    part: np.ndarray,
    *,
    client_ids: Optional[list[int]] = None,
    retention_limit: Optional[int] = None,
    retained_remote: Optional[dict[int, np.ndarray]] = None,
    seed: int = 0,
    chunk_edges: int = 1 << 21,
) -> list[ClientShard]:
    """Bit-identical ``make_client_shards`` over a streamed CSR.

    ``client_ids`` restricts extraction (a fed_worker asks only for the
    shards it owns); edges arrive grouped by destination in ascending
    order — exactly the global CSR order the in-memory path sees — and
    each shard is assembled by the shared ``assemble_shard``.  The
    chunking granularity never changes the output, only the transient
    working set.
    """
    part = np.asarray(part)
    k = int(part.max()) + 1
    wanted = list(range(k)) if client_ids is None else sorted(client_ids)
    e_src_acc: dict[int, list[np.ndarray]] = {c: [] for c in wanted}
    e_dst_acc: dict[int, list[np.ndarray]] = {c: [] for c in wanted}
    push_acc: dict[int, list[np.ndarray]] = {c: [] for c in wanted}

    for lo, hi in iter_edge_chunks(g, chunk_edges):
        ptr = np.asarray(g.indptr[lo: hi + 1]).astype(np.int64)
        e_src = np.asarray(g.indices[ptr[0]: ptr[-1]]).astype(np.int64)
        e_dst = np.repeat(np.arange(lo, hi, dtype=np.int64),
                          np.diff(ptr))
        dst_part = part[e_dst]
        src_part = part[e_src]
        for c in wanted:
            mine = dst_part == c
            if np.any(mine):
                e_src_acc[c].append(e_src[mine])
                e_dst_acc[c].append(e_dst[mine])
            # reciprocal push candidates: my locals feeding other clients
            out = (src_part == c) & (dst_part != c)
            if np.any(out):
                push_acc[c].append(np.unique(e_src[out]))

    shards = []
    for c in wanted:
        e_src = np.concatenate(e_src_acc[c]) if e_src_acc[c] \
            else np.zeros(0, np.int64)
        e_dst = np.concatenate(e_dst_acc[c]) if e_dst_acc[c] \
            else np.zeros(0, np.int64)
        push = np.unique(np.concatenate(push_acc[c])) if push_acc[c] \
            else np.zeros(0, np.int64)
        shards.append(assemble_shard(
            g, part, c, e_src, e_dst, push,
            retention_limit=retention_limit,
            retained_remote=retained_remote, seed=seed))
    return shards


def build_client_shards(g, part: np.ndarray, **kw) -> list[ClientShard]:
    """Dispatch: stream for an mmap store, materialize for a Graph.

    Both paths produce bit-identical shards (gated in
    ``tests/test_torch_graphstore.py``); the split is purely about peak
    memory — ``make_client_shards`` repeats the O(E) destination array,
    which is exactly what an out-of-core graph cannot afford.
    """
    if getattr(g, "is_store", False):
        return stream_client_shards(g, part, **kw)
    client_ids = kw.pop("client_ids", None)
    shards = make_client_shards(g, part, **kw)
    if client_ids is not None:
        shards = [shards[c] for c in sorted(client_ids)]
    return shards
