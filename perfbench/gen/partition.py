"""The benchmark's partition: a frozen copy of
``repro_torch/graphs/partition.py`` ``bfs_partition`` (with
``neighbours_of``, ``ranks_within`` and ``_water_fill``) over bare CSR
arrays.  The same arrays and seed give the program's partition byte for
byte (a CPU test holds it to it)."""

from __future__ import annotations

import numpy as np


def neighbours_of(indptr: np.ndarray, indices: np.ndarray,
                  frontier: np.ndarray) -> np.ndarray:
    """The concatenated in-neighbour lists of every vertex in
    ``frontier``."""
    starts = indptr[frontier]
    cnt = indptr[frontier + 1] - starts
    total = int(cnt.sum())
    if total == 0:
        return np.zeros(0, indices.dtype)
    offs = np.cumsum(cnt) - cnt
    pos = np.arange(total, dtype=np.int64) \
        - np.repeat(offs, cnt) + np.repeat(starts, cnt)
    return indices[pos]


def ranks_within(groups: np.ndarray) -> np.ndarray:
    """Rank of each element within its group value, in list order."""
    order = np.argsort(groups, kind="stable")
    gs = groups[order]
    starts = np.r_[0, 1 + np.nonzero(np.diff(gs))[0]] \
        if len(gs) else np.zeros(0, np.int64)
    run = np.zeros(len(groups), np.int64)
    run[starts] = 1
    run = np.cumsum(run) - 1
    r = np.empty(len(groups), dtype=np.int64)
    r[order] = np.arange(len(groups)) - starts[run]
    return r


def _water_fill(sizes: np.ndarray, m: int) -> np.ndarray:
    """``m`` extra slots over the parts, each to the then-smallest part
    (ties to the lowest index); the fill counts per part."""
    k = len(sizes)
    fills = np.zeros(k, dtype=np.int64)
    if m <= 0:
        return fills
    order = np.argsort(sizes, kind="stable")
    s = sizes[order].astype(np.int64)
    lift = np.cumsum(np.arange(1, k) * np.diff(s))
    j = int(np.searchsorted(lift, m, side="right"))
    base = m - (lift[j - 1] if j > 0 else 0)
    level = s[j]
    f = np.zeros(k, dtype=np.int64)
    f[: j + 1] = level - s[: j + 1]
    nrecv = j + 1
    f[:nrecv] += base // nrecv
    rem = int(base % nrecv)
    if rem:
        lowest_ids = np.sort(order[:nrecv])[:rem]
        fills[lowest_ids] += 1
    fills[order] += f
    return fills


def bfs_partition(indptr: np.ndarray, indices: np.ndarray, k: int, *,
                  seed: int = 0) -> np.ndarray:
    """BFS-grown balanced parts and one boundary-refinement sweep (int32
    part of each vertex)."""
    rng = np.random.default_rng(seed)
    n = len(indptr) - 1
    target = (n + k - 1) // k
    part = np.full(n, -1, dtype=np.int32)
    sizes = np.zeros(k, dtype=np.int64)
    order = rng.permutation(n)
    cursor = 0
    for p in range(k):
        while cursor < n and part[order[cursor]] >= 0:
            cursor += 1
        if cursor >= n:
            break
        frontier = order[cursor: cursor + 1].astype(np.int64)
        while len(frontier) and sizes[p] < target:
            room = int(target - sizes[p])
            take, rest = frontier[:room], frontier[room:]
            part[take] = p
            sizes[p] += len(take)
            if len(rest) or sizes[p] >= target:
                break
            nxt = np.unique(neighbours_of(indptr, indices, take))
            frontier = nxt[part[nxt] < 0].astype(np.int64)
    left = np.nonzero(part < 0)[0]
    if len(left):
        fills = _water_fill(sizes, len(left))
        recv = np.argsort(sizes, kind="stable")
        part[left] = np.repeat(recv, fills[recv]).astype(np.int32)
        sizes += fills
    lo, hi = int(0.9 * target), int(1.1 * target) + 1
    deg = np.diff(indptr)
    e_dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    cnt = np.bincount(e_dst * k + part[indices],
                      minlength=n * k).reshape(n, k)
    best = np.argmax(cnt, axis=1)
    cur = part.astype(np.int64)
    ar = np.arange(n)
    cand = (best != cur) & (cnt[ar, best] > cnt[ar, cur]) \
        & (sizes[best] < hi) & (sizes[cur] > lo) & (deg > 0)
    prio = np.empty(n, dtype=np.int64)
    prio[rng.permutation(n)] = np.arange(n)
    cand_idx = np.nonzero(cand)[0]
    if len(cand_idx):
        cand_idx = cand_idx[np.argsort(prio[cand_idx], kind="stable")]
        dest, src = best[cand_idx], cur[cand_idx]
        admit = (ranks_within(dest) < (hi - sizes)[dest]) \
            & (ranks_within(src) < (sizes - lo)[src])
        moved = cand_idx[admit]
        part[moved] = best[moved].astype(np.int32)
    return part
