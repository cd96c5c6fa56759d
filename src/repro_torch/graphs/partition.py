"""Graph partitioning for cross-silo federated subgraph learning (copy of
``repro/graphs/partition.py``, so the same graph and seed give
byte-identical partitions and shards).

The paper uses METIS with vertex balancing and minimised edge cuts.  METIS
is not installable offline, so we provide a multilevel-lite equivalent:
BFS-grown balanced partitions followed by greedy Kernighan-Lin-style
boundary refinement.  A ``hash`` baseline is included for ablations.

``ClientShard`` is the per-client view the federated runtime consumes:
the *expanded* subgraph (local ∪ retained remote pull nodes, CSR over
local destinations), the pull/push node sets, and local→global maps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .graph import Graph


def neighbours_of(indptr: np.ndarray, indices: np.ndarray,
                  frontier: np.ndarray) -> np.ndarray:
    """CSR range-gather: the concatenated in-neighbour lists of every
    vertex in ``frontier``, without a per-vertex Python loop."""
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
    """Rank of each element within its group value, preserving list
    order — the ranked-admission primitive shared by the refinement
    sweep here and the streaming LDG partitioner."""
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
    """Distribute ``m`` extra slots over parts, always topping up the
    currently-smallest part (ties → lowest part index).  Returns the
    per-part fill counts; the vectorized equivalent of ``m`` sequential
    ``argmin(sizes)`` assignments (fuzz-pinned against that loop in
    the JAX package's tests)."""
    k = len(sizes)
    fills = np.zeros(k, dtype=np.int64)
    if m <= 0:
        return fills
    order = np.argsort(sizes, kind="stable")
    s = sizes[order].astype(np.int64)
    # raise the lowest j+1 parts to the level of part j+1: cumulative
    # cost.  Equal sizes have zero diff, so searchsorted(side="right")
    # pulls every part tied at the final level into the receiver set.
    lift = np.cumsum(np.arange(1, k) * np.diff(s))
    j = int(np.searchsorted(lift, m, side="right"))   # parts 0..j receive
    base = m - (lift[j - 1] if j > 0 else 0)
    level = s[j]
    f = np.zeros(k, dtype=np.int64)
    f[: j + 1] = level - s[: j + 1]
    # `base` slots remain once everyone is level: sequential argmin now
    # round-robins the receivers in PART-INDEX order (its tie-break),
    # so whole extra laps go to all of them and the remainder to the
    # lowest part ids among them — not to the previously-smallest.
    nrecv = j + 1
    f[:nrecv] += base // nrecv
    rem = int(base % nrecv)
    if rem:
        lowest_ids = np.sort(order[:nrecv])[:rem]
        fills[lowest_ids] += 1
    fills[order] += f
    return fills


def bfs_partition(g: Graph, k: int, *, seed: int = 0) -> np.ndarray:
    """Level-synchronous BFS-grown balanced parts + one vectorized
    boundary-refinement sweep.

    Fully CSR-sliced numpy: each part grows a whole BFS frontier per
    step (capped at the balance target), leftovers are water-filled onto
    the smallest parts, and the refinement pass moves every profitable
    boundary vertex against a frozen snapshot of the partition, with
    per-part in/out capacity enforced by ranked admission.  ~100×
    faster than a per-vertex flood at 100k+ vertices."""
    rng = np.random.default_rng(seed)
    n = g.num_vertices
    target = (n + k - 1) // k
    part = np.full(n, -1, dtype=np.int32)
    sizes = np.zeros(k, dtype=np.int64)
    order = rng.permutation(n)
    cursor = 0   # next seed candidate in `order`

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
            nxt = np.unique(neighbours_of(g.indptr, g.indices, take))
            frontier = nxt[part[nxt] < 0].astype(np.int64)

    # leftovers → water-fill onto the smallest parts (vertex-id order)
    left = np.nonzero(part < 0)[0]
    if len(left):
        fills = _water_fill(sizes, len(left))
        recv = np.argsort(sizes, kind="stable")
        part[left] = np.repeat(recv, fills[recv]).astype(np.int32)
        sizes += fills

    # one vectorized refinement sweep against a frozen snapshot: move a
    # boundary vertex to its majority-neighbour part when that strictly
    # beats its current part, admitting moves in seeded-permutation
    # order until the ±10% balance band (dest inflow / source outflow
    # capacity) is exhausted.
    lo, hi = int(0.9 * target), int(1.1 * target) + 1
    deg = np.diff(g.indptr)
    e_dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    # fused-index bincount: ~10× the throughput of an np.add.at scatter
    cnt = np.bincount(e_dst * k + part[g.indices],
                      minlength=n * k).reshape(n, k)
    best = np.argmax(cnt, axis=1)
    cur = part.astype(np.int64)
    ar = np.arange(n)
    cand = (best != cur) & (cnt[ar, best] > cnt[ar, cur]) \
        & (sizes[best] < hi) & (sizes[cur] > lo) & (deg > 0)
    prio = np.empty(n, dtype=np.int64)
    prio[rng.permutation(n)] = np.arange(n)    # sweep order of the old loop
    cand_idx = np.nonzero(cand)[0]
    if len(cand_idx):
        cand_idx = cand_idx[np.argsort(prio[cand_idx], kind="stable")]
        dest, src = best[cand_idx], cur[cand_idx]
        admit = (ranks_within(dest) < (hi - sizes)[dest]) \
            & (ranks_within(src) < (sizes - lo)[src])
        moved = cand_idx[admit]
        part[moved] = best[moved].astype(np.int32)
    return part


def hash_partition(g: Graph, k: int, *, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, k, size=g.num_vertices).astype(np.int32)


def edge_cut(g: Graph, part: np.ndarray) -> int:
    dst = np.repeat(np.arange(g.num_vertices), np.diff(g.indptr))
    return int((part[g.indices] != part[dst]).sum())


@dataclasses.dataclass
class ClientShard:
    """Per-client expanded subgraph + federation metadata.

    Local vertices occupy indices ``[0, num_local)``; retained remote
    (pull) vertices occupy ``[num_local, num_local + num_remote)``.
    Remote vertices have no in-edges here (their neighbourhoods are on
    other clients), matching the sampler rule that a remote node
    terminates a sampling path.
    """

    client_id: int
    indptr: np.ndarray          # (num_local+1,) in-edges of LOCAL vertices only
    indices: np.ndarray         # (E_local,) local indices into [0, n_total)
    global_ids: np.ndarray      # (n_total,) local→global
    num_local: int
    features: np.ndarray        # (num_local, F) — remotes have NO h^0
    labels: np.ndarray          # (num_local,)
    train_mask: np.ndarray      # (num_local,)
    pull_nodes: np.ndarray      # global ids of retained remote vertices
    push_nodes: np.ndarray      # global ids of local vertices other clients pull
    all_pull_nodes: np.ndarray  # global ids of remote in-neighbours pre-pruning
    num_classes: int = 0

    @property
    def num_remote(self) -> int:
        return int(len(self.global_ids) - self.num_local)

    def is_remote(self, local_idx: np.ndarray) -> np.ndarray:
        return np.asarray(local_idx) >= self.num_local

    def train_vertices(self) -> np.ndarray:
        return np.nonzero(self.train_mask)[0].astype(np.int64)


def _retention_edge_mask(e_dst: np.ndarray, remote_mask: np.ndarray,
                         limit: int, rng: np.random.Generator) -> np.ndarray:
    """§4.1.1 uniform random pruning with retention limit, at EDGE level:
    each local destination keeps at most ``limit`` of its remote in-edges
    (uniformly at random).  Edges arrive grouped by dst."""
    keep = ~remote_mask
    if limit > 0:
        prio = rng.random(len(e_dst))
        # rank of each remote edge among its (dst)'s remote edges by prio
        order = np.lexsort((prio, ~remote_mask, e_dst))
        ranked = np.zeros(len(e_dst), np.int64)
        pos = np.arange(len(e_dst))
        # position within each (dst, remote=True) run
        sorted_dst = e_dst[order]
        sorted_rem = remote_mask[order]
        grp_start = np.r_[0, 1 + np.nonzero(np.diff(sorted_dst))[0]]
        run_id = np.zeros(len(e_dst), np.int64)
        run_id[grp_start] = 1
        run_id = np.cumsum(run_id) - 1
        within = pos - grp_start[run_id]
        ranked[order] = within
        keep = keep | (remote_mask & (ranked < limit))
    return keep


def assemble_shard(
    g,
    part: np.ndarray,
    c: int,
    e_src: np.ndarray,
    e_dst: np.ndarray,
    push: np.ndarray,
    *,
    retention_limit: Optional[int] = None,
    retained_remote: Optional[dict[int, np.ndarray]] = None,
    seed: int = 0,
) -> ClientShard:
    """Assemble one :class:`ClientShard` from the client's in-edge list.

    ``e_src``/``e_dst`` are the global (src → dst) in-edges of client
    ``c``'s local vertices in global CSR order (grouped by dst).  ``g``
    only needs the node arrays (features/labels/train_mask) and
    ``num_classes``.
    """
    rng = np.random.default_rng(seed + 104729 * c)
    local = np.nonzero(part == c)[0].astype(np.int64)
    remote_mask = part[e_src] != c
    all_pull = np.unique(e_src[remote_mask])
    if retention_limit is not None:
        keep = _retention_edge_mask(e_dst, remote_mask,
                                    retention_limit, rng)
        e_src, e_dst = e_src[keep], e_dst[keep]
        remote_mask = remote_mask[keep]
    if retained_remote is not None:
        keep_set = np.asarray(retained_remote.get(c, all_pull),
                              dtype=np.int64)
        keep = np.isin(e_src, keep_set) | ~remote_mask
        e_src, e_dst = e_src[keep], e_dst[keep]
        remote_mask = remote_mask[keep]
    pull = np.unique(e_src[remote_mask])

    g2l = np.full(len(part), -1, dtype=np.int64)
    g2l[local] = np.arange(len(local))
    g2l[pull] = len(local) + np.arange(len(pull))
    order = np.argsort(e_dst, kind="stable")
    e_src, e_dst = g2l[e_src[order]], g2l[e_dst[order]]
    indptr = np.zeros(len(local) + 1, dtype=np.int64)
    np.add.at(indptr, e_dst + 1, 1)
    indptr = np.cumsum(indptr)
    return ClientShard(
        client_id=c,
        indptr=indptr,
        indices=e_src.astype(np.int32),
        global_ids=np.concatenate([local, pull]),
        num_local=len(local),
        features=np.asarray(g.features[local]),
        labels=np.asarray(g.labels[local]),
        train_mask=np.asarray(g.train_mask[local]),
        pull_nodes=pull,
        push_nodes=push,
        all_pull_nodes=all_pull,
        num_classes=g.num_classes,
    )


def make_client_shards(
    g: Graph,
    part: np.ndarray,
    *,
    retained_remote: Optional[dict[int, np.ndarray]] = None,
    retention_limit: Optional[int] = None,
    seed: int = 0,
) -> list[ClientShard]:
    """Split ``g`` by ``part`` into :class:`ClientShard` views.

    ``retention_limit`` applies §4.1.1 uniform random pruning (each local
    boundary vertex keeps ≤ limit remote in-edges; 0 ⇒ default federated
    GNN, None ⇒ P_inf / EmbC).  ``retained_remote`` optionally maps
    client → global ids of remote vertices to retain (score-based pruning,
    §4.1.2); both compose (limit first, then the vertex set filter).
    Materializes the full O(E) edge array — right for in-memory graphs;
    an mmap :class:`repro_torch.graphstore.GraphStore` goes through
    ``repro_torch.graphstore.stream_client_shards`` (the same shards,
    bounded memory).
    """
    k = int(part.max()) + 1
    deg = np.diff(g.indptr)
    dst_of_edge = np.repeat(np.arange(g.num_vertices), deg)
    src_of_edge = g.indices.astype(np.int64)
    shards = []
    for c in range(k):
        e_mask = part[dst_of_edge] == c
        e_src, e_dst = src_of_edge[e_mask], dst_of_edge[e_mask]
        # push nodes: local vertices that appear as in-neighbours on other
        # clients (symmetric graphs ⇒ out-edges mirror in-edges).
        other_dst = part[dst_of_edge] != c
        push = np.unique(src_of_edge[other_dst & (part[src_of_edge] == c)])
        shards.append(assemble_shard(
            g, part, c, e_src, e_dst, push,
            retention_limit=retention_limit,
            retained_remote=retained_remote, seed=seed))
    return shards


def filter_shard_remote(sh: ClientShard,
                        keep_gids: np.ndarray) -> ClientShard:
    """Shard-local §4.1.2 filter: drop remote in-edges whose source is
    not in ``keep_gids`` and compact the pull slots.

    Equivalent to rebuilding the shard with ``retained_remote`` (the
    edge order, pull ordering and local→global maps all match the
    full-graph rebuild), but needs only the shard itself: the
    out-of-core plane uses it so a worker holding one mmap'd shard can
    apply score-based pruning without re-scanning the graph."""
    keep_set = np.asarray(keep_gids, dtype=np.int64)
    e_dst = np.repeat(np.arange(sh.num_local), np.diff(sh.indptr))
    e_src = sh.indices.astype(np.int64)
    remote = e_src >= sh.num_local
    src_gid = sh.global_ids[e_src]
    keep = ~remote | np.isin(src_gid, keep_set)
    e_src, e_dst = e_src[keep], e_dst[keep]
    remote = remote[keep]
    pull = np.unique(sh.global_ids[e_src[remote]])
    # remap: locals keep their slots, surviving pulls compact after them
    g2l = np.full(int(sh.global_ids.max()) + 1, -1, dtype=np.int64)
    g2l[sh.global_ids[: sh.num_local]] = np.arange(sh.num_local)
    g2l[pull] = sh.num_local + np.arange(len(pull))
    e_src = g2l[sh.global_ids[e_src]]
    indptr = np.zeros(sh.num_local + 1, dtype=np.int64)
    np.add.at(indptr, e_dst + 1, 1)
    indptr = np.cumsum(indptr)
    return dataclasses.replace(
        sh, indptr=indptr, indices=e_src.astype(np.int32),
        global_ids=np.concatenate([sh.global_ids[: sh.num_local], pull]),
        pull_nodes=pull)
