"""Score-based pruning (§4.1.2) and remote-node scoring.

Port of ``repro/core/pruning.py``.  The scores are computed on the host
in numpy (copies of the JAX package's functions, so the same shard gives
identical scores); the selection of the top-f% goes through the
``topk_mask`` threshold bisection (:func:`repro_torch.kernels.ops.topk_mask`:
one kernel launch on the card) and then resolves the threshold's ties, so
the indices are exactly those of the JAX ``top_fraction``.

Scores:
  - ``frequency``: S(v) = |{x ∈ T : v ∈ N_L(x)}| / |T| — the fraction of
    training vertices with v inside their L-hop in-neighbourhood of the
    expanded subgraph.  It builds a dense (train × shard) bool matrix, so
    it is for small shards only.
  - ``degree``: in-degree of the remote vertex as seen by this client.
  - ``bridge``: degree-based bridging coefficient × ego betweenness proxy.

Uniform retention-limit pruning (§4.1.1) happens while the shards are
built (:func:`repro_torch.graphs.partition.make_client_shards`);
:func:`retention_pruned_sets` gives the per-client retained vertex sets
of that rule over the whole graph, as the JAX package's does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs.partition import ClientShard
from repro_torch.kernels import ops


def retention_pruned_sets(
    g,
    part: np.ndarray,
    limit: int | None,
    *,
    seed: int = 0,
) -> dict[int, np.ndarray] | None:
    """Per-client retained remote vertex sets under retention limit P_i.

    Returns None for P_inf (no pruning).  Retention is per *boundary
    vertex*: each local vertex keeps ≤ limit remote in-neighbours; the
    retained set is the union.  Done offline before loading the subgraph,
    as in the paper's implementation.
    """
    if limit is None:
        return None
    rng = np.random.default_rng(seed)
    k = int(part.max()) + 1
    if limit == 0:
        return {c: np.zeros(0, np.int64) for c in range(k)}
    # Vectorized over the whole CSR: one uniform priority per edge, and
    # each boundary vertex keeps the ``limit`` remote in-neighbours with
    # the smallest priorities — uniform without replacement, selected
    # for every vertex at once instead of a per-vertex rng.choice loop
    # (a test pins the selection rule against a per-vertex reference
    # with the same priorities).
    e_dst = np.repeat(np.arange(g.num_vertices), np.diff(g.indptr))
    e_src = g.indices.astype(np.int64)
    prio = rng.random(g.num_edges)
    # only boundary (remote) edges compete for retention slots
    bnd = np.nonzero(part[e_src] != part[e_dst])[0]
    e_src, e_dst, prio = e_src[bnd], e_dst[bnd], prio[bnd]
    if len(e_dst) == 0:
        return {c: np.zeros(0, np.int64) for c in range(k)}
    # CSR order survives the filter, so each destination's remote edges
    # form one contiguous run — `limit` minimum.reduceat sweeps select
    # its `limit` smallest priorities without any sort (priorities are
    # continuous, so within-run duplicates have probability zero)
    starts = np.r_[0, 1 + np.nonzero(np.diff(e_dst))[0]]
    run_of = np.zeros(len(e_dst), np.int64)
    run_of[starts] = 1
    run_of = np.cumsum(run_of) - 1
    work = prio.copy()
    keep_mask = np.zeros(len(e_dst), bool)
    for _ in range(min(limit, int(np.diff(np.r_[starts,
                                                len(e_dst)]).max()))):
        m = np.minimum.reduceat(work, starts)
        sel = (work == m[run_of]) & np.isfinite(work)
        keep_mask |= sel
        work[sel] = np.inf
    kept = np.nonzero(keep_mask)[0]
    # group survivors by client: unique (client, src) pairs in one pass
    key = part[e_dst[kept]].astype(np.int64) * g.num_vertices + e_src[kept]
    key = np.unique(key)
    cli = key // g.num_vertices
    srcs = key % g.num_vertices
    bounds = np.searchsorted(cli, np.arange(k + 1))
    return {c: srcs[bounds[c]: bounds[c + 1]] for c in range(k)}


def _reach_counts(shard: ClientShard, num_hops: int) -> np.ndarray:
    """counts[v] = #train vertices with node v in their ≤num_hops
    in-neighbourhood of the expanded subgraph."""
    train = shard.train_vertices()
    n_total = len(shard.global_ids)
    t = len(train)
    if t == 0:
        return np.zeros(n_total, np.int64)
    reach = np.zeros((t, n_total), dtype=bool)
    reach[np.arange(t), train] = True
    e_dst = np.repeat(np.arange(shard.num_local), np.diff(shard.indptr))
    e_src = shard.indices.astype(np.int64)
    for _ in range(num_hops):
        new = np.zeros_like(reach)
        # v reachable next hop if some u with (v -> u) edge is reachable.
        np.logical_or.at(new.T, e_src, reach[:, e_dst].T)
        reach |= new
    return reach.sum(axis=0).astype(np.int64)


def frequency_scores(shard: ClientShard, num_hops: int) -> np.ndarray:
    """S(v) for each remote (pull) slot of the shard (§4.1.2)."""
    counts = _reach_counts(shard, num_hops)
    t = max(1, len(shard.train_vertices()))
    return counts[shard.num_local:] / t


def degree_scores(shard: ClientShard) -> np.ndarray:
    """In-degree centrality of remote vertices as seen locally: number of
    local vertices each remote vertex feeds into."""
    n_total = len(shard.global_ids)
    deg = np.zeros(n_total, np.int64)
    np.add.at(deg, shard.indices.astype(np.int64), 1)
    return deg[shard.num_local:].astype(np.float64)


def bridge_scores(shard: ClientShard) -> np.ndarray:
    """Bridging-coefficient proxy for bridge centrality: BrC(v) ≈ local
    degree × (1/deg v) / Σ_{n∈N(v)} 1/deg(n), over the local star of each
    remote vertex."""
    n_total = len(shard.global_ids)
    deg = np.zeros(n_total, np.float64)
    np.add.at(deg, shard.indices.astype(np.int64), 1.0)
    local_deg = np.maximum(np.diff(shard.indptr).astype(np.float64), 1.0)
    inv_nbr_sum = np.zeros(n_total, np.float64)
    e_dst = np.repeat(np.arange(shard.num_local), np.diff(shard.indptr))
    np.add.at(inv_nbr_sum, shard.indices.astype(np.int64),
              1.0 / local_deg[e_dst])
    d = np.maximum(deg, 1.0)
    bridging = (1.0 / d) / np.maximum(inv_nbr_sum, 1e-9)
    return (deg * bridging)[shard.num_local:]


def score_remote_nodes(shard: ClientShard, kind: str,
                       num_hops: int) -> np.ndarray:
    if kind == "frequency":
        return frequency_scores(shard, num_hops)
    if kind == "degree":
        return degree_scores(shard)
    if kind == "bridge":
        return bridge_scores(shard)
    raise KeyError(f"unknown score kind {kind!r}")


def top_fraction(scores: np.ndarray, frac: float,
                 *, rng: np.random.Generator | None = None,
                 random_subset: bool = False,
                 device: str = "cuda") -> np.ndarray:
    """Sorted indices of the top ``frac`` of scores, ties broken by index
    (or a random subset of the same size, for the R25-style ablations).

    The threshold mask of ``ops.topk_mask`` over the fp32 scores on
    ``device`` holds at least k entries, and every entry it holds is ≥
    every entry it drops (fp32 rounding keeps the order), so the exact
    top k by (−score, index) lies inside it; the candidates are ranked
    on the host in the scores' own precision."""
    n = len(scores)
    k = int(np.ceil(frac * n))
    if k >= n:
        return np.arange(n)
    if random_subset:
        rng = rng or np.random.default_rng(0)
        return np.sort(rng.choice(n, size=k, replace=False))
    scores = np.asarray(scores)
    s = torch.from_numpy(scores.astype(np.float32)).to(device)
    cand = np.nonzero(ops.topk_mask(s, k).cpu().numpy())[0]
    if len(cand) > k:
        order = np.lexsort((cand, -scores[cand]))
        cand = cand[order[:k]]
    return np.sort(cand)
