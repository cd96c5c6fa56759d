"""Score-based pruning (§4.1.2) and remote-node scoring.

Port of ``repro/core/pruning.py``.  The scores are computed on the host
in numpy (copies of the JAX package's functions, so the same shard gives
identical scores); the selection of the top-f% goes through the
``topk_mask`` threshold bisection (:func:`repro_torch.kernels.ops.topk_mask`:
the count kernel on the card) and then resolves the threshold's ties, so
the indices are exactly those of the JAX ``top_fraction``.

Scores:
  - ``frequency``: S(v) = |{x ∈ T : v ∈ N_L(x)}| / |T| — the fraction of
    training vertices with v inside their L-hop in-neighbourhood of the
    expanded subgraph.  It builds a dense (train × shard) bool matrix, so
    it is for small shards only.
  - ``degree``: in-degree of the remote vertex as seen by this client.
  - ``bridge``: degree-based bridging coefficient × ego betweenness proxy.

Uniform retention-limit pruning (§4.1.1) happens while the shards are
built (:func:`repro_torch.graphs.partition.make_client_shards`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs.partition import ClientShard
from repro_torch.kernels import ops


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
