"""The reference's client shards, pruning and evaluation sample (numpy).

Frozen copies, each rule as the configuration states it:
``_retention_edge_mask``, ``assemble_shard`` and ``make_client_shards``
of ``repro_torch/graphs/partition.py`` (the retention draws made once a
client and filtered by the top-f % set after, which gives the shards of
the program's two builds) (a client's expanded subgraph: its
local vertices, then its retained remote in-neighbours as pull slots),
the §4.1.2 degree score of ``repro_torch/core/pruning.py``, the push-set
rule of ``repro_torch/core/federated.py`` ``assign_push_sets`` and the
evaluation sample of ``sampled_eval_vertices`` / ``eval_arrays_for``.
The top-f % selection is an exact sort by (−score, index), not the
program's threshold bisection.
"""

from __future__ import annotations

import numpy as np


def _retention_edge_mask(e_dst: np.ndarray, remote_mask: np.ndarray,
                         limit: int, rng: np.random.Generator) -> np.ndarray:
    """Each local destination keeps at most ``limit`` of its remote
    in-edges, uniformly at random (edges grouped by destination)."""
    keep = ~remote_mask
    if limit > 0:
        prio = rng.random(len(e_dst))
        order = np.lexsort((prio, ~remote_mask, e_dst))
        ranked = np.zeros(len(e_dst), np.int64)
        pos = np.arange(len(e_dst))
        sorted_dst = e_dst[order]
        grp_start = np.r_[0, 1 + np.nonzero(np.diff(sorted_dst))[0]]
        run_id = np.zeros(len(e_dst), np.int64)
        run_id[grp_start] = 1
        run_id = np.cumsum(run_id) - 1
        ranked[order] = pos - grp_start[run_id]
        keep = keep | (remote_mask & (ranked < limit))
    return keep


def _client_edges(g: dict, part: np.ndarray, c: int, e_src: np.ndarray,
                  e_dst: np.ndarray, retention_limit, seed: int) -> tuple:
    """Client ``c``'s in-edges after the retention limit, whether each
    source is remote, and every remote in-neighbour before pruning."""
    rng = np.random.default_rng(seed + 104729 * c)
    remote_mask = part[e_src] != c
    all_pull = np.unique(e_src[remote_mask])
    if retention_limit is not None:
        keep = _retention_edge_mask(e_dst, remote_mask, retention_limit, rng)
        e_src, e_dst, remote_mask = e_src[keep], e_dst[keep], remote_mask[keep]
    return e_src, e_dst, remote_mask, all_pull


def _assemble(g: dict, part: np.ndarray, c: int, edges: tuple,
              retained_remote) -> dict:
    e_src, e_dst, remote_mask, all_pull = edges
    local = np.nonzero(part == c)[0].astype(np.int64)
    if retained_remote is not None:
        keep_set = np.asarray(retained_remote.get(c, all_pull), np.int64)
        keep = np.isin(e_src, keep_set) | ~remote_mask
        e_src, e_dst, remote_mask = e_src[keep], e_dst[keep], remote_mask[keep]
    pull = np.unique(e_src[remote_mask])
    g2l = np.full(len(part), -1, dtype=np.int64)
    g2l[local] = np.arange(len(local))
    g2l[pull] = len(local) + np.arange(len(pull))
    order = np.argsort(e_dst, kind="stable")
    e_src, e_dst = g2l[e_src[order]], g2l[e_dst[order]]
    indptr = np.zeros(len(local) + 1, dtype=np.int64)
    np.add.at(indptr, e_dst + 1, 1)
    indptr = np.cumsum(indptr)
    return {"cid": c, "indptr": indptr, "indices": e_src.astype(np.int64),
            "global_ids": np.concatenate([local, pull]),
            "num_local": len(local),
            "features": g["features"][local], "labels": g["labels"][local],
            "train_mask": g["train_mask"][local], "pull_nodes": pull}


def client_edges(g: dict, part: np.ndarray, retention_limit,
                 seed: int) -> list[tuple]:
    """:func:`_client_edges` of every client of ``part``."""
    k = int(part.max()) + 1
    deg = np.diff(g["indptr"])
    dst_of_edge = np.repeat(np.arange(len(deg)), deg)
    src_of_edge = g["indices"].astype(np.int64)
    out = []
    for c in range(k):
        e_mask = part[dst_of_edge] == c
        out.append(_client_edges(g, part, c, src_of_edge[e_mask],
                                 dst_of_edge[e_mask], retention_limit, seed))
    return out


def make_shards(g: dict, part: np.ndarray, *, retention_limit=None,
                retained_remote=None, seed: int = 0,
                edges: list | None = None) -> list[dict]:
    """One shard per client of ``part`` (over ``edges`` from
    :func:`client_edges` where given)."""
    if edges is None:
        edges = client_edges(g, part, retention_limit, seed)
    return [_assemble(g, part, c, e, retained_remote)
            for c, e in enumerate(edges)]


def degree_scores(sh: dict) -> np.ndarray:
    """Each pull slot's count of local in-edges it feeds."""
    n_total = len(sh["global_ids"])
    deg = np.bincount(sh["indices"], minlength=n_total)
    return deg[sh["num_local"]:].astype(np.float64)


def top_fraction(scores: np.ndarray, frac: float) -> np.ndarray:
    """Sorted indices of the ``ceil(frac · n)`` highest scores, ties to
    the lower index."""
    n = len(scores)
    k = int(np.ceil(frac * n))
    if k >= n:
        return np.arange(n)
    order = np.lexsort((np.arange(n), -np.asarray(scores)))
    return np.sort(order[:k])


def build_shards(g: dict, part: np.ndarray, strategy: dict,
                 seed: int) -> list[dict]:
    """The shards a strategy trains on, with their push sets: no remote
    vertices without embeddings; else the retention limit, then the
    top-f % of the pull slots by degree score."""
    use = strategy["use_embeddings"]
    limit = 0 if not use else strategy.get("retention_limit")
    edges = client_edges(g, part, limit, seed)
    shards = make_shards(g, part, edges=edges)
    frac = strategy.get("scored_prune_frac")
    if use and frac is not None:
        if strategy.get("score_kind") != "degree":
            raise ValueError("the reference scores by degree only")
        retained = {sh["cid"]: sh["pull_nodes"][top_fraction(
            degree_scores(sh), frac)] for sh in shards}
        shards = make_shards(g, part, retained_remote=retained, edges=edges)
    for sh in shards:
        wanted = [o["pull_nodes"][part[o["pull_nodes"]] == sh["cid"]]
                  for o in shards if o["cid"] != sh["cid"]]
        sh["push_nodes"] = np.unique(np.concatenate(wanted)) \
            if wanted else np.zeros(0, np.int64)
        local = sh["global_ids"][: sh["num_local"]]
        sh["push_rows"] = np.searchsorted(local, sh["push_nodes"])
    return shards


def eval_vertices(g: dict, max_edges: int, seed: int) -> np.ndarray:
    """The whole graph, or past ``max_edges`` a seeded uniform vertex
    sample whose in-edges fit it (sorted)."""
    deg = np.diff(g["indptr"])
    n = len(deg)
    if len(g["indices"]) <= max_edges:
        return np.arange(n, dtype=np.int64)
    rng = np.random.default_rng((seed, 104729))
    perm = rng.permutation(n)
    k = int(np.searchsorted(np.cumsum(deg[perm]), max_edges, side="right"))
    return np.sort(perm[: max(1, k)]).astype(np.int64)


def induced_edges(g: dict, sel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) positions in ``sel`` of the edges with both ends in the
    sorted selection ``sel``."""
    indptr = g["indptr"]
    starts = indptr[sel]
    counts = indptr[sel + 1] - starts
    dst = np.repeat(np.arange(len(sel), dtype=np.int64), counts)
    offsets = np.cumsum(counts) - counts
    pos = np.arange(int(counts.sum()), dtype=np.int64) \
        - np.repeat(offsets, counts) + np.repeat(starts, counts)
    src = g["indices"][pos].astype(np.int64)
    loc = np.minimum(np.searchsorted(sel, src), len(sel) - 1)
    keep = sel[loc] == src
    return loc[keep], dst[keep]
