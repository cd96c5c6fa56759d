"""The benchmark's graphs: a frozen DC-SBM generator and an on-disk cache.

:func:`dcsbm` is a copy of ``repro_torch/graphs/synthetic.py``
``make_graph`` with the preset's numbers passed in (vertices, undirected
edge draws, classes, feature width, train fraction, homophily, feature
noise), and :func:`csr_from_edges` a copy of ``repro_torch/graphs/graph.py``
``from_edges``.  Given a preset's own numbers they give the program's
arrays byte for byte (a CPU test holds them to it); the configurations
then depart to the published widths.

:func:`load` returns the arrays of a configuration's graph and its fixed
partition, cached as ``.npy`` files under ``build/perfbench/`` keyed by
the graph's parameters, so only the first run in a checkout generates.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib

import numpy as np

from perfbench.gen.partition import bfs_partition

ARRAYS = ("indptr", "indices", "features", "labels", "train_mask", "part")


def csr_from_edges(num_vertices: int, src: np.ndarray, dst: np.ndarray, *,
                   symmetric: bool = True, dedup: bool = True
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(indptr int64, indices int32) of the in-edge CSR of ``src → dst``,
    with the reverse edges added (``symmetric``) and parallel edges and
    self-loops removed (``dedup``); each row's sources ascending."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    if dedup:
        keep = src != dst
        src, dst = src[keep], dst[keep]
        key = dst * num_vertices + src
        _, uniq = np.unique(key, return_index=True)
        src, dst = src[uniq], dst[uniq]
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.add.at(indptr, dst + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, src.astype(np.int32)


def dcsbm(vertices: int, edge_draws: int, classes: int, feat_dim: int,
          train_frac: float, homophily: float, feature_noise: float,
          seed: int) -> dict:
    """A degree-corrected stochastic block model graph: labels are the
    blocks, features noisy projections of the label.  Returns the arrays
    ``indptr``, ``indices``, ``features``, ``labels``, ``train_mask``."""
    n_v, n_cls = vertices, classes
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_cls, size=n_v).astype(np.int32)
    theta = rng.lognormal(mean=0.0, sigma=0.9, size=n_v)
    theta /= theta.mean()
    n_e = edge_draws
    p = theta / theta.sum()
    src = rng.choice(n_v, size=n_e, p=p)
    same = rng.random(n_e) < homophily
    dst = np.empty(n_e, dtype=np.int64)
    dst[~same] = rng.choice(n_v, size=int((~same).sum()), p=p)
    order = np.argsort(labels, kind="stable")
    block_start = np.searchsorted(labels[order], np.arange(n_cls))
    block_end = np.searchsorted(labels[order], np.arange(n_cls), side="right")
    for c in np.unique(labels[src[same]]):
        members = order[block_start[c]: block_end[c]]
        pc = theta[members] / theta[members].sum()
        sel = same & (labels[src] == c)
        dst[sel] = rng.choice(members, size=int(sel.sum()), p=pc)
    proj = rng.standard_normal((n_cls, feat_dim)).astype(np.float32)
    feats = proj[labels] + feature_noise * rng.standard_normal(
        (n_v, feat_dim)).astype(np.float32)
    train_mask = rng.random(n_v) < train_frac
    train_mask[: n_cls] = True
    indptr, indices = csr_from_edges(n_v, src, dst)
    return {"indptr": indptr, "indices": indices,
            "features": feats.astype(np.float32), "labels": labels,
            "train_mask": train_mask}


def graph_params(cfg: dict) -> dict:
    """The generator's keyword arguments from a configuration."""
    g = cfg["graph"]
    return {k: g[k] for k in ("vertices", "edge_draws", "classes",
                              "feat_dim", "train_frac", "homophily",
                              "feature_noise")} | {"seed": g["data_seed"]}


def cache_dir(root: pathlib.Path, cfg: dict) -> pathlib.Path:
    """``build/perfbench/<config>-<hash of the graph's parameters>``."""
    key = json.dumps([graph_params(cfg), cfg["model"]["clients"]],
                     sort_keys=True)
    digest = hashlib.sha256(key.encode()).hexdigest()[:12]
    return root / "build" / "perfbench" / f"{cfg['name']}-{digest}"


def generate(cfg: dict) -> dict:
    """The graph's arrays and its partition over the configuration's
    clients (BFS-grown, seeded by the graph's ``data_seed``)."""
    arrays = dcsbm(**graph_params(cfg))
    arrays["part"] = bfs_partition(arrays["indptr"], arrays["indices"],
                                   cfg["model"]["clients"],
                                   seed=cfg["graph"]["data_seed"])
    return arrays


def load(root: pathlib.Path, cfg: dict) -> dict:
    """The configuration's arrays, from the cache or generated and then
    cached (each file written under a fixed partial name and renamed)."""
    d = cache_dir(root, cfg)
    paths = {k: d / f"{k}.npy" for k in ARRAYS}
    if all(p.exists() for p in paths.values()):
        return {k: np.load(p) for k, p in paths.items()}
    arrays = generate(cfg)
    d.mkdir(parents=True, exist_ok=True)
    for k, p in paths.items():
        part = d / f"{k}.partial.npy"
        np.save(part, arrays[k])
        os.replace(part, p)
    return arrays
