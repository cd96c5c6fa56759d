"""Immutable CSR graph store (copy of ``repro/graphs/graph.py``).

Numpy-backed compressed-sparse-row graphs used by the federated GNN
substrate.  Adjacency is stored as *in-edges*: ``indices[indptr[u]:
indptr[u+1]]`` are the in-neighbours of ``u`` — the set aggregated by a
GNN layer (Eqn. 2.1 of the paper).  Generators in this package produce
symmetric graphs, so in == out unless stated otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """A CSR graph with optional node features / labels / train mask."""

    indptr: np.ndarray            # (V+1,) int64
    indices: np.ndarray           # (E,)  int32 — in-neighbours, sorted per row
    features: Optional[np.ndarray] = None   # (V, F) float32
    labels: Optional[np.ndarray] = None     # (V,)  int32
    train_mask: Optional[np.ndarray] = None  # (V,) bool
    num_classes: int = 0
    name: str = "graph"

    @property
    def num_vertices(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def feat_dim(self) -> int:
        return 0 if self.features is None else int(self.features.shape[1])

    def in_degree(self, u: Optional[np.ndarray] = None) -> np.ndarray:
        deg = np.diff(self.indptr)
        return deg if u is None else deg[u]

    def neighbours(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u]: self.indptr[u + 1]]

    def avg_degree(self) -> float:
        return self.num_edges / max(1, self.num_vertices)

    def validate(self) -> None:
        assert self.indptr[0] == 0 and self.indptr[-1] == len(self.indices)
        assert np.all(np.diff(self.indptr) >= 0)
        if self.num_edges:
            assert self.indices.min() >= 0
            assert self.indices.max() < self.num_vertices
        if self.features is not None:
            assert self.features.shape[0] == self.num_vertices
        if self.labels is not None:
            assert self.labels.shape[0] == self.num_vertices

    def train_vertices(self) -> np.ndarray:
        if self.train_mask is None:
            return np.arange(self.num_vertices)
        return np.nonzero(self.train_mask)[0].astype(np.int64)


def from_edges(
    num_vertices: int,
    src: np.ndarray,
    dst: np.ndarray,
    *,
    symmetric: bool = True,
    dedup: bool = True,
    **node_data,
) -> Graph:
    """Build a CSR :class:`Graph` from a (src → dst) edge list.

    ``symmetric=True`` adds the reverse edges; ``dedup`` removes parallel
    edges and self-loops.
    """
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
    # CSR over in-edges: group by dst.
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.add.at(indptr, dst + 1, 1)
    indptr = np.cumsum(indptr)
    return Graph(indptr=indptr, indices=src.astype(np.int32), **node_data)


def induced_subgraph(g: Graph, nodes: np.ndarray) -> tuple[Graph, np.ndarray]:
    """Vertex-induced subgraph; returns (subgraph, global_ids) where
    ``global_ids[i]`` is the global id of local vertex ``i``."""
    nodes = np.asarray(nodes, dtype=np.int64)
    g2l = np.full(g.num_vertices, -1, dtype=np.int64)
    g2l[nodes] = np.arange(len(nodes))
    src_all, dst_all = [], []
    for li, u in enumerate(nodes):
        nbrs = g.neighbours(u)
        loc = g2l[nbrs]
        keep = loc >= 0
        src_all.append(loc[keep])
        dst_all.append(np.full(int(keep.sum()), li, dtype=np.int64))
    src = np.concatenate(src_all) if src_all else np.zeros(0, np.int64)
    dst = np.concatenate(dst_all) if dst_all else np.zeros(0, np.int64)
    sub = from_edges(
        len(nodes), src, dst, symmetric=False, dedup=False,
        features=None if g.features is None else g.features[nodes],
        labels=None if g.labels is None else g.labels[nodes],
        train_mask=None if g.train_mask is None else g.train_mask[nodes],
        num_classes=g.num_classes, name=f"{g.name}/induced",
    )
    return sub, nodes
