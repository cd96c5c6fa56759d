"""Mmap-backed CSR graph store — the out-of-core twin of ``graphs.Graph``.

Port of ``repro/graphstore/store.py`` (numpy only): the same files, byte
for byte, so either package opens a store the other wrote.

A store is a directory of ``.npy`` arrays plus a ``meta.json``:

    meta.json        {num_vertices, num_edges, num_classes, name, ...}
    indptr.npy       (V+1,) int64
    indices.npy      (E,)   int32   in-neighbours, sorted per row
    features.npy     (V, F) float32
    labels.npy       (V,)   int32
    train_mask.npy   (V,)   bool
    part_k{K}_s{S}.npy            optional partition labels
    shards_k{K}_s{S}_r{R}/        optional prebuilt per-client shards

:class:`GraphStore` opens every array with ``mmap_mode="r"`` and exposes
the exact accessor protocol of :class:`repro_torch.graphs.graph.Graph`
(``num_vertices`` / ``indptr`` / ``neighbours`` / ``train_vertices`` /
...), so samplers, pruning, and the federated trainer are agnostic to
which plane a graph lives on.  Pages fault in on access: opening a
111M-vertex store costs metadata only, and a worker that touches one
client shard never reads the rest of the file.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from repro_torch.graphs.partition import ClientShard

META_NAME = "meta.json"
NODE_ARRAYS = ("features", "labels", "train_mask")
_SHARD_ARRAYS = ("indptr", "indices", "global_ids", "features", "labels",
                 "train_mask", "pull_nodes", "push_nodes", "all_pull_nodes")


class GraphStore:
    """An on-disk CSR graph with the :class:`Graph` accessor protocol."""

    is_store = True   # duck-type marker (isinstance needs no import)

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        with open(os.path.join(self.path, META_NAME)) as f:
            self.meta = json.load(f)
        self.name = self.meta.get("name", os.path.basename(self.path))
        self.num_classes = int(self.meta.get("num_classes", 0))
        self.indptr = self._load("indptr")
        self.indices = self._load("indices")
        self.features = self._load("features", optional=True)
        self.labels = self._load("labels", optional=True)
        self.train_mask = self._load("train_mask", optional=True)

    def _load(self, name: str, *, optional: bool = False):
        p = os.path.join(self.path, name + ".npy")
        if not os.path.exists(p):
            if optional:
                return None
            raise FileNotFoundError(f"graph store {self.path} missing {name}.npy")
        return np.load(p, mmap_mode="r")

    # -- Graph accessor protocol -------------------------------------------

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

    def train_vertices(self) -> np.ndarray:
        if self.train_mask is None:
            return np.arange(self.num_vertices)
        return np.nonzero(self.train_mask)[0].astype(np.int64)

    def validate(self, *, chunk_vertices: int = 1 << 18) -> None:
        assert self.indptr[0] == 0 and self.indptr[-1] == len(self.indices)
        for lo in range(0, self.num_vertices, chunk_vertices):
            hi = min(lo + chunk_vertices, self.num_vertices)
            ptr = np.asarray(self.indptr[lo: hi + 1])
            assert np.all(np.diff(ptr) >= 0)
            if ptr[-1] > ptr[0]:
                idx = np.asarray(self.indices[ptr[0]: ptr[-1]])
                assert idx.min() >= 0 and idx.max() < self.num_vertices
        if self.features is not None:
            assert self.features.shape[0] == self.num_vertices
        if self.labels is not None:
            assert self.labels.shape[0] == self.num_vertices

    # -- partitions / prebuilt shards ---------------------------------------

    def partition_path(self, k: int, seed: int) -> str:
        return os.path.join(self.path, f"part_k{k}_s{seed}.npy")

    def load_partition(self, k: int, seed: int) -> Optional[np.ndarray]:
        p = self.partition_path(k, seed)
        return np.load(p) if os.path.exists(p) else None

    def save_partition(self, part: np.ndarray, k: int, seed: int) -> str:
        p = self.partition_path(k, seed)
        np.save(p, np.asarray(part, np.int32))
        return p

    def shards_dir(self, k: int, seed: int,
                   retention_limit: Optional[int]) -> str:
        r = "inf" if retention_limit is None else str(int(retention_limit))
        return os.path.join(self.path, f"shards_k{k}_s{seed}_r{r}")

    def has_shards(self, k: int, seed: int,
                   retention_limit: Optional[int]) -> bool:
        return os.path.exists(os.path.join(
            self.shards_dir(k, seed, retention_limit), "done"))

    def save_shard(self, sh: ClientShard, k: int, seed: int,
                   retention_limit: Optional[int]) -> str:
        """Write one client shard's arrays (no completion marker — call
        :meth:`finalize_shards` once every shard landed)."""
        root = self.shards_dir(k, seed, retention_limit)
        d = os.path.join(root, f"shard{sh.client_id}")
        os.makedirs(d, exist_ok=True)
        for name in _SHARD_ARRAYS:
            np.save(os.path.join(d, name + ".npy"), getattr(sh, name))
        with open(os.path.join(d, META_NAME), "w") as f:
            json.dump({"client_id": sh.client_id,
                       "num_local": int(sh.num_local),
                       "num_classes": int(sh.num_classes)}, f)
        return root

    def finalize_shards(self, k: int, seed: int,
                        retention_limit: Optional[int],
                        count: int) -> None:
        root = self.shards_dir(k, seed, retention_limit)
        with open(os.path.join(root, "done"), "w") as f:
            f.write(f"{count}\n")

    def save_shards(self, shards: list[ClientShard], k: int, seed: int,
                    retention_limit: Optional[int]) -> str:
        for sh in shards:
            root = self.save_shard(sh, k, seed, retention_limit)
        self.finalize_shards(k, seed, retention_limit, len(shards))
        return root

    def load_shard(self, c: int, k: int, seed: int,
                   retention_limit: Optional[int],
                   *, mmap: bool = True) -> ClientShard:
        """One prebuilt client shard, arrays mmap'd from disk — a worker
        that owns client ``c`` never touches the other shards.  The
        arrays are read-only views of the files: copy one before handing
        it to ``torch.from_numpy``."""
        d = os.path.join(self.shards_dir(k, seed, retention_limit),
                         f"shard{c}")
        with open(os.path.join(d, META_NAME)) as f:
            meta = json.load(f)
        kw = {"mmap_mode": "r"} if mmap else {}
        arrs = {name: np.load(os.path.join(d, name + ".npy"), **kw)
                for name in _SHARD_ARRAYS}
        return ClientShard(client_id=int(meta["client_id"]),
                           num_local=int(meta["num_local"]),
                           num_classes=int(meta["num_classes"]), **arrs)

    def load_pull_nodes(self, k: int, seed: int,
                        retention_limit: Optional[int]) -> list[np.ndarray]:
        """Every client's pull set (tiny arrays) — the reciprocal push
        recompute needs them without loading full shards."""
        root = self.shards_dir(k, seed, retention_limit)
        return [np.load(os.path.join(root, f"shard{c}", "pull_nodes.npy"))
                for c in range(k)]


def open_store(path: str) -> GraphStore:
    return GraphStore(path)


def store_from_graph(g, path: str, *, name: Optional[str] = None) -> GraphStore:
    """Write an in-memory :class:`Graph` out as a store (small graphs /
    tests; million-vertex stores come from ``builder.build_csr_store``)."""
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "indptr.npy"), np.asarray(g.indptr, np.int64))
    np.save(os.path.join(path, "indices.npy"), np.asarray(g.indices, np.int32))
    for arr_name in NODE_ARRAYS:
        arr = getattr(g, arr_name, None)
        if arr is not None:
            np.save(os.path.join(path, arr_name + ".npy"), np.asarray(arr))
    meta = {"num_vertices": int(g.num_vertices),
            "num_edges": int(g.num_edges),
            "num_classes": int(g.num_classes),
            "name": name or g.name}
    with open(os.path.join(path, META_NAME), "w") as f:
        json.dump(meta, f)
    return GraphStore(path)
