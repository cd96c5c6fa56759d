"""Chunked edge-stream → mmap CSR builder (external bucket sort by dst).

Port of ``repro/graphstore/builder.py`` (numpy only).

The in-memory path (``graphs.graph.from_edges`` with ``symmetric=True,
dedup=True``) produces a *canonical* CSR: per destination row, the
sorted unique source ids with self-loops removed.  That canonical form
is what makes an out-of-core builder possible without ever holding the
edge list: edges arrive in chunks, each chunk is scattered (plus its
reverse edges) into destination-range bucket files on disk, and each
bucket is then independently deduped + sorted and appended to the
``indices`` array.  Peak memory is one bucket (+ its sort
temporaries), not the graph: ``tests/test_torch_graphstore.py`` pins
the output bit-identical to ``from_edges`` and to the JAX package's
builder.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

from .store import META_NAME, GraphStore

# target pairs resident per bucket while deduping (~16 B/pair on disk,
# a few transient copies of that in RAM during np.unique)
DEFAULT_BUCKET_PAIRS = 2_000_000


class _BucketSpill:
    """Append-only (dst, src) int64 pair files, one per dst range."""

    def __init__(self, tmp_dir: str, num_vertices: int, num_buckets: int):
        self.width = -(-num_vertices // num_buckets)   # ceil
        self.num_buckets = num_buckets
        self.paths = [os.path.join(tmp_dir, f"bucket{b}.pairs")
                      for b in range(num_buckets)]
        self._fh = [open(p, "wb") for p in self.paths]

    def append(self, src: np.ndarray, dst: np.ndarray) -> None:
        if len(src) == 0:
            return
        b = dst // self.width
        order = np.argsort(b, kind="stable")
        b_sorted = b[order]
        bounds = np.searchsorted(b_sorted, np.arange(self.num_buckets + 1))
        pair = np.empty((len(src), 2), dtype=np.int64)
        pair[:, 0] = dst[order]
        pair[:, 1] = src[order]
        for bi in range(self.num_buckets):
            lo, hi = bounds[bi], bounds[bi + 1]
            if hi > lo:
                pair[lo:hi].tofile(self._fh[bi])

    def close(self) -> None:
        for f in self._fh:
            f.close()

    def load(self, b: int) -> np.ndarray:
        return np.fromfile(self.paths[b], dtype=np.int64).reshape(-1, 2)


def build_csr_store(
    edge_chunks: Iterable[tuple[np.ndarray, np.ndarray]],
    num_vertices: int,
    path: str,
    *,
    symmetric: bool = True,
    dedup: bool = True,
    est_pairs: int,
    bucket_pairs: int = DEFAULT_BUCKET_PAIRS,
    node_writer: Optional[Callable[[str], dict]] = None,
    num_classes: int = 0,
    name: str = "store",
    meta_extra: Optional[dict] = None,
) -> GraphStore:
    """Stream ``(src, dst)`` chunks into a canonical mmap CSR store.

    ``symmetric`` adds reverse edges, ``dedup`` removes self-loops and
    parallel edges — exactly the semantics (and exact output bytes) of
    ``from_edges(num_vertices, src, dst, symmetric=True, dedup=True)``.
    ``node_writer(path)`` is called after the CSR lands to emit the node
    arrays (features/labels/train_mask) and may return extra meta keys.
    ``est_pairs`` (directed pairs before symmetrization) is required —
    it sizes the bucket fan-out so each bucket stays near
    ``bucket_pairs`` resident; an understated estimate degrades the
    memory bound proportionally, never correctness.
    """
    if est_pairs <= 0:
        raise ValueError("est_pairs must be positive: the bucket fan-out "
                         "(and with it the memory bound) is sized from it")
    os.makedirs(path, exist_ok=True)
    total_pairs = est_pairs * (2 if symmetric else 1)
    num_buckets = max(1, -(-total_pairs // bucket_pairs))
    num_buckets = min(num_buckets, max(1, num_vertices))
    tmp_dir = tempfile.mkdtemp(prefix="csrbuild_", dir=path)
    try:
        spill = _BucketSpill(tmp_dir, num_vertices, num_buckets)
        for src, dst in edge_chunks:
            src = np.asarray(src, dtype=np.int64)
            dst = np.asarray(dst, dtype=np.int64)
            spill.append(src, dst)
            if symmetric:
                spill.append(dst, src)
        spill.close()

        indptr = np.zeros(num_vertices + 1, dtype=np.int64)
        idx_tmp = os.path.join(tmp_dir, "indices.raw")
        with open(idx_tmp, "wb") as out:
            for b in range(num_buckets):
                pairs = spill.load(b)
                os.unlink(spill.paths[b])
                if dedup:
                    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
                    # canonical order = sorted unique (dst, src): encode
                    # as one int64 key (dst, src < V so key < V², which
                    # fits int64 up to V ≈ 3e9)
                    key = pairs[:, 0] * num_vertices + pairs[:, 1]
                    key = np.unique(key)
                    dst_b = key // num_vertices
                    src_b = key % num_vertices
                else:
                    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
                    dst_b, src_b = pairs[order, 0], pairs[order, 1]
                np.add.at(indptr, dst_b + 1, 1)
                src_b.astype(np.int32).tofile(out)
        indptr = np.cumsum(indptr)
        num_edges = int(indptr[-1])

        np.save(os.path.join(path, "indptr.npy"), indptr)
        out_idx = np.lib.format.open_memmap(
            os.path.join(path, "indices.npy"), mode="w+",
            dtype=np.int32, shape=(num_edges,))
        with open(idx_tmp, "rb") as f:
            off = 0
            while True:
                blk = np.fromfile(f, dtype=np.int32, count=1 << 22)
                if len(blk) == 0:
                    break
                out_idx[off: off + len(blk)] = blk
                off += len(blk)
        out_idx.flush()
        del out_idx
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)

    meta = {"num_vertices": int(num_vertices), "num_edges": num_edges,
            "num_classes": int(num_classes), "name": name}
    if node_writer is not None:
        meta.update(node_writer(path) or {})
    meta.update(meta_extra or {})
    with open(os.path.join(path, META_NAME), "w") as f:
        json.dump(meta, f)
    return GraphStore(path)


def chunked(src: np.ndarray, dst: np.ndarray,
            chunk_edges: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Adapt a materialized edge list to the chunk-iterator interface."""
    for lo in range(0, len(src), chunk_edges):
        yield src[lo: lo + chunk_edges], dst[lo: lo + chunk_edges]
