"""Append-side CSR delta segments over a frozen mmap ``GraphStore``.

Port of ``repro/dyngraph/delta.py`` (numpy only): the same segments,
merged views, log files and compacted stores, byte for byte.  Its
compaction histogram is ``pt_dyngraph.compact_s`` (the JAX module owns
``dyngraph.compact_s``).

A *segment* is one batch of graph growth: a CSR fragment holding the
new in-edges (rows cover the grown vertex range, row contents are
deduped against everything already visible) plus the node arrays for
the vertices the batch introduced.  ``GraphOverlay`` stacks the base
store and any number of segments behind the ``Graph`` accessor
protocol — ``indptr``/``indices``/``features``/``labels``/
``train_mask``/``neighbours``/``in_degree`` — so the streaming
partitioner, shard extraction and samplers see one merged graph
without the base ever being rewritten.

Rows in the merged view are the concatenation of per-layer runs
(base run first, then each segment's run, oldest first); runs are
disjoint by construction because ``apply`` dedups new pairs against
the current merged view, and the merged edge *set* is kept symmetric
and self-loop-free — the same canonical form ``builder.py`` emits.
That invariant is what lets :func:`compact` feed the merged entries
back through ``build_csr_store`` as already-directed pairs and still
land bit-identical to a from-scratch rebuild of the full edge stream.

``DeltaLog`` persists segments as plain ``.npy`` files plus a JSON
manifest next to the base store, so a grown graph survives a restart
without recompacting.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from repro_torch.graphstore.builder import build_csr_store
from repro_torch.graphstore.partition_stream import iter_edge_chunks
from repro_torch.obsv.metrics import REGISTRY
from repro_torch.obsv.trace import TRACE

_COMPACT_S = REGISTRY.histogram("pt_dyngraph.compact_s")

_NODE_KEYS = ("features", "labels", "train_mask")


class Segment:
    """One growth batch: segment CSR + node arrays for new rows."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 v_lo: int, v_hi: int, nodes: dict):
        self.indptr = np.ascontiguousarray(indptr, np.int64)
        self.indices = np.ascontiguousarray(indices, np.int64)
        self.v_lo = int(v_lo)          # first vertex id this batch added
        self.v_hi = int(v_hi)          # one past the last (== its V)
        self.nodes = nodes             # features/labels/train_mask rows
        assert len(self.indptr) == self.v_hi + 1

    @property
    def num_edges(self) -> int:
        return int(len(self.indices))


class _MergedIndices:
    """Array-like view of the merged edge array.

    Maps flat edge positions (merged-CSR order) to values across the
    base and segment runs of each row.  Supports the three access
    shapes the graph plane uses: contiguous slices (streaming chunk
    reads), int64 fancy indexing (eval subgraph gather) and full
    materialization via ``__array__``.
    """

    def __init__(self, overlay: "GraphOverlay"):
        self._ov = overlay

    @property
    def shape(self):
        return (self._ov.num_edges,)

    @property
    def dtype(self):
        return np.dtype(np.int64)

    def __len__(self) -> int:
        return self._ov.num_edges

    def __array__(self, dtype=None, copy=None):
        out = self[np.arange(self._ov.num_edges, dtype=np.int64)]
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self._ov.num_edges)
            if step != 1:
                raise IndexError("merged indices support unit-step slices")
            key = np.arange(start, stop, dtype=np.int64)
        pos = np.asarray(key, dtype=np.int64)
        scalar = pos.ndim == 0
        pos = np.atleast_1d(pos)
        ov = self._ov
        rows = np.searchsorted(ov.indptr, pos, side="right") - 1
        rem = pos - ov.indptr[rows]
        out = np.empty(len(pos), dtype=np.int64)
        deg = ov._base_deg[rows]
        hit = rem < deg
        if np.any(hit):
            out[hit] = _gather_base(ov.base, rows[hit], rem[hit])
        rem = rem - deg
        for seg in ov.segments:
            # rows newer than this segment have zero degree in it
            clamped = np.minimum(rows, seg.v_hi - 1)
            deg = np.where(rows < seg.v_hi,
                           np.diff(seg.indptr)[clamped], 0)
            hit = (rem >= 0) & (rem < deg)
            if np.any(hit):
                r = rows[hit]
                out[hit] = seg.indices[seg.indptr[r] + rem[hit]]
            rem = rem - deg
        return out[0] if scalar else out


def _gather_base(base, rows: np.ndarray, rem: np.ndarray) -> np.ndarray:
    starts = np.asarray(base.indptr)[rows].astype(np.int64)
    return np.asarray(base.indices)[starts + rem].astype(np.int64)


class _StackedRows:
    """Row-stacked view over the base node array + per-segment rows."""

    def __init__(self, blocks: list, bounds: np.ndarray):
        self._blocks = blocks          # block b covers [bounds[b], bounds[b+1])
        self._bounds = bounds

    @property
    def shape(self):
        first = np.asarray(self._blocks[0])
        return (int(self._bounds[-1]),) + first.shape[1:]

    @property
    def dtype(self):
        return np.asarray(self._blocks[0]).dtype

    def __len__(self) -> int:
        return int(self._bounds[-1])

    def __array__(self, dtype=None, copy=None):
        out = np.concatenate([np.asarray(b) for b in self._blocks], axis=0)
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, key):
        n = len(self)
        if isinstance(key, slice):
            start, stop, step = key.indices(n)
            key = np.arange(start, stop, step, dtype=np.int64)
        idx = np.asarray(key)
        scalar = idx.ndim == 0
        idx = np.atleast_1d(idx).astype(np.int64)
        block = np.searchsorted(self._bounds, idx, side="right") - 1
        out = None
        for b, blk in enumerate(self._blocks):
            hit = block == b
            if not np.any(hit):
                continue
            rows = np.asarray(blk)[idx[hit] - int(self._bounds[b])]
            if out is None:
                out = np.empty((len(idx),) + rows.shape[1:],
                               dtype=rows.dtype)
            out[hit] = rows
        if out is None:
            out = np.empty((0,) + np.asarray(self._blocks[0]).shape[1:],
                           dtype=self.dtype)
        return out[0] if scalar else out


class GraphOverlay:
    """Base store + delta segments behind the ``Graph`` protocol.

    Quacks like a ``GraphStore`` (``is_store`` is set so shard
    extraction takes the streaming path); with no segments every
    accessor passes straight through to the base, which is what makes
    an empty growth schedule bit-identical to static training.
    """

    is_store = True

    def __init__(self, base, segments: list = ()):  # noqa: B006
        self.base = base
        self.segments: list[Segment] = list(segments)
        self._base_v = int(base.num_vertices)
        self._base_deg = np.zeros(0, np.int64)
        self._rebuild_indptr()

    # -- merged shape ------------------------------------------------------

    def _rebuild_indptr(self) -> None:
        v = self._base_v if not self.segments else self.segments[-1].v_hi
        base_ptr = np.asarray(self.base.indptr, dtype=np.int64)
        deg = np.zeros(v, np.int64)
        deg[:self._base_v] = np.diff(base_ptr)
        self._base_deg = deg.copy()
        for seg in self.segments:
            deg[:seg.v_hi] += np.diff(seg.indptr)
        self.indptr = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(deg)])
        self.num_vertices = v
        self.num_edges = int(self.indptr[-1])
        if self.segments:
            self.indices = _MergedIndices(self)
            self.features = _StackedRows(
                [self.base.features] + [s.nodes["features"]
                                        for s in self.segments
                                        if s.v_hi > s.v_lo],
                self._node_bounds())
            self.labels = _StackedRows(
                [self.base.labels] + [s.nodes["labels"]
                                      for s in self.segments
                                      if s.v_hi > s.v_lo],
                self._node_bounds())
            self.train_mask = _StackedRows(
                [self.base.train_mask] + [s.nodes["train_mask"]
                                          for s in self.segments
                                          if s.v_hi > s.v_lo],
                self._node_bounds())
        else:
            self.indices = self.base.indices
            self.features = self.base.features
            self.labels = self.base.labels
            self.train_mask = self.base.train_mask

    def _node_bounds(self) -> np.ndarray:
        cuts = [0, self._base_v]
        cuts += [s.v_hi for s in self.segments if s.v_hi > s.v_lo]
        return np.asarray(sorted(set(cuts)), dtype=np.int64)

    # -- Graph protocol ----------------------------------------------------

    @property
    def feat_dim(self) -> int:
        return self.base.feat_dim

    @property
    def num_classes(self) -> int:
        return self.base.num_classes

    def in_degree(self, u=None):
        deg = np.diff(self.indptr)
        return deg if u is None else deg[u]

    def neighbours(self, u: int) -> np.ndarray:
        rows, vals = self.gather_rows(np.asarray([u], np.int64))
        return vals

    def train_vertices(self) -> np.ndarray:
        return np.nonzero(np.asarray(self.train_mask))[0]

    def gather_rows(self, rows: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
        """→ (row id per value, values) for the merged rows, in merged
        order — the bulk primitive behind dedup and ``neighbours``."""
        rows = np.asarray(rows, np.int64)
        counts = np.diff(self.indptr)[rows]
        starts = self.indptr[rows]
        pos = np.repeat(starts, counts) + _ranges(counts)
        rids = np.repeat(rows, counts)
        if self.segments:
            vals = self.indices[pos]
        else:
            vals = np.asarray(self.base.indices)[pos].astype(np.int64)
        return rids, vals

    # -- growth ------------------------------------------------------------

    def apply(self, src: np.ndarray, dst: np.ndarray,
              nodes: dict | None = None) -> Segment:
        """Apply one growth batch: ``nodes`` carries the arrays for the
        newly added vertex rows (may be empty), ``src``/``dst`` the new
        undirected edges (symmetrized, self-loops dropped, deduped
        against the current merged view)."""
        nodes = nodes or {k: _empty_like(self, k) for k in _NODE_KEYS}
        n_new = len(nodes["labels"])
        v_lo, v_hi = self.num_vertices, self.num_vertices + n_new
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        s2 = np.concatenate([src, dst])
        d2 = np.concatenate([dst, src])
        keep = s2 != d2
        s2, d2 = s2[keep], d2[keep]
        if len(s2) and (s2.max() >= v_hi or d2.max() >= v_hi):
            raise ValueError("edge endpoint beyond grown vertex range")
        key = np.unique(d2 * np.int64(v_hi) + s2)
        d2, s2 = key // v_hi, key % v_hi
        # dedup against rows that already exist in the merged view
        old = d2 < self.num_vertices
        if np.any(old):
            touched = np.unique(d2[old])
            rids, vals = self.gather_rows(touched)
            have = rids * np.int64(v_hi) + vals
            dup = np.isin(d2 * np.int64(v_hi) + s2, have)
            s2, d2 = s2[~dup], d2[~dup]
        indptr = np.zeros(v_hi + 1, np.int64)
        np.add.at(indptr, d2 + 1, 1)
        seg = Segment(np.cumsum(indptr), s2, v_lo, v_hi, nodes)
        self.segments.append(seg)
        self._rebuild_indptr()
        return seg


def _ranges(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    out = np.ones(total, np.int64)
    out[0] = 0
    # zero-count rows give duplicate (or trailing out-of-range)
    # boundary positions: accumulate, and drop the past-the-end ones
    ends = np.cumsum(counts)[:-1]
    keep = ends < total
    np.subtract.at(out, ends[keep], counts[:-1][keep])
    return np.cumsum(out)


def _empty_like(ov: GraphOverlay, key: str) -> np.ndarray:
    ref = np.asarray(getattr(ov.base, key)[:1])
    return np.zeros((0,) + ref.shape[1:], dtype=ref.dtype)


# -- persistence --------------------------------------------------------------

MANIFEST_NAME = "delta_manifest.json"


class DeltaLog:
    """Segment files + manifest living next to (or apart from) a base
    store — the durable form of an overlay for single-process runs and
    compaction tooling.  Multi-process workers regenerate segments from
    the seeded schedule instead of sharing files."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _manifest(self) -> list[dict]:
        p = os.path.join(self.path, MANIFEST_NAME)
        if not os.path.exists(p):
            return []
        with open(p) as f:
            return json.load(f)["segments"]

    def append(self, seg: Segment) -> None:
        rows = self._manifest()
        i = len(rows)
        np.save(os.path.join(self.path, f"seg{i}_indptr.npy"), seg.indptr)
        np.save(os.path.join(self.path, f"seg{i}_indices.npy"), seg.indices)
        for k in _NODE_KEYS:
            np.save(os.path.join(self.path, f"seg{i}_{k}.npy"),
                    np.asarray(seg.nodes[k]))
        rows.append({"v_lo": seg.v_lo, "v_hi": seg.v_hi,
                     "num_edges": seg.num_edges})
        tmp = os.path.join(self.path, MANIFEST_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump({"segments": rows}, f)
        os.replace(tmp, os.path.join(self.path, MANIFEST_NAME))

    def load(self, base) -> GraphOverlay:
        ov = GraphOverlay(base)
        for i, row in enumerate(self._manifest()):
            nodes = {k: np.load(os.path.join(self.path, f"seg{i}_{k}.npy"))
                     for k in _NODE_KEYS}
            ov.segments.append(Segment(
                np.load(os.path.join(self.path, f"seg{i}_indptr.npy")),
                np.load(os.path.join(self.path, f"seg{i}_indices.npy")),
                row["v_lo"], row["v_hi"], nodes))
        ov._rebuild_indptr()
        return ov


# -- compaction ---------------------------------------------------------------

def compact(overlay: GraphOverlay, out_path: str, *,
            name: str = "store", chunk_edges: int = 1 << 21,
            row_chunk: int = 1 << 14):
    """Fold base + segments into a fresh store at ``out_path``.

    The merged view is already the canonical symmetric, self-loop-free,
    deduped edge set, so its entries stream through ``build_csr_store``
    as directed pairs (``symmetric=False``) — per-bucket sort/unique
    then canonicalizes to exactly the CSR a from-scratch symmetric
    rebuild of the raw edge stream produces, bit for bit, at half the
    spill I/O.
    """
    t0 = time.perf_counter()
    with TRACE.span("dyngraph.compact",
                    args={"segments": len(overlay.segments)}):
        def merged_chunks():
            for lo, hi in iter_edge_chunks(overlay, chunk_edges):
                ptr = overlay.indptr[lo: hi + 1]
                e_src = np.asarray(overlay.indices[ptr[0]: ptr[-1]])
                e_dst = np.repeat(np.arange(lo, hi, dtype=np.int64),
                                  np.diff(ptr))
                yield e_src, e_dst

        def node_writer(path: str) -> dict:
            from numpy.lib.format import open_memmap
            v = overlay.num_vertices
            np.save(os.path.join(path, "labels.npy"),
                    np.asarray(overlay.labels))
            np.save(os.path.join(path, "train_mask.npy"),
                    np.asarray(overlay.train_mask))
            feats = open_memmap(
                os.path.join(path, "features.npy"), mode="w+",
                dtype=np.asarray(overlay.features[:1]).dtype,
                shape=(v, overlay.feat_dim))
            for lo in range(0, v, row_chunk):
                hi = min(lo + row_chunk, v)
                feats[lo:hi] = overlay.features[lo:hi]
            feats.flush()
            del feats
            return {"num_classes": int(overlay.num_classes)}

        store = build_csr_store(
            merged_chunks(), overlay.num_vertices, out_path,
            symmetric=False, dedup=True,
            est_pairs=max(1, overlay.num_edges),
            node_writer=node_writer, name=name,
            meta_extra={"compacted_segments": len(overlay.segments)})
    _COMPACT_S.observe(time.perf_counter() - t0)
    return store
