"""Streaming graph generators: chunked R-MAT and chunked DC-SBM.

Port of ``repro/graphstore/generators.py`` (numpy only).

Both emit ``(src, dst)`` edge chunks for ``builder.build_csr_store`` so
million-vertex graphs build without ever materializing the edge list.

**R-MAT** (`build_rmat_store`): the Graph500 kernel-1 recursive-matrix
sampler, vectorized per chunk — each edge walks ``scale`` quadrant
levels drawn from one sequential PCG64 stream, so the output depends
only on ``(scale, edge_factor, seed)``, not on the chunk size.  Node
data (labels / noisy label-projection features / train mask, same
family as the DC-SBM presets) streams to the store row-chunk by
row-chunk.

**DC-SBM** (`build_sbm_store`): a chunk-by-chunk *replay* of
``graphs.synthetic.make_graph``'s exact RNG stream.  numpy draws fill
sequentially (``random``/``standard_normal``/``choice(p=...)`` consume
the bit stream per element), so drawing the same quantities in chunks
yields bit-identical values; the only state this needs in RAM is the
O(V) node arrays — per-edge arrays (src / homophily mask / dst) spill
to temp files.  ``tests/test_torch_graphstore.py`` gates bit-identity
against ``make_graph`` and the JAX package's store: same
``(preset, scale, seed)`` key ⇒ same graph, whichever plane built it.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from repro_torch.graphs.synthetic import PRESETS

from .builder import build_csr_store
from .store import GraphStore

# -- R-MAT ------------------------------------------------------------------

# Graph500 quadrant probabilities
RMAT_A, RMAT_B, RMAT_C = 0.57, 0.19, 0.19
# fixed generation block: each block draws from its own (seed, block)
# child stream, so the emitted edges depend only on (scale,
# edge_factor, seed) — never on how a consumer sizes its chunks
RMAT_BLOCK = 1 << 16


def rmat_chunks(scale: int, edge_factor: int, seed: int):
    """Yield (src, dst) blocks of ``edge_factor · 2**scale`` R-MAT edges."""
    n_e = edge_factor << scale
    p_src1 = 1.0 - (RMAT_A + RMAT_B)            # P(src bit = 1)
    p_dst1_src0 = RMAT_B / (RMAT_A + RMAT_B)    # P(dst bit = 1 | src bit 0)
    p_dst1_src1 = 1.0 - RMAT_C / (1.0 - (RMAT_A + RMAT_B)) \
        if (1.0 - (RMAT_A + RMAT_B)) > 0 else 0.0
    for block, lo in enumerate(range(0, n_e, RMAT_BLOCK)):
        rng = np.random.default_rng((seed, block))
        m = min(RMAT_BLOCK, n_e - lo)
        src = np.zeros(m, dtype=np.int64)
        dst = np.zeros(m, dtype=np.int64)
        for level in range(scale):
            u = rng.random(m)
            v = rng.random(m)
            sbit = u < p_src1
            dbit = np.where(sbit, v < p_dst1_src1, v < p_dst1_src0)
            src = (src << 1) | sbit
            dst = (dst << 1) | dbit
        yield src, dst


def _write_node_arrays(path: str, rng: np.random.Generator,
                       labels: np.ndarray, n_cls: int, feat_dim: int,
                       feature_noise: float, train_frac: float,
                       row_chunk: int) -> dict:
    """Shared node-data body: noisy label-projection features written
    row-chunk by row-chunk to an open_memmap, plus the train mask with
    every class guaranteed a train vertex — drawn from the *caller's*
    generator, so the SBM path can keep replaying make_graph's stream
    while R-MAT uses its own."""
    n_v = len(labels)
    np.save(os.path.join(path, "labels.npy"), labels)
    proj = rng.standard_normal((n_cls, feat_dim)).astype(np.float32)
    feats = np.lib.format.open_memmap(
        os.path.join(path, "features.npy"), mode="w+",
        dtype=np.float32, shape=(n_v, feat_dim))
    for lo in range(0, n_v, row_chunk):
        hi = min(lo + row_chunk, n_v)
        feats[lo:hi] = proj[labels[lo:hi]] + feature_noise * \
            rng.standard_normal((hi - lo, feat_dim)).astype(np.float32)
    feats.flush()
    del feats
    mask = rng.random(n_v) < train_frac
    mask[:n_cls] = True
    np.save(os.path.join(path, "train_mask.npy"), mask)
    return {"num_classes": n_cls}


def _node_writer(n_v: int, n_cls: int, feat_dim: int, train_frac: float,
                 feature_noise: float, seed: int, chunk: int = 1 << 17):
    """Label/feature/mask writer for generated stores (R-MAT): labels are
    uniform blocks, features a noisy label projection — the same signal
    family the DC-SBM presets use, so cross-client aggregation still
    carries information at any scale."""

    def write(path: str) -> dict:
        rng = np.random.default_rng(seed + 0x5EED)
        labels = rng.integers(0, n_cls, size=n_v).astype(np.int32)
        return _write_node_arrays(path, rng, labels, n_cls, feat_dim,
                                  feature_noise, train_frac, chunk)

    return write


def build_rmat_store(path: str, scale: int, *, edge_factor: int = 8,
                     seed: int = 0, num_classes: int = 16,
                     feat_dim: int = 32, train_frac: float = 0.01,
                     feature_noise: float = 2.0) -> GraphStore:
    n_v = 1 << scale
    return build_csr_store(
        rmat_chunks(scale, edge_factor, seed),
        n_v, path,
        est_pairs=edge_factor << scale,
        node_writer=_node_writer(n_v, num_classes, feat_dim, train_frac,
                                 feature_noise, seed),
        name=f"rmat{scale}",
        meta_extra={"generator": "rmat", "scale": scale,
                    "edge_factor": edge_factor, "seed": seed})


# -- DC-SBM (bit-identical streaming replay of synthetic.make_graph) --------

def build_sbm_store(path: str, preset: str, *, seed: int = 0,
                    scale: float = 1.0,
                    feature_noise: float | None = None,
                    chunk_edges: int = 1 << 18) -> GraphStore:
    """Build ``make_graph(preset, scale=..., seed=...)`` as an mmap store
    without materializing the edge list, bit-identical to the in-memory
    generator (same RNG stream, replayed in chunks)."""
    if preset not in PRESETS:
        raise KeyError(f"unknown synthetic graph {preset!r}; "
                       f"options {list(PRESETS)}")
    n_v, avg_deg, n_cls, feat_dim, train_frac, homophily, preset_noise = \
        PRESETS[preset]
    if feature_noise is None:
        feature_noise = preset_noise
    n_v = max(4 * n_cls, int(n_v * scale))
    rng = np.random.default_rng(seed)

    labels = rng.integers(0, n_cls, size=n_v).astype(np.int32)
    theta = rng.lognormal(mean=0.0, sigma=0.9, size=n_v)
    theta /= theta.mean()

    n_e = int(n_v * avg_deg / 2)
    p = theta / theta.sum()
    chunks = [(lo, min(lo + chunk_edges, n_e))
              for lo in range(0, n_e, chunk_edges)]

    os.makedirs(path, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="sbm_", dir=path)
    try:
        # pass 1 — src endpoints, chunk-replayed from the single stream
        src_paths = []
        for i, (lo, hi) in enumerate(chunks):
            s = rng.choice(n_v, size=hi - lo, p=p)
            sp = os.path.join(tmp, f"src{i}.raw")
            s.tofile(sp)
            src_paths.append(sp)

        # pass 2 — homophily mask + per-(chunk, block) same-edge counts
        same_paths, block_counts = [], np.zeros((len(chunks), n_cls),
                                                dtype=np.int64)
        for i, (lo, hi) in enumerate(chunks):
            same = rng.random(hi - lo) < homophily
            mp = os.path.join(tmp, f"same{i}.raw")
            same.astype(np.uint8).tofile(mp)
            same_paths.append(mp)
            s = np.fromfile(src_paths[i], dtype=np.int64)
            block_counts[i] = np.bincount(labels[s[same]], minlength=n_cls)

        # pass 3 — cross-block dst: make_graph draws them in one call in
        # edge order, so chunked draws of the per-chunk cross counts land
        # on the identical stream positions
        dst_paths = []
        for i, (lo, hi) in enumerate(chunks):
            same = np.fromfile(same_paths[i], dtype=np.uint8).astype(bool)
            d = np.empty(hi - lo, dtype=np.int64)
            n_cross = int((~same).sum())
            if n_cross:
                d[~same] = rng.choice(n_v, size=n_cross, p=p)
            dp = os.path.join(tmp, f"dst{i}.raw")
            d.tofile(dp)
            dst_paths.append(dp)

        # pass 4 — same-block dst, block-major (make_graph's loop order):
        # for each present block ascending, the one big choice() call is
        # replayed as per-chunk draws in edge order within the block.
        # Draws are spilled per (block, chunk) and applied in a single
        # chunk-major pass afterwards, so every chunk file is rewritten
        # once — not once per class (O(E) I/O, not O(n_cls · E)).
        order = np.argsort(labels, kind="stable")
        block_start = np.searchsorted(labels[order], np.arange(n_cls))
        block_end = np.searchsorted(labels[order], np.arange(n_cls),
                                    side="right")
        present = np.nonzero(block_counts.sum(axis=0) > 0)[0]
        for c in present:
            members = order[block_start[c]: block_end[c]]
            pc = theta[members] / theta[members].sum()
            for i in range(len(chunks)):
                cnt = int(block_counts[i, c])
                if cnt == 0:
                    continue
                rng.choice(members, size=cnt, p=pc).tofile(
                    os.path.join(tmp, f"draw{c}_{i}.raw"))
        for i in range(len(chunks)):
            if not block_counts[i].sum():
                continue
            s = np.fromfile(src_paths[i], dtype=np.int64)
            same = np.fromfile(same_paths[i], dtype=np.uint8).astype(bool)
            d = np.fromfile(dst_paths[i], dtype=np.int64)
            lab_s = labels[s]
            for c in present:
                if block_counts[i, c]:
                    d[same & (lab_s == c)] = np.fromfile(
                        os.path.join(tmp, f"draw{c}_{i}.raw"),
                        dtype=np.int64)
            d.tofile(dst_paths[i])

        def edge_chunks():
            for i in range(len(chunks)):
                yield (np.fromfile(src_paths[i], dtype=np.int64),
                       np.fromfile(dst_paths[i], dtype=np.int64))

        def node_writer(out: str) -> dict:
            # continues the SAME generator the edge passes consumed, so
            # the replay stays aligned with make_graph's stream
            row_chunk = max(1, (chunk_edges * 8) // max(1, feat_dim))
            return _write_node_arrays(out, rng, labels, n_cls, feat_dim,
                                      feature_noise, train_frac,
                                      row_chunk)

        store = build_csr_store(
            edge_chunks(), n_v, path,
            est_pairs=n_e, node_writer=node_writer, name=preset,
            meta_extra={"generator": "sbm", "preset": preset,
                        "scale": scale, "seed": seed})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return store
