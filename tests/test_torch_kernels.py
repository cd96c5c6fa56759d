"""The port's kernels on the CPU: plain PyTorch versions against the JAX
package's references, and the dispatch rules.  Each CUDA kernel is held
against its plain version on a GPU in ``tests/test_torch_cuda.py``.

The int8 codec, the fused gather and the scatter-set are held bit-exact
(``torch.equal`` after conversion); scatter-add is exact for unique rows;
the segment mean is held to rtol = atol = 1e-6 against the JAX model's
``_segment_mean``, whose sequential segment sum adds in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.quantize import quantize_int8 as pallas_quantize
from repro.models.gnn import _segment_mean
from repro_torch.kernels import _build, ops
from repro_torch.kernels import exchange_fused as tfused
from repro_torch.kernels import gnn_aggregate as tagg
from repro_torch.kernels import quantize as tquant

torch.set_num_threads(1)

TOL = 1e-6


def _rows(n, h, seed, *, zero_rows=True):
    x = (np.random.default_rng(seed).standard_normal((n, h)) * 3) \
        .astype(np.float32)
    if zero_rows and n:
        x[n // 2] = 0.0
        x[-1] = 0.0
    return x


def _np(t):
    return t.detach().cpu().numpy()


# -- int8 codec ----------------------------------------------------------------

@pytest.mark.parametrize("n,h", [(0, 32), (1, 16), (255, 32), (256, 96),
                                 (257, 100), (300, 16), (513, 32)])
def test_quantize_bit_exact(n, h):
    x = _rows(n, h, n + h)
    q, s = ops.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and q.shape == (n, h)
    assert s.dtype == torch.float32 and s.shape == (n, 1)
    nq, ns = jops._np_quantize_int8(x)
    jq, js = jref.quantize_int8(jnp.asarray(x))
    for wq, ws in ((nq, ns), (np.asarray(jq), np.asarray(js))):
        np.testing.assert_array_equal(_np(q), wq)
        np.testing.assert_array_equal(_np(s), ws)
    if n in (0, 257):                         # the Pallas body itself
        pq, ps = pallas_quantize(jnp.asarray(x), interpret=True)
        np.testing.assert_array_equal(_np(q), np.asarray(pq))
        np.testing.assert_array_equal(_np(s), np.asarray(ps))
    if n:
        assert np.all(_np(s)[n // 2] == 0) and np.all(_np(q)[n // 2] == 0)


@pytest.mark.parametrize("n,h", [(0, 16), (255, 32), (257, 100), (512, 96)])
def test_dequantize_bit_exact(n, h):
    nq, ns = jops._np_quantize_int8(_rows(n, h, 3 * n + h))
    got = ops.dequantize_int8(torch.from_numpy(nq), torch.from_numpy(ns))
    np.testing.assert_array_equal(_np(got), jops._np_dequantize_int8(nq, ns))
    np.testing.assert_array_equal(
        _np(got), np.asarray(jref.dequantize_int8(jnp.asarray(nq),
                                                   jnp.asarray(ns))))


# -- fused exchange ops --------------------------------------------------------

def _table_rows(R, h, n, seed):
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((R, h)) * 3).astype(np.float32)
    if R:
        table[R // 2] = 0.0
    rows = rng.choice(R, size=n, replace=False).astype(np.int64)
    return table, rows


@pytest.mark.parametrize("R,n,h", [(300, 123, 32), (257, 257, 129),
                                   (64, 0, 16), (512, 300, 128)])
def test_gather_quantize_bit_exact(R, n, h):
    table, rows = _table_rows(R, h, n, R + n + h)
    v, s = ops.gather_quantize(torch.from_numpy(table), rows)
    wv, ws = jref.gather_quantize(jnp.asarray(table), jnp.asarray(rows))
    np.testing.assert_array_equal(_np(v), np.asarray(wv))
    np.testing.assert_array_equal(_np(s), np.asarray(ws))
    nv, ns = jops._np_gather_quantize(table, rows)
    np.testing.assert_array_equal(_np(v), nv)
    np.testing.assert_array_equal(_np(s), ns)


def test_gather_quantize_rejects_out_of_range_rows():
    table = torch.zeros((8, 4))
    with pytest.raises(IndexError):
        ops.gather_quantize(table, np.array([0, 8]))


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("R,n,h", [(300, 123, 32), (257, 100, 129),
                                   (64, 0, 16), (512, 300, 128)])
def test_dequant_scatter_bit_exact(R, n, h, accumulate):
    table, rows = _table_rows(R, h, n, R + n + h + int(accumulate))
    values, scales = jops._np_quantize_int8(_rows(n, h, 7, zero_rows=False))
    values[n // 2:] = 0
    want = jref.dequant_scatter(jnp.asarray(table), jnp.asarray(rows),
                                jnp.asarray(values), jnp.asarray(scales),
                                accumulate=accumulate)
    t = torch.from_numpy(table.copy())
    out = ops.dequant_scatter_(t, rows, torch.from_numpy(values),
                               torch.from_numpy(scales),
                               accumulate=accumulate)
    assert out is t                                    # in place
    np.testing.assert_array_equal(_np(t), np.asarray(want))


def test_dequant_scatter_drops_out_of_range_and_adds_duplicates():
    table, _ = _table_rows(50, 8, 0, 1)
    rows = np.array([3, 50, -1, 3, 7, 3], np.int64)   # 50 and -1 dropped
    values, scales = jops._np_quantize_int8(_rows(6, 8, 2, zero_rows=False))
    want = table.copy()
    keep = (rows >= 0) & (rows < 50)
    np.add.at(want, rows[keep],
              jops._np_dequantize_int8(values, scales)[keep])
    t = torch.from_numpy(table.copy())
    ops.dequant_scatter_(t, rows, torch.from_numpy(values),
                         torch.from_numpy(scales), accumulate=True)
    np.testing.assert_allclose(_np(t), want, rtol=TOL, atol=TOL)
    set_rows = np.array([1, 50, 2], np.int64)
    t = torch.from_numpy(table.copy())
    ops.dequant_scatter_(t, set_rows, torch.from_numpy(values[:3]),
                         torch.from_numpy(scales[:3]))
    want = table.copy()
    want[[1, 2]] = jops._np_dequantize_int8(values, scales)[[0, 2]]
    np.testing.assert_array_equal(_np(t), want)


# -- neighbour mean-aggregation ------------------------------------------------

def _edges(n_src, n_dst, e, f, seed, *, grouped=True, pad=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, e).astype(np.int32)
    dst = rng.integers(0, n_dst, e).astype(np.int32)
    if grouped:
        dst = np.sort(dst)
    mask = rng.random(e) < 0.7
    if pad:     # the serving blocks' padded tail: dst 0, mask off
        src = np.concatenate([src, np.zeros(pad, np.int32)])
        dst = np.concatenate([dst, np.zeros(pad, np.int32)])
        mask = np.concatenate([mask, np.zeros(pad, bool)])
    feats = rng.standard_normal((n_src, f)).astype(np.float32)
    return feats, src, dst, mask


@pytest.mark.parametrize("n_src,n_dst,e,f,grouped,pad", [
    (64, 32, 200, 16, True, 0), (257, 100, 1000, 32, True, 56),
    (1024, 300, 4000, 96, False, 0), (33, 500, 100, 200, True, 0),
    (10, 10, 0, 8, True, 0),
])
def test_segment_mean_matches_jax_model(n_src, n_dst, e, f, grouped, pad):
    feats, src, dst, mask = _edges(n_src, n_dst, e, f, n_src + e,
                                   grouped=grouped, pad=pad)
    mean, cnt = ops.gnn_aggregate(torch.from_numpy(feats),
                                  torch.from_numpy(src),
                                  torch.from_numpy(dst),
                                  torch.from_numpy(mask), n_dst)
    jf = jnp.asarray(feats)
    wmean, wcnt = _segment_mean(jf[jnp.asarray(src)], jnp.asarray(dst),
                                jnp.asarray(mask), n_dst)
    np.testing.assert_allclose(_np(mean), np.asarray(wmean), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(_np(cnt), np.asarray(wcnt))
    iso = _np(cnt) == 0                          # isolated rows are exactly 0
    assert np.all(_np(mean)[iso] == 0)


@pytest.mark.parametrize("n_src,n_dst,k,f", [
    (64, 32, 5, 16), (257, 100, 5, 32), (1024, 300, 8, 96)])
def test_segment_mean_matches_ell_reference(n_src, n_dst, k, f):
    """Fanout-bounded ELL input, flattened to a grouped edge list, gives
    the JAX ELL kernel's reference mean."""
    rng = np.random.default_rng(n_src + n_dst)
    feats = rng.standard_normal((n_src, f)).astype(np.float32)
    idx = rng.integers(0, n_src, (n_dst, k)).astype(np.int32)
    mask = rng.random((n_dst, k)) < 0.7
    want = jref.gnn_aggregate(jnp.asarray(feats), jnp.asarray(idx),
                              jnp.asarray(mask))
    mean, _ = ops.gnn_aggregate(
        torch.from_numpy(feats), torch.from_numpy(idx.reshape(-1)),
        torch.from_numpy(np.repeat(np.arange(n_dst, dtype=np.int32), k)),
        torch.from_numpy(mask.reshape(-1)), n_dst)
    np.testing.assert_allclose(_np(mean), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_csr_glue_builds_rows_and_rejects_ungrouped_edges():
    feats, src, dst, mask = _edges(40, 20, 300, 4, 9, pad=30)
    indptr, indices = tagg.csr_from_edges(
        40, torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(mask), 20)
    kept = dst[mask]
    np.testing.assert_array_equal(
        _np(indptr), np.r_[0, np.cumsum(np.bincount(kept, minlength=20))])
    np.testing.assert_array_equal(_np(indices), src[mask])
    assert indptr.dtype == torch.int64 and indices.dtype == torch.int32
    shuffled = dst.copy()
    shuffled[[0, -40]] = shuffled[[-40, 0]]
    with pytest.raises(ValueError, match="grouped"):
        tagg.csr_from_edges(40, torch.from_numpy(src),
                            torch.from_numpy(shuffled),
                            torch.ones(len(dst), dtype=torch.bool), 20)
    with pytest.raises(ValueError, match="out of range"):
        tagg.csr_from_edges(10, torch.from_numpy(src), torch.from_numpy(dst),
                            torch.from_numpy(mask), 20)


# -- dispatch ------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_without_launching():
    ops.reset_launch_counts()
    x = torch.from_numpy(_rows(20, 8, 1))
    q, s = ops.quantize_int8(x)
    ops.dequantize_int8(q, s)
    ops.gather_quantize(x, np.arange(5))
    ops.dequant_scatter_(x.clone(), np.arange(20), q, s)
    ops.gnn_aggregate(x, torch.zeros(3, dtype=torch.int32),
                      torch.zeros(3, dtype=torch.int32),
                      torch.ones(3, dtype=torch.bool), 2)
    assert set(ops.launch_counts()) == set(_build.LAUNCHES)
    assert all(c == 0 for c in ops.launch_counts().values())
    with pytest.raises(ValueError, match="no kernel"):
        ops.quantize_int8(torch.zeros((2, 2), device="meta"))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise — never fall
    back to a plain version."""
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tquant.quantize_int8(x)
    with pytest.raises(ValueError, match="CUDA"):
        tquant.dequantize_int8(torch.zeros((4, 8), dtype=torch.int8),
                               torch.zeros((4, 1)))
    with pytest.raises(ValueError, match="CUDA"):
        tfused.gather_quantize(x, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        tfused.dequant_scatter_(x, torch.zeros(4, dtype=torch.int32),
                                torch.zeros((4, 8), dtype=torch.int8),
                                torch.zeros((4, 1)))
    with pytest.raises(ValueError, match="CUDA"):
        tagg.gnn_aggregate(x, torch.zeros(2, dtype=torch.int32),
                           torch.zeros(2, dtype=torch.int32),
                           torch.ones(2, dtype=torch.bool), 4)
