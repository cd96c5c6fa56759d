"""The port's kernels on the CPU: plain PyTorch versions against the JAX
package's references, and the dispatch rules.  Each CUDA kernel is held
against its plain version on a GPU in ``tests/test_torch_cuda.py``.

The int8 codec, the fused gather and the scatter-set are held bit-exact
(``torch.equal`` after conversion); scatter-add is exact for unique rows;
the segment mean is held to rtol = atol = 1e-6 against the JAX model's
``_segment_mean``, whose sequential segment sum adds in the same order,
and its gradient to rtol = atol = 1e-6 against ``jax.vjp`` of it (the
terms are bit-equal, the sums add in other orders).  The top-k masks are
bit-equal to the Pallas ``topk_mask`` in interpret mode and the
``top_fraction`` indices equal to the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.core.pruning import degree_scores as jdegree_scores
from repro.core.pruning import top_fraction as jtop_fraction
from repro.graphs import bfs_partition, make_client_shards, make_graph
from repro.kernels.quantize import quantize_int8 as pallas_quantize
from repro.kernels.topk_mask import topk_mask as pallas_topk
from repro.models.gnn import _segment_mean
from repro_torch.core.pruning import top_fraction as ttop_fraction
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import exchange_fused as tfused
from repro_torch.kernels import gnn_aggregate as tagg
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels import topk_mask as ttopk

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


def _edges_with_repeats(n_src, n_dst, e, f, seed, pad=0):
    """Grouped edges whose sources repeat (a quarter of the table) and
    leave destination rows isolated."""
    feats, src, dst, mask = _edges(n_src, n_dst, e, f, seed, pad=pad)
    return feats, src % max(1, n_src // 4), dst, mask


@pytest.mark.parametrize("n_src,n_dst,e,f,pad", [
    (64, 32, 200, 16, 0), (257, 100, 1000, 32, 56), (40, 500, 300, 8, 0),
    (10, 10, 0, 8, 0)])
def test_gnn_aggregate_gradient_matches_jax_vjp(n_src, n_dst, e, f, pad):
    feats, src, dst, mask = _edges_with_repeats(n_src, n_dst, e, f,
                                                n_src + e, pad)
    g = np.random.default_rng(e).standard_normal((n_dst, f)) \
        .astype(np.float32)
    x = torch.from_numpy(feats).requires_grad_()
    mean, cnt = ops.gnn_aggregate(x, torch.from_numpy(src),
                                  torch.from_numpy(dst),
                                  torch.from_numpy(mask), n_dst)
    assert not cnt.requires_grad
    (mean * torch.from_numpy(g)).sum().backward()

    def jmean(h):
        return _segment_mean(h[jnp.asarray(src)], jnp.asarray(dst),
                             jnp.asarray(mask), n_dst)[0]

    _, vjp = jax.vjp(jmean, jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(_np(x.grad), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert np.all(_np(x.grad)[n_src // 4 + 1:] == 0)   # never a source


@pytest.mark.parametrize("n_src,n_dst,e,f,pad", [
    (64, 32, 200, 16, 0), (257, 100, 1000, 32, 56), (40, 500, 300, 8, 0)])
def test_plain_backward_equals_autograd_through_plain_forward(n_src, n_dst,
                                                             e, f, pad):
    feats, src, dst, mask = _edges_with_repeats(n_src, n_dst, e, f, e, pad)
    args = [torch.from_numpy(a) for a in (src, dst, mask)]
    g = torch.from_numpy(_rows(n_dst, f, 4))
    x = torch.from_numpy(feats).requires_grad_()
    mean, cnt = ref.segment_mean(x, *args, n_dst)
    (mean * g).sum().backward()
    got = ref.segment_mean_backward(g, *args, cnt.detach(), n_src)
    torch.testing.assert_close(got, x.grad, rtol=TOL, atol=TOL)


# -- topk_mask / top_fraction --------------------------------------------------

@pytest.mark.parametrize("n,k,ties", [(100, 10, False), (1024, 256, False),
                                      (5000, 1250, False), (10, 10, False),
                                      (64, 0, False), (3000, 700, True),
                                      (2048, 1, True), (777, 776, True)])
def test_topk_mask_bit_equal_to_pallas(n, k, ties):
    rng = np.random.default_rng(n + k)
    s = (rng.integers(0, 12, n) if ties else rng.standard_normal(n)) \
        .astype(np.float32)
    got = ops.topk_mask(torch.from_numpy(s), k)
    want = pallas_topk(jnp.asarray(s), k, interpret=True)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert int(got.sum()) >= min(k, n)
    thr = torch.tensor(s[n // 2])
    assert int(ops.count_ge(torch.from_numpy(s), thr)) == int((s >= s[n // 2])
                                                              .sum())


def _scores(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random(n)
    if kind == "tied":
        return rng.integers(0, 5, n).astype(np.float64)
    g = make_graph("reddit", scale=0.2, seed=seed)
    sh = make_client_shards(g, bfs_partition(g, 3, seed=0))[seed % 3]
    return jdegree_scores(sh)


@pytest.mark.parametrize("kind", ["random", "tied", "degree"])
@pytest.mark.parametrize("frac", [0.1, 0.25, 0.999, 1.0])
def test_top_fraction_matches_jax(kind, frac):
    scores = _scores(kind, 1500, 2)
    want = jtop_fraction(scores, frac)
    np.testing.assert_array_equal(
        ttop_fraction(scores, frac, device="cpu"), want)
    got = ttop_fraction(scores, frac, rng=np.random.default_rng(9),
                        random_subset=True, device="cpu")
    np.testing.assert_array_equal(
        got, jtop_fraction(scores, frac, rng=np.random.default_rng(9),
                           random_subset=True))


# -- dispatch ------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_without_launching():
    ops.reset_launch_counts()
    x = torch.from_numpy(_rows(20, 8, 1))
    q, s = ops.quantize_int8(x)
    ops.dequantize_int8(q, s)
    ops.gather_quantize(x, np.arange(5))
    ops.dequant_scatter_(x.clone(), np.arange(20), q, s)
    xg = x.clone().requires_grad_()
    mean, _ = ops.gnn_aggregate(xg, torch.zeros(3, dtype=torch.int32),
                                torch.zeros(3, dtype=torch.int32),
                                torch.ones(3, dtype=torch.bool), 2)
    mean.sum().backward()
    ops.topk_mask(x[:, 0].contiguous(), 5)
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
    with pytest.raises(ValueError, match="CUDA"):
        tagg.segment_mean_csr_bwd(x, torch.zeros(5, dtype=torch.int64),
                                  torch.zeros(2, dtype=torch.int32),
                                  torch.zeros(4), 4)
    with pytest.raises(ValueError, match="CUDA"):
        ttopk.topk_mask(x[:, 0].contiguous(), 2)
    with pytest.raises(ValueError, match="CUDA"):
        ttopk.count_ge(x[:, 0].contiguous(), torch.tensor(0.0))
