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
``top_fraction`` indices equal to the JAX package's.  The decode
attention's plain version is held to JAX's ``layers.decode_attention``
(the function on the serving path) within 2e-5 in fp32, and to the
Pallas kernel in interpret mode within the JAX test's own tolerances
(2e-5 in fp32, 3e-2 in bf16): the three round in other places (the
Pallas kernel divides after the p·V product, its oracle casts p to V's
dtype).  The aggregation over an int8 table is held to JAX's
``ops.dequant_aggregate`` within the segment mean's 1e-6, with and
without the host-built CSR of the same edges.
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
from repro.exchange import InProcessTransport as JInProcessTransport
from repro.kernels.quantize import quantize_int8 as pallas_quantize
from repro.kernels.swa_attention import swa_attention_decode as pallas_swa
from repro.kernels.topk_mask import topk_mask as pallas_topk
from repro.models.gnn import _segment_mean
from repro.models.layers import decode_attention as j_decode_attention
from repro_torch.exchange import InProcessTransport
from repro_torch.core.pruning import top_fraction as ttop_fraction
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import exchange_fused as tfused
from repro_torch.kernels import gnn_aggregate as tagg
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels import swa_attention as tswa
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


# -- int8 codec ---------------------------------------------------------------

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


# -- fused exchange ops -------------------------------------------------------

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


# -- neighbour mean-aggregation -----------------------------------------------

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


def _np_transpose(n_src, src, dst, mask):
    """The transposed CSR of the kept edges, built with numpy: sources'
    row pointer, and each kept edge's destination grouped by source in
    ascending edge order."""
    ks, kd = src[mask].astype(np.int64), dst[mask]
    order = np.argsort(ks, kind="stable")
    return (np.r_[0, np.cumsum(np.bincount(ks, minlength=n_src))],
            kd[order].astype(np.int32))


@pytest.mark.parametrize("n_src,n_dst,e,pad,isolated", [
    (40, 20, 300, 30, False),      # masked edges and a padded tail
    (257, 100, 1000, 56, True),    # repeated sources, isolated sources
    (1024, 300, 20000, 0, True),
    (10, 10, 0, 0, False),         # an empty edge list
    (10, 10, 0, 8, False),         # only masked edges
])
def test_transpose_csr_glue_matches_numpy(n_src, n_dst, e, pad, isolated):
    _, src, dst, mask = _edges(n_src, n_dst, e, 4, n_src + e, pad=pad)
    if isolated:                   # sources repeat within a quarter
        src = src % max(1, n_src // 4)
    indptr, indices = tagg.csr_from_edges(
        n_src, torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(mask), n_dst)
    t_indptr, t_dst = tagg.transpose_csr(indptr, indices, n_src)
    want_ptr, want_dst = _np_transpose(n_src, src, dst, mask)
    assert t_indptr.dtype == torch.int64 and t_dst.dtype == torch.int32
    np.testing.assert_array_equal(_np(t_indptr), want_ptr)
    np.testing.assert_array_equal(_np(t_dst), want_dst)


@pytest.mark.parametrize("n_src,n_dst,e,f,pad", [
    (257, 100, 1000, 32, 56), (1024, 300, 20000, 96, 0), (40, 500, 300, 8, 0),
    (10, 10, 0, 8, 0)])
def test_transposed_plain_backward_bit_equal_to_plain(n_src, n_dst, e, f,
                                                      pad):
    """The gather over the transposed CSR adds the same terms in the same
    order as the plain scatter, so on the CPU the two are equal bit for
    bit (the card's kernel is held to this in tests/test_torch_cuda.py)."""
    _, src, dst, mask = _edges(n_src, n_dst, e, f, e + 1, pad=pad)
    src = src % max(1, n_src // 4)
    es, ed, em = (torch.from_numpy(a) for a in (src, dst, mask))
    indptr, indices = tagg.csr_from_edges(n_src, es, ed, em, n_dst)
    cnt = (indptr[1:] - indptr[:-1]).to(torch.float32)
    g = torch.from_numpy(_rows(n_dst, f, 3))
    want = ref.segment_mean_backward(g, es, ed, em, cnt, n_src)
    got = ref.segment_mean_backward_csc(
        g, *tagg.transpose_csr(indptr, indices, n_src), cnt, n_src)
    assert torch.equal(got, want)
    assert np.all(_np(got)[n_src // 4 + 1:] == 0)     # never a source


# -- topk_mask / top_fraction -------------------------------------------------

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


# -- aggregation over an int8 table -----------------------------------------

def _ell_as_edges(idx, mask):
    n_dst, k = idx.shape
    return (torch.from_numpy(idx.reshape(-1)),
            torch.from_numpy(np.repeat(np.arange(n_dst, dtype=np.int32), k)),
            torch.from_numpy(mask.reshape(-1)))


@pytest.mark.parametrize("n_src,n_dst,k,h", [
    (300, 100, 5, 32), (257, 257, 3, 129), (64, 30, 4, 128)])
def test_dequant_aggregate_matches_jax(n_src, n_dst, k, h):
    rng = np.random.default_rng(n_src + h)
    values, scales = jops._np_quantize_int8(
        rng.standard_normal((n_src, h)).astype(np.float32))
    idx = rng.integers(0, n_src, (n_dst, k)).astype(np.int32)
    mask = rng.random((n_dst, k)) < 0.7
    got = ops.dequant_aggregate(torch.from_numpy(values),
                                torch.from_numpy(scales),
                                *_ell_as_edges(idx, mask), n_dst)
    assert got.dtype == torch.float32 and got.shape == (n_dst, h)
    want = jops.dequant_aggregate(values, scales, idx, mask)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)
    two_step, _ = ops.gnn_aggregate(
        ops.dequantize_int8(torch.from_numpy(values),
                            torch.from_numpy(scales)),
        *_ell_as_edges(idx, mask), n_dst)
    assert torch.equal(got, two_step)


@pytest.mark.parametrize("n_src,n_dst,k,h", [
    (300, 100, 5, 32), (257, 257, 3, 129), (64, 30, 4, 128)])
def test_dequant_aggregate_over_a_host_csr_matches_jax(n_src, n_dst, k, h):
    """Given the host-built CSR of the same edges, the CPU ignores it for
    the arithmetic (the plain version runs over the edge lists) but still
    checks it against the table and the destination count."""
    rng = np.random.default_rng(n_src + h + 1)
    values, scales = jops._np_quantize_int8(
        rng.standard_normal((n_src, h)).astype(np.float32))
    idx = rng.integers(0, n_src, (n_dst, k)).astype(np.int32)
    mask = rng.random((n_dst, k)) < 0.7
    edges = _ell_as_edges(idx, mask)
    csr = tagg.csr_arrays(n_src, *[e.numpy() for e in edges], n_dst)
    tv, ts = torch.from_numpy(values), torch.from_numpy(scales)
    got = ops.dequant_aggregate(tv, ts, *edges, n_dst, csr)
    assert torch.equal(got, ops.dequant_aggregate(tv, ts, *edges, n_dst))
    want = jops.dequant_aggregate(values, scales, idx, mask)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)
    short = csr.src_rows - 1
    with pytest.raises(ValueError, match=f"table of {short} rows"):
        ops.dequant_aggregate(tv[:short], ts[:short], *edges, n_dst, csr)
    with pytest.raises(ValueError, match=f"{n_dst + 1} destinations"):
        ops.dequant_aggregate(tv, ts, *edges, n_dst + 1, csr)


def test_fused_exchange_takes_a_device_index_as_it_is():
    """An int32 index on the table's device (``row_index``) gives the
    same bytes as the host ids it was made from; other ids go through
    ``row_index``, which checks a gather's range."""
    table = torch.from_numpy(_rows(40, 8, 3))
    rows = np.array([3, 17, 0, 39, 22])
    idx = ops.row_index(rows, 40, table.device, check=True)
    assert idx.dtype == torch.int32
    for got, want in zip(ops.gather_quantize(table, idx),
                         ops.gather_quantize(table, rows)):
        assert torch.equal(got, want)
    v, s = ops.quantize_int8(torch.from_numpy(_rows(5, 8, 4)))
    pushed = ops.dequant_scatter_(table.clone(), idx, v, s)
    assert torch.equal(pushed, ops.dequant_scatter_(table.clone(), rows, v,
                                                    s))
    assert torch.equal(
        pushed, ops.dequant_scatter_(table.clone(),
                                     torch.from_numpy(rows), v, s))
    with pytest.raises(IndexError, match="outside a table of 40 rows"):
        ops.gather_quantize(table, torch.tensor([0, 40]))


def test_pull_then_dequant_aggregate_matches_jax():
    """The consumer chain of ``test_exchange.py``'s
    ``test_pull_dequant_aggregate_matches_host_path``: an int8 pull in
    wire form off an in-process embedding server, fed straight into the
    aggregation."""
    hidden = 32
    gids = np.arange(150)
    rng = np.random.default_rng(4)
    vals = [rng.standard_normal((150, hidden)).astype(np.float32)
            for _ in range(2)]
    idx = rng.integers(0, 150, (60, 5)).astype(np.int32)
    mask = rng.random((60, 5)) < 0.8
    jtr = JInProcessTransport(3, hidden, device_tables=True)
    ttr = InProcessTransport(3, hidden, device="cpu")
    for tr in (jtr, ttr):
        tr.register(gids)
    jtr.write(gids, vals)
    ttr.write(gids, [torch.from_numpy(v) for v in vals])
    jqv, jqs = jtr.gather_quantized(gids)[0]
    qv, qs = ttr.gather_quantized(gids)[0]
    np.testing.assert_array_equal(_np(qv), np.asarray(jqv))
    np.testing.assert_array_equal(_np(qs), np.asarray(jqs))
    got = ops.dequant_aggregate(qv, qs, *_ell_as_edges(idx, mask), 60)
    want = jops.dequant_aggregate(jqv, jqs, idx, mask)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)


# -- sliding-window decode attention ------------------------------------------

def _swa_inputs(B, T, Hkv, G, dh, seed, dtype=np.float32, *,
                wrapped=False):
    """The JAX test's inputs; ``wrapped`` gives each sequence a ring that
    has wrapped (positions rotated past the capacity)."""
    rng = np.random.default_rng(seed)
    H = Hkv * G
    q = rng.standard_normal((B, H, dh)).astype(dtype)
    k = rng.standard_normal((B, T, Hkv, dh)).astype(dtype)
    v = rng.standard_normal((B, T, Hkv, dh)).astype(dtype)
    kv_pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    length = int(rng.integers(T // 2, T))
    kv_valid = kv_pos < length
    q_pos = np.full((B,), length - 1, np.int32)
    if wrapped:
        for b in range(B):
            shift = int(rng.integers(1, T))
            kv_pos[b] = np.roll(np.arange(T), shift) + T
            q_pos[b] = T + T - 1 - shift
        kv_valid = rng.random((B, T)) < 0.9
    return q, k, v, kv_pos, kv_valid, q_pos


def _torch_swa(args, window, dtype=torch.float32):
    q, k, v, kv_pos, kv_valid, q_pos = args
    return ops.swa_attention_decode(
        torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
        torch.from_numpy(v).to(dtype), torch.from_numpy(kv_pos),
        torch.from_numpy(kv_valid), torch.from_numpy(q_pos), window=window)


SWA_SHAPES = [(2, 64, 2, 3, 16, 32), (1, 128, 1, 1, 64, 128),
              (3, 256, 4, 2, 32, 100)]


@pytest.mark.parametrize("B,T,Hkv,G,dh,window", SWA_SHAPES + [
    (2, 48, 1, 12, 128, None), (3, 40, 2, 3, 64, 7)])
@pytest.mark.parametrize("wrapped", [False, True])
def test_swa_plain_matches_decode_attention(B, T, Hkv, G, dh, window,
                                            wrapped):
    args = _swa_inputs(B, T, Hkv, G, dh, B * T, wrapped=wrapped)
    q, k, v, kv_pos, kv_valid, q_pos = args
    if window is None:
        kv_valid[0] = False            # a fully masked row: uniform average
    got = _torch_swa(args, window)
    want = j_decode_attention(
        jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
        q_position=jnp.asarray(q_pos), kv_positions=jnp.asarray(kv_pos),
        window=window, kv_valid=jnp.asarray(kv_valid))[:, 0]
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    if window is None:
        np.testing.assert_allclose(
            _np(got)[0], np.repeat(v[0].mean(axis=0), G, axis=0),
            rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,T,Hkv,G,dh,window", SWA_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_plain_matches_the_pallas_kernel(B, T, Hkv, G, dh, window,
                                             dtype):
    args = _swa_inputs(B, T, Hkv, G, dh, B * T)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    q, k, v, kv_pos, kv_valid, q_pos = args
    want = pallas_swa(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                      jnp.asarray(v, jdt), jnp.asarray(kv_pos),
                      jnp.asarray(kv_valid), jnp.asarray(q_pos),
                      window=window, interpret=True)
    got = _torch_swa(args, window, tdt)
    assert got.dtype == tdt and got.shape == (B, Hkv * G, dh)
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(got.float()), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _cluster_swa(args, window, clusters, warps=4, tile=32):
    """A plain-PyTorch model of ``csrc/swa_decode.cu``'s split, in fp32:
    T cut into ``clusters`` ranges of ceil(T / clusters) slots rounded up
    to a tile, each range's tiles dealt round-robin to ``warps`` warps,
    each warp an online-softmax state (max, sum, accumulator) per query
    head, and every state merged in (rank, warp) order."""
    q, k, v, kv_pos, kv_valid, q_pos = (torch.from_numpy(a) for a in args)
    B, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qs = q.reshape(B, Hkv, H // Hkv, dh) * float(np.float32(1 / np.sqrt(dh)))
    keep = kv_valid & (kv_pos <= q_pos[:, None])
    if window is not None:
        keep = keep & (kv_pos > q_pos[:, None] - window)
    per = -(-T // clusters)
    chunk = -(-per // tile) * tile
    states = []
    for r in range(clusters):
        lo, hi = r * chunk, min(T, (r + 1) * chunk)
        n_tiles = -(-(hi - lo) // tile) if hi > lo else 0
        for w in range(warps):
            m = torch.full(qs.shape[:3], -1e30)
            l = torch.zeros(qs.shape[:3])
            acc = torch.zeros(qs.shape)
            for j in range(w, n_tiles, warps):
                t0 = lo + j * tile
                t1 = min(hi, t0 + tile)
                sc = torch.einsum("bkgd,btkd->bkgt", qs, k[:, t0:t1])
                sc = torch.where(keep[:, None, None, t0:t1], sc, -1e30)
                m_new = torch.maximum(m, sc.amax(-1))
                pr = torch.exp(sc - m_new[..., None])
                corr = torch.exp(m - m_new)
                l = l * corr + pr.sum(-1)
                acc = acc * corr[..., None] \
                    + torch.einsum("bkgt,btkd->bkgd", pr, v[:, t0:t1])
                m = m_new
            states.append((m, l, acc))
    mx = torch.stack([st[0] for st in states]).amax(0)
    den = sum(st[1] * torch.exp(st[0] - mx) for st in states)
    num = sum(st[2] * torch.exp(st[0] - mx)[..., None] for st in states)
    return (num / den[..., None]).reshape(B, H, dh)


@pytest.mark.parametrize("clusters", [1, 8, 16])
@pytest.mark.parametrize("B,T,Hkv,G,dh,window,wrapped", [
    (2, 64, 2, 3, 16, 32, False), (1, 128, 1, 1, 64, 128, False),
    (3, 256, 4, 2, 32, 100, True), (2, 5, 2, 3, 16, None, False),
    (2, 70, 1, 12, 32, 16, True), (3, 300, 2, 3, 64, None, True)])
def test_cluster_split_matches_the_jax_references(B, T, Hkv, G, dh, window,
                                                  wrapped, clusters):
    """The kernel's split of T across a cluster, modelled on the CPU, is
    held to the Pallas kernel (interpret mode) and to ``decode_attention``
    before any card sees it: T below the cluster size (empty blocks), T
    no multiple of the tile, G = 12, and with ``window=None`` a fully
    masked row, which must average V over every block's slots."""
    args = _swa_inputs(B, T, Hkv, G, dh, B * T + dh, wrapped=wrapped)
    q, k, v, kv_pos, kv_valid, q_pos = args
    if window is None:
        kv_valid[0] = False
    got = _np(_cluster_swa(args, window, clusters))
    want = j_decode_attention(
        jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
        q_position=jnp.asarray(q_pos), kv_positions=jnp.asarray(kv_pos),
        window=window, kv_valid=jnp.asarray(kv_valid))[:, 0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    # the Pallas kernel takes an int window: 4T reaches back past every slot
    pallas = pallas_swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(kv_pos), jnp.asarray(kv_valid),
                        jnp.asarray(q_pos),
                        window=4 * T if window is None else window,
                        interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-5, atol=2e-5)
    if window is None:
        np.testing.assert_allclose(
            got[0], np.repeat(v[0].mean(axis=0), G, axis=0), rtol=2e-5,
            atol=2e-5)


def test_swa_wrapper_checks_its_inputs():
    """The wrapper's checks run before any CUDA call, so wrong inputs
    raise here too."""
    q, k, v, kv_pos, kv_valid, q_pos = (
        torch.from_numpy(a) for a in _swa_inputs(2, 16, 2, 3, 8, 0))
    with pytest.raises(ValueError, match="CUDA"):
        tswa.swa_attention_decode(q, k, v, kv_pos, kv_valid, q_pos,
                                  window=4)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tswa.swa_attention_decode(q.half(), k.half(), v.half(), kv_pos,
                                  kv_valid, q_pos, window=4)


# -- dispatch -----------------------------------------------------------------

def test_launch_passes_pointers_counts_once_and_raises(monkeypatch):
    """``_build.launch`` with a stand-in entry point and packer: tensors
    pass as their ``data_ptr`` and None as 0, the stream comes last, a
    launch counts once, and a nonzero code raises naming the kernel
    without counting."""
    calls, codes = [], [0, 2]

    def entry(packed):
        calls.append(packed)
        return codes.pop(0)

    monkeypatch.setitem(_build._entries, "stand_in",
                        (entry, lambda *fields: fields,
                         lambda code: b"stand-in error"))
    monkeypatch.setattr(_build, "current_stream", lambda: 77)
    monkeypatch.setitem(_build.LAUNCHES, "stand_in", 0)
    t = torch.arange(6, dtype=torch.float32)
    _build.launch("stand_in", "stand_in", t, 3, None, 1.5)
    assert calls == [(t.data_ptr(), 3, 0, 1.5, 77)]
    assert _build.LAUNCHES["stand_in"] == 1
    with pytest.raises(RuntimeError,
                       match=r"stand_in launch failed: CUDA error 2 "
                             r"\(stand-in error\)"):
        _build.launch("stand_in", "stand_in", t, 3, None, 1.5)
    assert _build.LAUNCHES["stand_in"] == 1
    assert len(calls) == 2


def test_packed_structs_match_the_signatures():
    """Each library's entry point takes one struct whose fields are those
    of ``SIGNATURES`` in order, so ``struct.pack`` in native alignment lays
    them out as the C compiler does."""
    import re

    c_type = {"P": "void*", "q": "int64_t", "i": "int", "f": "float"}
    for name in _build.SIGNATURES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        exports = re.findall(r"REPRO_EXPORT int (\w+)\(", src)
        assert name in exports and set(exports) <= {name, f"{name}_info"}
        arg = re.search(r"REPRO_EXPORT int " + name + r"\(const (\w+)\* "
                        r"args\)", src)
        assert arg, name
        body = re.search(r"struct " + arg.group(1) + r" \{([^}]*)\};", src)
        assert body, name
        fields = [f.strip().rsplit(" ", 1)[0].replace("const ", "")
                  for f in body.group(1).split(";") if f.strip()]
        codes = _build.packer(name).format.lstrip("@")
        assert [c_type[c] for c in codes] == fields, name


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
    ops.dequant_aggregate(q, s, torch.zeros(3, dtype=torch.int32),
                          torch.zeros(3, dtype=torch.int32),
                          torch.ones(3, dtype=torch.bool), 2)
    _torch_swa(_swa_inputs(2, 16, 2, 3, 8, 0), 4)
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
    with pytest.raises(ValueError, match="CUDA"):
        tagg.dequant_aggregate(torch.zeros((4, 8), dtype=torch.int8),
                               torch.zeros((4, 1)),
                               torch.zeros(2, dtype=torch.int32),
                               torch.zeros(2, dtype=torch.int32),
                               torch.ones(2, dtype=torch.bool), 4)
