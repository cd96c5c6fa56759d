"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need a CUDA device and ``nvcc``; elsewhere they skip.  The
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

The codec, the fused gather and the scatter-set are held bit-exact; the
segment mean, over the CSR built on the host or the glue's, bit for bit
to its plain version run on the CPU, which adds in the kernel's order;
the scatter-add with duplicate rows bit for bit to the plain version on
the CPU (a sequential ``index_add_``); the aggregation's backward bit
for bit to its plain version on the CPU, and to itself launch after
launch; a training step's aggregations and ``full_propagate`` with no
host sync (``torch.cuda.set_sync_debug_mode("error")``); the top-k masks
bit for bit; the aggregation over an int8 table, over the host-built CSR
or the glue's, bit for bit to the codec's decode followed by the fp32
aggregation; the decode attention within
2e-5 of its plain version in fp32, and in bf16, where the two differ
only in rounding the fp32 result, within one bf16 step of each element
(2^-7 of it, plus 1e-5 near zero).  A short training
round on the card is held to the same round on the CPU, and a
full-width smollm-360m batcher serves its requests through the kernel.
The LM training step of reduced configs (fp32, TF32 off) is held to the
CPU (the loss within 1e-5, each gradient leaf within 1e-4 of its
largest |g|, one SGD step within 1e-6), remat on and off agree, and a
checkpoint of bf16 leaves and AdamW state round-trips on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.federated import (FederatedGNNTrainer,
                                        export_for_serving, pretrain_push,
                                        setup_exchange)
from repro_torch.core.pruning import top_fraction
from repro_torch.core.serving import ContinuousBatcher
from repro_torch.core.strategies import default_strategies
from repro_torch.data import synthetic_request_stream
from repro_torch.exchange import ShardedTransport, make_transport
from repro_torch.gnnserve import build_serving
from repro_torch.graphs import bfs_partition, make_client_shards, make_graph
from repro_torch.kernels import gnn_aggregate as agg_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import swa_attention as swa_mod
from repro_torch.launch.steps import shape_variant
from repro_torch.models import lm
from repro_torch.models.gnn import (blocks_to_arrays, init_gnn, loss_fn,
                                    to_device)
from repro_torch.tree import tree_leaves, tree_paths

pytestmark = pytest.mark.gpu

TOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rows(n, h, seed):
    x = (np.random.default_rng(seed).standard_normal((n, h)) * 3) \
        .astype(np.float32)
    if n:
        x[n // 2] = 0.0
    return x


@pytest.mark.parametrize("n,h,offset,odd_byte", [
    pytest.param(n, h, 0, False, id=f"{n}-{h}")
    for n, h in ((0, 32), (255, 32), (257, 100), (4096, 96))] + [
    (1, 32, 0, False), (1, 3, 0, False), (300, 3, 0, False),
    (100, 100, 0, False), (64, 32, 1, False), (64, 3, 1, False),
    (64, 100, 3, False), (64, 32, 0, True), (1, 32, 0, True),
    (257, 100, 0, True), (300, 3, 0, True)])
def test_codec_matches_plain(cuda, n, h, offset, odd_byte):
    """``offset`` > 0 decodes a view that starts ``offset`` rows into the
    block.  Where h % 4 == 0 its q stays 4-byte aligned and the output is
    new, so it takes the four-values-a-thread kernel; h = 3 takes the
    warp-per-row kernel.  ``odd_byte`` puts q at an odd byte of its
    storage, so the no-rows mode takes the warp-per-row kernel at any h."""
    x = torch.from_numpy(_rows(n, h, n + h)).to(cuda)
    q, s = ops.quantize_int8(x)
    rq, rs = ref.quantize_int8(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    q, s = q[offset:], s[offset:]
    if odd_byte:
        flat = torch.empty(q.numel() + 1, dtype=torch.int8, device=cuda)
        q = flat[1:].view(q.shape).copy_(q)
        assert q.data_ptr() % 4 != 0
    ops.reset_launch_counts()
    assert torch.equal(ops.dequantize_int8(q, s), ref.dequantize_int8(q, s))
    assert ops.launch_counts()["dequantize_int8"] == int(n > offset)
    torch.cuda.synchronize()


@pytest.mark.parametrize("h", [3, 4, 32, 100, 128])
@pytest.mark.parametrize("form", ["block", "ld", "misaligned", "gather",
                                  "gather_ld"])
def test_encode_matches_plain(cuda, h, form):
    """Rows 1 and 3 of the kernel table: the encode of a block and the
    gathered encode (row ids with repeats), on a contiguous table, on a
    column slice whose rows are h + 8 floats apart (16-byte aligned, so
    h % 4 == 0 takes the four-values-a-thread kernel), and at an odd
    float of its storage (the warp-per-row kernel)."""
    n = 300
    rng = np.random.default_rng(h)
    wide = torch.from_numpy(_rows(n, h + 8, h)).to(cuda)
    x = wide[:, 4:4 + h] if form.endswith("ld") else wide[:, :h].contiguous()
    if form == "misaligned":
        flat = torch.empty(n * h + 1, device=cuda)
        x = flat[1:].view(n, h).copy_(x)
        assert x.data_ptr() % 16 != 0
    ops.reset_launch_counts()
    if form.startswith("gather"):
        rows = rng.integers(0, n, 517)
        got = ops.gather_quantize(x, rows)
        want = ref.gather_quantize(x, torch.from_numpy(rows).to(cuda))
        assert ops.launch_counts()["gather_quantize"] == 1
    else:
        got, want = ops.quantize_int8(x), ref.quantize_int8(x)
        assert ops.launch_counts()["quantize_int8"] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()


@pytest.mark.parametrize("R,n,h", [(300, 123, 32), (257, 257, 129),
                                   (64, 0, 16)])
def test_fused_exchange_matches_plain(cuda, R, n, h):
    rng = np.random.default_rng(R + n)
    t = torch.from_numpy(_rows(R, h, R)).to(cuda)
    rows = rng.choice(R, size=n, replace=False)
    v, s = ops.gather_quantize(t, rows)
    rv, rs = ref.gather_quantize(t, torch.from_numpy(rows).to(cuda))
    assert torch.equal(v, rv) and torch.equal(s, rs)
    a, b = t.clone(), t.clone()
    ops.dequant_scatter_(a, rows, v, s)
    ref.dequant_scatter_(b, torch.from_numpy(rows).to(cuda), v, s)
    assert torch.equal(a, b)
    # set mode with ids outside [0, R) dropped: four values a thread where
    # h % 4 == 0 and the table is 16-byte aligned; a table view one float
    # into its storage takes the warp-per-row kernel, with the same bytes
    dropped = rows.copy()
    dropped[: min(n, 2)] = [-1, R][: min(n, 2)]
    want = ref.dequant_scatter_(t.clone(), torch.from_numpy(dropped)
                                .to(cuda), v, s)
    idx = ops.row_index(dropped, R, cuda, check=False)
    assert torch.equal(ops.dequant_scatter_(t.clone(), idx, v, s), want)
    flat = torch.empty(R * h + 1, device=cuda)
    view = flat[1:].view(R, h).copy_(t)
    assert view.data_ptr() % 16 != 0
    assert torch.equal(ops.dequant_scatter_(view, dropped, v, s), want)
    # duplicate rows (and ids outside the table, dropped) add in index
    # order, as the plain version's index_add_ does on the CPU
    dup = rng.integers(-1, R + 1, n)
    want = ref.dequant_scatter_(b.cpu(), torch.from_numpy(dup), v.cpu(),
                                s.cpu(), accumulate=True)
    ops.dequant_scatter_(a, dup, v, s, accumulate=True)
    assert torch.equal(a.cpu(), want)
    again = b.clone()
    ops.dequant_scatter_(again, dup, v, s, accumulate=True)
    assert torch.equal(again, a)
    torch.cuda.synchronize()


def _aggregate_both_ways(src, dst, mask, feats, n_dst, cuda):
    """The card's mean and count over the host-built CSR and over the
    glue's, each checked bit for bit against the plain version on a CPU
    copy (which adds in the kernel's edge order) and to itself over two
    launches."""
    es, ed, em = (torch.from_numpy(a).to(cuda) for a in (src, dst, mask))
    x = feats if isinstance(feats, torch.Tensor) \
        else torch.from_numpy(feats).to(cuda)
    csr = to_device(agg_mod.csr_arrays(x.shape[0], src, dst, mask, n_dst),
                    cuda)
    rmean, rcnt = ref.segment_mean(x.cpu(), es.cpu(), ed.cpu(), em.cpu(),
                                   n_dst)
    for prebuilt in (csr, None):
        ops.reset_launch_counts()
        mean, cnt = ops.gnn_aggregate(x, es, ed, em, n_dst, prebuilt)
        assert ops.launch_counts()["gnn_aggregate"] == 1
        assert torch.equal(cnt.cpu(), rcnt)
        assert torch.equal(mean.cpu(), rmean), \
            float((mean.cpu() - rmean).abs().max())
        again, _ = ops.gnn_aggregate(x, es, ed, em, n_dst, prebuilt)
        assert torch.equal(again, mean)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n_src,n_dst,e,f,pad", [
    (257, 100, 1000, 32, 56), (1024, 300, 20000, 96, 0), (10, 10, 0, 8, 0)])
def test_segment_mean_matches_plain(cuda, n_src, n_dst, e, f, pad):
    rng = np.random.default_rng(e)
    src = np.r_[rng.integers(0, n_src, e), np.zeros(pad)].astype(np.int32)
    dst = np.r_[np.sort(rng.integers(0, n_dst, e)),
                np.zeros(pad)].astype(np.int32)
    mask = np.r_[rng.random(e) < 0.7, np.zeros(pad, bool)]
    _aggregate_both_ways(src, dst, mask, _rows(n_src, f, 1), n_dst, cuda)


@pytest.mark.parametrize("f", [1, 3, 32, 96, 100, 128, 130, 300])
@pytest.mark.parametrize("misaligned", [False, True])
def test_segment_mean_chunk_edges_and_a_heavy_row(cuda, f, misaligned):
    """Rows of 0, 1, 31, 32, 33, 64 and 65 edges (the edges of a chunk of
    ids), one of 10,007 and random ones, behind a masked padded tail;
    every column tile (f > 128, or 256 with 16-byte loads); a table at an
    odd float of its storage takes the one-float-a-lane variant."""
    rng = np.random.default_rng(f)
    degs = np.r_[[0, 1, 31, 32, 33, 64, 65, 10_007],
                 rng.integers(0, 80, 200)]
    degs = degs[rng.permutation(len(degs))]
    n_src, pad = 3000, 77
    dst = np.r_[np.repeat(np.arange(len(degs)), degs), np.zeros(pad)] \
        .astype(np.int32)
    src = rng.integers(0, n_src, len(dst)).astype(np.int32)
    mask = np.r_[np.ones(len(dst) - pad, bool), np.zeros(pad, bool)]
    x = torch.from_numpy(_rows(n_src, f, f + 1)).to(cuda)
    if misaligned:
        flat = torch.empty(n_src * f + 1, device=cuda)
        x = flat[1:].view(n_src, f).copy_(x)
    _aggregate_both_ways(src, dst, mask, x, len(degs), cuda)


def test_prebuilt_csr_is_checked_against_the_table(cuda):
    src = np.array([0, 5, 9], np.int32)
    dst = np.array([0, 0, 1], np.int32)
    mask = np.ones(3, bool)
    csr = to_device(agg_mod.csr_arrays(10, src, dst, mask, 2,
                                       transposed=True), cuda)
    es, ed, em = (torch.from_numpy(a).to(cuda) for a in (src, dst, mask))
    with pytest.raises(ValueError, match="table of 8 rows"):
        ops.gnn_aggregate(torch.zeros((8, 4), device=cuda), es, ed, em, 2,
                          csr)
    with pytest.raises(ValueError, match="3 destinations"):
        ops.gnn_aggregate(torch.zeros((10, 4), device=cuda), es, ed, em, 3,
                          csr)
    with pytest.raises(ValueError, match="10 sources for a table of 12"):
        ops.gnn_aggregate(torch.zeros((12, 4), device=cuda,
                                      requires_grad=True), es, ed, em, 2, csr)


def _publish_and_serve(device):
    g = make_graph("reddit", scale=0.3, seed=2)
    part = bfs_partition(g, 2, seed=0)
    shards = make_client_shards(g, part)
    model = init_gnn("graphconv", g.feat_dim, 32, g.num_classes, 3,
                     generator=torch.Generator().manual_seed(0),
                     device=device)
    tr = make_transport(3, 32, device=device)
    setup_exchange(shards, part, tr)
    pretrain_push(model, shards, tr, "int8", device=device)
    bundle = export_for_serving(model, shards, part, tr, "int8",
                                device=device)
    plane = build_serving(bundle, cache_rows=256, depth_schedule=[1, 3],
                          device=device)
    vids = np.random.default_rng(1).integers(0, g.num_vertices, 64)
    for i, v in enumerate(vids):
        plane.submit(int(v), 1.0 if i % 2 else 0.1)
    res = {r.rid: r for r in plane.drain()}
    tables = [t.cpu() for t in tr.gather(np.arange(g.num_vertices))]
    return res, tables


def test_slice_on_the_card_matches_the_cpu(cuda):
    ops.reset_launch_counts()
    res_g, tab_g = _publish_and_serve("cuda")
    counts = ops.launch_counts()
    serving = ("quantize_int8", "dequantize_int8", "gather_quantize",
               "dequant_scatter", "gnn_aggregate")
    assert all(counts[k] > 0 for k in serving), counts
    res_c, tab_c = _publish_and_serve("cpu")
    for a, b in zip(tab_g, tab_c):
        step = b.abs().amax(dim=1, keepdim=True) / 127.0
        assert bool(((a - b).abs() <= step * (1 + 1e-6) + 1e-12).all())
    assert sorted(res_g) == sorted(res_c)
    agree = np.mean([res_g[r].pred == res_c[r].pred for r in res_c])
    assert agree >= 0.95
    torch.cuda.synchronize()


@pytest.mark.parametrize("n_src,n_dst,e,f,pad", [
    (257, 100, 1000, 32, 56), (1024, 300, 20000, 96, 0), (40, 500, 300, 8, 0),
    (10, 10, 0, 8, 0)])
def test_segment_mean_backward_matches_plain(cuda, n_src, n_dst, e, f, pad):
    """Masked edges, isolated rows and repeated sources: the gradient is
    bit-equal to the plain version on the CPU, which adds in the same
    order, and two launches give the same bytes.  The backward launches
    only where the source needs a gradient."""
    rng = np.random.default_rng(e + 1)
    src = np.r_[rng.integers(0, n_src // 4 + 1, e), np.zeros(pad)] \
        .astype(np.int32)
    dst = np.r_[np.sort(rng.integers(0, n_dst, e)),
                np.zeros(pad)].astype(np.int32)
    mask = np.r_[rng.random(e) < 0.7, np.zeros(pad, bool)]
    es, ed, em = (torch.from_numpy(a).to(cuda) for a in (src, dst, mask))
    x = torch.from_numpy(_rows(n_src, f, 2)).to(cuda).requires_grad_()
    g = torch.from_numpy(_rows(n_dst, f, 3)).to(cuda)
    ops.reset_launch_counts()
    mean, cnt = ops.gnn_aggregate(x, es, ed, em, n_dst)
    (mean * g).sum().backward()
    assert ops.launch_counts()["segment_mean_bwd"] == 1
    want = ref.segment_mean_backward(g.cpu(), es.cpu(), ed.cpu(), em.cpu(),
                                     cnt.cpu(), n_src)
    assert torch.equal(x.grad.cpu(), want)
    first = x.grad.clone()
    x.grad = None
    mean, _ = ops.gnn_aggregate(x, es, ed, em, n_dst)
    (mean * g).sum().backward()
    assert torch.equal(x.grad, first)
    ops.gnn_aggregate(x.detach(), es, ed, em, n_dst)
    assert ops.launch_counts()["segment_mean_bwd"] == 2
    torch.cuda.synchronize()


@pytest.mark.parametrize("n,k,ties", [(1, 1, False), (1000, 10, False),
                                      (4096, 100, False), (5000, 1250, True),
                                      (100_000, 25_000, True),
                                      (101_526, 25_382, False),
                                      (10_000_000, 2_500_000, True),
                                      (1000, 0, False)])
def test_topk_mask_matches_plain(cuda, n, k, ties):
    """One launch per selection; 10M scores overflow the grid's shared
    memory, so part of each block's slice is read on every pass."""
    rng = np.random.default_rng(n + k)
    s = rng.integers(0, 30, n) if ties else rng.standard_normal(n)
    s = torch.from_numpy(s.astype(np.float32))
    ops.reset_launch_counts()
    got = ops.topk_mask(s.to(cuda), k)
    assert ops.launch_counts()["topk_mask"] == (1 if 0 < k < n else 0)
    assert ops.launch_counts()["count_ge"] == 0
    assert torch.equal(got.cpu(), ref.topk_mask(s, k))
    assert torch.equal(got, ref.topk_mask(s.to(cuda), k))
    thr = s[n // 2].reshape(()).to(cuda)
    assert int(ops.count_ge(s.to(cuda), thr)) == int((s >= s[n // 2]).sum())
    if n <= 200_000:    # the host lexsort is slow at 10M
        scores = s.double().numpy()
        order = np.lexsort((np.arange(n), -scores))
        assert np.array_equal(top_fraction(scores, k / n, device="cuda"),
                              np.sort(order[: int(np.ceil(k / n * n))]))
    torch.cuda.synchronize()


def _train_one_round(device):
    g = make_graph("reddit", scale=0.3, seed=2)
    st = dataclasses.replace(default_strategies()["OPG"], codec="int8",
                             score_kind="degree")
    model = init_gnn("graphconv", g.feat_dim, 32, g.num_classes, 3,
                     generator=torch.Generator().manual_seed(0),
                     device=device)
    tr = FederatedGNNTrainer(g, 2, st, model=model, epochs_per_round=2,
                             device=device)
    stats = tr.train(1)
    return tr, stats[0]


def test_training_on_the_card_matches_the_cpu(cuda):
    ops.reset_launch_counts()
    tr_g, s_g = _train_one_round("cuda")
    counts = ops.launch_counts()
    for name in ("gnn_aggregate", "segment_mean_bwd", "topk_mask",
                 "gather_quantize", "dequant_scatter"):
        assert counts[name] > 0, counts
    tr_c, s_c = _train_one_round("cpu")
    assert s_g.pull_rpc_sizes == s_c.pull_rpc_sizes
    assert s_g.embeddings_stored == s_c.embeddings_stored
    assert (tr_g.exchange.log.bytes, tr_g.exchange.log.rpcs) == \
        (tr_c.exchange.log.bytes, tr_c.exchange.log.rpcs)
    assert abs(s_g.train_loss - s_c.train_loss) <= 1e-2 * s_c.train_loss
    assert abs(s_g.accuracy - s_c.accuracy) <= 0.02
    torch.cuda.synchronize()


def test_training_on_the_card_is_reproducible(cuda):
    """No kernel on the training path adds with atomics, so two rounds
    from the same seed give the same bytes."""
    (tr_a, s_a), (tr_b, s_b) = _train_one_round("cuda"), \
        _train_one_round("cuda")
    assert s_a.train_loss == s_b.train_loss
    assert s_a.accuracy == s_b.accuracy
    for a, b in zip(tr_a.model.leaves(), tr_b.model.leaves()):
        assert torch.equal(a, b)
    torch.cuda.synchronize()


def test_aggregations_on_the_path_never_wait_on_the_host(cuda):
    """One training step (forward and backward, every block carrying its
    host-built CSR) and ``full_propagate`` over both of a shard's edge
    sets run under ``set_sync_debug_mode("error")``: no aggregation call
    waits on the card."""
    g = make_graph("reddit", scale=0.3, seed=2)
    st = dataclasses.replace(default_strategies()["OPG"], codec="int8",
                             score_kind="degree")
    model = init_gnn("graphconv", g.feat_dim, 32, g.num_classes, 3,
                     generator=torch.Generator().manual_seed(0),
                     device="cuda")
    tr = FederatedGNNTrainer(g, 2, st, model=model, device="cuda")
    batch = blocks_to_arrays(next(tr.samplers[0].epoch()), "cuda")
    leaves = tr.model.leaves()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = loss_fn(tr.model, batch, tr.feats[0], tr._caches[0],
                       tr.labels[0])
        torch.autograd.grad(loss, leaves)
        tr.model.full_propagate(tr.shard_arrays[0], tr._caches[0])
        tr.model.full_propagate(tr.shard_arrays[0], None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = ops.launch_counts()
    assert counts["gnn_aggregate"] == 3 + 3 + 3
    assert counts["segment_mean_bwd"] == 2
    torch.cuda.synchronize()


def _dequant_aggregate_both_ways(values, scales, src, dst, mask, n_dst,
                                 cuda):
    """The int8 aggregation over the host-built CSR and over the glue's,
    each one launch, bit-equal to the codec's decode followed by the fp32
    aggregation and to itself over two launches, and within TOL of the
    plain version on a CPU copy."""
    edges = [torch.from_numpy(a).to(cuda) for a in (src, dst, mask)]
    csr = to_device(agg_mod.csr_arrays(values.shape[0], src, dst, mask,
                                       n_dst), cuda)
    want, _ = ops.gnn_aggregate(ops.dequantize_int8(values, scales), *edges,
                                n_dst, csr)
    plain = ref.dequant_aggregate(*[t.cpu() for t in (values, scales,
                                                      *edges)], n_dst)
    for prebuilt in (csr, None):
        ops.reset_launch_counts()
        got = ops.dequant_aggregate(values, scales, *edges, n_dst, prebuilt)
        assert ops.launch_counts()["dequant_aggregate"] == 1
        assert torch.equal(got, want), float((got - want).abs().max())
        assert torch.equal(
            ops.dequant_aggregate(values, scales, *edges, n_dst, prebuilt),
            got)
        assert torch.allclose(got.cpu(), plain, rtol=TOL, atol=TOL)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n_src,n_dst,e,f,pad", [
    (300, 100, 600, 32, 0), (257, 257, 3000, 129, 40), (85185, 59803,
                                                       400_000, 32, 0)])
def test_dequant_aggregate_bit_equal_to_decode_then_aggregate(
        cuda, n_src, n_dst, e, f, pad):
    rng = np.random.default_rng(n_src + f)
    x = torch.from_numpy(_rows(n_src, f, n_src)).to(cuda)
    values, scales = ops.quantize_int8(x)
    src = rng.integers(0, n_src, e + pad).astype(np.int32)
    dst = np.concatenate([np.sort(rng.integers(0, n_dst, e)),
                          np.zeros(pad, np.int64)]).astype(np.int32)
    mask = np.concatenate([rng.random(e) < 0.8, np.zeros(pad, bool)])
    _dequant_aggregate_both_ways(values, scales, src, dst, mask, n_dst, cuda)


@pytest.mark.parametrize("f", [1, 3, 32, 33, 96, 130])
@pytest.mark.parametrize("misaligned", [False, True])
def test_dequant_aggregate_chunk_edges_and_a_heavy_row(cuda, f, misaligned):
    """Rows of 0, 1, 31, 32, 33, 64 and 65 kept edges (the edges of a
    chunk of ids), one of 10,007 and random ones, behind a masked padded
    tail; every group width (1 to 32 lanes a row) and the column tiles
    past 32 lanes; an int8 table at an odd byte of its storage takes the
    one-byte-a-lane variant."""
    rng = np.random.default_rng(f + 1000)
    degs = np.r_[[0, 1, 31, 32, 33, 64, 65, 10_007],
                 rng.integers(0, 80, 200)]
    degs = degs[rng.permutation(len(degs))]
    n_src, pad = 3000, 77
    dst = np.r_[np.repeat(np.arange(len(degs)), degs), np.zeros(pad)] \
        .astype(np.int32)
    src = rng.integers(0, n_src, len(dst)).astype(np.int32)
    mask = np.r_[np.ones(len(dst) - pad, bool), np.zeros(pad, bool)]
    values, scales = ops.quantize_int8(
        torch.from_numpy(_rows(n_src, f, f + 7)).to(cuda))
    if misaligned:
        flat = torch.empty(n_src * f + 1, dtype=torch.int8, device=cuda)
        values = flat[1:].view(n_src, f).copy_(values)
    _dequant_aggregate_both_ways(values, scales, src, dst, mask, len(degs),
                                 cuda)


def test_prebuilt_csr_is_checked_against_the_int8_table(cuda):
    src = np.array([0, 5, 9], np.int32)
    dst = np.array([0, 0, 1], np.int32)
    mask = np.ones(3, bool)
    csr = to_device(agg_mod.csr_arrays(10, src, dst, mask, 2), cuda)
    es, ed, em = (torch.from_numpy(a).to(cuda) for a in (src, dst, mask))
    scales = torch.ones((8, 1), device=cuda)
    with pytest.raises(ValueError, match="table of 8 rows"):
        ops.dequant_aggregate(torch.zeros((8, 4), dtype=torch.int8,
                                          device=cuda), scales, es, ed, em,
                              2, csr)
    with pytest.raises(ValueError, match="3 destinations"):
        ops.dequant_aggregate(torch.zeros((10, 4), dtype=torch.int8,
                                          device=cuda),
                              torch.ones((10, 1), device=cuda), es, ed, em,
                              3, csr)


def _swa_inputs(B, T, Hkv, G, dh, seed, dtype, device, at_head):
    """Random q/K/V, a ring that has wrapped in every sequence, a tenth
    of its slots invalid.  The query sits at a random point of the ring
    (the slots after it are in the future) or, ``at_head``, at the
    newest position, as on the serving path."""
    rng = np.random.default_rng(seed)
    H = Hkv * G

    def t(a):
        return torch.from_numpy(a).to(device)
    q = t(rng.standard_normal((B, H, dh)).astype(np.float32)).to(dtype)
    k = t(rng.standard_normal((B, T, Hkv, dh)).astype(np.float32)).to(dtype)
    v = t(rng.standard_normal((B, T, Hkv, dh)).astype(np.float32)).to(dtype)
    shift = rng.integers(0, T, B)
    pos = np.stack([np.roll(np.arange(T), s) + T for s in shift])
    qpos = pos.max(axis=1) if at_head else 2 * T - 1 - shift
    valid = rng.random((B, T)) < 0.9
    return (q, k, v, t(pos.astype(np.int32)), t(valid),
            t(qpos.astype(np.int32)))


@pytest.mark.parametrize("B,T,Hkv,G,dh,window,at_head", [
    (2, 64, 2, 3, 16, 32, False), (1, 128, 1, 1, 64, 128, False),
    (3, 256, 4, 2, 32, 100, False), (2, 48, 1, 12, 128, None, False),
    (1, 300, 2, 8, 192, 77, False), (2, 70, 3, 5, 20, 16, False),
    (8, 8192, 5, 3, 64, 8192, True), (1, 8192, 5, 3, 64, 8192, True),
    (2, 5, 2, 3, 64, None, False), (3, 1000, 5, 3, 64, 300, False),
    (3, 1000, 5, 3, 20, None, False), (1, 200, 2, 12, 256, 150, False),
    (2, 100, 2, 16, 32, 64, False),
    # the LM zoo's decode shapes: deepseek's MLA (dh 128 + 64, G 1),
    # hymba's self-attention (G 5), the VLM's and whisper's cross-decode
    (4, 1024, 16, 1, 192, None, True), (4, 1024, 5, 5, 64, 8192, True),
    (4, 1600, 8, 4, 128, None, False), (4, 1500, 6, 1, 64, None, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_decode_matches_plain(cuda, B, T, Hkv, G, dh, window, at_head,
                                  dtype):
    q, k, v, pos, valid, qpos = _swa_inputs(B, T, Hkv, G, dh, B * T + dh,
                                            dtype, cuda, at_head)
    if window is None:
        valid[0] = False               # a fully masked row
    ops.reset_launch_counts()
    got = ops.swa_attention_decode(q, k, v, pos, valid, qpos, window=window)
    assert ops.launch_counts()["swa_attention_decode"] == 1
    want = ref.swa_attention_decode(q, k, v, pos, valid, qpos, window)
    assert got.dtype == dtype and got.shape == q.shape
    # bf16: one rounding step of each element apart at most
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (2.0 ** -7, 1e-5)
    assert torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol), \
        float((got.float() - want.float()).abs().max())
    torch.cuda.synchronize()


@pytest.mark.parametrize("cluster,warps", [(1, 1), (2, 4), (8, 2), (16, 4)])
def test_swa_decode_split_does_not_change_the_function(cuda, monkeypatch,
                                                       cluster, warps):
    """Any split of T across a cluster's blocks and their warps stays
    within the tolerances of the plain version, and a split that leaves
    most blocks empty (T = 40) adds nothing from them."""
    monkeypatch.setattr(swa_mod, "CLUSTER", cluster)
    monkeypatch.setattr(swa_mod, "MAX_CLUSTER", cluster)
    monkeypatch.setattr(swa_mod, "WARPS", warps)
    for T, window in ((40, None), (777, 500)):
        q, k, v, pos, valid, qpos = _swa_inputs(2, T, 2, 3, 64, T,
                                                torch.float32, cuda, False)
        valid[1] = False
        got = ops.swa_attention_decode(q, k, v, pos, valid, qpos,
                                       window=window)
        want = ref.swa_attention_decode(q, k, v, pos, valid, qpos, window)
        assert torch.allclose(got, want, rtol=2e-5, atol=2e-5), \
            float((got - want).abs().max())
    torch.cuda.synchronize()


@pytest.mark.parametrize("T,Hkv,G,dh", [(1600, 8, 4, 128), (1500, 6, 1, 64)])
def test_swa_decode_as_cross_attention_matches_plain(cuda, T, Hkv, G, dh):
    """The cross-decode's call: every slot valid at position 0, the query
    at 0, no window (``lm._cross_decode``)."""
    q, k, v, _, _, _ = _swa_inputs(4, T, Hkv, G, dh, T, torch.bfloat16,
                                   cuda, False)
    pos = torch.zeros((4, T), dtype=torch.int32, device=cuda)
    valid = torch.ones((4, T), dtype=torch.bool, device=cuda)
    qpos = torch.zeros((4,), dtype=torch.int32, device=cuda)
    got = ops.swa_attention_decode(q, k, v, pos, valid, qpos, window=None)
    want = ref.swa_attention_decode(q, k, v, pos, valid, qpos, None)
    assert torch.allclose(got.float(), want.float(), rtol=2.0 ** -7,
                          atol=1e-5), float((got.float() - want.float())
                                            .abs().max())
    torch.cuda.synchronize()


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_moe_ffn_on_the_card_is_deterministic(cuda, arch):
    """Two runs of the MoE FFN give the same bytes (the dispatch is an
    index copy, the combine adds a token's experts in a fixed order:
    no atomics), at full width in bf16."""
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config(arch), num_layers=1)
    p = moe.init_moe(cfg, generator=torch.Generator(device="cuda")
                     .manual_seed(0), device="cuda")
    x = torch.randn((2, 512, cfg.d_model), generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda").to(cfg.dtype)
    a, aux_a = moe.moe_ffn(p, cfg, x)
    b, aux_b = moe.moe_ffn(p, cfg, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    assert bool(torch.isfinite(a.float()).all())
    torch.cuda.synchronize()


def test_swa_decode_is_deterministic_at_the_path_shape(cuda):
    args = _swa_inputs(8, 8192, 5, 3, 64, 8, torch.bfloat16, cuda, True)
    a = ops.swa_attention_decode(*args, window=8192)
    b = ops.swa_attention_decode(*args, window=8192)
    assert torch.equal(a, b)
    torch.cuda.synchronize()


def test_full_width_batcher_on_the_card(cuda):
    cfg = shape_variant(get_config("smollm-360m"), SHAPES["long_500k"])
    params = lm.init_params(cfg, device="cuda")
    bat = ContinuousBatcher(cfg, params, lanes=4, capacity=32,
                            device="cuda")
    prompts = next(synthetic_request_stream(cfg, batch=6, prompt_len=12,
                                            seed=0))
    for p in prompts:
        bat.submit(p, max_new=8)
    ops.reset_launch_counts()
    done = bat.run_to_completion()
    assert sorted(r.rid for r in done) == list(range(6))
    assert all(len(r.generated) == 8 for r in done)
    assert ops.launch_counts()["swa_attention_decode"] == \
        bat.steps * cfg.num_layers
    torch.cuda.synchronize()


@pytest.mark.parametrize("num_shards,empty", [(1, None), (3, None), (4, 2)])
def test_sharded_fused_exchange_equals_one_server(cuda, num_shards, empty):
    """The sharded transport's fused int8 pull (each shard's gather +
    encode, recombined in id order on the card) and push apply (each
    shard's payload rows selected on the card, then decode + scatter)
    equal one in-process server's bit for bit, at 1, 3 and 4 shards (at
    4 one shard owns no id); a pull makes one gather launch a non-empty
    shard and layer, and runs with no host sync."""
    rng = np.random.default_rng(num_shards)
    pool = np.arange(6000)
    if empty is not None:
        pool = pool[pool % num_shards != empty]
    gids = rng.choice(pool, 2500, replace=False)
    one = make_transport(3, 32, device="cuda")
    many = make_transport(3, 32, kind="sharded", num_shards=num_shards,
                          device="cuda")
    assert isinstance(many, ShardedTransport)
    gen = torch.Generator(device="cuda").manual_seed(num_shards)
    vals = [torch.randn((len(gids), 32), generator=gen, device="cuda") * 3
            for _ in range(2)]
    for t in (one, many):
        t.register(gids)
        t.write(gids, vals)
    ask = rng.choice(gids, 1800)               # repeats and any order
    busy = len(many._split(ask))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = many.gather_quantized(ask)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ops.launch_counts()["gather_quantize"] == busy * 2
    for (a, b), (c, d) in zip(one.gather_quantized(ask), got):
        assert torch.equal(a, c) and torch.equal(b, d)
    push = rng.permutation(gids)[:1500]
    payloads = [ops.quantize_int8(torch.randn((len(push), 32), generator=gen,
                                              device="cuda"))
                for _ in range(2)]
    ops.reset_launch_counts()
    for t in (one, many):
        t.write_quantized(push, payloads)
    assert ops.launch_counts()["dequant_scatter"] == \
        2 + len(many._split(push)) * 2
    for a, b in zip(one.gather(gids), many.gather(gids)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(many.gather_versioned(
        gids, np.full(len(gids), -1))[0], one.gather_versioned(
        gids, np.full(len(gids), -1))[0])
    if empty is not None:
        assert many.shards[empty].num_embeddings_stored == 0


@pytest.mark.parametrize("codec", ["fp32", "fp16", "int8"])
@pytest.mark.parametrize("shards", [1, 2])
def test_tcp_on_the_card_equals_a_cpu_server(cuda, codec, shards):
    """The same register, write, gather and versioned-gather RPCs over
    loopback TCP, once with the embed servers' tables and the client on
    the card (the int8 encode and decode kernels on the client, the
    fused gather + encode and decode + scatter on the servers) and once
    on the CPU: every gather bit-equal, every payload byte-equal."""
    from repro_torch.exchange.socket_transport import TcpTransport
    from repro_torch.launch.embed_server import serve_in_thread

    rng = np.random.default_rng(5)
    gids = rng.permutation(5000)[:1537]
    vals = [rng.standard_normal((len(gids), 32)).astype(np.float32)
            for _ in range(2)]
    out = {}
    for dev in ("cuda", "cpu"):
        hs = [serve_in_thread(3, 32, device=dev) for _ in range(shards)]
        try:
            t = TcpTransport(3, 32, [h.address for h in hs], codec=codec,
                             device=dev)
            t.register(gids)
            t.write(gids, [torch.from_numpy(v).to(dev) for v in vals])
            got = [v.cpu() for v in t.gather(gids)]
            got += [v.cpu() for v in t.gather(gids[::3], [2])]
            have = np.where(np.arange(len(gids)) % 2 == 0, -1, 1)
            ver, stale, sv = t.gather_versioned(gids, have, [1])
            out[dev] = (got + [sv[0].cpu()], ver, stale,
                        [r.payload_bytes for r in t.rpc_samples])
            t.close()
        finally:
            for h in hs:
                h.stop()
    (a, va, sa, pa), (b, vb, sb, pb) = out["cuda"], out["cpu"]
    for x, y in zip(a, b):
        assert x.device.type == "cpu" and torch.equal(x, y)
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(sa, sb)
    assert pa == pb


@pytest.mark.parametrize("sname", ["E", "OPG"])
def test_store_backed_training_on_the_card_is_bit_equal(cuda, tmp_path,
                                                        sname):
    """One round off an mmap graph store with its prebuilt shards on the
    card, bit-equal to the in-memory trainer over the same partition on
    the card (OPG filters the prebuilt shards on their own)."""
    from repro_torch.fedsvc.runtime import RunConfig
    from repro_torch.graphstore import (ldg_partition, store_from_graph,
                                        stream_client_shards)

    g = make_graph("reddit", scale=0.1, seed=3)
    k, seed = 2, 0
    st = store_from_graph(g, str(tmp_path / "g"))
    part = ldg_partition(st, k, seed=seed)
    st.save_partition(part, k, seed)
    cfg = RunConfig(graph=f"store:{st.path}", num_clients=k, strategy=sname,
                    overrides={"codec": "int8", "score_kind": "degree"},
                    epochs_per_round=1, rounds=1, seed=seed)
    strat = cfg.build_strategy()
    shards = stream_client_shards(st, part, seed=seed,
                                  retention_limit=strat.retention_limit)
    for sh in shards:
        wanted = [o.pull_nodes[part[o.pull_nodes] == sh.client_id]
                  for o in shards if o.client_id != sh.client_id]
        sh.push_nodes = np.unique(np.concatenate(wanted))
    st.save_shards(shards, k, seed, strat.retention_limit)
    runs = []
    for tr in (cfg.build_trainer(),
               FederatedGNNTrainer(g, k, strat, epochs_per_round=1,
                                   seed=seed, part=part)):
        s = tr.train(1)
        runs.append(([x.accuracy for x in s], [x.train_loss for x in s],
                     tr.params_leaves()))
    (aa, al, ap), (ba, bl, bp) = runs
    assert aa == ba and al == bl
    assert all(np.array_equal(x, y) for x, y in zip(ap, bp))


def test_frontend_round_trip_on_the_card(cuda):
    """The scoring frontend over a plane on the card: PREDICT over
    loopback TCP answers each vertex as ``offline_predict``, at full
    depth for threshold 1.0, and SSTATS counts the served queries."""
    from repro_torch.gnnserve import GnnServeClient, serve_in_thread

    g = make_graph("arxiv", scale=0.1, seed=7)
    tr = FederatedGNNTrainer(g, 2, default_strategies()["E"], num_layers=3,
                             hidden=16, epochs_per_round=1, seed=0)
    tr.pretrain_round()
    tr.run_round(0, 0.0)
    plane = build_serving(tr.export_for_serving(), cache_rows=64,
                          serve_fanout=4, batch_size=16)
    vids = np.random.default_rng(3).integers(0, g.num_vertices, 80)
    with serve_in_thread(plane) as h:
        with GnnServeClient(h.address) as cli:
            preds, confs, depths = cli.predict(vids)
            stats = cli.stats()
    want = []
    for v in vids:
        eng = plane.engines[int(plane.part[v])]
        want.append(int(eng.offline_predict(
            np.array([eng.local_id(int(v))], np.int64))[0]))
    np.testing.assert_array_equal(preds, np.array(want, np.int32))
    np.testing.assert_array_equal(depths, np.full(len(vids), 3))
    assert np.all(np.isfinite(confs)) and stats["served"] == len(vids)


# -- LM training ---------------------------------------------------------------

def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return None if tree is None else tree.to(device, copy=True)


def _reduced_step_inputs(arch):
    from repro_torch.configs import get_reduced
    from repro_torch.data import synthetic_batches

    cfg = get_reduced(arch)
    S = cfg.ssm_chunk if cfg.family in ("ssm", "hybrid") else 8
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    if cfg.family == "vlm":
        params["blocks"]["gate"] += 0.5
    batch = next(synthetic_batches(cfg, batch=2, seq=S, seed=0,
                                   device="cpu"))
    batch["labels"][0, :3] = -1
    return cfg, params, batch


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b",
                                  "mamba2-1.3b", "llama-3.2-vision-11b",
                                  "whisper-tiny"])
def test_lm_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """fp32, TF32 off: the loss within 1e-5, each gradient leaf within
    1e-4 of its largest |g| on the CPU (floored at 1e-3 of the whole
    gradient's), and after one SGD step every parameter within 1e-6."""
    from repro_torch.optim import sgd

    cfg, params, batch = _reduced_step_inputs(arch)
    p_dev, b_dev = _tree_to(params, cuda), _tree_to(batch, cuda)
    loss_c, _, g_c = lm.loss_and_grads(params, cfg, batch)
    loss_d, _, g_d = lm.loss_and_grads(p_dev, cfg, b_dev)
    assert abs(float(loss_d) - float(loss_c)) <= 1e-5 * max(
        1.0, abs(float(loss_c)))
    floor = 1e-3 * max(float(g.abs().max()) for g in g_c)
    for path, a, b in zip(tree_paths(params), g_d, g_c):
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-4 * max(float(b.abs().max()), floor), path
    opt = sgd(0.1)
    step = lm.make_train_step(cfg, opt)
    new_c, _, _ = step(params, opt.init(tree_leaves(params)), batch)
    new_d, _, m = step(p_dev, opt.init(tree_leaves(p_dev)), b_dev)
    assert m["loss"].device.type == "cuda"
    for a, b in zip(tree_leaves(new_d), tree_leaves(new_c)):
        assert a.device.type == "cuda"
        assert float((a.cpu() - b).abs().max()) <= 1e-6


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-1.3b",
                                  "llama-3.2-vision-11b"])
def test_lm_remat_on_and_off_agree_on_the_card(cuda, arch):
    """Recomputing the scanned units in the backward changes no bit where
    the step is deterministic on the card (two runs without remat equal);
    else remat stays within 1e-6 of the largest |g| of each leaf."""
    cfg, params, batch = _reduced_step_inputs(arch)
    p_dev, b_dev = _tree_to(params, cuda), _tree_to(batch, cuda)
    off = dataclasses.replace(cfg, remat=False)
    on_l, _, on_g = lm.loss_and_grads(p_dev, cfg, b_dev)
    off_l, _, off_g = lm.loss_and_grads(p_dev, off, b_dev)
    off2_l, _, off2_g = lm.loss_and_grads(p_dev, off, b_dev)
    if torch.equal(off_l, off2_l) and all(
            torch.equal(a, b) for a, b in zip(off_g, off2_g)):
        assert torch.equal(on_l, off_l)
        assert all(torch.equal(a, b) for a, b in zip(on_g, off_g))
    else:
        for a, b in zip(on_g, off_g):
            assert float((a - b).abs().max()) <= 1e-6 * max(
                float(b.abs().max()), 1e-30)


def test_checkpoint_round_trip_of_bf16_leaves_on_the_card(cuda, tmp_path):
    """bf16 parameters and AdamW state saved from the card and loaded
    back onto it: every leaf bit-equal, dtypes kept."""
    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.configs import get_reduced
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_reduced("smollm-360m"),
                              param_dtype="bfloat16")
    params = lm.init_params(cfg, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    opt = adamw(1e-3)
    state = opt.init(tree_leaves(params))
    gen = torch.Generator(device=cuda).manual_seed(1)
    for t in state.mu + state.nu:
        t.normal_(generator=gen)
    tree = {"params": params, "opt": state}
    save_pytree(tmp_path / "ck", tree, step=3)
    got, manifest = load_pytree(tmp_path / "ck", tree)
    assert manifest["step"] == 3 and "params/embed" in manifest["paths"]
    for a, b in zip(tree_leaves(tree), tree_leaves(got)):
        assert b.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)
    assert any(t.dtype == torch.bfloat16 for t in tree_leaves(got))


def test_host_mesh_steps_on_the_card_equal_unsharded(cuda):
    """``build_step`` on the host mesh, (data=1, model=1) over an NCCL
    world of one (chip_smoke.py's phase 20a at the reduced smollm in
    fp32): the train step (AdamW, 2 microbatches), the prefill and 4
    decode steps equal the unsharded port on the card (parameters within
    2·lr where a near-zero gradient's sign may flip, logits within 1e-5
    of the largest); the sharded decode launches the decode attention
    once a layer a step."""
    import torch.distributed as dist

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import InputShape
    from repro_torch.data import synthetic_batches
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_step, make_optimizer

    cfg = get_reduced("smollm-360m")
    mesh = make_host_mesh("cuda")
    try:
        assert dist.get_backend() == "nccl"
        params = lm.init_params(cfg, generator=torch.Generator(
            device=cuda).manual_seed(0), device=cuda)
        B, S = 4, 64
        batch = next(synthetic_batches(cfg, batch=B, seq=S, seed=0,
                                       device=cuda))
        train = build_step(cfg, InputShape("t", "train", S, B), mesh,
                           microbatches=2)
        opt = make_optimizer(train.cfg)
        state = opt.init(tree_leaves(params))
        p1, _, m1 = train.run(params, state, batch)
        p0, _, m0 = lm.make_train_step(train.cfg, opt, microbatches=2)(
            params, state, batch)
        assert abs(float(m1["loss"].full_tensor()) - float(m0["loss"])) \
            <= 1e-5 * max(1.0, abs(float(m0["loss"])))
        for a, b in zip(tree_leaves(p1), tree_leaves(p0)):
            assert float((a.full_tensor() - b).abs().max()) <= 2 * 3e-4
        prefill = build_step(cfg, InputShape("t", "prefill", S, B), mesh)
        fwd = {"tokens": batch["tokens"]}
        l1 = prefill.run(params, fwd).full_tensor()
        l0, _ = lm.forward(params, prefill.cfg, fwd)
        assert float((l1 - l0).abs().max()) <= 1e-5 * float(
            l0.abs().max())
        decode = build_step(cfg, InputShape("t", "decode", S, B), mesh)
        c1 = lm.init_cache(decode.cfg, B, S, device=cuda)
        c0 = lm.init_cache(decode.cfg, B, S, device=cuda)
        ops.reset_launch_counts()
        got = []
        for i in range(4):
            lg, c1 = decode.run(params, batch["tokens"][:, i:i + 1], c1)
            got.append(lg.full_tensor())
        assert ops.launch_counts()["swa_attention_decode"] == \
            4 * cfg.num_layers
        for i, g in enumerate(got):
            w, c0 = lm.decode_step(params, decode.cfg,
                                   batch["tokens"][:, i:i + 1], c0)
            assert float((g - w).abs().max()) <= 1e-5 * float(
                w.abs().max())
    finally:
        dist.destroy_process_group()
