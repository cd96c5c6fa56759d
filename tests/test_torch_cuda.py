"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need a CUDA device and ``nvcc``; elsewhere they skip.  The
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

The codec, the fused gather and the scatter-set are held bit-exact; the
segment mean within rtol = atol = 1e-6 of its plain version run on the
CPU, which adds in the kernel's order; the scatter-add with duplicate
rows and the aggregation's backward, whose atomics add in no fixed
order, within 1e-6 of each row's summed magnitudes; the top-k masks bit
for bit.  A short training round on the card is held to the same round
on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.federated import (FederatedGNNTrainer,
                                        export_for_serving, pretrain_push,
                                        setup_exchange)
from repro_torch.core.pruning import top_fraction
from repro_torch.core.strategies import default_strategies
from repro_torch.exchange import make_transport
from repro_torch.gnnserve import build_serving
from repro_torch.graphs import bfs_partition, make_client_shards, make_graph
from repro_torch.kernels import ops, ref
from repro_torch.models.gnn import init_gnn

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


@pytest.mark.parametrize("n,h", [(0, 32), (255, 32), (257, 100), (4096, 96)])
def test_codec_matches_plain(cuda, n, h):
    x = torch.from_numpy(_rows(n, h, n + h)).to(cuda)
    q, s = ops.quantize_int8(x)
    rq, rs = ref.quantize_int8(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert torch.equal(ops.dequantize_int8(q, s), ref.dequantize_int8(q, s))
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
    dup = rng.integers(0, R, n)
    dup_t = torch.from_numpy(dup).to(cuda)
    mag = ref.dequant_scatter_(b.abs(), dup_t, v.abs(), s, accumulate=True)
    ops.dequant_scatter_(a, dup, v, s, accumulate=True)
    ref.dequant_scatter_(b, dup_t, v, s, accumulate=True)
    assert bool(((a - b).abs() <= TOL * mag + TOL).all())
    torch.cuda.synchronize()


@pytest.mark.parametrize("n_src,n_dst,e,f,pad", [
    (257, 100, 1000, 32, 56), (1024, 300, 20000, 96, 0), (10, 10, 0, 8, 0)])
def test_segment_mean_matches_plain(cuda, n_src, n_dst, e, f, pad):
    rng = np.random.default_rng(e)
    src = np.r_[rng.integers(0, n_src, e), np.zeros(pad)].astype(np.int32)
    dst = np.r_[np.sort(rng.integers(0, n_dst, e)),
                np.zeros(pad)].astype(np.int32)
    mask = np.r_[rng.random(e) < 0.7, np.zeros(pad, bool)]
    feats = _rows(n_src, f, 1)
    args = [torch.from_numpy(a).to(cuda) for a in (feats, src, dst, mask)]
    ops.reset_launch_counts()
    mean, cnt = ops.gnn_aggregate(*args, n_dst)
    assert ops.launch_counts()["gnn_aggregate"] == 1
    # the plain version on a CPU copy adds in the kernel's edge order; on
    # the card its index_add_ would add with atomics in no fixed order
    rmean, rcnt = ref.segment_mean(*[a.cpu() for a in args], n_dst)
    assert torch.equal(cnt.cpu(), rcnt)
    torch.testing.assert_close(mean.cpu(), rmean, rtol=TOL, atol=TOL)
    torch.cuda.synchronize()


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
    """Masked edges, isolated rows and repeated sources; the backward
    launches only where the source needs a gradient."""
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
    assert ops.launch_counts()["segment_mean_bwd"] == (1 if e else 0)
    want = ref.segment_mean_backward(g, es, ed, em, cnt, n_src)
    mag = ref.segment_mean_backward(g.abs(), es, ed, em, cnt, n_src)
    assert bool(((x.grad - want).abs() <= TOL * mag + TOL).all())
    ops.gnn_aggregate(x.detach(), es, ed, em, n_dst)
    assert ops.launch_counts()["segment_mean_bwd"] == (1 if e else 0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n,k,ties", [(1, 1, False), (1000, 10, False),
                                      (4096, 100, False), (5000, 1250, True),
                                      (100_000, 25_000, True)])
def test_topk_mask_matches_plain(cuda, n, k, ties):
    rng = np.random.default_rng(n + k)
    s = rng.integers(0, 30, n) if ties else rng.standard_normal(n)
    s = torch.from_numpy(s.astype(np.float32))
    ops.reset_launch_counts()
    got = ops.topk_mask(s.to(cuda), k)
    assert ops.launch_counts()["count_ge"] == (25 if 0 < k < n else 0)
    assert torch.equal(got.cpu(), ref.topk_mask(s, k))
    assert torch.equal(got, ref.topk_mask(s.to(cuda), k))
    thr = s[n // 2].reshape(()).to(cuda)
    assert int(ops.count_ge(s.to(cuda), thr)) == int((s >= s[n // 2]).sum())
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
    for name in ("gnn_aggregate", "segment_mean_bwd", "count_ge",
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
