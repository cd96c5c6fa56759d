"""The port's GNN module against the JAX model, parameters carried over
with ``from_jax_leaves``: logits of ``forward`` on a JAX-sampled
mini-batch and every output of ``full_propagate``, within rtol = atol =
1e-5 (the two frameworks' float32 matrix products sum in different
orders).  Then the CSRs that the block and shard builders make once on
the host, byte-equal to what the card's torch glue builds from the same
edge lists (``csr_from_edges``, ``transpose_csr``), and their one copy
to the device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import bfs_partition, make_client_shards, make_graph
from repro.graphs.sampler import NeighborSampler
from repro.models import gnn as jgnn
from repro_torch import graphs as tgraphs
from repro_torch.core.federated import eval_arrays_for
from repro_torch.gnnserve.engine import ShardServeEngine
from repro_torch.graphs import sampler as tsampler
from repro_torch.kernels import gnn_aggregate as tagg
from repro_torch.models import gnn as tgnn

torch.set_num_threads(1)

TOL = 1e-5
L, HIDDEN = 3, 16


@pytest.fixture(scope="module")
def shard():
    g = make_graph("arxiv", scale=0.1, seed=7)
    part = bfs_partition(g, 2, seed=0)
    return make_client_shards(g, part)[0], g


def _params(conv, g, seed):
    params = jgnn.init_gnn(jax.random.PRNGKey(seed), conv, g.feat_dim,
                           HIDDEN, g.num_classes, L)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    return params, tgnn.from_jax_leaves(leaves, conv, device="cpu")


def _caches(sh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((max(1, sh.num_remote), HIDDEN))
            .astype(np.float32) for _ in range(L - 1)]


@pytest.mark.parametrize("conv", ["graphconv", "sageconv"])
def test_forward_logits_match(shard, conv):
    sh, g = shard
    params, model = _params(conv, g, 1)
    sampler = NeighborSampler(sh, 5, L, 32, seed=3)
    mb = sampler.sample_batch(sh.train_vertices()[:32])
    caches = _caches(sh, 2)
    want = jgnn.forward(params, jgnn.blocks_to_arrays(mb),
                        jnp.asarray(sh.features), [jnp.asarray(c)
                                                   for c in caches],
                        conv=conv)
    got = model(tgnn.blocks_to_arrays(mb, "cpu"),
                torch.from_numpy(sh.features),
                [torch.from_numpy(c) for c in caches])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    pred = model.predict(tgnn.blocks_to_arrays(mb, "cpu"),
                         torch.from_numpy(sh.features),
                         [torch.from_numpy(c) for c in caches])
    np.testing.assert_array_equal(pred.numpy(), np.argmax(want, axis=-1))


@pytest.mark.parametrize("conv", ["graphconv", "sageconv"])
@pytest.mark.parametrize("with_caches", [False, True])
def test_full_propagate_matches(shard, conv, with_caches):
    sh, g = shard
    params, model = _params(conv, g, 4)
    caches = _caches(sh, 5) if with_caches else None
    want = jgnn.full_propagate(
        params, jgnn.shard_to_arrays(sh),
        None if caches is None else [jnp.asarray(c) for c in caches],
        conv=conv)
    got = model.full_propagate(
        tgnn.shard_to_arrays(sh, "cpu"),
        None if caches is None else [torch.from_numpy(c) for c in caches])
    assert len(got) == len(want) == L
    for l, (a, b) in enumerate(zip(got, want), start=1):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL, err_msg=f"h^{l}")


def test_init_is_seeded():
    a = tgnn.init_gnn("sageconv", 12, 8, 5, 3,
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
    b = tgnn.init_gnn("sageconv", 12, 8, 5, 3,
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert [tuple(l.w_self.shape) for l in a.layers] == \
        [(12, 8), (8, 8), (8, 5)]
    assert all(torch.all(l.b == 0) for l in a.layers)
    w = a.layers[0].w_neigh.detach()
    assert abs(float(w.std()) - (2.0 / 12) ** 0.5) < 0.15
    with pytest.raises(ValueError):
        tgnn.init_gnn("gat", 4, 4, 4, 2, generator=torch.Generator())


# -- the CSR built once on the host ------------------------------------------

def _glue_csr(n_src, es, ed, em, n_dst, *, transposed):
    """The CSR (and transposed CSR) that the card's torch glue builds from
    the same padded edge list, here on the CPU."""
    es, ed, em = (torch.as_tensor(np.asarray(a)) for a in (es, ed, em))
    indptr, indices = tagg.csr_from_edges(n_src, es, ed, em, n_dst)
    out = [indptr, indices]
    if transposed:
        out += list(tagg.transpose_csr(indptr, indices, n_src))
    return out


def _assert_same_bytes(got, want):
    got, want = torch.as_tensor(np.asarray(got)), torch.as_tensor(want)
    assert got.dtype == want.dtype
    assert got.numpy().tobytes() == want.numpy().tobytes()


def _assert_host_csr(edges, n_src, n_dst, *, transposed=False):
    """``edges`` (a block's or an edge set's dict, on the CPU) carries the
    CSR of its kept edges byte-equal to the glue's, rows ordered by
    falling degree, and its source bound."""
    csr = edges["csr"]
    want = _glue_csr(n_src, edges["edge_src"], edges["edge_dst"],
                     edges["edge_mask"], n_dst, transposed=transposed)
    got = [csr.indptr, csr.indices]
    if transposed:
        got += [csr.t_indptr, csr.t_dst]
    else:
        assert csr.t_indptr is None and csr.t_dst is None
    for a, b in zip(got, want):
        _assert_same_bytes(a, b)
    deg = np.diff(np.asarray(csr.indptr))
    order = np.asarray(csr.order)
    assert order.dtype == np.int32
    assert sorted(order.tolist()) == list(range(n_dst))
    assert np.all(np.diff(deg[order]) <= 0)
    kept = np.asarray(csr.indices)
    assert csr.src_rows == (int(kept.max()) + 1 if len(kept) else 0)


@pytest.fixture(scope="module")
def port_shards():
    g = tgraphs.make_graph("arxiv", scale=0.1, seed=7)
    part = tgraphs.bfs_partition(g, 2, seed=0)
    return tgraphs.make_client_shards(g, part), g


def test_shard_arrays_carry_both_csrs(port_shards):
    """``full_propagate``'s two edge sets: remote sources masked (pointed
    at the zero row past the local ones) and every edge."""
    shards, _ = port_shards
    for sh in shards:
        arr = tgnn.shard_to_arrays(sh, "cpu")
        n = sh.num_local
        remote = arr["src_is_remote"].numpy()
        assert remote.any() and not remote.all()
        _assert_host_csr(arr["local"], n + 1, n)
        _assert_host_csr(arr["every"], n + sh.num_remote, n)
        np.testing.assert_array_equal(arr["local"]["edge_mask"].numpy(),
                                      ~remote)
        _assert_same_bytes(arr["every"]["csr"].indptr,
                           torch.from_numpy(np.asarray(sh.indptr, np.int64)))


def test_eval_arrays_carry_the_csr(port_shards):
    _, g = port_shards
    sel = np.sort(np.random.default_rng(3).choice(g.num_vertices, 400,
                                                  replace=False))
    arr = eval_arrays_for(g, sel, "cpu")
    assert arr["local"] is arr["every"]
    _assert_host_csr(arr["every"], len(sel), len(sel))
    assert len(arr["every"]["csr"].indices) > 0


def test_sampled_blocks_carry_csrs_and_transposed_csrs(port_shards):
    """Every block of a minibatch carries its CSR; every block past the
    first (whose source, the feature table, needs no gradient) also its
    transposed CSR over the block's padded source rows."""
    shards, _ = port_shards
    sh = shards[0]
    sampler = tsampler.NeighborSampler(sh, 5, L, 32, seed=3)
    mb = sampler.sample_batch(sh.train_vertices()[:32])
    arr = tgnn.blocks_to_arrays(mb, "cpu")
    for j, (b, blk) in enumerate(zip(mb.blocks, arr["blocks"])):
        assert not b.edge_mask.all()          # a padded tail
        _assert_host_csr(blk, b.p_src, b.p_dst, transposed=j > 0)


def test_serving_blocks_carry_csrs(port_shards):
    """The serving plan's blocks, whose padded tail carries dst = 0 with
    the mask off, at every depth."""
    shards, g = port_shards
    sh = shards[1]
    model = tgnn.init_gnn("graphconv", g.feat_dim, HIDDEN, g.num_classes, L,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    eng = ShardServeEngine(model, sh, cache=None, serve_fanout=4,
                           batch_size=16, device="cpu")
    seeds = np.arange(0, sh.num_local, max(1, sh.num_local // 16))[:16]
    for depth in range(1, L + 1):
        plan = eng._plan(seeds, depth)
        arr = eng._batch_arrays(plan)
        for b, blk in zip(plan["blocks"], arr["blocks"]):
            tail = ~b.edge_mask
            assert tail.any() and np.all(b.edge_dst[tail] == 0)
            _assert_host_csr(blk, b.p_src, b.p_dst)


def test_host_csr_build_raises_like_the_glue():
    rng = np.random.default_rng(5)
    src = rng.integers(0, 40, 300).astype(np.int32)
    dst = np.sort(rng.integers(0, 20, 300)).astype(np.int32)
    mask = rng.random(300) < 0.7
    shuffled = dst.copy()
    shuffled[[0, -40]] = shuffled[[-40, 0]]
    with pytest.raises(ValueError, match="grouped"):
        tagg.csr_arrays(40, src, shuffled, np.ones(300, bool), 20)
    with pytest.raises(ValueError, match="grouped"):
        _glue_csr(40, src, shuffled, np.ones(300, bool), 20,
                  transposed=False)
    for n_src, n_dst in ((10, 20), (40, 5)):
        with pytest.raises(ValueError, match="out of range"):
            tagg.csr_arrays(n_src, src, dst, mask, n_dst)
        with pytest.raises(ValueError, match="out of range"):
            _glue_csr(n_src, src, dst, mask, n_dst, transposed=False)
    # a masked edge's ids do not count: masking the ungrouped pair passes
    ok = mask.copy()
    ok[[0, -40]] = False
    tagg.csr_arrays(40, src, shuffled, ok, 20, transposed=True)


@pytest.mark.parametrize("n_src,n_dst,e,pad", [
    (40, 20, 300, 30), (257, 100, 1000, 56), (10, 10, 0, 0), (10, 10, 0, 8),
    (64, 300, 900, 0)])
def test_host_csr_matches_the_glue(n_src, n_dst, e, pad):
    """Masked edges, a padded tail, isolated rows and repeated sources,
    an empty edge list: the host build gives the glue's bytes."""
    rng = np.random.default_rng(e + pad)
    src = np.r_[rng.integers(0, n_src // 2 + 1, e), np.zeros(pad)] \
        .astype(np.int32)
    dst = np.r_[np.sort(rng.integers(0, n_dst, e)), np.zeros(pad)] \
        .astype(np.int32)
    mask = np.r_[rng.random(e) < 0.7, np.zeros(pad, bool)]
    csr = tagg.csr_arrays(n_src, src, dst, mask, n_dst, transposed=True)
    _assert_host_csr({"edge_src": src, "edge_dst": dst, "edge_mask": mask,
                      "csr": csr}, n_src, n_dst, transposed=True)


def test_to_device_makes_one_copy_of_typed_views():
    """Every array of the tree lands in one buffer (one transfer), at its
    dtype and shape; an array that appears twice is one view; other
    leaves pass through."""
    a = np.arange(7, dtype=np.int32)
    tree = {"a": a, "again": a, "n": 5,
            "csr": tagg.Csr(np.arange(4, dtype=np.int64),
                            np.zeros(0, np.int32),
                            np.array([2, 0, 1], np.int32), 0),
            "rows": [np.array([[1.5, -2.0]], np.float32),
                     np.array([True, False, True])]}
    out = tgnn.to_device(tree, "cpu")
    assert out["n"] == 5 and out["again"] is out["a"]
    assert isinstance(out["csr"], tagg.Csr) and out["csr"].t_dst is None
    leaves = [out["a"], *out["csr"][:3], *out["rows"]]
    for got, want in zip(leaves, [a, *tree["csr"][:3], *tree["rows"]]):
        assert got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(got.numpy(), want)
    storages = {t.untyped_storage().data_ptr() for t in leaves}
    assert len(storages) == 1
    assert all(t.data_ptr() % 16 == 0 for t in leaves)


def test_card_blocks_carry_the_csr_in_place_of_the_edge_lists(port_shards):
    """Blocks bound for the card leave the padded edge lists, which only
    the plain versions read, on the host; their CSRs are the CPU blocks'
    bytes."""
    shards, _ = port_shards
    sh = shards[0]
    sampler = tsampler.NeighborSampler(sh, 5, L, 32, seed=3)
    mb = sampler.sample_batch(sh.train_vertices()[:32])
    card = tgnn._host_blocks(mb.blocks, mb.input_ids, "cuda",
                             transposed=True)
    cpu = tgnn._host_blocks(mb.blocks, mb.input_ids, "cpu", transposed=True)
    for c, h in zip(card["blocks"], cpu["blocks"]):
        assert not {"edge_src", "edge_dst", "edge_mask"} & set(c)
        assert {"edge_src", "edge_dst", "edge_mask"} <= set(h)
        for a, b in zip(c["csr"], h["csr"]):
            if isinstance(a, np.ndarray):
                assert a.tobytes() == b.tobytes()
            else:
                assert a == b
