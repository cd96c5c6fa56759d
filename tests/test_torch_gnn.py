"""The port's GNN module against the JAX model, parameters carried over
with ``from_jax_leaves``: logits of ``forward`` on a JAX-sampled
mini-batch and every output of ``full_propagate``, within rtol = atol =
1e-5 (the two frameworks' float32 matrix products sum in different
orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import bfs_partition, make_client_shards, make_graph
from repro.graphs.sampler import NeighborSampler
from repro.models import gnn as jgnn
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
