"""The port's federated LM training (``repro_torch.core.fedopt``) on the
CPU against the JAX package's ``repro.core.fedopt``.

The counterparts of ``tests/test_distributed.py``'s fedopt tests (a round
with delta pruning, stale aggregation deferring one round); two rounds of
``FederatedLMTrainer`` started from JAX's own anchor (``lm.init_params``
at ``PRNGKey(0)``, loaded with ``from_jax_params``) against JAX's trainer
over the same batches, dense, top-k 0.2 and top-k with stale
aggregation; ``_topk_sparsify`` element for element on small leaves and
on one of 2**24 + 3 elements, where JAX's fp32 quantile position is no
longer the exact index; ``comm_bytes_per_round``.

The rounds use SGD (lr 0.5): smooth in the gradient, so the anchors stay
within rounding of JAX's (AdamW's update is about lr·sign(g) at its first
step, and a gradient within rounding of zero may flip it; see
``tests/test_torch_lm_train.py``).  Tolerances: every anchor and silo
parameter within 1e-6 (measured ≤ 2.2e-7), the round's loss within 1e-5
(measured ≤ 4.8e-7), ``comm_fraction`` and the byte count equal, and an
anchor that stale aggregation leaves alone equal bit for bit.  Top-k may
keep an entry at the threshold in one package and drop it in the other
(its delta and its neighbour's sort either way within rounding):
``_check_anchor`` allows two such entries a leaf and checks that they
are at the threshold (one of them, in ``blocks/mlp/w_in``, in round 2 of
the top-k run).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core import fedopt as jfedopt
from repro.optim import sgd as j_sgd
from repro_torch.configs import get_reduced
from repro_torch.core.fedopt import (FedOptConfig, FederatedLMTrainer,
                                     _topk_sparsify, replicate)
from repro_torch.data import synthetic_batches
from repro_torch.models import lm
from repro_torch.optim import adamw, sgd
from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

torch.set_num_threads(1)

ARCH = "smollm-360m"
TOL = 1e-6
LOSS_TOL = 1e-5


def _silo_batches(cfg, silos, steps, *, seed0=0, batch=2, seq=16):
    """{key: (silos, steps, batch, ...)}: silo s draws from seed0 + s."""
    gens = [synthetic_batches(cfg, batch=batch, seq=seq, seed=seed0 + s,
                              device="cpu") for s in range(silos)]
    per = [[next(g) for _ in range(steps)] for g in gens]
    return {k: torch.stack([torch.stack([b[k] for b in s]) for s in per])
            for k in per[0][0]}


def _leaf_sum_abs_diff(a, b):
    return sum(float((x - y).abs().sum())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


# -- tests/test_distributed.py's fedopt cases, on the port --------------------

def test_fedopt_round_and_delta_pruning():
    cfg = get_reduced(ARCH)
    fed = FedOptConfig(num_silos=2, local_steps=2, delta_topk_frac=0.2)
    tr = FederatedLMTrainer(cfg, adamw(1e-3), fed, device="cpu")
    m = tr.round(_silo_batches(cfg, 2, 2))
    assert np.isfinite(m["loss"])
    assert tr.comm_bytes_per_round() < 0.25 * sum(
        p.numel() * p.element_size() for p in tree_leaves(tr.anchor))


def test_fedopt_stale_aggregation_defers_one_round():
    cfg = get_reduced(ARCH)
    fed = FedOptConfig(num_silos=2, local_steps=1, stale_aggregation=True)
    tr = FederatedLMTrainer(cfg, adamw(1e-3), fed, device="cpu")
    anchor0 = tree_unflatten(tr.anchor, [t.clone() for t in
                                            tree_leaves(tr.anchor)])
    b = next(synthetic_batches(cfg, batch=2, seq=16, seed=0, device="cpu"))
    batches = {k: v.expand(2, 1, *v.shape) for k, v in b.items()}
    tr.round(batches)
    # first round: nothing applied yet (delta pending)
    assert _leaf_sum_abs_diff(anchor0, tr.anchor) == 0.0
    tr.round(batches)
    assert _leaf_sum_abs_diff(anchor0, tr.anchor) > 0.0


def test_replicate_copies_each_silo():
    cfg = get_reduced(ARCH)
    p = lm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    r = replicate(p, 3)
    for a, b in zip(tree_leaves(p), tree_leaves(r)):
        assert b.shape == (3,) + a.shape
        assert all(torch.equal(a, s) for s in b)
    tree_leaves(r)[0][0].add_(1.0)          # the silos are apart
    assert torch.equal(tree_leaves(r)[0][1], tree_leaves(p)[0])


# -- against JAX's trainer ----------------------------------------------------

def _check_anchor(r, got, want, got0, want0, frac):
    """The port's anchor against JAX's after round ``r``: every entry within
    TOL, except where top-k kept an entry in one package and dropped it in
    the other.  That happens only at the threshold, where two deltas a
    rounding apart sort either way: at most two entries a leaf, each kept
    by exactly one package, its magnitude within 1e-3 of the smallest
    delta JAX kept in that leaf (its neighbour in the sort)."""
    for path, g, w, g0, w0 in zip(tree_paths(got), tree_leaves(got),
                                  jax.tree_util.tree_leaves(want), got0,
                                  want0):
        g, w = g.numpy(), np.asarray(w)
        off = np.abs(g - w) > TOL
        if not off.any():
            continue
        assert frac is not None and off.sum() <= 2, (
            r, path, float(np.abs(g - w).max()), int(off.sum()))
        dg, dw = (g - g0)[off], (w - w0)[off]
        assert ((dg == 0) != (dw == 0)).all(), (r, path)
        kept = np.abs(w - w0)
        thr = kept[kept > 0].min()
        np.testing.assert_allclose(np.maximum(np.abs(dg), np.abs(dw)), thr,
                                   rtol=1e-3)


@pytest.mark.parametrize("frac,stale", [(None, False), (0.2, False),
                                        (0.2, True)],
                         ids=["dense", "topk", "topk-stale"])
def test_rounds_match_jax(frac, stale):
    cfg, jcfg = get_reduced(ARCH), j_get_reduced(ARCH)
    fed = FedOptConfig(num_silos=2, local_steps=2, delta_topk_frac=frac,
                       stale_aggregation=stale)
    jt = jfedopt.FederatedLMTrainer(
        jcfg, j_sgd(0.5), jfedopt.FedOptConfig(
            num_silos=2, local_steps=2, delta_topk_frac=frac,
            stale_aggregation=stale))
    anchor = lm.from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                       jt.anchor),
                                cfg, device="cpu")
    tr = FederatedLMTrainer(cfg, sgd(0.5), fed, params=anchor, device="cpu")
    assert tr.comm_bytes_per_round() == jt.comm_bytes_per_round()
    for r in range(2):
        got0 = [t.numpy().copy() for t in tree_leaves(tr.anchor)]
        want0 = [np.asarray(a) for a in jax.tree_util.tree_leaves(jt.anchor)]
        b = _silo_batches(cfg, 2, 2, seed0=2 * r)
        jm = jt.round({k: jnp.asarray(v.numpy()) for k, v in b.items()})
        m = tr.round(b)
        assert abs(m["loss"] - jm["loss"]) <= LOSS_TOL * abs(jm["loss"])
        assert m["comm_fraction"] == jm["comm_fraction"]
        if frac is not None:
            assert abs(m["comm_fraction"] - frac) < 1e-12
        _check_anchor(r, tr.anchor, jt.anchor, got0, want0, frac)
        if stale and r == 0:
            # nothing applied: the anchor is as it was, the silos train on
            assert all(np.array_equal(t.numpy(), a) for t, a in
                       zip(tree_leaves(tr.anchor), got0))
            for path, g, w in zip(tree_paths(tr.params),
                                  tree_leaves(tr.params),
                                  jax.tree_util.tree_leaves(jt.params)):
                err = float(np.abs(g.numpy() - np.asarray(w)).max())
                assert err <= TOL, (path, err)
        else:
            assert _leaf_sum_abs_diff(
                [torch.from_numpy(a) for a in got0],
                tree_leaves(tr.anchor)) > 0
            # the silos restart from the new anchor
            for a, p in zip(tree_leaves(tr.anchor),
                            tree_leaves(tr.params)):
                assert all(torch.equal(a, s) for s in p)
    assert tr.comm_bytes_per_round() == jt.comm_bytes_per_round()


# -- the sparsifier -----------------------------------------------------------

def test_topk_sparsify_matches_jax_on_small_leaves():
    """Leaf sizes where the interpolation weight is not zero, a 0-dim leaf
    (passed through, uncounted), a bf16 leaf and a None bias."""
    rng = np.random.default_rng(0)
    leaves = {"a": rng.standard_normal((7,)).astype(np.float32),
              "b": rng.standard_normal((33, 31)).astype(np.float32),
              "c": rng.standard_normal((3, 5, 41)).astype(np.float32),
              "g": np.float32(0.25), "z": None}
    bf = rng.standard_normal((19, 21)).astype(np.float32)
    for frac in (0.1, 0.2, 0.35):
        jtree = {k: None if v is None else jnp.asarray(v)
                 for k, v in leaves.items()}
        jtree["h"] = jnp.asarray(bf, jnp.bfloat16)
        ttree = {k: None if v is None else torch.from_numpy(np.array(v))
                 for k, v in leaves.items()}
        ttree["h"] = torch.from_numpy(bf).to(torch.bfloat16)
        jout, jkept = jfedopt._topk_sparsify(jtree, frac)
        tout, tkept = _topk_sparsify(ttree, frac)
        assert tkept == jkept
        assert tout["z"] is None and tout["g"] is ttree["g"]
        for k in ("a", "b", "c", "h"):
            assert tout[k].dtype == ttree[k].dtype
            np.testing.assert_array_equal(
                tout[k].to(torch.float32).numpy(),
                np.asarray(jout[k], np.float32))


def test_topk_masks_match_jax_above_2_24():
    """2**24 + 3 elements: n − 1 in fp32 is 16,777,220, past the last
    index, and q·(n − 1) rounds to another index than the exact one; the
    port's mask must still be JAX's, element for element."""
    n = 2 ** 24 + 3
    d = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    jout, jkept = jfedopt._topk_sparsify({"w": jnp.asarray(d)}, 0.2)
    tout, tkept = _topk_sparsify({"w": torch.from_numpy(d)}, 0.2)
    want = np.asarray(jout["w"])
    got = tout["w"].numpy()
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_array_equal(got, want)
    assert tkept == jkept
    # the exact-index quantile would keep a different count
    exact = np.sort(np.abs(d))[int(0.8 * (n - 1))]
    assert (np.abs(d) >= exact).sum() != (got != 0).sum()


def test_comm_bytes_count_the_anchor_dtype():
    """bf16 anchors count 2 bytes a value, fp32 ones 4; top-k ships the
    nominal fraction of them."""
    cfg = get_reduced(ARCH)
    for dtype, size in (("float32", 4), ("bfloat16", 2)):
        c = dataclasses.replace(cfg, param_dtype=dtype)
        fed = FedOptConfig(num_silos=2, local_steps=1, delta_topk_frac=0.1)
        tr = FederatedLMTrainer(c, sgd(0.1), fed, device="cpu")
        n = sum(p.numel() for p in tree_leaves(tr.anchor))
        assert tr.comm_bytes_per_round() == int(n * size * 0.1)
