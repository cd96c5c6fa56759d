"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU against
the JAX package's ``repro.checkpoint``.

The counterparts of ``tests/test_optim.py``'s checkpoint tests (a round
trip with a bf16 leaf and Adam state; a structure mismatch refused); a
tree ``{"params", "opt"}`` saved by JAX and loaded by the port, and the
reverse, for AdamW, Adafactor (whose vector leaves keep a ``()`` column
statistic) and SGD with momentum, over the reduced smollm config in bf16
with random optimizer statistics: the manifests equal (paths, dtypes,
shapes, step, extra), every leaf equal bit for bit, bf16 included;
``from_jax_opt_state`` equal to what the checkpoint loads.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_reduced as j_get_reduced
from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.optim import sgd as j_sgd
from repro_torch.checkpoint import load_pytree, restore, save, save_pytree
from repro_torch.configs import get_reduced
from repro_torch.models import lm
from repro_torch.optim import (adafactor, adam, adamw, from_jax_opt_state,
                               sgd)
from repro_torch.tree import tree_leaves, tree_unflatten

torch.set_num_threads(1)


def _np32(t):
    return t.detach().to(torch.float32).numpy()


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    np.testing.assert_array_equal(_np32(got), want.astype(np.float32))


# -- tests/test_optim.py's cases, on the port ---------------------------------

def test_checkpoint_roundtrip(tmp_path):
    opt = adam(1e-3)
    params = {"a": torch.arange(6.0).reshape(2, 3),
              "nested": {"b": torch.ones(4, dtype=torch.bfloat16)}}
    state = opt.init(tree_leaves(params))
    save_pytree(tmp_path / "ck", {"params": params, "opt": state}, step=7)
    like = {"params": params, "opt": state}
    restored, manifest = load_pytree(tmp_path / "ck", like, device="cpu")
    assert manifest["step"] == 7
    assert manifest["paths"] == ["opt/.mu/a", "opt/.mu/nested/b",
                                 "opt/.nu/a", "opt/.nu/nested/b",
                                 "opt/.count", "params/a", "params/nested/b"]
    assert isinstance(restored["opt"].mu, list)
    for a, b in zip(tree_leaves(like), tree_leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_structure_mismatch_rejected(tmp_path):
    save_pytree(tmp_path / "ck", {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree(tmp_path / "ck", {"b": torch.ones(3)}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        load_pytree(tmp_path / "ck", {"a": torch.ones(4)}, device="cpu")


def test_aliases_and_meta_like(tmp_path):
    """``save``/``restore`` are the same functions; ``like`` may be on the
    meta device (shapes and dtypes only), and each leaf takes its dtype."""
    assert save is save_pytree and restore is load_pytree
    tree = {"w": torch.randn(3, 4).to(torch.bfloat16), "n": torch.tensor(5)}
    save(tmp_path / "ck", tree, extra={"arch": "x"})
    like = {"w": torch.empty(3, 4, dtype=torch.float32, device="meta"),
            "n": torch.empty((), dtype=torch.int64, device="meta")}
    got, manifest = restore(tmp_path / "ck", like, device="cpu")
    assert manifest["extra"] == {"arch": "x"}
    assert manifest["dtypes"] == ["int64", "bfloat16"]
    assert got["w"].dtype == torch.float32
    assert torch.equal(got["w"], tree["w"].to(torch.float32))
    assert torch.equal(got["n"], tree["n"])


# -- across the two packages --------------------------------------------------

OPTS = {"adamw": (adamw(1e-3), j_adamw(1e-3)),
        "adafactor": (adafactor(1e-3), j_adafactor(1e-3)),
        "sgd-momentum": (sgd(0.1, momentum=0.9), j_sgd(0.1, momentum=0.9))}


def _trees(opt_name):
    """Port params (bf16, reduced smollm) and a random optimizer state,
    and the same numbers as JAX's ``{"params", "opt"}`` tree."""
    cfg = dataclasses.replace(get_reduced("smollm-360m"),
                              param_dtype="bfloat16")
    assert dataclasses.replace(j_get_reduced("smollm-360m"),
                               param_dtype="bfloat16").dtype == jnp.bfloat16
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    t_opt, j_opt = OPTS[opt_name]
    state = t_opt.init(tree_leaves(params))
    gen = torch.Generator().manual_seed(1)
    for t in tree_leaves(state):
        if t.is_floating_point():
            t.copy_(torch.rand(t.shape, generator=gen))
        else:
            t.fill_(3)

    def to_j(t):
        return jnp.asarray(_np32(t)).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else
            {torch.float32: jnp.float32, torch.int32: jnp.int32}[t.dtype])
    jparams = tree_unflatten(params, [to_j(t) for t in
                                         tree_leaves(params)])
    j_state = j_opt.init(jparams)
    j_state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(j_state),
        [to_j(t) for t in tree_leaves(state)])
    return params, state, jparams, j_state


@pytest.mark.parametrize("opt_name", list(OPTS))
def test_jax_checkpoint_loads_in_the_port(tmp_path, opt_name):
    params, state, jparams, j_state = _trees(opt_name)
    jckpt.save_pytree(tmp_path / "j", {"params": jparams, "opt": j_state},
                      step=11, extra={"arch": "smollm-360m"})
    like = {"params": params, "opt": state}
    got, manifest = load_pytree(tmp_path / "j", like, device="cpu")
    assert manifest["step"] == 11
    want = jax.tree_util.tree_leaves({"params": jparams, "opt": j_state})
    assert len(tree_leaves(got)) == len(want)
    for g, w in zip(tree_leaves(got), want):
        _same(g, w)
    # the port writes the same manifest and the same arrays
    save_pytree(tmp_path / "t", got, step=11, extra={"arch": "smollm-360m"})
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    # the JAX state converted leaf by leaf is what the checkpoint loaded
    conv = from_jax_opt_state(
        jax.tree_util.tree_map(np.asarray, j_state), params)
    assert type(conv) is type(state)
    for a, b in zip(tree_leaves(conv), tree_leaves(got["opt"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("opt_name", list(OPTS))
def test_port_checkpoint_loads_in_jax(tmp_path, opt_name):
    params, state, jparams, j_state = _trees(opt_name)
    save_pytree(tmp_path / "t", {"params": params, "opt": state}, step=4)
    like = {"params": jparams, "opt": j_state}
    got, manifest = jckpt.load_pytree(tmp_path / "t", like)
    paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(like)[0]]
    assert manifest["paths"] == paths
    if opt_name == "adafactor":
        assert any(p.startswith("opt/.vc/") and s == []
                   for p, s in zip(paths, manifest["shapes"]))
    for g, t in zip(jax.tree_util.tree_leaves(got),
                    tree_leaves({"params": params, "opt": state})):
        _same(t, g)
    assert json.loads((tmp_path / "t.json").read_text())["step"] == 4
