"""The port's LM training step on the CPU against the JAX package.

``lm.loss_fn`` and every gradient leaf (in JAX's leaf order) of every
reduced config against ``jax.value_and_grad`` of JAX's ``loss_fn``, on a
batch with masked (−1) labels; ``make_train_step`` over 3 steps with SGD,
AdamW, Adafactor (nemotron's reduced config, whose optimizer it is) and
with 2 microbatches against JAX's jitted step; remat on and off bit for
bit on the port; the counterparts of the JAX package's smoke tests (one
forward, train step and two decode steps of every arch, the loss falling
on a repeated batch, the training loop learning the Markov stream);
``default_microbatches`` and ``make_optimizer``; the launcher.

Parameters: the port's seeded ``init_params``, handed to JAX as the same
numbers and loaded back through ``lm.from_jax_params`` (JAX's own
initialisers would take most of the file's time); the VLM's cross gate is
moved off zero, where tanh would hide the cross branch's gradients.

Tolerances, fp32 throughout (the two frameworks add products and sums in
other orders):
- the loss, the aux loss and the total within 1e-5 of max(1, |JAX's|)
  (measured ≤ 2.4e-6);
- each gradient leaf within 1e-4 of that leaf's largest |g| in JAX's
  gradient (measured ≤ 5e-6), that scale floored at 1e-3 of the largest
  |g| of the whole gradient: a leaf whose gradient is zero in exact
  arithmetic (a key bias: softmax ignores a shift shared by all keys)
  holds only rounding noise in both;
- SGD and Adafactor, chained over 3 steps: each parameter within 1e-6
  (measured ≤ 1.2e-7), the step losses within 1e-5;
- AdamW: each step from JAX's parameters and state before it (converted
  with ``from_jax_opt_state``), since Adam amplifies the smallest
  gradients: at step 1 its update is about lr·sign(g), so a gradient
  within rounding of zero may take either sign, and a sign flip moves
  every later gradient.  A gradient error δ (1e-4 of the leaf's largest
  |g|, the gradient tolerance) moves the update u = m̂/(√v̂ + eps) by
  about δ/(√v̂ + eps) through m̂ and as much again through v̂; each
  parameter must lie within
  lr·min(2, 3·δ/(√v̂ + eps)) + 1e-7 of JAX's, √v̂ read from JAX's new
  state.  An entry with a near-zero gradient history (small v̂) may flip
  sign; every other entry is held to a few ulps of its update.  Entries
  more than 1e-6 from JAX's, summed over the three steps, must stay under
  0.1 % of the parameters, and in each leaf at most max(2, 0.1 % of
  the leaf) (measured: at most 29 in a leaf of 524,288, and 1 in a
  leaf of 1,024).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.configs import list_archs
from repro.launch import steps as j_steps
from repro.models import lm as jlm
from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.optim import sgd as j_sgd
from repro_torch.configs import SHAPES, get_config, get_reduced
from repro_torch.data import synthetic_batches
from repro_torch.launch import steps, train
from repro_torch.models import lm
from repro_torch.optim import adafactor, adamw, from_jax_opt_state, sgd
from repro_torch.tree import tree_leaves, tree_paths

torch.set_num_threads(1)

ARCHS = list_archs()
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-6
ROUND_TOL = 1e-7


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return None if tree is None else tree.numpy()


def _seq(cfg):
    return cfg.ssm_chunk if cfg.family in ("ssm", "hybrid") else 8


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(port cfg, JAX cfg, port params, JAX params, port batch, JAX batch)
    from one numpy tree; the batch's first row has masked labels."""
    cfg, jcfg = get_reduced(arch), j_get_reduced(arch)
    p = lm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    if cfg.family == "vlm":
        p["blocks"]["gate"] += 0.5
    tree = _numpy_tree(p)
    params = lm.from_jax_params(tree, cfg, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    batch = next(synthetic_batches(cfg, batch=2, seq=_seq(cfg), seed=0,
                                   device="cpu"))
    batch["labels"][0, :3] = -1
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    return cfg, jcfg, params, jparams, batch, jbatch


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(arch):
    jcfg = j_get_reduced(arch)
    return jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch):
    _, _, _, jparams, _, jbatch = _setup(arch)
    (total, metrics), grads = _jax_grad_fn(arch)(jparams, jbatch)
    return (float(total), float(metrics["loss"]), float(metrics["aux"]),
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


def _close_scalar(got, want, tol=LOSS_TOL):
    assert abs(float(got) - want) <= tol * max(1.0, abs(want)), (got, want)


# -- loss and gradients -------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    cfg, _, params, _, batch, _ = _setup(arch)
    total, loss, aux, _ = _jax_loss_and_grads(arch)
    with torch.no_grad():
        got_total, m = lm.loss_fn(params, cfg, batch)
    _close_scalar(got_total, total)
    _close_scalar(m["loss"], loss)
    _close_scalar(m["aux"], aux)
    if cfg.num_experts:
        assert aux > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(arch):
    cfg, _, params, _, batch, _ = _setup(arch)
    want = _jax_loss_and_grads(arch)[3]
    _, _, grads = lm.loss_and_grads(params, cfg, batch)
    paths = tree_paths(params)
    assert len(grads) == len(want) == len(paths)
    floor = 1e-3 * max(float(np.abs(w).max()) for w in want)
    for path, g, w in zip(paths, grads, want):
        assert tuple(g.shape) == w.shape, path
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(_np(g) - w).max())
        assert err <= GRAD_TOL * scale, (path, err, scale)


def test_masked_labels_are_left_out():
    """Labels < 0 add nothing: masking a row gives the other row's loss,
    and an all-masked batch gives loss 0 (JAX's max(count, 1) divisor)."""
    cfg, _, params, _, batch, _ = _setup("smollm-360m")
    masked = dict(batch, labels=batch["labels"].clone())
    masked["labels"][0] = -1
    none = dict(batch, labels=torch.full_like(batch["labels"], -1))
    with torch.no_grad():
        _, m_masked = lm.loss_fn(params, cfg, masked)
        _, m_row = lm.loss_fn(params, cfg, {k: v[1:]
                                            for k, v in batch.items()})
        _, m_none = lm.loss_fn(params, cfg, none)
    _close_scalar(m_masked["loss"], float(m_row["loss"]))
    assert float(m_none["loss"]) == 0.0


# -- the train step -----------------------------------------------------------

def _batches(cfg, n, batch=2):
    gen = synthetic_batches(cfg, batch=batch, seq=_seq(cfg), seed=1,
                            device="cpu")
    return [next(gen) for _ in range(n)]


def _jb(b):
    return {k: jnp.asarray(v.numpy()) for k, v in b.items()}


@pytest.mark.parametrize("arch,opt,microbatches", [
    ("smollm-360m", "sgd", 1),
    ("nemotron-4-340b", "adafactor", 1),
    ("smollm-360m", "sgd", 2),
])
def test_train_step_matches_jax_chained(arch, opt, microbatches):
    """SGD and Adafactor are smooth in the gradient: three chained steps
    from the same parameters stay within PARAM_TOL of JAX's."""
    cfg, jcfg, params, jparams, _, _ = _setup(arch)
    if opt == "adafactor":
        assert cfg.optimizer == "adafactor"
    t_opt, j_opt = {"sgd": (sgd(0.1), j_sgd(0.1)),
                    "adafactor": (adafactor(1e-3), j_adafactor(1e-3))}[opt]
    j_step = jax.jit(jlm.make_train_step(jcfg, j_opt,
                                         microbatches=microbatches))
    t_step = lm.make_train_step(cfg, t_opt, microbatches=microbatches)
    jp, js = jparams, j_opt.init(jparams)
    tp, ts = params, t_opt.init(tree_leaves(params))
    for b in _batches(cfg, 3):
        jp, js, jm = j_step(jp, js, _jb(b))
        tp, ts, tm = t_step(tp, ts, b)
        _close_scalar(tm["loss"], float(jm["loss"]))
        _close_scalar(tm["aux"], float(jm["aux"]))
    for path, got, want in zip(tree_paths(tp), tree_leaves(tp),
                               jax.tree_util.tree_leaves(jp)):
        err = float(np.abs(_np(got) - np.asarray(want)).max())
        assert err <= PARAM_TOL, (path, err)


@pytest.mark.parametrize("arch,microbatches", [
    ("smollm-360m", 1), ("smollm-360m", 2), ("mamba2-1.3b", 1)])
def test_adamw_step_matches_jax(arch, microbatches):
    """Three AdamW steps, each from JAX's parameters and state before it;
    each parameter within the bound of the module docstring."""
    lr = 1e-3
    cfg, jcfg, _, jparams, _, _ = _setup(arch)
    j_opt, t_opt = j_adamw(lr), adamw(lr)
    j_step = jax.jit(jlm.make_train_step(jcfg, j_opt,
                                         microbatches=microbatches))
    t_step = lm.make_train_step(cfg, t_opt, microbatches=microbatches)
    g_fn = _jax_grad_fn(arch)
    jp, js = jparams, j_opt.init(jparams)
    flipped: dict[str, int] = {}
    for t, b in enumerate(_batches(cfg, 3), start=1):
        jb = _jb(b)
        scales = [float(np.abs(np.asarray(g)).max()) for g in
                  jax.tree_util.tree_leaves(g_fn(jp, jb)[1])]
        tp = lm.from_jax_params(
            jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
        ts = from_jax_opt_state(jax.tree_util.tree_map(np.asarray, js),
                                   tp)
        tp, ts, tm = t_step(tp, ts, b)
        jp, js, jm = j_step(jp, js, jb)
        _close_scalar(tm["loss"], float(jm["loss"]))
        assert int(ts.count) == int(js.count) == t
        c2 = 1 - 0.999 ** t
        for path, got, want, nu, scale in zip(
                tree_paths(tp), tree_leaves(tp),
                jax.tree_util.tree_leaves(jp),
                jax.tree_util.tree_leaves(js.nu), scales):
            sqrt_v = np.sqrt(np.asarray(nu) / c2)
            bound = lr * np.minimum(2.0, 3 * GRAD_TOL * scale
                                    / (sqrt_v + 1e-8)) + ROUND_TOL
            err = np.abs(_np(got) - np.asarray(want))
            assert (err <= bound).all(), (t, path, float(err.max()))
            flipped[path] = flipped.get(path, 0) + int((err > 1e-6).sum())
    # the bound is loose only where the gradient history is near zero:
    # few entries over the three steps, in the whole tree and in each leaf
    sizes = dict(zip(tree_paths(tp), (t.numel() for t in tree_leaves(tp))))
    assert sum(flipped.values()) < 1e-3 * sum(sizes.values())
    for path, n in flipped.items():
        assert n <= max(2, 1e-3 * sizes[path]), (path, n, sizes[path])


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_equal(arch):
    """Recomputing the scanned units in the backward changes no bit of
    the loss or of any gradient."""
    cfg, _, params, _, batch, _ = _setup(arch)
    assert cfg.remat
    on = lm.loss_and_grads(params, cfg, batch)
    off = lm.loss_and_grads(params, dataclasses.replace(cfg, remat=False),
                            batch)
    assert torch.equal(on[0], off[0])
    for a, b in zip(on[2], off[2]):
        assert torch.equal(a, b)


def test_remat_recomputes_the_units(monkeypatch):
    """With remat the forward of each scanned block runs again in the
    backward; without it, once."""
    cfg, _, params, _, batch, _ = _setup("smollm-360m")
    calls = []
    inner = lm._dense_layer_fwd

    def counted(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)
    monkeypatch.setattr(lm, "_dense_layer_fwd", counted)
    lm.loss_and_grads(params, cfg, batch)
    with_remat = len(calls)
    calls.clear()
    lm.loss_and_grads(params, dataclasses.replace(cfg, remat=False),
                      batch)
    assert (with_remat, len(calls)) == (2 * cfg.num_layers, cfg.num_layers)


# -- the JAX package's smoke tests, on the port -------------------------------

def _smoke_batch(cfg, B=2, S=32, seed=0):
    """``tests/test_archs_smoke.py``'s ``make_batch``."""
    rng = np.random.default_rng(seed)
    b = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)),
         "labels": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.family == "vlm":
        b["vision"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32))
    if cfg.family == "audio":
        b["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return b


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_train_decode(arch):
    cfg = get_reduced(arch)
    S = 64 if cfg.family in ("ssm", "hybrid") else 32
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    batch = _smoke_batch(cfg, S=S)
    with torch.no_grad():
        logits, _ = lm.forward(params, cfg, batch)
    assert tuple(logits.shape) == (2, S, cfg.vocab_size)
    assert not bool(torch.isnan(logits).any())

    opt = adamw(1e-3)
    step = lm.make_train_step(cfg, opt)
    p2, _, metrics = step(params, opt.init(tree_leaves(params)), batch)
    assert np.isfinite(float(metrics["loss"]))
    delta = sum(float((a - b).abs().sum()) for a, b in zip(
        tree_leaves(params), tree_leaves(p2)))
    assert delta > 0

    cache = lm.init_cache(cfg, 2, 16, device="cpu")
    with torch.no_grad():
        lg, cache = lm.decode_step(params, cfg, batch["tokens"][:, :1], cache)
        lg2, cache = lm.decode_step(params, cfg, batch["tokens"][:, 1:2],
                                    cache)
    assert tuple(lg.shape) == (2, 1, cfg.vocab_size)
    assert not bool(torch.isnan(lg2).any())


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-1.3b",
                                  "hymba-1.5b", "deepseek-v2-lite-16b"])
def test_smoke_loss_decreases(arch):
    """A few steps on a repeated batch must reduce the loss."""
    cfg = get_reduced(arch)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    batch = _smoke_batch(cfg, B=4, S=64 if cfg.family in ("ssm", "hybrid")
                         else 32)
    opt = adamw(3e-3)
    step = lm.make_train_step(cfg, opt)
    st = opt.init(tree_leaves(params))
    losses = []
    for _ in range(8):
        params, st, m = step(params, st, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1, losses


def test_transformer_training_loop_learns():
    """``tests/test_e2e.py``'s loop: the Markov stream is learnable."""
    cfg = get_reduced("smollm-360m")
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    opt = adamw(5e-3)
    state = opt.init(tree_leaves(params))
    step = lm.make_train_step(cfg, opt)
    gen = synthetic_batches(cfg, batch=8, seq=64, seed=0, device="cpu")
    losses = []
    for _ in range(25):
        params, state, m = step(params, state, next(gen))
        losses.append(float(m["loss"]))
    assert min(losses[-3:]) < losses[0] - 0.5, losses


# -- training defaults and the launcher ---------------------------------------

def test_training_defaults_match_jax():
    for arch in ARCHS:
        for shape in SHAPES:
            assert steps.default_microbatches(get_config(arch),
                                              SHAPES[shape]) == \
                j_steps.default_microbatches(j_get_config(arch),
                                             J_SHAPES[shape]), (arch, shape)
        for full in (True, False):
            cfg = get_config(arch) if full else get_reduced(arch)
            jcfg = j_get_config(arch) if full else j_get_reduced(arch)
            assert steps.make_optimizer(cfg).name == \
                j_steps.make_optimizer(jcfg).name, arch
    assert steps.default_microbatches(get_config("smollm-360m"),
                                      SHAPES["train_4k"]) == 4
    assert steps.make_optimizer(get_reduced("nemotron-4-340b")).name == \
        "adafactor(lr=0.001)"


def test_train_launcher_runs_on_the_cpu(capsys):
    train.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=smollm-reduced family=dense")
    assert out[0].endswith("device=cpu")
    assert [ln.split()[:2] for ln in out[1:3]] == [["step", "0"],
                                                   ["step", "1"]]
    assert all("loss" in ln and "aux" in ln for ln in out[1:3])
    assert out[-1] == "done"


def test_train_launcher_rounds_the_ssm_sequence(capsys):
    train.main(["--device", "cpu", "--arch", "mamba2-1.3b", "--steps", "1",
                "--batch", "1", "--seq", "100"])
    assert capsys.readouterr().out.splitlines()[-1] == "done"
