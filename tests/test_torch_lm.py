"""The port's LM decode-serving path on the CPU against the JAX package.

Configs, the synthetic request stream and the decode building blocks are
held to the JAX package's from the same numpy inputs; the decode step of
the reduced dense configs, loaded with ``from_jax_params``, to JAX's
``lm.decode_step`` step for step over a wrapped sliding-window ring; and
``ContinuousBatcher`` to JAX's over the same requests.

Tolerances: in fp32 the two frameworks' matrix products and reductions
add in other orders, so the blocks are held to 1e-5 and the logits of 24
decode steps to 1e-5 of the largest logit.  In bf16 the two round the
intermediates at other places (XLA may keep an elementwise chain in fp32
where PyTorch rounds each op), so the logits are held to 5e-2 of the
largest logit, about six bf16 steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.configs.base import SHAPES as J_SHAPES
from repro.core.serving import ContinuousBatcher as JBatcher
from repro.core.serving import _reset_lane as JResetLane
from repro.data.pipeline import _markov_tokens as j_markov_tokens
from repro.data.pipeline import synthetic_request_stream as j_request_stream
from repro.launch import steps as j_steps
from repro.models import layers as jl
from repro.models import lm as jlm
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_reduced
from repro_torch.core.serving import ContinuousBatcher, _reset_lane
from repro_torch.data.pipeline import _markov_tokens, synthetic_request_stream
from repro_torch.kernels import ops
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps
from repro_torch.models import layers as tl
from repro_torch.models import lm

torch.set_num_threads(1)

DENSE = ["smollm-360m", "nemotron-4-340b", "command-r-35b", "starcoder2-15b"]
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


def _jax_tree_np(params):
    return jax.tree_util.tree_map(np.asarray, params)


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(J_ARCH_IDS))
def test_configs_equal_the_jax_package(arch):
    for mine, theirs in ((get_config(arch), j_get_config(arch)),
                         (get_reduced(arch), j_get_reduced(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_count() == theirs.param_count()
        assert mine.active_param_count() == theirs.active_param_count()
        assert mine.resolved_head_dim == theirs.resolved_head_dim
        assert str(mine.dtype).split(".")[-1] == jnp.dtype(theirs.dtype).name
        for name, shape in J_SHAPES.items():
            v = steps.shape_variant(mine, SHAPES[name])
            jv = j_steps.shape_variant(theirs, shape)
            assert dataclasses.asdict(v) == dataclasses.asdict(jv)
            assert steps.cache_capacity(v, SHAPES[name]) == \
                j_steps.cache_capacity(jv, shape)


def test_registry_and_shapes_equal_the_jax_package():
    assert ARCH_IDS == J_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    assert steps.LONG_CONTEXT_WINDOW == j_steps.LONG_CONTEXT_WINDOW


# -- data ---------------------------------------------------------------------

def test_request_stream_is_byte_identical():
    for seed, vocab, batch, seq in ((0, 512, 4, 32), (7, 49152, 3, 65)):
        a = _markov_tokens(np.random.default_rng(seed), vocab, batch, seq)
        b = j_markov_tokens(np.random.default_rng(seed), vocab, batch, seq)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    cfg, jcfg = get_reduced("smollm-360m"), j_get_reduced("smollm-360m")
    mine = synthetic_request_stream(cfg, batch=5, prompt_len=16, seed=3)
    theirs = j_request_stream(jcfg, batch=5, prompt_len=16, seed=3)
    for _ in range(3):
        a, b = next(mine), next(theirs)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -- building blocks ----------------------------------------------------------

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    got = tl.rms_norm(_t(x), _t(w), 1e-5)
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("head_axis", [True, False])
def test_apply_rope_matches_jax(head_axis):
    rng = np.random.default_rng(1)
    shape = (2, 5, 3, 16) if head_axis else (2, 5, 16)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, 9000, (2, 5)).astype(np.int32)
    got = tl.apply_rope(_t(x), _t(pos), 10_000.0, head_axis=head_axis)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0,
                         head_axis=head_axis)
    # angles up to 9000 rad: both packages' fp32 sin/cos of the same
    # fp32 angle, which may differ in the last bit
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("activation", ["silu_gated", "squared_relu",
                                        "gelu"])
def test_mlp_matches_jax(activation):
    cfg = dataclasses.replace(get_reduced("smollm-360m"),
                              activation=activation, use_bias=True)
    jcfg = dataclasses.replace(j_get_reduced("smollm-360m"),
                               activation=activation, use_bias=True)
    p = jl.init_mlp(jax.random.PRNGKey(3), jcfg, 96)
    p = {k: (None if v is None else v + 0.1) for k, v in p.items()}
    x = np.random.default_rng(2).standard_normal((2, 1, cfg.d_model)) \
        .astype(np.float32)
    got = tl.mlp({k: None if v is None else _t(np.asarray(v))
                  for k, v in p.items()}, cfg, _t(x))
    want = jl.mlp(p, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_jax(window):
    rng = np.random.default_rng(4)
    B, T, Hkv, G, dh = 3, 12, 2, 3, 8
    q = rng.standard_normal((B, 1, Hkv * G, dh)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, dh)).astype(np.float32)
    kv_pos = np.stack([np.roll(np.arange(T), r) + 3 for r in range(B)]) \
        .astype(np.int32)
    valid = rng.random((B, T)) < 0.8
    qpos = np.array([9, 14, 11], np.int32)
    got = tl.decode_attention(_t(q), _t(k), _t(v), q_position=_t(qpos),
                              kv_positions=_t(kv_pos), window=window,
                              kv_valid=_t(valid))
    want = jl.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), q_position=jnp.asarray(qpos),
                               kv_positions=jnp.asarray(kv_pos),
                               window=window, kv_valid=jnp.asarray(valid))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


# -- the decode step ----------------------------------------------------------

def _decode_both(arch, *, dtype="float32", steps_=24, window=8, B=2):
    cfg = dataclasses.replace(get_reduced(arch), sliding_window=window,
                              param_dtype=dtype)
    jcfg = dataclasses.replace(j_get_reduced(arch), sliding_window=window,
                               param_dtype=dtype)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    params = lm.from_jax_params(_jax_tree_np(jparams), cfg, device="cpu")
    assert lm.param_count(params) == jlm.param_count(jparams)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, steps_))
    jcache = jlm.init_cache(jcfg, B, window)
    cache = lm.init_cache(cfg, B, window, device="cpu")
    dec = jax.jit(lambda p, t, c: jlm.decode_step(p, jcfg, t, c))
    for t in range(steps_):
        jlg, jcache = dec(jparams, jnp.asarray(toks[:, t: t + 1], jnp.int32),
                          jcache)
        lg, cache = lm.decode_step(params, cfg, _t(toks[:, t: t + 1]), cache)
        yield t, _np(lg), np.asarray(jlg, np.float32), cache, jcache


@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_jax_over_a_wrapped_ring(arch):
    """24 steps over a ring of 8 slots with sliding_window=8 (the shape of
    ``test_lm_semantics.py::test_ring_buffer_window_decode``)."""
    for t, got, want, cache, jcache in _decode_both(arch):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                                   err_msg=f"step {t}")
    for key in ("pos", "valid", "index", "length"):
        np.testing.assert_array_equal(_np(cache["blocks"][key]),
                                      np.asarray(jcache["blocks"][key],
                                                 np.float32))
    np.testing.assert_allclose(_np(cache["blocks"]["k"]),
                               np.asarray(jcache["blocks"]["k"]),
                               rtol=TOL, atol=TOL)


def test_decode_step_matches_jax_in_bf16():
    for t, got, want, _, _ in _decode_both("smollm-360m", dtype="bfloat16",
                                           steps_=12):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-2 * scale,
                                   err_msg=f"step {t}")


def test_from_jax_params_checks_the_tree():
    cfg = get_reduced("smollm-360m")
    tree = _jax_tree_np(jlm.init_params(jax.random.PRNGKey(0),
                                        j_get_reduced("smollm-360m")))
    bad = dict(tree)
    bad["final_norm"] = tree["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        lm.from_jax_params(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        lm.from_jax_params({k: v for k, v in tree.items() if k != "embed"},
                           cfg, device="cpu")
    star = j_get_reduced("starcoder2-15b")
    with pytest.raises(ValueError, match="bias"):
        lm.from_jax_params(
            _jax_tree_np(jlm.init_params(jax.random.PRNGKey(0), star)),
            dataclasses.replace(get_reduced("starcoder2-15b"),
                                use_bias=False), device="cpu")


def test_init_params_shapes_and_seed():
    cfg = get_reduced("starcoder2-15b")
    g = torch.Generator().manual_seed(5)
    a = lm.init_params(cfg, generator=g, device="cpu")
    b = lm.init_params(cfg, generator=torch.Generator().manual_seed(5),
                       device="cpu")
    jtree = jlm.init_params(jax.random.PRNGKey(0), j_get_reduced(
        "starcoder2-15b"))
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), jtree)
    mine = jax.tree_util.tree_map(lambda x: tuple(x.shape), a)
    assert mine == shapes
    assert lm.param_count(a) == jlm.param_count(jtree)
    assert torch.equal(a["blocks"]["attn"]["wq"], b["blocks"]["attn"]["wq"])
    # per-layer fan-in, as under JAX's vmap: wq (D, H, dh) → 1/sqrt(D·H)
    wq = a["blocks"]["attn"]["wq"]
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model * cfg.num_heads)
               - 1.0) < 0.05


# -- continuous batching ------------------------------------------------------

def test_batcher_matches_jax():
    """Same requests, same completion order, and the same tokens wherever
    JAX's top-2 logit gap exceeds the fp32 tolerance."""
    cfg, jcfg = get_reduced("smollm-360m"), j_get_reduced("smollm-360m")
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    params = lm.from_jax_params(_jax_tree_np(jparams), cfg, device="cpu")
    prompts = next(synthetic_request_stream(cfg, batch=7, prompt_len=6,
                                            seed=1))
    max_new = [5, 3, 8, 4, 6, 2, 7]
    mine = ContinuousBatcher(cfg, params, lanes=3, capacity=16,
                             device="cpu")
    theirs = JBatcher(jcfg, jparams, lanes=3, capacity=16)
    gaps = []
    inner = theirs._decode

    def decode(p, t, c):
        logits, c = inner(p, t, c)
        top2 = np.sort(np.asarray(logits[:, 0], np.float32), axis=-1)
        gaps.append(top2[:, -1] - top2[:, -2])
        return logits, c
    theirs._decode = decode
    for p, n in zip(prompts, max_new):
        mine.submit(p, max_new=n)
        theirs.submit(p, max_new=n)
    while any(theirs.active) or theirs.queue:
        ours = mine.step()
        jax_out = theirs.step()
        assert [r for r, _ in ours] == [r for r, _ in jax_out]
    done, jdone = mine.completed, theirs.completed
    assert [r.rid for r in done] == [r.rid for r in jdone]
    assert sorted(r.rid for r in done) == list(range(len(prompts)))
    assert all(len(r.generated) == r.max_new for r in done)
    assert mine.steps == theirs.steps
    # every token was picked with a clear margin, so all must agree
    assert min(float(g.min()) for g in gaps) > 1e-4
    assert [r.generated for r in done] == [r.generated for r in jdone]


def test_reset_lane_is_in_place_and_refuses_ssm_caches():
    """Every lane reset, held to JAX's ``_reset_lane`` on the same cache
    contents: a dense cache's bookkeeping, and since SSM caches are
    ported, the conv windows and state of an SSM cache (the lane at axis
    -4 of ``state``, -3 of the windows, under the layer stack) and both
    halves of a hybrid cache, all in place."""
    cache = lm.init_cache(get_reduced("smollm-360m"), 3, 8, prefill_len=5,
                          device="cpu")
    out = _reset_lane(cache, 1)
    assert out is cache
    b = cache["blocks"]
    assert b["length"][:, 1].eq(0).all() and b["length"][:, 0].eq(5).all()
    assert not b["valid"][:, 1].any() and b["valid"][:, 0, :5].all()
    rng = np.random.default_rng(9)
    for arch in ("mamba2-1.3b", "hymba-1.5b"):
        cache = lm.init_cache(get_reduced(arch), 3, 8, prefill_len=5,
                              device="cpu")
        leaves = [t for t in jax.tree_util.tree_leaves(cache)
                  if t.is_floating_point()]
        for t in leaves:
            t.copy_(torch.from_numpy(rng.standard_normal(
                tuple(t.shape)).astype(np.float32)))
        ptrs = [t.data_ptr() for t in leaves]
        want = JResetLane(jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.numpy()), cache), 2)
        assert _reset_lane(cache, 2) is cache
        for got, w in zip(jax.tree_util.tree_leaves(cache),
                          jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        blocks = cache["blocks"] if arch == "mamba2-1.3b" \
            else cache["blocks"]["ssm"]
        assert not blocks["state"][:, 2].any()
        assert blocks["state"][:, :2].abs().sum() > 0
        assert not blocks["conv_x"][:, 2].any()
        assert [t.data_ptr() for t in leaves] == ptrs


def test_serve_launcher_runs_on_the_cpu(capsys):
    ops.reset_launch_counts()
    t_serve.main(["--device", "cpu", "--batch", "2", "--prompt", "4",
                  "--generate", "3"])
    out = capsys.readouterr().out
    assert "served 12 tokens" in out and "on CPU" in out
    assert all(c == 0 for c in ops.launch_counts().values())
