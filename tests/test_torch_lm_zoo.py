"""The port's LM zoo beyond the dense family, on the CPU, against the JAX
package: parameter trees, caches, the decode step, the batcher and the
serving launcher of the MoE, MLA, SSM, hybrid, VLM and audio families.

JAX's own parameter trees (``lm.init_params``, lists and None biases
kept) load with ``from_jax_params``; the decode step of each new family
is held to JAX's ``lm.decode_step`` step for step over a wrapped
sliding-window ring (cross K/V filled with the same random memory); the
port's decode is held to its own forward, teacher-forced, as
``tests/test_lm_semantics.py::test_decode_matches_forward`` holds JAX's;
``ContinuousBatcher`` on mamba2 (SSM lane resets) and deepseek (MLA and
MoE) to JAX's over the same requests.

Tolerances: fp32 decode logits within 1e-5 of the largest logit for the
attention families (measured 0.8–1.4e-6) and 1e-4 for ssm and hybrid
(measured 1.5–1.7e-6); bf16 deepseek within 5e-2, as
``test_torch_lm.py`` holds the dense decode.  The port's decode against
its own forward: the same 1e-5 and 1e-4 (measured 0.66–1.11e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.configs import list_archs
from repro.core.serving import ContinuousBatcher as JBatcher
from repro.models import lm as jlm
from repro_torch.configs import get_reduced
from repro_torch.core.serving import ContinuousBatcher
from repro_torch.data import synthetic_request_stream
from repro_torch.kernels import ops
from repro_torch.launch import serve as t_serve
from repro_torch.models import lm
from repro_torch.models.layers import _project, add_bias

torch.set_num_threads(1)

NEW = ["phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b", "mamba2-1.3b",
       "hymba-1.5b", "llama-3.2-vision-11b", "whisper-tiny"]
TOL = 1e-5
SSM_TOL = 1e-4
BF16_TOL = 5e-2


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


def _tol(cfg):
    return SSM_TOL if cfg.family in ("ssm", "hybrid") else TOL


def _both(arch, **over):
    return (dataclasses.replace(get_reduced(arch), **over),
            dataclasses.replace(j_get_reduced(arch), **over))


def _jax_init(jcfg):
    """JAX's own parameters (jitted: the eager init compiles op by op),
    the VLM's gates moved off zero, which would hide the cross branch."""
    jp = jax.jit(jlm.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
    if jcfg.family == "vlm":
        jp["blocks"]["gate"] = jp["blocks"]["gate"] + 0.5
    return jp


def _as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(tree):
    """(shape, dtype name) at every leaf of a JAX or port tree."""
    return jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), tree)


# -- trees --------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_init_params_tree_equals_jax(arch):
    """The port's seeded tree has JAX's keys, lists, shapes and dtypes
    (abstractly evaluated: no JAX numbers are drawn)."""
    cfg, jcfg = _both(arch, param_dtype="bfloat16")
    tree = lm.init_params(cfg, generator=torch.Generator().manual_seed(1),
                          device="cpu")
    want = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    assert _shapes(tree) == _shapes(want)
    assert lm.param_count(tree) == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(want))


@pytest.mark.parametrize("arch", NEW)
def test_from_jax_params_keeps_every_leaf(arch):
    """A tree of JAX's structure and dtypes in a bf16 config (the SSM's
    A_log, D and dt_bias stay fp32) loads bit for bit; a leaf in the
    wrong dtype and a layer list of the wrong length are refused."""
    cfg, jcfg = _both(arch, param_dtype="bfloat16")
    abstract = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                      jcfg))
    rng = np.random.default_rng(2)
    tree = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), abstract)
    params = lm.from_jax_params(tree, cfg, device="cpu")
    assert _shapes(params) == _shapes(abstract)
    for got, want in zip(jax.tree_util.tree_leaves(params),
                         jax.tree_util.tree_leaves(tree)):
        assert _np(got).tobytes() == want.astype(np.float32).tobytes()
    if cfg.family in ("ssm", "hybrid"):
        assert params["blocks"]["ssm"]["A_log"].dtype == torch.float32
        bad = jax.tree_util.tree_map(lambda a: a, tree)
        bad["blocks"]["ssm"]["D"] = bad["blocks"]["ssm"]["D"].astype(
            jnp.bfloat16)
        with pytest.raises(ValueError, match="ssm/D"):
            lm.from_jax_params(bad, cfg, device="cpu")
    lists = [k for k in ("head_blocks", "enc_blocks", "dec_blocks")
             if k in tree]
    for key in lists:
        short = dict(tree)
        short[key] = tree[key][:-1]
        with pytest.raises(ValueError, match=key):
            lm.from_jax_params(short, cfg, device="cpu")
    assert bool(lists) == (cfg.family == "audio" or cfg.first_dense_layers
                           > 0)


@pytest.mark.parametrize("arch", NEW)
def test_init_cache_equals_jax(arch):
    """Keys, lists, shapes, dtypes and contents of an empty cache and of
    one that has seen 5 tokens; JAX's ``extras`` is accepted and
    ignored on both sides."""
    cfg, jcfg = _both(arch)
    for prefill in (0, 5):
        cache = lm.init_cache(cfg, 3, 8, prefill_len=prefill,
                              extras={"ignored": True}, device="cpu")
        want = jlm.init_cache(jcfg, 3, 8, prefill_len=prefill,
                              extras={"ignored": True})
        assert _shapes(cache) == _shapes(want)
        for a, b in zip(jax.tree_util.tree_leaves(cache),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(_np(a), np.asarray(b, np.float32))


# -- the decode step ----------------------------------------------------------

def _fill_cross(cfg, cache, jcache, seed):
    """The same random memory K/V in both caches (the serving path leaves
    them zero)."""
    rng = np.random.default_rng(seed)
    pairs = [(cache["blocks"], jcache["blocks"])] if cfg.family == "vlm" \
        else list(zip(cache.get("dec_blocks", []),
                      jcache.get("dec_blocks", [])))
    for c, jc in pairs:
        for key in ("cross_k", "cross_v"):
            a = rng.standard_normal(tuple(c[key].shape)).astype(np.float32)
            c[key].copy_(torch.from_numpy(a))
            jc[key] = jnp.asarray(a, jc[key].dtype)


def _decode_both(arch, *, dtype="float32", steps=20, window=8, B=2):
    cfg, jcfg = _both(arch, sliding_window=window, param_dtype=dtype)
    jp = _jax_init(jcfg)
    params = lm.from_jax_params(_as_numpy(jp), cfg, device="cpu")
    assert lm.param_count(params) == jlm.param_count(jp)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, steps))
    cache = lm.init_cache(cfg, B, window, device="cpu")
    jcache = jlm.init_cache(jcfg, B, window)
    _fill_cross(cfg, cache, jcache, 4)
    dec = jax.jit(lambda p, t, c: jlm.decode_step(p, jcfg, t, c))
    for t in range(steps):
        jlg, jcache = dec(jp, jnp.asarray(toks[:, t: t + 1], jnp.int32),
                          jcache)
        lg, out = lm.decode_step(params, cfg, torch.from_numpy(
            toks[:, t: t + 1]), cache)
        assert out is cache
        yield t, cfg, _np(lg), np.asarray(jlg, np.float32), cache, jcache


@pytest.mark.parametrize("arch", NEW)
def test_decode_step_matches_jax_over_a_wrapped_ring(arch):
    """20 steps over a ring of 8 slots with sliding_window=8; afterwards
    every cache leaf (K/V or latents, SSM state and conv windows, the
    bookkeeping) equals JAX's."""
    for t, cfg, got, want, cache, jcache in _decode_both(arch):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=_tol(cfg) * np.abs(want).max(),
                                   err_msg=f"step {t}")
    assert _shapes(cache) == _shapes(jcache)
    for a, b in zip(jax.tree_util.tree_leaves(cache),
                    jax.tree_util.tree_leaves(jcache)):
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                   rtol=_tol(cfg), atol=_tol(cfg))


def test_decode_step_matches_jax_in_bf16():
    for t, _, got, want, _, _ in _decode_both(
            "deepseek-v2-lite-16b", dtype="bfloat16", steps=10):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BF16_TOL * np.abs(want).max(),
                                   err_msg=f"step {t}")


def _seed_cross(params, cfg, cache, batch):
    """Cross K/V of the memory the forward attends to, written into the
    decode cache."""
    if cfg.family == "vlm":
        memory = batch["vision"] @ params["vis_proj"]
        layers = [lp["cross"] for lp in lm._layers(params["blocks"])]
        caches = lm._layers(cache["blocks"])
    elif cfg.family == "audio":
        memory = lm._encode(params, cfg, batch["frames"])
        layers = [lp["cross"] for lp in params["dec_blocks"]]
        caches = cache["dec_blocks"]
    else:
        return
    for p, c in zip(layers, caches):
        c["cross_k"].copy_(add_bias(_project(memory, p["wk"]), p.get("bk")))
        c["cross_v"].copy_(add_bias(_project(memory, p["wv"]), p.get("bv")))


@pytest.mark.parametrize("arch", ["smollm-360m"] + NEW)
def test_decode_matches_forward(arch):
    """Teacher-forced decode reproduces the forward's logits (MoE with
    capacity enough that neither path drops a token)."""
    cfg = get_reduced(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    S = 64 if cfg.family in ("ssm", "hybrid") else 16
    B = 2
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(5),
                            device="cpu")
    if cfg.family == "vlm":
        params["blocks"]["gate"] += 0.5
    rng = np.random.default_rng(6)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.family == "vlm":
        batch["vision"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32))
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    want, _ = lm.forward(params, cfg, batch)
    cache = lm.init_cache(cfg, B, S, device="cpu")
    _seed_cross(params, cfg, cache, batch)
    got = torch.cat([lm.decode_step(params, cfg,
                                    batch["tokens"][:, t: t + 1], cache)[0]
                     for t in range(S)], dim=1)
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=_tol(cfg) * np.abs(want).max())


# -- continuous batching and the launcher -------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-1.3b", "deepseek-v2-lite-16b"])
def test_batcher_matches_jax(arch):
    """Same requests, same completion order and tokens; every lane that
    takes a new request is reset (for mamba2, its conv windows and
    state), so each request's tokens depend on it alone."""
    cfg, jcfg = get_reduced(arch), j_get_reduced(arch)
    jp = _jax_init(jcfg)
    params = lm.from_jax_params(_as_numpy(jp), cfg, device="cpu")
    prompts = next(synthetic_request_stream(cfg, batch=7, prompt_len=6,
                                            seed=1))
    max_new = [5, 3, 8, 4, 6, 2, 7]
    mine = ContinuousBatcher(cfg, params, lanes=3, capacity=16,
                             device="cpu")
    theirs = JBatcher(jcfg, jp, lanes=3, capacity=16)
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
        assert [r for r, _ in mine.step()] == [r for r, _ in theirs.step()]
    done, jdone = mine.completed, theirs.completed
    assert [r.rid for r in done] == [r.rid for r in jdone]
    assert sorted(r.rid for r in done) == list(range(len(prompts)))
    assert all(len(r.generated) == r.max_new for r in done)
    assert mine.steps == theirs.steps
    # every token was picked with a clear margin, so all must agree
    assert min(float(g.min()) for g in gaps) > 1e-4
    assert [r.generated for r in done] == [r.generated for r in jdone]


@pytest.mark.parametrize("arch", NEW)
def test_serve_launcher_runs_every_family(arch, capsys):
    ops.reset_launch_counts()
    t_serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                  "--prompt", "4", "--generate", "3"])
    out = capsys.readouterr().out
    assert f"arch={get_reduced(arch).name} served 12 tokens" in out
    assert "on CPU" in out
    assert all(c == 0 for c in ops.launch_counts().values())
