"""The port's LM forward (prefill) on the CPU against the JAX package.

Every layer the forward runs is held to its JAX counterpart from the same
numpy inputs and parameters: the blocked attention core (causal,
windowed, a KV length that is no multiple of the block, a validity
mask), the attention,
cross-attention and MLA layers, MLA's decode in both forms, the MoE FFN
(one dispatch group and two, with capacity that drops tokens), the
Mamba2 pieces (causal conv, the chunked SSD scan, the block's forward
and decode step); then ``lm.forward`` of the reduced config of every
architecture, and the synthetic batches byte for byte.  Parameters come
from the port's seeded initialisers and go to JAX as the same numbers
(JAX's own initialisers, eager, would take most of the file's time);
``tests/test_torch_lm_zoo.py`` loads JAX's own trees with
``from_jax_params``.

Tolerances.  fp32 throughout: the two frameworks' products and
reductions add in other orders.  Layers within 1e-5 (measured ≤ 2e-6).
The forward's logits within 1e-5 of the largest logit for the attention
families (measured 0.61–1.49e-6) and 1e-4 for ssm and hybrid, whose
chunked SSD runs a cumsum / exp chain (measured 1.34–1.89e-6).  In bf16
(deepseek) the two round intermediates at other places, so the logits are
held to 5e-2 of the largest logit, about six bf16 steps, as
``test_torch_lm.py`` holds the dense decode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.configs import list_archs
from repro.data.pipeline import synthetic_batches as j_synthetic_batches
from repro.models import layers as jl
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch.configs import get_reduced
from repro_torch.data import synthetic_batches
from repro_torch.models import layers as tl
from repro_torch.models import lm
from repro_torch.models import moe
from repro_torch.models import ssm

torch.set_num_threads(1)

TOL = 1e-5
SSM_TOL = 1e-4
BF16_TOL = 5e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


def _jnp(tree):
    """A port parameter tree as the JAX package's (None leaves and layer
    lists kept)."""
    if isinstance(tree, dict):
        return {k: _jnp(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jnp(v) for v in tree]
    return None if tree is None else jnp.asarray(_np(tree))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _params(cfg, seed=0):
    """The port's seeded parameters and the same numbers as JAX's tree."""
    p = lm.init_params(cfg, generator=_gen(seed), device="cpu")
    if cfg.family == "vlm":
        # zero at init, which would hide the cross branch
        p["blocks"]["gate"] += 0.5
    return p, _jnp(p)


def _both(arch, **over):
    return (dataclasses.replace(get_reduced(arch), **over),
            dataclasses.replace(j_get_reduced(arch), **over))


# -- attention ----------------------------------------------------------------

@pytest.mark.parametrize("Sq,Skv,G,causal,window,kv_block,valid", [
    (24, 24, 2, True, None, 8, False),        # causal, three whole blocks
    (24, 24, 3, True, 5, 8, False),           # sliding window
    (7, 19, 1, False, None, 8, False),        # Skv no multiple of the block
    (6, 21, 2, True, None, 16, True),         # a validity mask, padded
    (10, 600, 2, False, None, 512, True),     # the default block, ragged
])
def test_blocked_attention_matches_jax(Sq, Skv, G, causal, window, kv_block,
                                       valid):
    rng = np.random.default_rng(Sq * Skv)
    B, Hkv, dh = 2, 2, 8
    q = rng.standard_normal((B, Sq, Hkv * G, dh)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, dh)).astype(np.float32)
    qpos = (np.arange(Sq) + Skv - Sq).astype(np.int32)
    kpos = np.arange(Skv, dtype=np.int32)
    kv_valid = rng.random((B, Skv)) < 0.7 if valid else None
    if valid:
        kv_valid[1] = False                   # a row with nothing to see
    kw = dict(causal=causal, window=window, kv_block=kv_block)
    got = tl.blocked_attention(
        _t(q), _t(k), _t(v), q_positions=_t(qpos), kv_positions=_t(kpos),
        kv_valid=None if kv_valid is None else _t(kv_valid), **kw)
    want = jl.blocked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
        kv_valid=None if kv_valid is None else jnp.asarray(kv_valid), **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("arch,window", [("smollm-360m", None),
                                         ("starcoder2-15b", 6)])
def test_attention_layer_matches_jax(arch, window):
    cfg, jcfg = _both(arch)
    p = tl.init_attention(cfg, generator=_gen(1), device="cpu")
    p = {k: None if v is None else v + 0.05 for k, v in p.items()}
    x = np.random.default_rng(2).standard_normal((2, 20, cfg.d_model)) \
        .astype(np.float32)
    pos = np.arange(20, dtype=np.int32)
    got, (k, v) = tl.attention(p, cfg, _t(x), positions=_t(pos),
                               window=window)
    p = _jnp(p)
    want, (jk, jv) = jl.attention(p, jcfg, jnp.asarray(x),
                                  positions=jnp.asarray(pos), window=window)
    _close(got, want)
    _close(k, jk)
    _close(v, jv)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_cross_attention_matches_jax(arch):
    cfg, jcfg = _both(arch)
    p = tl.init_cross_attention(cfg, generator=_gen(3), device="cpu")
    p = {k: None if v is None else v + 0.05 for k, v in p.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    got = tl.cross_attention(p, cfg, _t(x), _t(mem), kv_block=16)
    want = jl.cross_attention(_jnp(p), jcfg, jnp.asarray(x),
                              jnp.asarray(mem), kv_block=16)
    _close(got, want)


def test_gated_rms_norm_matches_jax():
    rng = np.random.default_rng(5)
    x, z = (rng.standard_normal((2, 3, 64)).astype(np.float32) * 3
            for _ in range(2))
    w = rng.standard_normal(64).astype(np.float32)
    _close(tl.gated_rms_norm(_t(x), _t(z), _t(w), 1e-5),
           jl.gated_rms_norm(jnp.asarray(x), jnp.asarray(z),
                             jnp.asarray(w), 1e-5))


# -- MLA ----------------------------------------------------------------------

def _mla_params(seed=6):
    cfg, jcfg = _both("deepseek-v2-lite-16b")
    p = tl.init_mla(cfg, generator=_gen(seed), device="cpu")
    return cfg, jcfg, _jnp(p), p


def test_mla_attention_matches_jax():
    cfg, jcfg, jp, p = _mla_params()
    x = np.random.default_rng(7).standard_normal((2, 21, cfg.d_model)) \
        .astype(np.float32)
    pos = np.arange(21, dtype=np.int32)
    got, (c_kv, k_rope) = tl.mla_attention(p, cfg, _t(x), positions=_t(pos),
                                           kv_block=8)
    want, (jc, jr) = jl.mla_attention(jp, jcfg, jnp.asarray(x),
                                      positions=jnp.asarray(pos), kv_block=8)
    _close(got, want)
    _close(c_kv, jc)
    _close(k_rope, jr)


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("window", [None, 4])
def test_mla_decode_matches_jax(absorb, window):
    """Ten steps over a ring of 6 slots, so it wraps; the latent cache
    and its bookkeeping equal JAX's after every step."""
    cfg, jcfg, jp, p = _mla_params()
    T, B = 6, 2
    cache = tl.init_mla_cache(cfg, B, T, device="cpu")
    jcache = jl.init_mla_cache(jcfg, B, T)
    xs = np.random.default_rng(8).standard_normal((10, B, 1, cfg.d_model)) \
        .astype(np.float32)
    for t, x in enumerate(xs):
        got, out_cache = tl.mla_decode(p, cfg, _t(x), cache, absorb=absorb,
                                       window=window)
        assert out_cache is cache
        want, jcache = jl.mla_decode(jp, jcfg, jnp.asarray(x), jcache,
                                     absorb=absorb, window=window)
        _close(got, want)
        for key in ("c_kv", "k_rope", "pos", "valid", "index", "length"):
            _close(cache[key], jcache[key])


# -- MoE ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("groups", [1, 2])
def test_moe_ffn_matches_jax(arch, groups):
    """Capacity factor 0.5: about half the assignments are dropped, and
    which ones follows the stable sort, so the outputs agree only if the
    dispatch does."""
    cfg, jcfg = _both(arch, moe_groups=groups, capacity_factor=0.5)
    p = moe.init_moe(cfg, generator=_gen(9), device="cpu")
    x = np.random.default_rng(10).standard_normal((2, 12, cfg.d_model)) \
        .astype(np.float32)
    got, aux = moe.moe_ffn(p, cfg, _t(x))
    want, jaux = jmoe.moe_ffn(_jnp(p), jcfg, jnp.asarray(x))
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL)
    # the capacity did bind
    T, K, E = 24 // groups, cfg.top_k, cfg.num_experts
    C = int(np.ceil(T * K / E * cfg.capacity_factor))
    assert C * E < T * K


def test_moe_route_breaks_ties_to_the_lower_expert():
    cfg, jcfg = _both("deepseek-v2-lite-16b")
    p = moe.init_moe(cfg, generator=_gen(11), device="cpu")
    # every token's logits tie in pairs: experts 0 = 1 and 2 = 3
    p["router"] = torch.zeros_like(p["router"])
    p["router"][:, 2:] = 0.01
    jp = _jnp(p)
    x = np.abs(np.random.default_rng(12).standard_normal(
        (5, cfg.d_model))).astype(np.float32)
    top_p, top_e, _ = moe._route(p, cfg, _t(x))
    jtop_p, jtop_e, _ = jmoe._route(jp, jcfg, jnp.asarray(x))
    assert top_e.tolist() == np.asarray(jtop_e).tolist() == [[2, 3]] * 5
    _close(top_p, jtop_p)


def test_moe_dispatch_and_combine_match_jax():
    cfg, jcfg = _both("phi3.5-moe-42b-a6.6b")
    rng = np.random.default_rng(13)
    T, E, K, C = 10, cfg.num_experts, cfg.top_k, 3
    xt = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    top_e = np.stack([rng.permutation(E)[:K] for _ in range(T)])
    top_p = rng.random((T, K)).astype(np.float32)
    buf, meta = moe._dispatch(cfg, _t(xt), _t(top_p), _t(top_e), C)
    jbuf, jmeta = jmoe._dispatch(jcfg, jnp.asarray(xt), jnp.asarray(top_p),
                                 jnp.asarray(top_e.astype(np.int32)), C)
    np.testing.assert_array_equal(_np(buf), np.asarray(jbuf))
    eo = rng.standard_normal((E, C, cfg.d_model)).astype(np.float32)
    _close(moe._combine(cfg, _t(eo), meta, T),
           jmoe._combine(jcfg, jnp.asarray(eo), jmeta, T))


# -- SSM ----------------------------------------------------------------------

def test_causal_conv_matches_jax():
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    _close(ssm._causal_conv(_t(x), _t(w), _t(b)),
           jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(b)))


@pytest.mark.parametrize("S,with_state", [(64, False), (192, True)])
def test_ssd_scan_matches_jax(S, with_state):
    """One chunk, and three chunks continuing from a state."""
    cfg, jcfg = _both("mamba2-1.3b")
    rng = np.random.default_rng(S)
    B, H, P, N = 2, 4, 8, cfg.ssm_state
    xs = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (rng.random((B, S, H)) * 0.2).astype(np.float32)
    Bc, Cc = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32) \
        if with_state else None
    y, state = ssm.ssd_scan(cfg, _t(xs), _t(dt), _t(Bc), _t(Cc), _t(A),
                            _t(D), None if s0 is None else _t(s0))
    jy, jstate = jssm.ssd_scan(jcfg, *map(jnp.asarray, (xs, dt, Bc, Cc, A,
                                                         D)),
                               init_state=None if s0 is None
                               else jnp.asarray(s0))
    _close(y, jy, SSM_TOL)
    _close(state, jstate, SSM_TOL)


def _ssm_params(seed=15):
    cfg, jcfg = _both("mamba2-1.3b")
    p = ssm.init_ssm(cfg, generator=_gen(seed), device="cpu")
    # move the fp32 leaves off their constant init
    for k in ("A_log", "D", "dt_bias"):
        p[k] += 0.1 * torch.arange(p[k].shape[0])
    return cfg, jcfg, _jnp(p), p


def test_ssm_forward_matches_jax():
    cfg, jcfg, jp, p = _ssm_params()
    x = np.random.default_rng(16).standard_normal((2, 128, cfg.d_model)) \
        .astype(np.float32)
    y, ((tx, tbc), state) = ssm.ssm_forward(p, cfg, _t(x))
    jy, ((jtx, jtbc), jstate) = jssm.ssm_forward(jp, jcfg, jnp.asarray(x))
    _close(y, jy, SSM_TOL)
    _close(tx, jtx)
    _close(tbc, jtbc)
    _close(state, jstate, SSM_TOL)


def test_ssm_decode_matches_jax():
    cfg, jcfg, jp, p = _ssm_params()
    B = 3
    cache = ssm.init_ssm_cache(cfg, B, device="cpu")
    jcache = jssm.init_ssm_cache(jcfg, B)
    assert cache["state"].dtype == torch.float32
    xs = np.random.default_rng(17).standard_normal((6, B, 1, cfg.d_model)) \
        .astype(np.float32)
    for x in xs:
        got, out_cache = ssm.ssm_decode(p, cfg, _t(x), cache)
        assert out_cache is cache
        want, jcache = jssm.ssm_decode(jp, jcfg, jnp.asarray(x), jcache)
        _close(got, want)
        for key in ("conv_x", "conv_BC", "state"):
            _close(cache[key], jcache[key])


# -- the forward --------------------------------------------------------------

def _seq(cfg):
    """Two SSD chunks for the ssm / hybrid configs (chunk 64)."""
    return 128 if cfg.family in ("ssm", "hybrid") else 16


@pytest.mark.parametrize("arch", list_archs())
def test_forward_matches_jax(arch):
    cfg, jcfg = get_reduced(arch), j_get_reduced(arch)
    params, jp = _params(cfg)
    S = _seq(cfg)
    batch = next(synthetic_batches(cfg, batch=2, seq=S, seed=1,
                                   device="cpu"))
    jbatch = next(j_synthetic_batches(jcfg, batch=2, seq=S, seed=1))
    logits, aux = lm.forward(params, cfg, batch)
    jlogits, jaux = jax.jit(lambda p, b: jlm.forward(p, jcfg, b))(jp, jbatch)
    want = np.asarray(jlogits, np.float32)
    assert logits.shape == want.shape
    tol = SSM_TOL if cfg.family in ("ssm", "hybrid") else TOL
    np.testing.assert_allclose(_np(logits), want, rtol=0,
                               atol=tol * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=0)
    assert (float(aux) > 0) == bool(cfg.num_experts)


def test_forward_matches_jax_in_bf16():
    cfg, jcfg = _both("deepseek-v2-lite-16b", param_dtype="bfloat16")
    params, jp = _params(cfg)
    batch = next(synthetic_batches(cfg, batch=2, seq=16, seed=1,
                                   device="cpu"))
    logits, _ = lm.forward(params, cfg, batch)
    jlogits, _ = jax.jit(lambda p, b: jlm.forward(p, jcfg, b))(
        jp, next(j_synthetic_batches(jcfg, batch=2, seq=16, seed=1)))
    want = np.asarray(jlogits, np.float32)
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(logits), want, rtol=0,
                               atol=BF16_TOL * np.abs(want).max())


@pytest.mark.parametrize("arch,dtype", [
    ("smollm-360m", "float32"), ("llama-3.2-vision-11b", "bfloat16"),
    ("whisper-tiny", "float32")])
def test_synthetic_batches_are_byte_identical(arch, dtype):
    cfg, jcfg = _both(arch, param_dtype=dtype)
    mine = synthetic_batches(cfg, batch=3, seq=10, seed=4, device="cpu")
    theirs = j_synthetic_batches(jcfg, batch=3, seq=10, seed=4)
    for _ in range(2):
        a, b = next(mine), next(theirs)
        assert sorted(a) == sorted(b)
        for k in b:
            want = np.asarray(b[k])
            got = a[k].view(torch.uint16) if a[k].dtype == torch.bfloat16 \
                else a[k]
            assert got.numpy().tobytes() == want.tobytes(), k
            assert tuple(a[k].shape) == want.shape
