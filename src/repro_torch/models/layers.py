"""Transformer building blocks of the LM zoo: the decode path.

Counterpart of ``repro/models/layers.py`` for what one-token decode runs:
initialisers, RMSNorm, rotary embeddings, the MLPs, GQA attention
against a ring-buffer KV cache, and the cache itself.  Prefill
(``blocked_attention``), MLA and cross-attention wait for later slices.

Conventions as in the JAX package: activations (B, S, D); attention
internals (B, S, H, dh); KV caches (B, T, Hkv, dh) with int32 absolute
positions, bool validity, an int32 ring write index and an int32 count
of tokens seen.  Parameters keep the JAX layouts (``wq`` (D, H, dh),
``wo`` (H, dh, D), ``w_in`` (D, F)), so a JAX parameter tree loads as it
is.  Softmax statistics are fp32 whatever the parameter dtype.

Unlike the JAX package, whose arrays are immutable, the port updates a
KV cache **in place**: :func:`attention_decode` writes the new slot with
``index_put_`` into the tensors it is given, advances ``index`` and
``length`` in place, and returns the same dict.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

# -- initialisers -------------------------------------------------------------

def dense_init(shape, dtype: torch.dtype, *, generator: torch.Generator,
               device, scale: float | None = None) -> torch.Tensor:
    """Normal(0, 1) · scale in fp32, cast to ``dtype``; ``scale`` defaults
    to 1/sqrt(fan_in) with JAX's fan-in rule (the first dim of a matrix,
    the product of all but the last dim of a higher-rank tensor).  Drawn
    from ``generator`` on its own device, then moved to ``device``."""
    fan_in = shape[0] if len(shape) <= 2 else int(np.prod(shape[:-1]))
    s = scale if scale is not None else float(1.0 / np.sqrt(fan_in))
    x = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=torch.float32) * s
    return x.to(device=device, dtype=dtype)


def maybe_bias(cfg: ModelConfig, shape, *, device) -> torch.Tensor | None:
    return torch.zeros(tuple(shape), dtype=cfg.dtype, device=device) \
        if cfg.use_bias else None


def add_bias(x: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    return x if b is None else x + b


# -- norms --------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in fp32, cast back to x's dtype."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.to(torch.float32)).to(x.dtype)


# -- rotary embeddings --------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, *, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, *,
               head_axis: bool = True) -> torch.Tensor:
    """x: (..., S, H, dh) if head_axis else (..., S, dh); positions
    (..., S) broadcastable against x's leading dims.  fp32 angles and a
    split-half rotation, cast back to x's dtype."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)             # (dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (.., S, dh/2)
    if head_axis:
        angles = angles[..., None, :]                        # (.., S, 1, dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- MLPs ---------------------------------------------------------------------

def mlp_shapes(cfg: ModelConfig, d_ff: int) -> dict:
    """Leaf shapes of :func:`init_mlp`'s tree (biases whether or not the
    config has them)."""
    D = cfg.d_model
    p = {"w_out": (d_ff, D), "b_out": (D,), "w_in": (D, d_ff),
         "b_in": (d_ff,)}
    if cfg.activation == "silu_gated":
        p["w_gate"] = (D, d_ff)
    return p


def _init_from_shapes(shapes: dict, cfg: ModelConfig, *,
                      generator: torch.Generator, device) -> dict:
    """Matrices by :func:`dense_init`, ``b*`` leaves by :func:`maybe_bias`."""
    return {k: maybe_bias(cfg, s, device=device) if k.startswith("b")
            else dense_init(s, cfg.dtype, generator=generator, device=device)
            for k, s in shapes.items()}


def init_mlp(cfg: ModelConfig, d_ff: int, *, generator: torch.Generator,
             device) -> dict:
    return _init_from_shapes(mlp_shapes(cfg, d_ff), cfg,
                             generator=generator, device=device)


def mlp(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = add_bias(x @ p["w_in"], p.get("b_in"))
    if cfg.activation == "silu_gated":
        h = F.silu(h) * (x @ p["w_gate"])
    elif cfg.activation == "squared_relu":
        h = torch.square(F.relu(h))
    elif cfg.activation == "gelu":
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    else:
        raise ValueError(cfg.activation)
    return add_bias(h @ p["w_out"], p.get("b_out"))


# -- attention ----------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, q_position: torch.Tensor,
                     kv_positions: torch.Tensor, window: int | None,
                     kv_valid: torch.Tensor) -> torch.Tensor:
    """Single-token attention against a cache, through the
    ``swa_attention_decode`` kernel on the card (its plain version on
    the CPU).

    q: (B, 1, H, dh); caches (B, T, Hkv, dh); q_position (B,) absolute;
    kv_positions (B, T) absolute; kv_valid (B, T)."""
    B, _, H, dh = q.shape
    out = ops.swa_attention_decode(q.reshape(B, H, dh), k_cache, v_cache,
                                   kv_positions, kv_valid, q_position,
                                   window=window)
    return out.reshape(B, 1, H, dh)


def attention_shapes(cfg: ModelConfig) -> dict:
    """Leaf shapes of :func:`init_attention`'s tree (biases whether or
    not the config has them)."""
    D, H, Hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    return {"wq": (D, H, dh), "wk": (D, Hkv, dh), "wv": (D, Hkv, dh),
            "wo": (H, dh, D), "bq": (H, dh), "bk": (Hkv, dh),
            "bv": (Hkv, dh), "bo": (D,)}


def init_attention(cfg: ModelConfig, *, generator: torch.Generator,
                   device) -> dict:
    return _init_from_shapes(attention_shapes(cfg), cfg,
                             generator=generator, device=device)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matrix product."""
    D, h, k = w.shape
    return (x @ w.reshape(D, h * k)).reshape(*x.shape[:-1], h, k)


def attention_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: dict, *, window: int | None = None
                     ) -> tuple[torch.Tensor, dict]:
    """One-token decode.  ``cache``: {"k", "v": (B, T, Hkv, dh), "pos":
    (B, T) absolute positions, "valid": (B, T), "index": (B,) ring write
    slot, "length": (B,) tokens seen}, updated in place.  Returns (out,
    cache)."""
    B = x.shape[0]
    q = add_bias(_project(x, p["wq"]), p.get("bq"))
    k = add_bias(_project(x, p["wk"]), p.get("bk"))
    v = add_bias(_project(x, p["wv"]), p.get("bv"))
    pos = cache["length"]                       # (B,) absolute position
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    T = cache["k"].shape[1]
    slot = cache["index"]                       # (B,)
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, slot] = k[:, 0]
    cache["v"][bidx, slot] = v[:, 0]
    cache["pos"][bidx, slot] = pos
    cache["valid"][bidx, slot] = True
    out = decode_attention(q, cache["k"], cache["v"], q_position=pos,
                           kv_positions=cache["pos"], window=window,
                           kv_valid=cache["valid"])
    H, dh = out.shape[2], out.shape[3]
    out = out.reshape(B, 1, H * dh) @ p["wo"].reshape(H * dh, -1)
    out = add_bias(out, p.get("bo"))
    slot.add_(1).remainder_(T)
    pos.add_(1)
    return out, cache


def _cache_bookkeeping(batch: int, capacity: int, length: int, *,
                       device) -> dict:
    """Ring-buffer metadata for a cache that has already absorbed
    ``length`` tokens (length ≤ capacity), in tensors of their own so the
    cache can be updated in place."""
    if not 0 <= length <= capacity:
        raise ValueError(f"a cache of {capacity} slots cannot hold "
                         f"{length} tokens")
    slots = torch.arange(capacity, dtype=torch.int32, device=device)
    return {
        "pos": slots.expand(batch, capacity).clone(),
        "valid": (slots < length).expand(batch, capacity).clone(),
        "index": torch.full((batch,), length % capacity, dtype=torch.int32,
                            device=device),
        "length": torch.full((batch,), length, dtype=torch.int32,
                             device=device),
    }


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int,
                  prefill_len: int | None = None, *, device="cuda") -> dict:
    """Empty (or "already saw prefill_len tokens") ring-buffer KV cache;
    the K/V slots are zeros."""
    Hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    out = {
        "k": torch.zeros((batch, capacity, Hkv, dh), dtype=cfg.dtype,
                         device=device),
        "v": torch.zeros((batch, capacity, Hkv, dh), dtype=cfg.dtype,
                         device=device),
    }
    out.update(_cache_bookkeeping(batch, capacity, prefill_len or 0,
                                  device=device))
    return out
