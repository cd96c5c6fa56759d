"""Language-model zoo: parameters, decode caches and the decode step.

Counterpart of ``repro/models/lm.py`` for the serving half of the dense
family (no MLA, no MoE)::

    params            = init_params(cfg, generator=g, device="cuda")
    params            = from_jax_params(jax_tree_as_numpy, cfg, device=...)
    cache             = init_cache(cfg, batch, capacity, prefill_len=...)
    logits, cache     = decode_step(params, cfg, tokens, cache)

Block parameters are stacked along a leading layer axis, as JAX's
``_stacked`` leaves them (``blocks["attn"]["wq"]`` is (L, D, H, dh)), so a
JAX parameter tree loads leaf for leaf; JAX's ``lax.scan`` over the
blocks is a Python loop over the layer index here.  The cache is stacked
the same way and updated in place (see :mod:`repro_torch.models.layers`).
A ``sliding_window`` config turns the ring buffer into the long-context
variant, whose attention is the ``swa_attention_decode`` kernel.

Every other family (MoE, MLA, SSM, hybrid, VLM, audio) raises
``NotImplementedError``: ROADMAP Queue A item 4 lists what is left.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

from .layers import (attention_decode, attention_shapes, dense_init,
                     init_attention, init_kv_cache, init_mlp, mlp, mlp_shapes,
                     rms_norm)

Params = Any


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.num_experts or cfg.kv_lora_rank:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family "
            f"{'with MLA ' if cfg.kv_lora_rank else ''}is not ported to "
            "PyTorch yet (ROADMAP Queue A item 4); the port has the dense "
            "family's decode path only")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _layer_shapes(cfg: ModelConfig) -> dict:
    """Leaf shapes of one dense block, in the JAX package's layout and
    key names (bias shapes whether or not the config has biases)."""
    D = cfg.d_model
    return {"ln1": (D,), "ln2": (D,), "attn": attention_shapes(cfg),
            "mlp": mlp_shapes(cfg, cfg.d_ff)}


def _top_shapes(cfg: ModelConfig) -> dict:
    out = {"embed": (cfg.vocab_size, cfg.d_model),
           "final_norm": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.d_model, cfg.vocab_size)
    return out


def _init_dense_layer(cfg: ModelConfig, gen: torch.Generator,
                      device) -> dict:
    return {"ln1": torch.ones(cfg.d_model, dtype=cfg.dtype, device=device),
            "ln2": torch.ones(cfg.d_model, dtype=cfg.dtype, device=device),
            "attn": init_attention(cfg, generator=gen, device=device),
            "mlp": init_mlp(cfg, cfg.d_ff, generator=gen, device=device)}


def _stack(trees: list[dict]) -> dict:
    """Leafwise stack of per-layer trees along a new leading axis (JAX's
    ``_stacked``: each layer initialised with its own fan-in)."""
    out = {}
    for k, v in trees[0].items():
        if isinstance(v, dict):
            out[k] = _stack([t[k] for t in trees])
        else:
            out[k] = None if v is None else torch.stack([t[k] for t in trees])
    return out


def init_params(cfg: ModelConfig, *,
                generator: torch.Generator | None = None,
                device: str = "cuda") -> Params:
    """Seeded random parameters in the JAX package's tree (``embed``
    normal·0.02, matrices normal/sqrt(fan_in), norms ones, biases zeros
    or None), each block initialised per layer and stacked.  The numbers
    come from ``generator`` (default: seed 0 on ``device``) and differ
    from ``jax.random``'s; load JAX's own with :func:`from_jax_params`."""
    _require_dense(cfg)
    gen = generator if generator is not None \
        else torch.Generator(device=device).manual_seed(0)
    p = {"embed": dense_init((cfg.vocab_size, cfg.d_model), cfg.dtype,
                             generator=gen, device=device, scale=0.02),
         "final_norm": torch.ones(cfg.d_model, dtype=cfg.dtype,
                                  device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init((cfg.d_model, cfg.vocab_size), cfg.dtype,
                                  generator=gen, device=device)
    p["blocks"] = _stack([_init_dense_layer(cfg, gen, device)
                          for _ in range(cfg.num_layers)])
    return p


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: same 16 bits
        return torch.from_numpy(a.view(np.uint16).copy()) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _convert(tree, shapes, cfg: ModelConfig, device, path: str):
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path or 'params'}: keys {got}, expected "
                             f"{sorted(shapes)}")
        return {k: _convert(tree[k], shapes[k], cfg, device, f"{path}/{k}")
                for k in shapes}
    if path.rsplit("/", 1)[-1].startswith("b") and not cfg.use_bias:
        if tree is not None:
            raise ValueError(f"{path}: a bias where {cfg.name} has none")
        return None
    t = _to_tensor(tree, device)
    if tuple(t.shape) != tuple(shapes) or t.dtype != cfg.dtype:
        raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype}, expected "
                         f"{tuple(shapes)} {cfg.dtype}")
    return t


def _stacked_shapes(shapes, n: int):
    if isinstance(shapes, dict):
        return {k: _stacked_shapes(v, n) for k, v in shapes.items()}
    return (n,) + tuple(shapes)


def from_jax_params(tree, cfg: ModelConfig, device: str = "cuda") -> Params:
    """The JAX package's ``lm.init_params`` tree, its leaves as numpy
    arrays (``jax.tree_util.tree_map(np.asarray, params)``, which keeps
    the None biases), as the port's parameters on ``device``: the same
    keys, layouts and dtypes, every shape checked against ``cfg``."""
    _require_dense(cfg)
    shapes = dict(_top_shapes(cfg))
    shapes["blocks"] = _stacked_shapes(_layer_shapes(cfg), cfg.num_layers)
    return _convert(tree, shapes, cfg, device, "")


def param_count(params: Params) -> int:
    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        return 0 if t is None else t.numel()
    return count(params)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, capacity: int, *,
               prefill_len: int = 0, device: str = "cuda") -> dict:
    """Per-layer ring-buffer KV caches stacked along a leading layer axis
    (``cache["blocks"]["k"]`` is (L, B, T, Hkv, dh)), zeros in every slot.
    ``capacity`` should be min(seq_len, sliding_window or seq_len)."""
    _require_dense(cfg)
    one = init_kv_cache(cfg, batch, capacity, prefill_len, device=device)
    L = cfg.num_layers
    return {"blocks": {k: t.unsqueeze(0).expand(L, *t.shape).contiguous()
                       for k, t in one.items()}}


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s view of a stacked tree (tensors are views, so
    in-place writes reach the stack)."""
    return {k: (_layer(v, i) if isinstance(v, dict)
                else None if v is None else v[i])
            for k, v in tree.items()}


def _dense_layer_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                        cache: dict, *, window: int | None
                        ) -> tuple[torch.Tensor, dict]:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache = attention_decode(p["attn"], cfg, h, cache, window=window)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(p["mlp"], cfg, h), cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict, *, window: Optional[int] = None
                ) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens: (B, 1) integer ids on the parameters'
    device.  Returns (logits (B, 1, V), cache), the cache updated in
    place."""
    _require_dense(cfg)
    window = window if window is not None else cfg.sliding_window
    x = params["embed"][tokens]
    for i in range(cfg.num_layers):
        x, _ = _dense_layer_decode(_layer(params["blocks"], i), cfg, x,
                                   _layer(cache["blocks"], i), window=window)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head, cache


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, tokens, cache):
        return decode_step(params, cfg, tokens, cache)
    return serve_step
