"""Language-model zoo: parameters, the forward (prefill), decode caches and
the decode step, for all six architecture families.

Counterpart of ``repro/models/lm.py``::

    params            = init_params(cfg, generator=g, device="cuda")
    params            = from_jax_params(jax_tree_as_numpy, cfg, device=...)
    logits, aux       = forward(params, cfg, batch)
    cache             = init_cache(cfg, batch, capacity, prefill_len=...)
    logits, cache     = decode_step(params, cfg, tokens, cache)
    total, metrics    = loss_fn(params, cfg, batch)
    total, m, grads   = loss_and_grads(params, cfg, batch)
    params, state, m  = make_train_step(cfg, opt)(params, state, batch)

Families: dense and MoE (GQA or DeepSeek's MLA attention; MoE FFNs after
``first_dense_layers`` dense ones, kept as the unstacked ``head_blocks``
list), SSM (Mamba2 SSD), hybrid (Hymba: attention and SSD over the same
input, mean-fused), VLM (super-blocks of self-attention layers, a gated
cross-attention to the projected vision tokens and a tail layer) and
audio (Whisper's encoder and a decoder with cross-attention, lists of
layers).

Homogeneous stacks are stacked along a leading layer axis, as JAX's
``_stacked`` leaves them (``blocks["attn"]["wq"]`` is (L, D, H, dh)), so
a JAX parameter tree loads leaf for leaf; JAX's ``lax.scan`` over a
stack is a Python loop over the layer index here.  With ``cfg.remat``
the forward recomputes each scanned unit in the backward
(``torch.utils.checkpoint``) where JAX wraps it in ``jax.checkpoint``.
The forward, loss and train step take JAX's sharding hooks
(``constrain``, ``constrain_logits``, ``constrain_grads``,
``constrain_block_params``), which :mod:`repro_torch.launch.steps` fills
from the sharding rules; with DTensor leaves on a ``DeviceMesh`` every
function here runs sharded (constants built inside take the input's
mesh: :func:`repro_torch.models.layers.const_like`).  The optimizer
steps the leaves in JAX's flattening order
(:func:`repro_torch.tree.tree_leaves`).
Caches are stacked the same way and updated in place (see
:mod:`repro_torch.models.layers`).  A ``sliding_window`` config turns
the ring buffers into the long-context variant.  Every decode attention
over a cache, cross-attention included, is the ``swa_attention_decode``
kernel; the SSM's decode is plain PyTorch.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import to_tensor, tree_leaves, tree_unflatten

from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import (_project, _unproject, add_bias, apply_rope, attention,
                     attention_decode, blocked_attention, const_like,
                     cross_attention, decode_attention, dense_init,
                     embed_lookup, init_attention,
                     init_cross_attention, init_kv_cache, init_mla,
                     init_mla_cache, init_mlp, mla_attention, mla_decode,
                     mlp, rms_norm)

Params = Any

_DENSE_KEYS = ("ln1", "ln2", "attn", "mlp")


# ---------------------------------------------------------------------------
# per-family layers
# ---------------------------------------------------------------------------

def _ones(cfg: ModelConfig, device) -> torch.Tensor:
    return torch.ones(cfg.d_model, dtype=cfg.dtype, device=device)


def _init_dense_layer(cfg: ModelConfig, gen: torch.Generator, device, *,
                      use_moe: bool) -> dict:
    p = {"ln1": _ones(cfg, device), "ln2": _ones(cfg, device)}
    p["attn"] = init_mla(cfg, generator=gen, device=device) \
        if cfg.kv_lora_rank \
        else init_attention(cfg, generator=gen, device=device)
    if use_moe:
        p["moe"] = moe_lib.init_moe(cfg, generator=gen, device=device)
    else:
        p["mlp"] = init_mlp(cfg, cfg.d_ff, generator=gen, device=device)
    return p


def _dense_layer_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                     positions: torch.Tensor, window: int | None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.kv_lora_rank:
        a, _ = mla_attention(p["attn"], cfg, h, positions=positions)
    else:
        a, _ = attention(p["attn"], cfg, h, positions=positions,
                         window=window)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        f, aux = moe_lib.moe_ffn(p["moe"], cfg, h)
    else:
        f, aux = mlp(p["mlp"], cfg, h), None
    return x + f, aux


def _dense_layer_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                        cache: dict, *, window: int | None
                        ) -> tuple[torch.Tensor, dict]:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.kv_lora_rank:
        a, cache = mla_decode(p["attn"], cfg, h, cache, window=window)
    else:
        a, cache = attention_decode(p["attn"], cfg, h, cache, window=window)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        f, _ = moe_lib.moe_ffn(p["moe"], cfg, h)
    else:
        f = mlp(p["mlp"], cfg, h)
    return x + f, cache


def _init_ssm_layer(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    return {"ln": _ones(cfg, device),
            "ssm": ssm_lib.init_ssm(cfg, generator=gen, device=device)}


def _ssm_layer_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    y, _ = ssm_lib.ssm_forward(p["ssm"], cfg, h)
    return x + y


def _ssm_layer_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      cache: dict):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    y, cache = ssm_lib.ssm_decode(p["ssm"], cfg, h, cache)
    return x + y, cache


def _init_hybrid_layer(cfg: ModelConfig, gen: torch.Generator,
                       device) -> dict:
    return {"ln1": _ones(cfg, device), "ln2": _ones(cfg, device),
            "attn": init_attention(cfg, generator=gen, device=device),
            "ssm": ssm_lib.init_ssm(cfg, generator=gen, device=device),
            "mlp": init_mlp(cfg, cfg.d_ff, generator=gen, device=device)}


def _hybrid_layer_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                      positions: torch.Tensor, window: int | None):
    """Hymba's parallel heads: attention ∥ SSD over the same normed
    input, mean-fused. [arXiv:2411.13676]"""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, _ = attention(p["attn"], cfg, h, positions=positions, window=window)
    s, _ = ssm_lib.ssm_forward(p["ssm"], cfg, h)
    x = x + 0.5 * (a + s)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(p["mlp"], cfg, h)


def _hybrid_layer_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                         cache: dict, *, window: int | None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, _ = attention_decode(p["attn"], cfg, h, cache["attn"], window=window)
    s, _ = ssm_lib.ssm_decode(p["ssm"], cfg, h, cache["ssm"])
    x = x + 0.5 * (a + s)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(p["mlp"], cfg, h), cache


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

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


def _layer_counts(cfg: ModelConfig) -> tuple[int, int]:
    """Dense / MoE family: (unstacked head layers, stacked layers)."""
    n_head = cfg.first_dense_layers if cfg.num_experts else 0
    return n_head, cfg.num_layers - n_head


def _vlm_counts(cfg: ModelConfig) -> tuple[int, int]:
    """VLM: (super-blocks, self-attention layers in each)."""
    return cfg.num_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1


def init_params(cfg: ModelConfig, *,
                generator: torch.Generator | None = None,
                device: str = "cuda") -> Params:
    """Seeded random parameters in the JAX package's tree (``embed``
    normal·0.02, matrices normal/sqrt(fan_in), norms ones, biases zeros
    or None, the VLM's gates zero), each stacked layer initialised on
    its own and stacked.  The numbers come from ``generator`` (default:
    seed 0 on ``device``) and differ from ``jax.random``'s; load JAX's
    own with :func:`from_jax_params`."""
    gen = generator if generator is not None \
        else torch.Generator(device=device).manual_seed(0)
    p = {"embed": dense_init((cfg.vocab_size, cfg.d_model), cfg.dtype,
                             generator=gen, device=device, scale=0.02),
         "final_norm": _ones(cfg, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init((cfg.d_model, cfg.vocab_size), cfg.dtype,
                                  generator=gen, device=device)

    def dense(use_moe=False):
        return _init_dense_layer(cfg, gen, device, use_moe=use_moe)

    fam = cfg.family
    if fam in ("dense", "moe"):
        n_head, n_stack = _layer_counts(cfg)
        if n_head:
            p["head_blocks"] = [dense() for _ in range(n_head)]
        p["blocks"] = _stack([dense(bool(cfg.num_experts))
                              for _ in range(n_stack)])
    elif fam == "ssm":
        p["blocks"] = _stack([_init_ssm_layer(cfg, gen, device)
                              for _ in range(cfg.num_layers)])
    elif fam == "hybrid":
        p["blocks"] = _stack([_init_hybrid_layer(cfg, gen, device)
                              for _ in range(cfg.num_layers)])
    elif fam == "vlm":
        n_super, inner = _vlm_counts(cfg)

        def init_super():
            return {"self": _stack([dense() for _ in range(inner)]),
                    "cross": init_cross_attention(cfg, generator=gen,
                                                  device=device),
                    "ln_cross": _ones(cfg, device),
                    "gate": torch.zeros((), dtype=cfg.dtype, device=device),
                    "tail": dense()}

        p["blocks"] = _stack([init_super() for _ in range(n_super)])
        p["vis_proj"] = dense_init((cfg.vision_dim, cfg.d_model), cfg.dtype,
                                   generator=gen, device=device)
    elif fam == "audio":
        p["enc_blocks"] = [dense() for _ in range(cfg.encoder_layers)]
        p["enc_norm"] = _ones(cfg, device)

        def init_dec():
            d = dense()
            d["cross"] = init_cross_attention(cfg, generator=gen,
                                              device=device)
            d["ln_cross"] = _ones(cfg, device)
            return d

        p["dec_blocks"] = [init_dec() for _ in range(cfg.num_layers)]
    else:
        raise ValueError(fam)
    return p


def _convert(tree, like, cfg: ModelConfig, device, path: str):
    """``tree`` as tensors on ``device``, each leaf checked against the
    shape and dtype of ``like``'s (a meta-device ``init_params``)."""
    where = path or "params"
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{where}: keys {got}, expected {sorted(like)}")
        return {k: _convert(tree[k], like[k], cfg, device, f"{path}/{k}")
                for k in like}
    if isinstance(like, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError(f"{where}: {type(tree).__name__} where a list "
                             f"of {len(like)} layers was expected")
        return [_convert(t, s, cfg, device, f"{path}/{i}")
                for i, (t, s) in enumerate(zip(tree, like))]
    if like is None:
        if tree is not None:
            raise ValueError(f"{where}: a bias where {cfg.name} has none")
        return None
    t = to_tensor(tree, device)
    if t.shape != like.shape or t.dtype != like.dtype:
        raise ValueError(f"{where}: {tuple(t.shape)} {t.dtype}, expected "
                         f"{tuple(like.shape)} {like.dtype}")
    return t


def from_jax_params(tree, cfg: ModelConfig, device: str = "cuda") -> Params:
    """The JAX package's ``lm.init_params`` tree, its leaves as numpy
    arrays (``jax.tree_util.tree_map(np.asarray, params)``, which keeps
    the None biases and the layer lists), as the port's parameters on
    ``device``: the keys, lists, shapes and dtypes of :func:`init_params`
    (the SSM's ``A_log``, ``D`` and ``dt_bias`` fp32 in every config),
    each leaf checked."""
    like = init_params(cfg, generator=torch.Generator(), device="meta")
    return _convert(tree, like, cfg, device, "")


def param_count(params: Params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _layers(tree: dict) -> list[dict]:
    """Every layer's view of a stacked tree, by one ``torch.unbind`` a
    leaf: in-place writes reach the stack, and under autograd the
    gradients of all layers are stacked once, where indexing layer by
    layer would add a zero-filled gradient of the whole stack a layer."""
    n = tree_leaves(tree)[0].shape[0]
    out: list[dict] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _layers(v) if isinstance(v, dict) \
            else [None] * n if v is None else v.unbind(0)
        for layer, part in zip(out, parts):
            layer[k] = part
    return out


def _encode(params: Params, cfg: ModelConfig,
            frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over precomputed frame embeddings (B, Te, D):
    non-causal self-attention with rope at the frame positions."""
    enc = frames
    enc_pos = const_like(enc, torch.arange(enc.shape[1], dtype=torch.int32,
                                           device=enc.device))
    for lp in params["enc_blocks"]:
        a = lp["attn"]
        h = rms_norm(enc, lp["ln1"], cfg.norm_eps)
        q = add_bias(_project(h, a["wq"]), a.get("bq"))
        k = add_bias(_project(h, a["wk"]), a.get("bk"))
        v = add_bias(_project(h, a["wv"]), a.get("bv"))
        q = apply_rope(q, enc_pos, cfg.rope_theta)
        k = apply_rope(k, enc_pos, cfg.rope_theta)
        o = blocked_attention(q, k, v, q_positions=enc_pos,
                              kv_positions=enc_pos, causal=False,
                              window=None)
        enc = enc + add_bias(_unproject(o, a["wo"]), a.get("bo"))
        h = rms_norm(enc, lp["ln2"], cfg.norm_eps)
        enc = enc + mlp(lp["mlp"], cfg, h)
    return rms_norm(enc, params["enc_norm"], cfg.norm_eps)


def _maybe_remat(f, cfg: ModelConfig):
    """``f`` recomputed in the backward when ``cfg.remat`` is set and
    autograd records the call (JAX's ``_maybe_remat``): only the unit's
    inputs are kept, not its intermediates.  A forward that records
    nothing (prefill, decode) runs ``f`` as it is."""
    if not cfg.remat:
        return f

    def run(*args):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in tree_leaves(args)
                if isinstance(t, torch.Tensor)):
            return torch.utils.checkpoint.checkpoint(f, *args,
                                                     use_reentrant=False)
        return f(*args)
    return run


def forward(params: Params, cfg: ModelConfig, batch: dict, *,
            window: Optional[int] = None, constrain=None,
            constrain_block_params=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (prefill, and training under autograd).
    batch: {"tokens": (B, S) integer ids, and for the VLM "vision":
    (B, Tv, vision_dim), for audio "frames": (B, Te, D)}, on the
    parameters' device.  Returns (logits (B, S, V), the MoE layers'
    summed aux loss, fp32 0-dim).  The units JAX scans under remat (a
    dense or MoE block of the stack, an SSM block, a hybrid block, a VLM
    super-block) go through :func:`_maybe_remat`; ``head_blocks`` and
    Whisper's layer lists do not, as in JAX.

    The sharding hooks, as in JAX (identity when None): ``constrain``
    lays out the residual stream after the embedding and after each unit
    of a stack; ``constrain_block_params`` lays out each layer's slice of
    a stack (dense, MoE, SSM, hybrid) as the unit takes it, so that its
    gradient comes back in that layout.  Both run inside the
    recomputed unit."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    window = window if window is not None else cfg.sliding_window
    constrain = constrain or (lambda t: t)
    cbp = constrain_block_params or (lambda t: t)
    x = constrain(embed_lookup(params["embed"], tokens))
    dev = x.device
    positions = const_like(x, torch.arange(S, dtype=torch.int32, device=dev))
    aux_total = const_like(x, torch.zeros((), dtype=torch.float32,
                                          device=dev))
    fam = cfg.family

    if fam in ("dense", "moe"):
        for lp in params.get("head_blocks", []):
            x, aux = _dense_layer_fwd(lp, cfg, x, positions=positions,
                                      window=window)
            if aux is not None:
                aux_total = aux_total + aux

        def dense_blk(x, aux_total, lp):
            x, aux = _dense_layer_fwd(cbp(lp), cfg, x, positions=positions,
                                      window=window)
            return constrain(x), \
                aux_total if aux is None else aux_total + aux

        blk = _maybe_remat(dense_blk, cfg)
        for lp in _layers(params["blocks"]):
            x, aux_total = blk(x, aux_total, lp)
    elif fam == "ssm":
        blk = _maybe_remat(
            lambda x, lp: constrain(_ssm_layer_fwd(cbp(lp), cfg, x)), cfg)
        for lp in _layers(params["blocks"]):
            x = blk(x, lp)
    elif fam == "hybrid":
        blk = _maybe_remat(
            lambda x, lp: constrain(_hybrid_layer_fwd(
                cbp(lp), cfg, x, positions=positions, window=window)), cfg)
        for lp in _layers(params["blocks"]):
            x = blk(x, lp)
    elif fam == "vlm":
        memory = batch["vision"] @ params["vis_proj"]

        def super_blk(x, memory, lp):
            for sp in _layers(lp["self"]):
                x, _ = _dense_layer_fwd(sp, cfg, x, positions=positions,
                                        window=window)
            h = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
            x = x + torch.tanh(lp["gate"]) * cross_attention(
                lp["cross"], cfg, h, memory)
            x, _ = _dense_layer_fwd(lp["tail"], cfg, x, positions=positions,
                                    window=window)
            return constrain(x)

        blk = _maybe_remat(super_blk, cfg)
        for lp in _layers(params["blocks"]):
            x = blk(x, memory, lp)
    elif fam == "audio":
        enc = _encode(params, cfg, batch["frames"])
        for lp in params["dec_blocks"]:
            x, _ = _dense_layer_fwd({k: lp[k] for k in _DENSE_KEYS}, cfg, x,
                                    positions=positions, window=window)
            h = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
            x = x + cross_attention(lp["cross"], cfg, h, enc)
    else:
        raise ValueError(fam)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head, aux_total


# ---------------------------------------------------------------------------
# loss / train step
# ---------------------------------------------------------------------------

def loss_fn(params: Params, cfg: ModelConfig, batch: dict, *,
            aux_weight: float = 0.01, constrain=None, constrain_logits=None,
            constrain_block_params=None
            ) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy over ``batch["labels"]`` (B, S), labels
    < 0 masked out: the fp32 log-softmax's NLL summed over the kept
    labels and divided by max(their count, 1).  Returns (loss +
    aux_weight · aux, {"loss", "aux"}).  A masked label is clamped to
    class 0 before the gather (``torch.gather`` refuses −1, where JAX's
    ``take_along_axis`` wraps it); the mask zeroes it either way.
    ``constrain_logits`` lays out the logits before the loss; the other
    hooks go to :func:`forward`."""
    logits, aux = forward(params, cfg, batch, constrain=constrain,
                          constrain_block_params=constrain_block_params)
    if constrain_logits is not None:
        logits = constrain_logits(logits)
    labels = batch["labels"].to(torch.int64)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    loss = torch.sum(nll * mask) / torch.clamp_min(mask.sum(), 1.0)
    return loss + aux_weight * aux, {"loss": loss, "aux": aux}


def loss_and_grads(params: Params, cfg: ModelConfig, batch: dict, **hooks
                   ) -> tuple[torch.Tensor, dict, list[torch.Tensor]]:
    """(total loss, {"loss", "aux"}, the gradient of every leaf in
    :func:`tree_leaves` order), all detached: ``jax.value_and_grad`` of
    :func:`loss_fn` (a leaf the loss does not reach gets zeros).
    ``hooks``: :func:`loss_fn`'s sharding hooks."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    total, metrics = loss_fn(tree_unflatten(params, leaves), cfg, batch,
                             **hooks)
    grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                materialize_grads=True)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            list(grads))


def make_train_step(cfg: ModelConfig, optimizer, *, microbatches: int = 1,
                    constrain=None, constrain_logits=None,
                    accum_dtype: torch.dtype = torch.float32,
                    constrain_grads=None, constrain_block_params=None):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``, the state ``optimizer.init(tree_leaves(params))``
    (the optimizer steps the leaves in :func:`tree_leaves` order).

    ``microbatches`` > 1 accumulates gradients: the batch splits along
    dim 0 into that many contiguous slices (JAX's ``reshape((m, B//m)
    + …)``), each slice's gradients are cast to ``accum_dtype`` and
    added, and gradients and metrics are divided by ``microbatches``, so
    activation memory scales with the slice.  Metrics are detached fp32
    0-dim tensors.

    The sharding hooks, as in JAX (identity when None): ``constrain``,
    ``constrain_logits`` and ``constrain_block_params`` go to
    :func:`loss_fn`; ``constrain_grads`` lays out each microbatch's
    gradient list (in :func:`tree_leaves` order) before it is added."""
    hooks = {"constrain": constrain, "constrain_logits": constrain_logits,
             "constrain_block_params": constrain_block_params}
    cg = constrain_grads or (lambda g: g)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            _, metrics, grads = loss_and_grads(params, cfg, batch, **hooks)
            grads = cg(grads)
        else:
            B = batch["tokens"].shape[0]
            if B % microbatches:
                raise ValueError(f"a batch of {B} does not split into "
                                 f"{microbatches} microbatches")
            n = B // microbatches
            grads = [torch.zeros_like(p, dtype=accum_dtype)
                     for p in tree_leaves(params)]
            zero = torch.zeros((), dtype=torch.float32,
                               device=grads[0].device)
            metrics = {k: const_like(grads[0], zero) for k in ("loss", "aux")}
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                _, m, g = loss_and_grads(params, cfg, mb, **hooks)
                for acc, gi in zip(grads, cg(g)):
                    acc.add_(gi.to(acc.dtype))
                metrics = {k: metrics[k] + m[k] for k in metrics}
                del g
            grads = [g / microbatches for g in grads]
            metrics = {k: v / microbatches for k, v in metrics.items()}
        leaves, opt_state = optimizer.step(tree_leaves(params), grads,
                                           opt_state)
        return tree_unflatten(params, leaves), opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _stack_cache(one: dict, n: int) -> dict:
    """``n`` copies of a cache tree along a new leading axis, each its own
    memory (the stack is written in place)."""
    return {k: _stack_cache(t, n) if isinstance(t, dict)
            else t.unsqueeze(0).expand(n, *t.shape).contiguous()
            for k, t in one.items()}


def init_cache(cfg: ModelConfig, batch: int, capacity: int, *,
               prefill_len: int = 0, extras: dict | None = None,
               device: str = "cuda") -> dict:
    """Per-layer decode caches, stacked where the parameters are
    (``cache["blocks"]["k"]`` is (L, B, T, Hkv, dh)), zeros in every slot.
    ``capacity`` should be min(seq_len, sliding_window or seq_len).

    ``extras`` is accepted and ignored, as the JAX package ignores it:
    the VLM's and audio's cross K/V stay zeros until a caller writes
    them."""
    del extras
    fam = cfg.family

    def kv():
        return init_kv_cache(cfg, batch, capacity, prefill_len,
                             device=device)

    def cross(T):
        return torch.zeros((batch, T, cfg.num_kv_heads,
                            cfg.resolved_head_dim), dtype=cfg.dtype,
                           device=device)

    if fam in ("dense", "moe"):
        def mk():
            return init_mla_cache(cfg, batch, capacity, prefill_len,
                                  device=device) if cfg.kv_lora_rank \
                else kv()
        n_head, n_stack = _layer_counts(cfg)
        cache = {"blocks": _stack_cache(mk(), n_stack)}
        if n_head:
            cache["head_blocks"] = [mk() for _ in range(n_head)]
        return cache
    if fam == "ssm":
        return {"blocks": _stack_cache(
            ssm_lib.init_ssm_cache(cfg, batch, device=device),
            cfg.num_layers)}
    if fam == "hybrid":
        return {"blocks": _stack_cache(
            {"attn": kv(),
             "ssm": ssm_lib.init_ssm_cache(cfg, batch, device=device)},
            cfg.num_layers)}
    if fam == "vlm":
        n_super, inner = _vlm_counts(cfg)
        return {"blocks": _stack_cache(
            {"self": _stack_cache(kv(), inner), "tail": kv(),
             "cross_k": cross(cfg.vision_tokens),
             "cross_v": cross(cfg.vision_tokens)}, n_super)}
    if fam == "audio":
        return {"dec_blocks": [
            {"self": kv(), "cross_k": cross(cfg.encoder_seq),
             "cross_v": cross(cfg.encoder_seq)}
            for _ in range(cfg.num_layers)]}
    raise ValueError(fam)


def _cross_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  k_cache: torch.Tensor, v_cache: torch.Tensor
                  ) -> torch.Tensor:
    """One-token cross-attention against precomputed memory K/V: the
    decode attention with every slot valid at position 0 and the query
    at 0, no window."""
    B, T = k_cache.shape[:2]
    q = add_bias(_project(x, p["wq"]), p.get("bq"))
    dev = x.device
    out = decode_attention(
        q, k_cache, v_cache,
        q_position=const_like(x, torch.zeros((B,), dtype=torch.int32,
                                             device=dev)),
        kv_positions=const_like(x, torch.zeros((B, T), dtype=torch.int32,
                                               device=dev)),
        window=None,
        kv_valid=const_like(x, torch.ones((B, T), dtype=torch.bool,
                                          device=dev)))
    return add_bias(_unproject(out, p["wo"]), p.get("bo"))


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict, *, window: Optional[int] = None
                ) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens: (B, 1) integer ids on the parameters'
    device.  Returns (logits (B, 1, V), cache), the cache updated in
    place."""
    window = window if window is not None else cfg.sliding_window
    x = embed_lookup(params["embed"], tokens)
    fam = cfg.family

    if fam in ("dense", "moe"):
        for lp, lc in zip(params.get("head_blocks", []),
                          cache.get("head_blocks", [])):
            x, _ = _dense_layer_decode(lp, cfg, x, lc, window=window)
        for lp, lc in zip(_layers(params["blocks"]),
                          _layers(cache["blocks"])):
            x, _ = _dense_layer_decode(lp, cfg, x, lc, window=window)
    elif fam == "ssm":
        for lp, lc in zip(_layers(params["blocks"]),
                          _layers(cache["blocks"])):
            x, _ = _ssm_layer_decode(lp, cfg, x, lc)
    elif fam == "hybrid":
        for lp, lc in zip(_layers(params["blocks"]),
                          _layers(cache["blocks"])):
            x, _ = _hybrid_layer_decode(lp, cfg, x, lc, window=window)
    elif fam == "vlm":
        for lp, lc in zip(_layers(params["blocks"]),
                          _layers(cache["blocks"])):
            for sp, sc in zip(_layers(lp["self"]), _layers(lc["self"])):
                x, _ = _dense_layer_decode(sp, cfg, x, sc, window=window)
            h = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
            x = x + torch.tanh(lp["gate"]) * _cross_decode(
                lp["cross"], cfg, h, lc["cross_k"], lc["cross_v"])
            x, _ = _dense_layer_decode(lp["tail"], cfg, x, lc["tail"],
                                       window=window)
    elif fam == "audio":
        for lp, lc in zip(params["dec_blocks"], cache["dec_blocks"]):
            x, _ = _dense_layer_decode({k: lp[k] for k in _DENSE_KEYS}, cfg,
                                       x, lc["self"], window=window)
            h = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
            x = x + _cross_decode(lp["cross"], cfg, h, lc["cross_k"],
                                  lc["cross_v"])
    else:
        raise ValueError(fam)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head, cache


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, tokens, cache):
        return decode_step(params, cfg, tokens, cache)
    return serve_step
