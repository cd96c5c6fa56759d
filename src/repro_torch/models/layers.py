"""Transformer building blocks shared by the LM zoo.

Counterpart of ``repro/models/layers.py``: initialisers, RMSNorm and
the Mamba2 gated norm, rotary embeddings, the MLPs, full-sequence GQA
attention (``blocked_attention``, the online-softmax recurrence over KV
blocks, in plain PyTorch as the JAX package leaves it to XLA), one-token
GQA attention against a ring-buffer KV cache through the
``swa_attention_decode`` kernel, cross-attention to a static memory,
DeepSeek's multi-head latent attention (MLA) for prefill and decode,
and the caches.

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

from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import NEG_INF

# -- DTensor leaves -------------------------------------------------------------

def const_like(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t``, a constant built inside the model (positions, masks, zeros),
    on ``x``'s mesh when ``x`` is a DTensor: replicated, since every rank
    builds the same values.  A plain ``x`` leaves ``t`` as it is."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return t


def replicated(t: torch.Tensor) -> torch.Tensor:
    """A DTensor redistributed to every rank whole, before an op DTensor
    has no sharding rule for (GSPMD would do the same); a plain tensor as
    it is."""
    if isinstance(t, DTensor):
        mesh = t.device_mesh
        return t.redistribute(mesh, [Replicate()] * mesh.ndim)
    return t


def pad_dim(t: torch.Tensor, dim: int, before: int, after: int,
            value=0) -> torch.Tensor:
    """``F.pad`` of one dim by ``before`` / ``after`` entries of ``value``.
    On a DTensor each rank pads its own shard, the dim made whole first
    (DTensor's own rule for the pad miscounts mesh dims on some
    releases)."""
    dim = dim % t.dim()
    pads = (0, 0) * (t.dim() - 1 - dim) + (before, after)
    if not isinstance(t, DTensor):
        return F.pad(t, pads, value=value)
    mesh = t.device_mesh
    pl = [Replicate() if p.is_shard(dim) else p for p in t.placements]
    local = F.pad(t.redistribute(mesh, pl).to_local(), pads, value=value)
    shape = list(t.shape)
    shape[dim] += before + after
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``: (B, S) ids → (B, S, D) rows.  On DTensors the
    ids are gathered first (the index op's sharding rule refuses ids
    split over two mesh dims, as (pod, data) splits a batch) and the rows
    then laid out on the batch as the ids were."""
    if not isinstance(tokens, DTensor):
        return table[tokens]
    x = table[replicated(tokens)]
    return x.redistribute(x.device_mesh, [
        Shard(0) if p.is_shard(0) else Replicate()
        for p in tokens.placements])


def on_replicas(f):
    """``f`` for DTensor arguments it has no sharding rules for: each
    DTensor argument replicated, ``f`` run on every rank's whole local
    copy, its tensor results returned as replicated DTensors on the same
    mesh (autograd passes through).  Without a DTensor argument ``f``
    runs as it is."""
    def run(*args):
        flat, spec = torch.utils._pytree.tree_flatten(args)
        mesh = next((a.device_mesh for a in flat if isinstance(a, DTensor)),
                    None)
        if mesh is None:
            return f(*args)
        local = [replicated(a).to_local() if isinstance(a, DTensor) else a
                 for a in flat]
        out = f(*torch.utils._pytree.tree_unflatten(local, spec))
        rep = [Replicate()] * mesh.ndim
        return torch.utils._pytree.tree_map(
            lambda t: DTensor.from_local(t, mesh, rep, run_check=False)
            if isinstance(t, torch.Tensor) else t, out)
    return run


def write_slots_(slot: torch.Tensor, *writes) -> None:
    """``buf[b, slot[b]] = value[b]`` for every lane b and every (buf,
    value) pair of ``writes``, in place (a ring cache's write).  On a
    DTensor each rank writes into its own shard: ``value`` and ``slot``
    take the cache's layout, and where the slots (dim 1) are sharded
    only the rank that holds a lane's slot changes it.  Data-independent
    shapes throughout, so a trace on meta shards runs it."""
    lanes = None
    for buf, value in writes:
        if isinstance(buf, DTensor):
            _write_shard_(buf, slot, value)
            continue
        if lanes is None:
            lanes = torch.arange(buf.shape[0], device=buf.device)
        buf[lanes, slot] = value


def _write_shard_(buf, slot, value) -> None:
    mesh = buf.device_mesh
    vpl, spl, off = [], [], 0
    for i, p in enumerate(buf.placements):
        if p.is_shard(0):                       # lanes
            vpl.append(Shard(0))
            spl.append(Shard(0))
        elif p.is_shard(1):                     # slots: one mesh dim only
            if off:
                raise NotImplementedError("slots sharded over two mesh dims")
            off = mesh.get_local_rank(i) * -(-buf.shape[1] // mesh.size(i))
            vpl.append(Replicate())
            spl.append(Replicate())
        elif p.is_shard():                      # a trailing dim of the slot
            vpl.append(Shard(p.dim - 1))
            spl.append(Replicate())
        else:
            vpl.append(Replicate())
            spl.append(Replicate())
    local = buf.to_local()
    s = slot.redistribute(mesh, spl).to_local().long() - off
    inside = (s >= 0) & (s < local.shape[1])
    s = torch.where(inside, s, 0)
    bidx = torch.arange(local.shape[0], device=local.device)
    cur = local[bidx, s]
    v = value.redistribute(mesh, vpl).to_local() \
        if isinstance(value, DTensor) else torch.full_like(cur, value)
    keep = inside.reshape(-1, *([1] * (cur.dim() - 1)))
    local[bidx, s] = torch.where(keep, v.to(cur.dtype), cur)


# -- initialisers -------------------------------------------------------------

def dense_init(shape, dtype: torch.dtype, *, generator: torch.Generator,
               device, scale: float | None = None) -> torch.Tensor:
    """Normal(0, 1) · scale in fp32, cast to ``dtype``; ``scale`` defaults
    to 1/sqrt(fan_in) with JAX's fan-in rule (the first dim of a matrix,
    the product of all but the last dim of a higher-rank tensor).  Drawn
    from ``generator`` on its own device, then moved to ``device``; on
    the ``meta`` device nothing is drawn."""
    if torch.device(device).type == "meta":     # shapes and dtypes only
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
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


def gated_rms_norm(x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Mamba2 output norm: RMSNorm(x * silu(z)), the gate in fp32 cast
    to x's dtype before the product."""
    return rms_norm(x * F.silu(z.to(torch.float32)).to(x.dtype), weight,
                    eps)


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
    freqs = const_like(x, rope_freqs(dh, theta, device=x.device))  # (dh/2,)
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


# -- blocked attention core ---------------------------------------------------

#: padding positions past Skv: above every real position, so a causal
#: mask drops them whatever ``kv_valid`` says
_PAD_POSITION = np.iinfo(np.int32).max // 2


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor, kv_positions: torch.Tensor,
                      causal: bool, window: int | None, kv_block: int = 512,
                      kv_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Online-softmax attention, blocked over KV, op for op the JAX
    package's recurrence: KV padded to whole blocks of ``kv_block`` (the
    padding at position ``int32 max // 2`` and invalid), ``q · scale``
    in fp32, masked scores set to the finite ``NEG_INF``, fp32 running
    max, sum and accumulator, and ``acc / max(l, 1e-30)`` cast to q's
    dtype.  No (Sq × Skv) score tensor forms beyond one block.

    q: (B, Sq, H, dh); k, v: (B, Skv, Hkv, dh) with H = G·Hkv.
    positions: (Sq,) and (Skv,) absolute token indices.  ``kv_valid``:
    optional (B, Skv) bool mask.  Returns (B, Sq, H, dh)."""
    B, Sq, H, dh = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    dev = q.device
    # (B, Hkv, Sq·G, dh): each kv head's queries as the rows of one product
    qg = (q.reshape(B, Sq, Hkv, G, dh).to(torch.float32)
          * float(1.0 / np.sqrt(dh))).permute(0, 2, 1, 3, 4) \
        .reshape(B, Hkv, Sq * G, dh)
    nb = -(-Skv // kv_block)
    pad = nb * kv_block - Skv
    if pad:
        k = pad_dim(k, 1, 0, pad)
        v = pad_dim(v, 1, 0, pad)
        kv_positions = pad_dim(kv_positions, 0, 0, pad, _PAD_POSITION)
        if kv_valid is None:
            kv_valid = const_like(q, (torch.arange(
                nb * kv_block, device=dev) < Skv).expand(B, nb * kv_block))
        else:
            kv_valid = pad_dim(kv_valid, 1, 0, pad, False)
    elif kv_valid is None:
        kv_valid = const_like(q, torch.ones((B, Skv), dtype=torch.bool,
                                            device=dev))
    qp = q_positions.reshape(1, 1, Sq, 1, 1)

    # the running statistics take qg's layout (zeros_like keeps a
    # DTensor's placements)
    acc = torch.zeros_like(qg.reshape(B, Hkv, Sq, G, dh))
    m = torch.full_like(acc[..., 0], NEG_INF)
    l = torch.zeros_like(m)
    for b in range(nb):
        blk = slice(b * kv_block, (b + 1) * kv_block)
        kb = k[:, blk].to(torch.float32).permute(0, 2, 3, 1)   # (B,Hkv,dh,t)
        vb = v[:, blk].to(torch.float32).permute(0, 2, 1, 3)   # (B,Hkv,t,dh)
        pb = kv_positions[blk].reshape(1, 1, 1, 1, kv_block)
        s = (qg @ kb).reshape(B, Hkv, Sq, G, kv_block)
        mask = kv_valid[:, blk].reshape(B, 1, 1, 1, kv_block)
        if causal:
            mask = mask & (qp >= pb)
        if window is not None:
            mask = mask & (qp - window < pb)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = (p.reshape(B, Hkv, Sq * G, kv_block) @ vb) \
            .reshape(B, Hkv, Sq, G, dh)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    # a dense copy before the reshape: a DTensor's global strides can call
    # its permuted local shard contiguous, and the reshape would then view
    # the shard where it must copy it
    return out.permute(0, 2, 1, 3, 4) \
        .clone(memory_format=torch.contiguous_format) \
        .reshape(B, Sq, H, dh).to(q.dtype)


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
    q3 = q.reshape(B, H, dh)
    args = (q3, k_cache, v_cache, kv_positions, kv_valid, q_position)
    if isinstance(q, DTensor):
        out, = local_map(
            lambda *a: (_decode_shard(*a, window=window),),
            **_decode_placements(q3, k_cache), redistribute_inputs=True,
            device_mesh=q.device_mesh)(*args)
    else:
        out = ops.swa_attention_decode(*args, window=window)
    return out.reshape(B, 1, H, dh)


def _decode_shard(*args, window):
    """The decode attention on one rank's shards.  A dry-run traces on
    meta shards (shapes only): there the plain version's ops stand for
    the kernel's work; the kernel's dispatcher refuses meta tensors."""
    if args[0].is_meta:
        return ref.swa_attention_decode(*args, window)
    return ops.swa_attention_decode(*args, window=window)


def _decode_placements(q: torch.Tensor, k_cache: torch.Tensor) -> dict:
    """The layout the decode kernel runs in on each rank: lanes split
    where the cache splits them, heads where it splits its kv heads
    (whole groups of G query heads with them), everything else whole
    (a cache split along its slots is gathered)."""
    mesh = k_cache.device_mesh
    rep = Replicate()
    qp, kp, bp = [], [], []          # q / out and K/V, positions and valid
    for i, p in enumerate(k_cache.placements):
        n = mesh.size(i)
        if p.is_shard(0) and q.shape[0] % n == 0:
            qp.append(Shard(0))
            kp.append(Shard(0))
            bp.append(Shard(0))
        elif p.is_shard(2) and k_cache.shape[2] % n == 0:
            qp.append(Shard(1))
            kp.append(Shard(2))
            bp.append(rep)
        else:
            qp.append(rep)
            kp.append(rep)
            bp.append(rep)
    qp, kp, bp = tuple(qp), tuple(kp), tuple(bp)
    return {"in_placements": (qp, kp, kp, bp, bp, bp),
            "out_placements": (qp,)}


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
    q = add_bias(_project(x, p["wq"]), p.get("bq"))
    k = add_bias(_project(x, p["wk"]), p.get("bk"))
    v = add_bias(_project(x, p["wv"]), p.get("bv"))
    pos = cache["length"]                       # (B,) absolute position
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    T = cache["k"].shape[1]
    slot = cache["index"]                       # (B,)
    write_slots_(slot, (cache["k"], k[:, 0]), (cache["v"], v[:, 0]),
                 (cache["pos"], pos), (cache["valid"], True))
    out = decode_attention(q, cache["k"], cache["v"], q_position=pos,
                           kv_positions=cache["pos"], window=window,
                           kv_valid=cache["valid"])
    out = add_bias(_unproject(out, p["wo"]), p.get("bo"))
    slot.add_(1).remainder_(T)
    pos.add_(1)
    return out, cache


def attention(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
              positions: torch.Tensor, window: int | None = None,
              kv_block: int = 512
              ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence (train / prefill) causal GQA self-attention.
    Returns (out, (k, v)), as the JAX package does."""
    q = add_bias(_project(x, p["wq"]), p.get("bq"))
    k = add_bias(_project(x, p["wk"]), p.get("bk"))
    v = add_bias(_project(x, p["wv"]), p.get("bv"))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = blocked_attention(q, k, v, q_positions=positions,
                            kv_positions=positions, causal=True,
                            window=window, kv_block=kv_block)
    return add_bias(_unproject(out, p["wo"]), p.get("bo")), (k, v)


def _unproject(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", x, w) as one matrix product."""
    h, k, D = w.shape
    return x.reshape(*x.shape[:-2], h * k) @ w.reshape(h * k, D)


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


# -- cross attention (VLM / enc-dec) ------------------------------------------

def init_cross_attention(cfg: ModelConfig, *, generator: torch.Generator,
                         device) -> dict:
    return init_attention(cfg, generator=generator, device=device)


def cross_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    memory: torch.Tensor, *, kv_block: int = 512
                    ) -> torch.Tensor:
    """Attend from x (B, Sq, D) to a static memory (B, Sm, D),
    non-causal, every position 0."""
    Sq, Sm = x.shape[1], memory.shape[1]
    q = add_bias(_project(x, p["wq"]), p.get("bq"))
    k = add_bias(_project(memory, p["wk"]), p.get("bk"))
    v = add_bias(_project(memory, p["wv"]), p.get("bv"))
    pos = const_like(x, torch.zeros(max(Sq, Sm), dtype=torch.int32,
                                    device=x.device))
    out = blocked_attention(q, k, v, q_positions=pos[:Sq],
                            kv_positions=pos[:Sm], causal=False,
                            window=None, kv_block=kv_block)
    return add_bias(_unproject(out, p["wo"]), p.get("bo"))


# -- MLA (DeepSeek multi-head latent attention) -------------------------------

def mla_shapes(cfg: ModelConfig) -> dict:
    """Leaf shapes of :func:`init_mla`'s tree (no biases)."""
    D, H = cfg.d_model, cfg.num_heads
    r, nope, vd = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.v_head_dim
    rp = cfg.qk_rope_head_dim
    return {"wq": (D, H, nope + rp), "w_dkv": (D, r), "w_kr": (D, rp),
            "w_uk": (r, H, nope), "w_uv": (r, H, vd), "wo": (H, vd, D)}


def init_mla(cfg: ModelConfig, *, generator: torch.Generator,
             device) -> dict:
    return _init_from_shapes(mla_shapes(cfg), cfg, generator=generator,
                             device=device)


def _mla_kv(cfg: ModelConfig, c_kv: torch.Tensor, k_rope: torch.Tensor,
            p: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-head K and V rebuilt from the latents: the shared rope head
    appended to each head's K, V padded to the same width.  c_kv (B, T,
    r); k_rope (B, T, rp) roped."""
    nope, rp, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                    cfg.v_head_dim)
    k_nope = _project(c_kv, p["w_uk"])                     # (B, T, H, nope)
    v = _project(c_kv, p["w_uv"])                          # (B, T, H, vd)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], rp)], dim=-1)
    if vd < nope + rp:
        v = pad_dim(v, -1, 0, nope + rp - vd)
    return k, v


def _mla_query(p: dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Per-head queries, the rope part roped: (B, S, H, nope + rp)."""
    nope = cfg.qk_nope_head_dim
    q = _project(x, p["wq"])
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    return torch.cat([q[..., :nope], q_rope], dim=-1)


def mla_attention(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                  positions: torch.Tensor, kv_block: int = 512
                  ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal MLA.  Returns (out, (c_kv, k_rope))."""
    q = _mla_query(p, cfg, x, positions)
    c_kv = x @ p["w_dkv"]                                   # (B, S, r)
    k_rope = apply_rope(x @ p["w_kr"], positions, cfg.rope_theta,
                        head_axis=False)                    # (B, S, rp)
    k, v = _mla_kv(cfg, c_kv, k_rope, p)
    out = blocked_attention(q, k, v, q_positions=positions,
                            kv_positions=positions, causal=True, window=None,
                            kv_block=kv_block)[..., :cfg.v_head_dim]
    return _unproject(out, p["wo"]), (c_kv, k_rope)


def _per_head(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (B, H, k) times w (H, k, r), head by head: (B, H, r)."""
    return (a.transpose(0, 1) @ w).transpose(0, 1)


def mla_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict, *,
               absorb: bool = False, window: int | None = None
               ) -> tuple[torch.Tensor, dict]:
    """One-token MLA decode against the latent cache {c_kv, k_rope,
    pos, valid, index, length}, updated in place as
    :func:`attention_decode` updates its cache.

    ``absorb=False`` (what ``decode_step`` runs): per-head K/V rebuilt
    from ``c_kv`` each step and attended through the
    ``swa_attention_decode`` kernel (G = 1, dh = nope + rp).
    ``absorb=True``: ``w_uk`` folded into the query and ``w_uv`` into the
    output, attention in the latent space, in plain PyTorch as in the
    JAX package (scores in x's dtype, divided, then cast to fp32)."""
    nope, rp, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                    cfg.v_head_dim)
    pos = cache["length"]
    q = _mla_query(p, cfg, x, pos[:, None])
    c_kv_t = x @ p["w_dkv"]
    k_rope_t = apply_rope(x @ p["w_kr"], pos[:, None], cfg.rope_theta,
                          head_axis=False)
    T = cache["c_kv"].shape[1]
    slot = cache["index"]
    write_slots_(slot, (cache["c_kv"], c_kv_t[:, 0]),
                 (cache["k_rope"], k_rope_t[:, 0]), (cache["pos"], pos),
                 (cache["valid"], True))
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]

    if absorb:
        mask = cache["valid"] & (cache["pos"] <= pos[:, None])
        if window is not None:
            mask = mask & (cache["pos"] > pos[:, None] - window)
        q_nope, q_rope = q[:, 0, :, :nope], q[:, 0, :, nope:]   # (B, H, ·)
        q_lat = _per_head(q_nope, p["w_uk"].permute(1, 2, 0))  # (B, H, r)
        s = q_lat @ c_cache.to(q_lat.dtype).transpose(1, 2) \
            + q_rope @ r_cache.to(q_rope.dtype).transpose(1, 2)  # (B, H, T)
        s = (s / float(np.sqrt(nope + rp))).to(torch.float32)
        s = torch.where(mask[:, None, :], s, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        ctx = pr.to(c_cache.dtype) @ c_cache                   # (B, H, r)
        out = _per_head(ctx, p["w_uv"].permute(1, 0, 2))[:, None]
    else:
        k, v = _mla_kv(cfg, c_cache, r_cache, p)
        out = decode_attention(q, k, v, q_position=pos,
                               kv_positions=cache["pos"], window=window,
                               kv_valid=cache["valid"])[..., :vd]
    out = _unproject(out, p["wo"])
    slot.add_(1).remainder_(T)
    pos.add_(1)
    return out, cache


def init_mla_cache(cfg: ModelConfig, batch: int, capacity: int,
                   prefill_len: int | None = None, *,
                   device="cuda") -> dict:
    """The latent cache of :func:`mla_decode`: zeros in every slot."""
    out = {
        "c_kv": torch.zeros((batch, capacity, cfg.kv_lora_rank),
                            dtype=cfg.dtype, device=device),
        "k_rope": torch.zeros((batch, capacity, cfg.qk_rope_head_dim),
                              dtype=cfg.dtype, device=device),
    }
    out.update(_cache_bookkeeping(batch, capacity, prefill_len or 0,
                                  device=device))
    return out
