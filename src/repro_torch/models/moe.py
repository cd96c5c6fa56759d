"""Mixture-of-Experts FFN with sort-based token dispatch.

Counterpart of ``repro/models/moe.py``.  Tokens are sorted by expert id
and copied into per-expert capacity buffers, run through batched expert
products, and combined back:

* Router: softmax over the expert logits (fp32), the top-k experts, their
  probabilities renormalised over the selection; a Switch-style load
  balance loss.  Ties go to the lower expert index, as
  ``jax.lax.top_k`` breaks them: a stable descending sort, first k.
* Capacity C = ceil(T·k/E · capacity_factor); a token past its expert's
  capacity goes to the trash row E·C and is dropped.
* Dispatch is an index copy: every kept slot receives exactly one token.
* Combine adds each token's k contributions in the reference's order,
  ascending expert id (the order the stable sort left them in), in the
  activation dtype, one add a step: no atomics, the same bytes every run.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

from .layers import dense_init, init_mlp, mlp, mlp_shapes, on_replicas


def moe_shapes(cfg: ModelConfig) -> dict:
    """Leaf shapes of :func:`init_moe`'s tree (the shared experts' MLP
    biases whether or not the config has them)."""
    E, D, F_ = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    p = {"router": (D, E), "w_in": (E, D, F_), "w_out": (E, F_, D)}
    if cfg.activation == "silu_gated":
        p["w_gate"] = (E, D, F_)
    if cfg.num_shared_experts:
        p["shared"] = mlp_shapes(cfg, F_ * cfg.num_shared_experts)
    return p


def init_moe(cfg: ModelConfig, *, generator: torch.Generator | None = None,
             device: str = "cuda") -> dict:
    """Seeded router (normal·0.02) and expert matrices (normal/sqrt(fan
    in)), and the shared experts' MLP where the config has them."""
    gen = generator if generator is not None \
        else torch.Generator(device=device).manual_seed(0)
    shapes = moe_shapes(cfg)
    p = {k: dense_init(shapes[k], cfg.dtype, generator=gen, device=device,
                       scale=0.02 if k == "router" else None)
         for k in ("router", "w_in", "w_out", "w_gate") if k in shapes}
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(cfg, cfg.moe_d_ff * cfg.num_shared_experts,
                               generator=gen, device=device)
    return p


def _activate(cfg: ModelConfig, h: torch.Tensor,
              gate: torch.Tensor | None) -> torch.Tensor:
    if cfg.activation == "silu_gated":
        return F.silu(h) * gate
    if cfg.activation == "squared_relu":
        return torch.square(F.relu(h))
    return F.gelu(h, approximate="tanh")       # jax.nn.gelu's default


def _expert_ffn(p: dict, cfg: ModelConfig, xs: torch.Tensor) -> torch.Tensor:
    """xs: (E, C, D) → (E, C, D), each expert's FFN on its rows."""
    gate = xs @ p["w_gate"] if cfg.activation == "silu_gated" else None
    return _activate(cfg, xs @ p["w_in"], gate) @ p["w_out"]


def _route(p: dict, cfg: ModelConfig, xt: torch.Tensor):
    """Router top-k and the Switch aux loss.  xt: (T, D) → (top_p (T, K)
    fp32, top_e (T, K) int64, aux 0-dim fp32)."""
    E, K = cfg.num_experts, cfg.top_k
    logits = (xt @ p["router"]).to(torch.float32)           # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    frac = F.one_hot(top_e[:, 0], E).to(torch.float32).mean(dim=0)
    aux = E * torch.sum(frac * probs.mean(dim=0))
    return top_p, top_e, aux


def _dispatch(cfg: ModelConfig, xt: torch.Tensor, top_p: torch.Tensor,
              top_e: torch.Tensor, C: int):
    """Sort tokens by expert, drop past capacity C, build the (E, C, D)
    buffers.  Returns (buf, combine metadata)."""
    E, K = cfg.num_experts, cfg.top_k
    T, D = xt.shape
    dev = xt.device
    TK = T * K
    flat_e = top_e.reshape(TK)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    flat_p = top_p.reshape(TK).to(xt.dtype)
    order = torch.argsort(flat_e, stable=True)
    se, st, sp = flat_e[order], flat_t[order], flat_p[order]
    # bincount by a scatter: the same counts, and a shape that does not
    # depend on the data (a dry-run traces it on meta tensors)
    counts = torch.zeros(E, dtype=se.dtype, device=dev) \
        .scatter_add_(0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(TK, device=dev) - starts[se]
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)            # E·C = trash row
    # kept slots are unique; the trash row's many writes are thrown away
    buf = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=dev) \
        .index_copy_(0, slot, xt[st])
    return buf[:-1].reshape(E, C, D), (order, se, pos, keep, sp)


def _combine(cfg: ModelConfig, expert_out: torch.Tensor, meta,
             T: int) -> torch.Tensor:
    """Each token's kept expert outputs weighted by their probabilities
    and added in ascending expert order, starting from zero."""
    E, C, D = expert_out.shape
    K = cfg.top_k
    order, se, pos, keep, sp = meta
    back = expert_out.reshape(E * C, D)[torch.where(keep, se * C + pos, 0)]
    back = back * (sp * keep.to(sp.dtype))[:, None]
    # sorted entry j holds flat entry order[j] = t·K + k; by the stable
    # sort a token's entries stand in ascending expert order, so listing
    # them by sorted position keeps that order
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    per_token = rank.reshape(T, K).sort(dim=1).values       # (T, K)
    contrib = back[per_token]                               # (T, K, D)
    out = torch.zeros((T, D), dtype=expert_out.dtype,
                      device=expert_out.device)
    for k in range(K):
        out = out + contrib[:, k]
    return out


def _dispatch_groups(router: torch.Tensor, xt: torch.Tensor,
                     cfg: ModelConfig, G: int):
    """Route and dispatch each of ``G`` token groups on its own, with
    capacity C_g = ceil(T_g·k/E · capacity_factor): the (E, G·C_g, D)
    buffers (every group's rows of an expert together), each group's
    combine metadata and the groups' mean aux loss."""
    E, K = cfg.num_experts, cfg.top_k
    T, D = xt.shape
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    Tg = T // G
    Cg = int(np.ceil(Tg * K / E * cfg.capacity_factor))
    bufs, metas, auxs = [], [], []
    for xg in xt.reshape(G, Tg, D):
        top_p, top_e, aux_g = _route({"router": router}, cfg, xg)
        buf, meta = _dispatch(cfg, xg, top_p, top_e, Cg)
        bufs.append(buf)
        metas.append(meta)
        auxs.append(aux_g)
    return (torch.stack(bufs, dim=1).reshape(E, G * Cg, D), metas,
            torch.stack(auxs).mean())


def _combine_groups(eo: torch.Tensor, metas: list,
                    cfg: ModelConfig) -> torch.Tensor:
    """Each group's tokens back from the (E, G·C_g, D) expert outputs."""
    G = len(metas)
    E, GC, D = eo.shape
    eo = eo.reshape(E, G, GC // G, D)
    Tg = metas[0][0].numel() // cfg.top_k
    return torch.cat([_combine(cfg, eo[:, g], metas[g], Tg)
                      for g in range(G)])


def moe_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out, aux_loss).

    ``cfg.moe_groups > 1`` splits the token stream into that many groups,
    each routed, dispatched and combined on its own; the expert products
    run over all groups at once.  On DTensors the routing, dispatch and
    combine (sorts, counts, index copies: ops DTensor has no sharding
    rules for) run on every rank's replica of the token stream, and the
    expert products on the experts' shards."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    xs, metas, aux = on_replicas(_dispatch_groups)(
        p["router"], xt, cfg, max(1, cfg.moe_groups))
    out = on_replicas(_combine_groups)(_expert_ffn(p, cfg, xs), metas, cfg)
    if cfg.num_shared_experts:
        out = out + mlp(p["shared"], cfg, xt)
    return out.reshape(B, S, D), aux
