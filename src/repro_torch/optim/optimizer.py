"""Functional optimizers over lists of tensors.

Port of ``repro/optim/optimizer.py``.  An :class:`Optimizer` is a pair of
functions

    state  = opt.init(params)
    params, state = opt.step(params, grads, state)

over a list of tensors (a model's leaves).  ``sgd``, ``adam`` /
``adamw`` and ``adafactor`` repeat the JAX package's arithmetic op for
op in fp32 (not ``torch.optim``, whose order of operations differs), so
the two trainers step alike: every Python constant becomes one fp32
value, as JAX's weak typing makes it; updates are out of place and
build no autograd graph.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import to_tensor, tree_leaves


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[list[torch.Tensor]], Any]
    step: Callable[[list[torch.Tensor], list[torch.Tensor], Any],
                   tuple[list[torch.Tensor], Any]]


def _f32(device):
    """Python constants as fp32 scalars on ``device``."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)
    return f32


# -- SGD (+momentum) ---------------------------------------------------------

def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """``p' = p − lr·g``, or with momentum ``v = momentum·v + g``,
    ``p' = p − lr·v``; the state is ``()`` without momentum."""

    def init(params):
        if momentum == 0.0:
            return ()
        return [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(params, grads, state):
        f32 = _f32(params[0].device)
        if momentum == 0.0:
            return [p - f32(lr) * g for p, g in zip(params, grads)], state
        vel = [f32(momentum) * v + g for v, g in zip(state, grads)]
        return [p - f32(lr) * v for p, v in zip(params, vel)], vel

    return Optimizer(f"sgd(lr={lr})", init, step)


# -- Adam / AdamW -------------------------------------------------------------

class AdamState(NamedTuple):
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    count: torch.Tensor          # int32, 0-dim


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Adam with bias correction, fp32 state:

        mu = b1·m + (1−b1)·g        nu = b2·v + (1−b2)·g²
        c  = 1 − b^count (fp32)      u  = (mu/c1)/(sqrt(nu/c2)+eps)
        u += weight_decay·p (when set)            p' = p − lr·u"""

    def init(params):
        z = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return AdamState(z, [t.clone() for t in z],
                         torch.zeros((), dtype=torch.int32,
                                     device=params[0].device))

    @torch.no_grad()
    def step(params, grads, state):
        f32 = _f32(state.count.device)
        count = state.count + 1
        mu = [f32(b1) * m + f32(1 - b1) * g.to(torch.float32)
              for m, g in zip(state.mu, grads)]
        nu = [f32(b2) * v + f32(1 - b2) * torch.square(g.to(torch.float32))
              for v, g in zip(state.nu, grads)]
        cf = count.to(torch.float32)
        c1 = 1 - torch.pow(f32(b1), cf)
        c2 = 1 - torch.pow(f32(b2), cf)

        def upd(p, m, v):
            u = (m / c1) / (torch.sqrt(v / c2) + f32(eps))
            if weight_decay:
                u = u + f32(weight_decay) * p.to(u.dtype)
            return (p - f32(lr) * u.to(p.dtype)).to(p.dtype)

        new = [upd(p, m, v) for p, m, v in zip(params, mu, nu)]
        return new, AdamState(mu, nu, count)

    tag = "adamw" if weight_decay else "adam"
    return Optimizer(f"{tag}(lr={lr})", init, step)


def adamw(lr: float, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


# -- Adafactor (factored second moment) ----------------------------------------

class AdafactorState(NamedTuple):
    vr: list[torch.Tensor]   # row stats for matrices, full for vectors
    vc: list[torch.Tensor]   # col stats for matrices, () for vectors
    count: torch.Tensor      # int32, 0-dim


def adafactor(lr: float, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Simplified Adafactor: factored second moment for leaves with
    ndim >= 2 (the last two dimensions), full for vectors; the update is
    clipped to RMS <= ``clip_threshold``.  A leaf with ndim >= 3 updates
    one leading slice at a time, as the JAX package's ``lax.map`` does
    (the clip's RMS is then per slice)."""

    def _factored(p):
        return p.dim() >= 2

    def init(params):
        def zeros(shape, p):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        vr = [zeros(p.shape[:-1], p) if _factored(p) else zeros(p.shape, p)
              for p in params]
        vc = [zeros(p.shape[:-2] + p.shape[-1:], p) if _factored(p)
              else zeros((), p) for p in params]
        return AdafactorState(vr, vc, torch.zeros(
            (), dtype=torch.int32, device=params[0].device))

    @torch.no_grad()
    def step(params, grads, state):
        f32 = _f32(state.count.device)
        count = state.count + 1
        beta = f32(1.0) - torch.pow(count.to(torch.float32), f32(-decay))
        one_minus_beta = f32(1) - beta
        e = f32(eps)

        def core(p, g, vr, vc):
            g = g.to(torch.float32)
            g2 = torch.square(g) + e
            if _factored(p):
                nvr = beta * vr + one_minus_beta * g2.mean(dim=-1)
                nvc = beta * vc + one_minus_beta * g2.mean(dim=-2)
                denom = nvr.mean(dim=-1, keepdim=True)
                r = (nvr / torch.maximum(denom, e))[..., None]
                c = nvc[..., None, :]
                u = g * torch.rsqrt(torch.maximum(r * c, e))
            else:
                nvr = beta * vr + one_minus_beta * g2
                nvc = vc
                u = g * torch.rsqrt(torch.maximum(nvr, e))
            rms = torch.sqrt(torch.mean(torch.square(u)) + e)
            u = u / torch.maximum(f32(1.0), rms / f32(clip_threshold))
            return (p - f32(lr) * u.to(p.dtype)).to(p.dtype), nvr, nvc

        def upd(p, g, vr, vc):
            if p.dim() >= 3:
                outs = [core(*t) for t in zip(p, g, vr, vc)]
                return tuple(torch.stack(o) for o in zip(*outs))
            return core(p, g, vr, vc)

        outs = [upd(*t) for t in zip(params, grads, state.vr, state.vc)]
        return ([o[0] for o in outs],
                AdafactorState([o[1] for o in outs], [o[2] for o in outs],
                               count))

    return Optimizer(f"adafactor(lr={lr})", init, step)


# -- state carried across from the JAX package -------------------------------

def from_jax_opt_state(state, params: Any) -> Any:
    """The JAX package's optimizer state, its leaves as numpy arrays
    (``AdamState`` or ``AdafactorState`` of parameter-shaped trees,
    ``()`` for SGD, a velocity tree for SGD with momentum), as the port's
    state for ``params``: each tree a list in :func:`tree_leaves` order,
    on the parameters' device.  Adafactor's vector leaves keep their
    ``()`` column statistics."""
    leaves = tree_leaves(params)
    device = leaves[0].device

    def as_list(tree, what):
        out = [to_tensor(a, device) for a in tree_leaves(tree)]
        if len(out) != len(leaves):
            raise ValueError(f"{what}: {len(out)} leaves for "
                             f"{len(leaves)} parameters")
        return out

    fields = getattr(state, "_fields", None)
    if fields == AdamState._fields:
        return AdamState(as_list(state.mu, "mu"), as_list(state.nu, "nu"),
                         to_tensor(state.count, device))
    if fields == AdafactorState._fields:
        return AdafactorState(as_list(state.vr, "vr"),
                              as_list(state.vc, "vc"),
                              to_tensor(state.count, device))
    if isinstance(state, tuple) and not state:
        return ()
    return as_list(state, "momentum")
