"""Functional optimizers over lists of tensors.

Port of ``repro/optim/optimizer.py``.  An :class:`Optimizer` is a pair of
functions

    state  = opt.init(params)
    params, state = opt.step(params, grads, state)

over a list of tensors (a model's leaves).  ``adam`` repeats the JAX
package's arithmetic op for op in fp32 — not ``torch.optim.Adam``, whose
order of operations differs — so the two trainers step alike.  ``sgd``,
``adamw`` and ``adafactor`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[list[torch.Tensor]], Any]
    step: Callable[[list[torch.Tensor], list[torch.Tensor], Any],
                   tuple[list[torch.Tensor], Any]]


class AdamState(NamedTuple):
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    count: torch.Tensor          # int32, 0-dim


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam with bias correction, fp32 state:

        mu = b1·m + (1−b1)·g        nu = b2·v + (1−b2)·g²
        c  = 1 − b^count (fp32)      p' = p − lr·((mu/c1)/(sqrt(nu/c2)+eps))

    Each Python constant becomes one fp32 value, as JAX's weak typing
    makes it; the update is out of place and builds no autograd graph."""

    def init(params):
        z = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return AdamState(z, [t.clone() for t in z],
                         torch.zeros((), dtype=torch.int32,
                                     device=params[0].device))

    @torch.no_grad()
    def step(params, grads, state):
        dev = state.count.device

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)

        count = state.count + 1
        mu = [f32(b1) * m + f32(1 - b1) * g.to(torch.float32)
              for m, g in zip(state.mu, grads)]
        nu = [f32(b2) * v + f32(1 - b2) * torch.square(g.to(torch.float32))
              for v, g in zip(state.nu, grads)]
        cf = count.to(torch.float32)
        c1 = 1 - torch.pow(f32(b1), cf)
        c2 = 1 - torch.pow(f32(b2), cf)
        new = [(p - f32(lr) * ((m / c1) / (torch.sqrt(v / c2) + f32(eps)))
                ).to(p.dtype)
               for p, m, v in zip(params, mu, nu)]
        return new, AdamState(mu, nu, count)

    return Optimizer(f"adam(lr={lr})", init, step)
