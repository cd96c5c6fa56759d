"""Federated optimization of the LM zoo: the paper's three levers applied
to cross-silo training of a transformer.

Port of ``repro/core/fedopt.py``.  Each silo runs ``local_steps`` of
training on its own data, then the silos aggregate:

  * prune what you communicate: top-k magnitude sparsification of the
    model delta before aggregation (the frequency-score pruning of
    boundary embeddings becomes magnitude scoring of parameter deltas);
  * overlap communication with the compute tail: ``stale_aggregation``
    applies round r−1's aggregate in round r (the stale push, with its
    one-round staleness);
  * batched exchange through a server: the aggregation is a mean over
    the silos.

Params are silo-stacked (leading dim = num_silos) as in JAX; each silo's
local steps run in a Python loop where JAX ``vmap``s them, each silo with
its own optimizer state.  Trees are walked in JAX's leaf order
(:func:`repro_torch.tree.tree_leaves`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.models import lm
from repro_torch.optim import Optimizer
from repro_torch.tree import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class FedOptConfig:
    num_silos: int
    local_steps: int = 4
    delta_topk_frac: Optional[float] = None   # None = dense deltas
    stale_aggregation: bool = False           # the stale-push analogue


def replicate(tree: Any, n: int) -> Any:
    """Each leaf repeated along a new leading axis of ``n`` (a copy each:
    the silos train apart)."""
    return tree_unflatten(tree, [
        a.unsqueeze(0).expand(n, *a.shape).contiguous()
        for a in tree_leaves(tree)])


def _quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` of a 1-D fp32 tensor, op for op: a sort,
    the position q·(n−1) in fp32 (n too is fp32, so above 2**24 the
    position is rounded as JAX rounds it), its floor and ceil clamped to
    the last index, and low·(1−w) + high·w.  XLA on the CPU contracts
    that sum into one fused multiply-add, fma(low, 1−w, high·w), so the
    port adds low·(1−w), exact in fp64, to the fp32 high·w and rounds
    once."""
    s = torch.sort(x).values

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=x.device)
    n = f32(x.numel())
    pos = f32(q) * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    last = x.numel() - 1            # an index past the end gathers the last
    lo = torch.clamp(low, min=0).to(torch.int64).clamp(max=last)
    hi = torch.clamp(high, min=0).to(torch.int64).clamp(max=last)

    def at(i):          # a gather, not .item(): a dry-run traces on meta
        return s.index_select(0, i.reshape(1)).reshape(())
    high_part = at(hi) * high_w
    return (at(lo).double() * low_w.double() + high_part.double()).float()


def _topk_sparsify(delta: Any, frac: float) -> tuple[Any, float]:
    """Keep the top-``frac`` magnitude entries of each leaf (threshold:
    the leaf's linear (1 − frac)-quantile of |d| in fp32; entries at or
    above it stay).  0-dim leaves pass through uncounted.  Returns (the
    sparse delta, the nominal kept fraction frac·size summed over the
    leaves it counts, as the JAX package reports it)."""
    kept_n, total_n = 0.0, 0.0
    out = []
    for d in tree_leaves(delta):
        if d.dim() == 0:
            out.append(d)
            continue
        mag = torch.abs(d.to(torch.float32))
        thr = _quantile_linear(mag.reshape(-1), 1.0 - frac)
        out.append(torch.where(mag >= thr, d, 0).to(d.dtype))
        kept_n += float(frac) * d.numel()
        total_n += d.numel()
    return tree_unflatten(delta, out), kept_n / max(total_n, 1.0)


class FederatedLMTrainer:
    """Federated training of any zoo architecture.

    Holds silo-stacked params, one optimizer state per silo and an
    ``anchor`` (the last agreed global model): ``params=`` (for example
    ``lm.from_jax_params(...)``) or, without it, ``lm.init_params`` from
    ``generator`` on ``device``.  ``round(batches)`` = ``local_steps`` per
    silo, then the aggregation (possibly stale, possibly sparsified)."""

    def __init__(self, model_cfg, optimizer: Optimizer, fed: FedOptConfig,
                 *, params: Any = None,
                 generator: torch.Generator | None = None,
                 device: str = "cuda"):
        self.cfg = model_cfg
        self.opt = optimizer
        self.fed = fed
        self.anchor = params if params is not None else lm.init_params(
            model_cfg, generator=generator, device=device)
        self.params = replicate(self.anchor, fed.num_silos)
        self.opt_state = self._init_states()
        self.pending_delta = None                   # stale-aggregation buffer
        self.comm_fraction = 1.0
        self._step = lm.make_train_step(model_cfg, optimizer)

    def _init_states(self) -> list:
        return [self.opt.init(tree_leaves(self.anchor))
                for _ in range(self.fed.num_silos)]

    def _silo_round(self, s: int, batches: dict):
        """``local_steps`` of training on silo ``s``; its new leaves and
        its mean loss."""
        p = tree_unflatten(self.anchor,
                              [t[s] for t in tree_leaves(self.params)])
        state = self.opt_state[s]
        losses = []
        for i in range(self.fed.local_steps):
            p, state, m = self._step(p, state,
                                     {k: v[s, i] for k, v in batches.items()})
            losses.append(m["loss"])
        self.opt_state[s] = state
        return tree_leaves(p), torch.stack(losses).mean()

    def round(self, batches: dict) -> dict:
        """batches: {key: tensor with leading (num_silos, local_steps, ...)
        dims}."""
        fed = self.fed
        runs = [self._silo_round(s, batches) for s in range(fed.num_silos)]
        self.params = tree_unflatten(self.anchor, [
            torch.stack(ls) for ls in zip(*[r[0] for r in runs])])
        losses = torch.stack([r[1] for r in runs])

        def mean_delta(p, a):
            d = p - a[None]          # jnp.mean sums low precision in fp32
            return (d.to(torch.float32).sum(0) / fed.num_silos).to(d.dtype)
        delta = tree_unflatten(self.anchor, [
            mean_delta(p, a) for p, a in zip(tree_leaves(self.params),
                                             tree_leaves(self.anchor))])
        if fed.delta_topk_frac is not None:
            delta, self.comm_fraction = _topk_sparsify(
                delta, fed.delta_topk_frac)

        if fed.stale_aggregation:
            # apply LAST round's aggregate now; ship this round's delta
            # while the next round trains (one-round staleness)
            apply_delta = self.pending_delta
            self.pending_delta = delta
        else:
            apply_delta = delta

        if apply_delta is not None:
            self.anchor = tree_unflatten(self.anchor, [
                a + d.to(a.dtype) for a, d in zip(
                    tree_leaves(self.anchor),
                    tree_leaves(apply_delta))])
            self.params = replicate(self.anchor, fed.num_silos)
            self.opt_state = self._init_states()
        return {"loss": float(losses.mean()),
                "comm_fraction": self.comm_fraction}

    def comm_bytes_per_round(self) -> int:
        n = sum(p.numel() * p.element_size()
                for p in tree_leaves(self.anchor))
        frac = self.fed.delta_topk_frac or 1.0
        return int(n * frac)
