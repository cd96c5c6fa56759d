"""The reference's GraphConv, loss, Adam, int8 codec and FedAvg, in plain
PyTorch float32.

GraphConv layer ``l``: ``h' = ((Σ_{u∈N(v)} h_u + h_v) / (|N(v)| + 1)) W_l
+ b_l``, ReLU on every layer but the last; the loss is the mean negative
log-likelihood of the seeds' labels.  The neighbour sums are
``index_add_`` over edge lists, in blocks of edges so that a wide
feature table fits; autograd gives the backward.

``Precision(tf32=True)`` is the control: every matrix product rounds its
operands to TF32 (10 mantissa bits, to nearest even) in the forward and
the backward, the precision a float32 product takes on the card's tensor
cores when TF32 is allowed.  The configuration states float32 with TF32
off.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

EDGE_BLOCK_ELEMS = 1 << 27


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) with its mantissa rounded to 10 bits."""
    bits = x.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class _Tf32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        return rg @ rb.T, ra.T @ rg


@dataclasses.dataclass(frozen=True)
class Precision:
    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _Tf32MatMul.apply(a, b) if self.tf32 else a @ b


def neighbour_sum(h: torch.Tensor, e_src: torch.Tensor, e_dst: torch.Tensor,
                  n_dst: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σ of ``h[src]`` per destination, in-degree as float32)."""
    out = torch.zeros((n_dst, h.shape[1]), dtype=h.dtype, device=h.device)
    step = max(1, EDGE_BLOCK_ELEMS // max(1, h.shape[1]))
    for i in range(0, len(e_src), step):
        out = out.index_add(0, e_dst[i: i + step],
                            h.index_select(0, e_src[i: i + step]))
    cnt = torch.bincount(e_dst, minlength=n_dst).to(h.dtype)
    return out, cnt


def graphconv(params: list, l: int, h_src: torch.Tensor, e_src, e_dst,
              n_dst: int, h_self: torch.Tensor, last: bool,
              prec: Precision) -> torch.Tensor:
    """Layer ``l`` (1-based); ``params`` holds per layer (b, W)."""
    s, cnt = neighbour_sum(h_src, e_src, e_dst, n_dst)
    mixed = (s + h_self) / (cnt + 1.0)[:, None]
    out = prec.mm(mixed, params[2 * l - 1]) + params[2 * l - 2]
    return out if last else torch.relu(out)


def positions(nodes: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """The position in ``nodes`` (unique ids) of each of ``ids``."""
    sorter = np.argsort(nodes, kind="stable")
    return sorter[np.searchsorted(nodes, ids, sorter=sorter)]


def forward_blocks(params: list, L: int, layers: list, edges: list,
                   h_in: torch.Tensor, caches: list, num_local: int,
                   prec: Precision) -> torch.Tensor:
    """The ``L`` layers over a minibatch's ``L``-hop expansion
    (``layers``, ``edges`` as the sampler gives them) from ``h_in``, the
    rows of ``layers[-1]``.  Remote destination rows of a layer below
    ``L`` are read from ``caches[l - 1]`` (slot = shard id −
    ``num_local``)."""
    dev = h_in.device
    h = h_in
    for l in range(1, L + 1):
        src_nodes, dst_nodes = layers[L - l + 1], layers[L - l]
        e_src, e_dst = edges[L - l]
        es = torch.from_numpy(positions(src_nodes, e_src)).to(dev)
        ed = torch.from_numpy(positions(src_nodes, e_dst)).to(dev)
        n_dst = len(dst_nodes)
        out = graphconv(params, l, h, es, ed, n_dst, h[:n_dst], l == L, prec)
        if l < L:
            rem = np.nonzero(dst_nodes >= num_local)[0]
            if len(rem):
                slots = torch.from_numpy(dst_nodes[rem] - num_local).to(dev)
                idx = torch.from_numpy(rem).to(dev)
                out = out.index_put((idx,), caches[l - 1][slots])
        h = out
    return h


def input_features(features: torch.Tensor, nodes: np.ndarray,
                   num_local: int) -> torch.Tensor:
    """h^0 of ``nodes``: a local vertex's features, zeros for a remote
    one (its row is never aggregated and its output is replaced)."""
    ids = torch.from_numpy(np.minimum(nodes, num_local - 1)).to(features.device)
    rows = features.index_select(0, ids)
    remote = torch.from_numpy(nodes >= num_local).to(features.device)
    return torch.where(remote[:, None], torch.zeros_like(rows), rows)


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None])[:, 0].mean()


def propagate(params: list, L: int, feats: torch.Tensor, e_src, e_dst,
              num_local: int, caches: list | None,
              prec: Precision) -> list[torch.Tensor]:
    """h^1..h^L of every local vertex over a CSR's edges (``e_src`` shard
    ids, remote ones from ``num_local`` on).  Layer 1, and every layer
    when ``caches`` is None, aggregates local sources only; layer
    ``l ≥ 2`` reads remote sources from ``caches[l - 2]``."""
    local = e_src < num_local
    es_l, ed_l = e_src[local], e_dst[local]
    h = feats
    outs = []
    with torch.no_grad():
        for l in range(1, L + 1):
            if l == 1 or caches is None:
                out = graphconv(params, l, h, es_l, ed_l, num_local, h,
                                l == L, prec)
            else:
                src = torch.cat([h, caches[l - 2]], dim=0)
                out = graphconv(params, l, src, e_src, e_dst, num_local, h,
                                l == L, prec)
            outs.append(out)
            h = out
    return outs


class Adam:
    """Adam with bias correction (float32 state)."""

    def __init__(self, params: list, lr: float, b1: float, b2: float,
                 eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, params: list, grads: list) -> list:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.m[i] = self.b1 * self.m[i] + (1.0 - self.b1) * g
            self.v[i] = self.b2 * self.v[i] + (1.0 - self.b2) * g * g
            upd = (self.m[i] / c1) / (torch.sqrt(self.v[i] / c2) + self.eps)
            out.append(p - self.lr * upd)
        return out


class Codec:
    """The wire codecs the configuration states: ``fp32`` passes rows
    through; ``int8`` scales each row by its absmax · float32(1/127) and
    rounds to nearest even, clamped to ±127."""

    INV127 = float(np.float32(1.0 / 127.0))

    def __init__(self, name: str):
        if name not in ("fp32", "int8"):
            raise ValueError(f"the reference has no codec {name!r}")
        self.name = name

    def roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return x
        scale = x.abs().amax(dim=1, keepdim=True) * self.INV127
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round(x / safe), -127.0, 127.0)
        return q * scale


def fedavg(models: list[list], weights: list[float]) -> list:
    """The weighted mean of the clients' leaves."""
    total = float(sum(weights))
    return [sum(w * m[i] for m, w in zip(models, weights)) / total
            for i in range(len(models[0]))]
