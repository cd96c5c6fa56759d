"""GraphConv and SAGEConv GNNs in PyTorch over padded blocks.

Port of ``repro/models/gnn.py``.  Layer ``l`` consumes the ``h^{l-1}``
embeddings of the nodes at hop ``L-(l-1)`` and produces ``h^l`` at hop
``L-l``; rows of *remote* destination nodes are overwritten from the
client's pulled embedding cache instead of being computed.

Neighbour aggregation goes through :func:`repro_torch.kernels.ops.gnn_aggregate`
— the hand-written CUDA kernel on the card, the plain segment mean on the
CPU — differentiable through its backward kernel (or the plain
backward).  The GraphConv mix and the matrix products stay PyTorch code,
as they stay XLA code in the JAX package.

Blocks are dicts of tensors (:func:`blocks_to_arrays`,
:func:`shard_to_arrays`) with the JAX package's keys and layouts, so the
two packages can be held against each other on the same inputs.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops

CONVS = ("graphconv", "sageconv")


class GNNLayer(nn.Module):
    """One layer's parameters: ``w_neigh`` (d_in, d_out), ``b`` (d_out,)
    and, for SAGEConv, ``w_self`` (d_in, d_out)."""

    def __init__(self, w_neigh: torch.Tensor, b: torch.Tensor,
                 w_self: torch.Tensor | None = None):
        super().__init__()
        self.w_neigh = nn.Parameter(w_neigh)
        self.b = nn.Parameter(b)
        self.w_self = None if w_self is None else nn.Parameter(w_self)


def _layer_forward(layer: GNNLayer, conv: str, h_src: torch.Tensor,
                   blk: dict, *, last: bool) -> torch.Tensor:
    n_dst = blk["dst_remote_mask"].shape[0]   # padded dst size
    agg, cnt = ops.gnn_aggregate(h_src, blk["edge_src"], blk["edge_dst"],
                                 blk["edge_mask"], n_dst)
    return _combine(layer, conv, agg, cnt, h_src[:n_dst], last=last)


def _combine(layer: GNNLayer, conv: str, agg: torch.Tensor,
             cnt: torch.Tensor, h_self: torch.Tensor, *,
             last: bool) -> torch.Tensor:
    """A layer's output from the neighbour mean ``agg`` (with counts) and
    the destination rows' own embeddings."""
    if conv == "graphconv":
        # mean over N(u) ∪ {u} (right-normalised GCN over sampled blocks)
        mixed = (agg * cnt[:, None] + h_self) / (cnt[:, None] + 1.0)
        out = mixed @ layer.w_neigh + layer.b
    else:  # sageconv (mean aggregator)
        out = h_self @ layer.w_self + agg @ layer.w_neigh + layer.b
    if not last:
        out = torch.relu(out)
    return out


class GNN(nn.Module):
    """An L-layer GraphConv or SAGEConv model."""

    def __init__(self, conv: str, layers: Sequence[GNNLayer]):
        super().__init__()
        if conv not in CONVS:
            raise ValueError(f"conv must be one of {CONVS}, got {conv!r}")
        self.conv = conv
        self.layers = nn.ModuleList(layers)

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def hidden(self) -> int:
        return int(self.layers[0].b.shape[0])

    def leaves(self) -> list[nn.Parameter]:
        """The parameters in the JAX package's ``tree_flatten`` order:
        per layer ``b``, ``w_neigh`` and, for SAGEConv, ``w_self``."""
        out = []
        for layer in self.layers:
            out += [layer.b, layer.w_neigh]
            if layer.w_self is not None:
                out.append(layer.w_self)
        return out

    @torch.no_grad()
    def load_leaves(self, leaves: Sequence) -> None:
        """Overwrite the parameters in place from arrays or tensors in
        :meth:`leaves` order."""
        mine = self.leaves()
        if len(leaves) != len(mine):
            raise ValueError(f"{len(leaves)} leaves for a model of "
                             f"{len(mine)}")
        for p, v in zip(mine, leaves):
            p.copy_(torch.as_tensor(np.asarray(v, np.float32))
                    if not isinstance(v, torch.Tensor) else v)

    def layer_forward(self, l: int, h_src: torch.Tensor, blk: dict, *,
                      last: bool) -> torch.Tensor:
        """Apply GNN layer ``l`` (1-indexed) to one block."""
        return _layer_forward(self.layers[l - 1], self.conv, h_src, blk,
                              last=last)

    def forward_from(self, start: int, h: torch.Tensor, blocks: Sequence[dict],
                     caches: Sequence[torch.Tensor]) -> torch.Tensor:
        """Run layers ``start..L`` from an h^{start-1} input table, one
        block each; ``caches[j]`` is the remote-slot table of layer
        ``start + j``, whose rows replace the remote destination rows."""
        L = self.num_layers
        for j, blk in enumerate(blocks):
            l = start + j
            out = self.layer_forward(l, h, blk, last=(l == L))
            if l < L:
                cached = caches[j][blk["dst_remote_slot"]]
                out = torch.where(blk["dst_remote_mask"][:, None], cached,
                                  out)
            h = out
        return h

    def forward(self, batch: dict, features: torch.Tensor,
                caches: Sequence[torch.Tensor]) -> torch.Tensor:
        """Logits for the (padded) seed set.  ``caches`` holds the L-1
        remote-slot tables (num_remote_pad, hidden)."""
        # Hop-L edge sources are all local, but the dst-prefix node list
        # can hold remote ids from earlier hops.  Their rows are never
        # aggregated and their outputs are overwritten from the cache, so
        # their ids are clamped into the table, as JAX's gather does.
        ids = batch["input_ids"].clamp(max=features.shape[0] - 1)
        return self.forward_from(1, features[ids], batch["blocks"], caches)

    @torch.no_grad()
    def predict(self, batch: dict, features: torch.Tensor,
                caches: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.argmax(self(batch, features, caches), dim=-1)

    @torch.no_grad()
    def full_propagate(self, shard_arrays: dict,
                       caches: Sequence[torch.Tensor] | None
                       ) -> list[torch.Tensor]:
        """h^1..h^L for ALL local vertices of a shard.

        ``caches=None`` masks remote neighbours (the pre-training
        bootstrap); otherwise layers ≥ 2 read remote sources from
        ``caches[l-2]``.  Layer 1 never reads remote sources: their h^0
        is private."""
        L = self.num_layers
        num_local = shard_arrays["num_local"]
        e_src = shard_arrays["edge_src"]
        e_dst = shard_arrays["edge_dst"]
        remote_e = shard_arrays["src_is_remote"]
        h_local = shard_arrays["features"]
        outs = []
        for l in range(1, L + 1):
            if l == 1 or caches is None:
                mask = ~remote_e
                pad = torch.zeros((1, h_local.shape[1]), dtype=h_local.dtype,
                                  device=h_local.device)
                src_tbl = torch.cat([h_local, pad], dim=0)
                src_idx = torch.where(remote_e, num_local, e_src)
            else:
                mask = torch.ones_like(remote_e)
                src_tbl = torch.cat([h_local, caches[l - 2]], dim=0)
                src_idx = e_src  # remote ids already offset past num_local
            agg, cnt = ops.gnn_aggregate(src_tbl, src_idx, e_dst, mask,
                                         num_local)
            h_local = _combine(self.layers[l - 1], self.conv, agg, cnt,
                               h_local, last=(l == L))
            outs.append(h_local)
        return outs


def loss_fn(model: GNN, batch: dict, features: torch.Tensor,
            caches: Sequence[torch.Tensor],
            labels: torch.Tensor) -> torch.Tensor:
    """Masked mean negative log-likelihood of the seeds' labels, op for
    op the JAX ``loss_fn``."""
    logits = model(batch, features, caches)
    seed_labels = labels[batch["seeds"]]
    mask = batch["seed_mask"].to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, seed_labels[:, None])[:, 0]
    return torch.sum(nll * mask) / torch.clamp_min(mask.sum(), 1.0)


def init_gnn(conv: str, in_dim: int, hidden: int, out_dim: int,
             num_layers: int, *, generator: torch.Generator,
             device: str = "cuda") -> GNN:
    """Seeded init with the JAX package's distribution: weights
    ``normal · sqrt(2 / d_in)``, zero bias.  Draws on the CPU generator,
    so the weights do not depend on ``device``."""
    if conv not in CONVS:
        raise ValueError(f"conv must be one of {CONVS}, got {conv!r}")
    dims = [in_dim] + [hidden] * (num_layers - 1) + [out_dim]
    layers = []
    for l in range(num_layers):
        d_in, d_out = dims[l], dims[l + 1]
        scale = math.sqrt(2.0 / d_in)
        w_neigh = torch.randn((d_in, d_out), generator=generator) * scale
        w_self = torch.randn((d_in, d_out), generator=generator) * scale \
            if conv == "sageconv" else None
        layers.append(GNNLayer(
            w_neigh.to(device), torch.zeros(d_out, device=device),
            None if w_self is None else w_self.to(device)))
    return GNN(conv, layers)


def from_jax_leaves(leaves: Sequence[np.ndarray], conv: str,
                    device: str = "cuda") -> GNN:
    """A model from the JAX parameters' flat leaves in ``tree_flatten``
    order (``FederatedGNNTrainer.params_leaves()``): per layer ``b``,
    ``w_neigh`` and, for SAGEConv, ``w_self``."""
    per = 3 if conv == "sageconv" else 2
    if len(leaves) % per:
        raise ValueError(f"{len(leaves)} leaves do not split into {conv} "
                         f"layers of {per}")

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)

    layers = []
    for i in range(0, len(leaves), per):
        layer = leaves[i: i + per]
        layers.append(GNNLayer(t(layer[1]), t(layer[0]),
                               t(layer[2]) if per == 3 else None))
    return GNN(conv, layers)


def block_arrays(blocks, input_ids, device) -> dict:
    """Padded blocks and the input node ids as tensors on ``device``."""
    def t(a, dtype):
        return torch.from_numpy(np.asarray(a).astype(dtype)).to(device)

    return {
        "blocks": [
            {
                "edge_src": t(b.edge_src, np.int32),
                "edge_dst": t(b.edge_dst, np.int32),
                "edge_mask": t(b.edge_mask, bool),
                "dst_remote_mask": t(b.dst_remote_mask, bool),
                "dst_remote_slot": t(b.dst_remote_slot, np.int64),
            }
            for b in blocks
        ],
        "input_ids": t(input_ids, np.int64),
    }


def blocks_to_arrays(mb, device) -> dict:
    """A sampled :class:`MiniBatch` (blocks, input ids, seeds and their
    mask) as tensors on ``device``."""
    out = block_arrays(mb.blocks, mb.input_ids, device)
    out["seeds"] = torch.from_numpy(mb.seeds.astype(np.int64)).to(device)
    out["seed_mask"] = torch.from_numpy(mb.seed_mask).to(device)
    return out


def shard_to_arrays(shard, device) -> dict:
    """A ClientShard's CSR over local destinations as a flat edge list."""
    e_dst = np.repeat(np.arange(shard.num_local), np.diff(shard.indptr))
    e_src = shard.indices.astype(np.int64)
    remote = e_src >= shard.num_local
    return {
        # remote src ids are already offset past num_local, which is where
        # full_propagate concatenates the cache table — no remap needed.
        "edge_src": torch.from_numpy(e_src.astype(np.int32)).to(device),
        "edge_dst": torch.from_numpy(e_dst.astype(np.int32)).to(device),
        "src_is_remote": torch.from_numpy(remote).to(device),
        "num_local": shard.num_local,
        "features": torch.from_numpy(
            np.asarray(shard.features, np.float32)).to(device),
    }
