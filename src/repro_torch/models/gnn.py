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
two packages can be held against each other on the same inputs; each
also carries the CSR of its kept edges, built once on the host, and a
block on the card carries that CSR in place of its padded edge lists.
"""

from __future__ import annotations

import copy
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.gnn_aggregate import csr_arrays, csr_of

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


def _aggregate(h_src: torch.Tensor, edges: dict, n_dst: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The neighbour mean over an edge set (a block, or one of a shard's
    two): over the CSR of its kept edges built on the host where the
    card aggregates, over its padded edge lists where the CPU does (a
    block on the card carries no edge lists)."""
    return ops.gnn_aggregate(h_src, edges.get("edge_src"),
                             edges.get("edge_dst"), edges.get("edge_mask"),
                             n_dst, edges["csr"])


def _layer_forward(layer: GNNLayer, conv: str, h_src: torch.Tensor,
                   blk: dict, *, last: bool) -> torch.Tensor:
    n_dst = blk["dst_remote_mask"].shape[0]   # padded dst size
    agg, cnt = _aggregate(h_src, blk, n_dst)
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
        h_local = shard_arrays["features"]
        outs = []
        for l in range(1, L + 1):
            if l == 1 or caches is None:
                # remote sources masked: their ids point at a zero row
                pad = torch.zeros((1, h_local.shape[1]), dtype=h_local.dtype,
                                  device=h_local.device)
                src_tbl = torch.cat([h_local, pad], dim=0)
                edges = shard_arrays["local"]
            else:
                # remote ids already offset past num_local
                src_tbl = torch.cat([h_local, caches[l - 2]], dim=0)
                edges = shard_arrays["every"]
            agg, cnt = _aggregate(src_tbl, edges, num_local)
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


def sgd_train_step(model: GNN, batch: dict, features: torch.Tensor,
                   caches: Sequence[torch.Tensor], labels: torch.Tensor,
                   *, lr: float) -> tuple[GNN, torch.Tensor]:
    """One plain SGD step, ``p - lr * grad`` on every leaf, as the JAX
    ``sgd_train_step``: a new model (``model`` is left as it was) and
    the step's loss."""
    leaves = model.leaves()
    loss = loss_fn(model, batch, features, caches, labels)
    grads = torch.autograd.grad(loss, leaves)
    new = copy.deepcopy(model)
    with torch.no_grad():
        for p, w, g in zip(new.leaves(), leaves, grads):
            p.copy_(w - lr * g)
    return new, loss.detach()


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


#: numpy dtype → torch dtype of the arrays :func:`to_device` moves
_TORCH_DTYPES = {np.dtype(d): t for d, t in (
    (bool, torch.bool), (np.int8, torch.int8), (np.uint8, torch.uint8),
    (np.int32, torch.int32), (np.int64, torch.int64),
    (np.float32, torch.float32))}


def to_device(tree, device):
    """``tree`` (dicts, lists and named tuples of numpy arrays and other
    leaves) with every array on ``device``, in one transfer.  The arrays
    are packed at 16-byte offsets into one host buffer (page-locked for
    the card, so the copy does not wait on the host), copied once, and
    split there into typed views; an array (or a container) that appears
    twice is copied once and comes back as one object.  Other leaves pass
    through."""
    arrays: dict[int, np.ndarray] = {}

    def collect(x):
        if isinstance(x, np.ndarray):
            arrays.setdefault(id(x), np.ascontiguousarray(x))
        elif isinstance(x, dict):
            for v in x.values():
                collect(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                collect(v)

    collect(tree)
    # each array, then the padding that puts the next one at 16 bytes
    sizes = []
    for a in arrays.values():
        sizes += [a.nbytes, -a.nbytes % 16]
    dev = torch.device(device)
    host = torch.empty(sum(sizes), dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    buf = host.numpy()
    at = 0
    for a, pad in zip(arrays.values(), sizes[1::2]):
        buf[at: at + a.nbytes] = a.reshape(-1).view(np.uint8)
        at += a.nbytes + pad
    pieces = host.to(dev, non_blocking=True).split(sizes)[::2]
    views = {}
    for (key, a), piece in zip(arrays.items(), pieces):
        t = piece.view(_TORCH_DTYPES[a.dtype])
        views[key] = t if a.ndim == 1 else t.view(a.shape)

    done: dict[int, object] = {}

    def rebuild(x):
        if isinstance(x, np.ndarray):
            return views[id(x)]
        if id(x) in done:
            return done[id(x)]
        if isinstance(x, dict):
            out = {k: rebuild(v) for k, v in x.items()}
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            out = type(x)(*[rebuild(v) for v in x])
        elif isinstance(x, (list, tuple)):
            out = type(x)(rebuild(v) for v in x)
        else:
            return x
        done[id(x)] = out
        return out

    return rebuild(tree)


def _host_blocks(blocks, input_ids, device, *, transposed: bool) -> dict:
    """Padded blocks and the input node ids as numpy arrays, each block
    with the CSR of its kept edges (and, with ``transposed``, the
    transposed CSR for the backward of every block past the first, whose
    source is the feature table).  The padded edge lists, which only the
    plain versions read, are kept for the CPU alone: the card's kernels
    read the CSRs."""
    edge_lists = torch.device(device).type != "cuda"

    def a(x, dtype):
        return np.asarray(x).astype(dtype, copy=False)

    out = []
    for j, b in enumerate(blocks):
        blk = {
            "dst_remote_mask": a(b.dst_remote_mask, bool),
            "dst_remote_slot": a(b.dst_remote_slot, np.int64),
            "csr": csr_arrays(b.p_src, b.edge_src, b.edge_dst, b.edge_mask,
                              b.p_dst, transposed=transposed and j > 0),
        }
        if edge_lists:
            blk.update(edge_src=a(b.edge_src, np.int32),
                       edge_dst=a(b.edge_dst, np.int32),
                       edge_mask=a(b.edge_mask, bool))
        out.append(blk)
    return {"blocks": out, "input_ids": a(input_ids, np.int64)}


def block_arrays(blocks, input_ids, device) -> dict:
    """Padded blocks and the input node ids as tensors on ``device``, in
    one copy, each block with the CSR of its kept edges."""
    return to_device(_host_blocks(blocks, input_ids, device,
                                  transposed=False), device)


def blocks_to_arrays(mb, device) -> dict:
    """A sampled :class:`MiniBatch` (blocks with their CSRs and transposed
    CSRs, input ids, seeds and their mask) as tensors on ``device``, in
    one copy."""
    host = _host_blocks(mb.blocks, mb.input_ids, device, transposed=True)
    host["seeds"] = np.asarray(mb.seeds, np.int64)
    host["seed_mask"] = np.asarray(mb.seed_mask, bool)
    return to_device(host, device)


def propagate_arrays(indptr: np.ndarray, e_src: np.ndarray, num_local: int,
                     n_src: int, features: np.ndarray, device) -> dict:
    """``full_propagate``'s inputs on ``device`` from a CSR over
    ``num_local`` destinations (``indptr``; source ids ``e_src`` below
    ``n_src``, those from ``num_local`` on remote): the features and two
    edge sets, "local" (remote sources masked and pointed at the zero row
    ``num_local``) and "every" edge, each with the CSR of its kept edges
    and its padded edge lists.  The CSRs are built on the host and copied
    with the features in one transfer; the edge lists, which only the
    plain versions read, are derived from them on the device."""
    e_src = np.asarray(e_src).astype(np.int32)
    src_rows = int(e_src.max()) + 1 if len(e_src) else 0
    if len(e_src) and (e_src.min() < 0 or src_rows > n_src):
        raise ValueError(f"edge ids out of range: src [{e_src.min()}, "
                         f"{src_rows - 1}] for {n_src} rows")
    every = csr_of(np.asarray(indptr, np.int64), e_src, src_rows)
    remote = e_src >= num_local
    if remote.any():
        # a row's kept edges start after the local edges before the row
        pos = np.flatnonzero(~remote)
        kept = e_src[pos]
        local = csr_of(np.searchsorted(pos, every.indptr), kept,
                       int(kept.max()) + 1 if len(kept) else 0)
    else:
        local = every
    t = to_device({"features": np.asarray(features, np.float32),
                   "every": every, "local": local}, device)
    csr = t["every"]
    e_src_t = csr.indices
    e_dst = torch.repeat_interleave(
        torch.arange(num_local, dtype=torch.int32, device=e_src_t.device),
        csr.indptr[1:] - csr.indptr[:-1], output_size=len(e_src))
    remote_t = e_src_t >= num_local
    out = {"edge_src": e_src_t, "edge_dst": e_dst, "src_is_remote": remote_t,
           "num_local": num_local, "features": t["features"],
           "every": {"edge_src": e_src_t, "edge_dst": e_dst,
                     "edge_mask": torch.ones_like(remote_t), "csr": csr}}
    out["local"] = out["every"] if local is every else {
        "edge_src": torch.where(remote_t, num_local, e_src_t),
        "edge_dst": e_dst, "edge_mask": ~remote_t, "csr": t["local"]}
    return out


def shard_to_arrays(shard, device) -> dict:
    """A ClientShard's CSR over local destinations as ``full_propagate``'s
    inputs (:func:`propagate_arrays`); remote source ids are already
    offset past num_local, which is where ``full_propagate``
    concatenates the cache table."""
    return propagate_arrays(shard.indptr, shard.indices, shard.num_local,
                            shard.num_local + shard.num_remote,
                            shard.features, device)
