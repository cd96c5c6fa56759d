"""Publish half of the federated runtime: bootstrap push and export.

Port of the parts of ``FederatedGNNTrainer`` (``repro/core/federated.py``)
that put a model's embeddings into the embedding server, as functions
over (model, shards, part, transport, codec):

  setup_exchange      — reciprocal push sets and registration of every
                        client's pull and push vertices
  pretrain_push       — §3.2.1 bootstrap: h^1..h^{L-1} of the push
                        vertices from the unexpanded local subgraph
  export_for_serving  — publish every owned vertex's h^1..h^{L-1} and
                        return the bundle ``gnnserve.build_serving`` takes

The training slice wraps them into the trainer.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.exchange import ExchangeClient, Transport
from repro_torch.graphs.partition import ClientShard
from repro_torch.models.gnn import GNN, shard_to_arrays


def setup_exchange(shards: list[ClientShard], part: np.ndarray,
                   transport: Transport) -> None:
    """Push sets follow the pull sets: client c pushes exactly the
    vertices other clients pull from it.  Then every client's pull and
    push vertices are registered with the exchange."""
    for sh in shards:
        wanted = [other.pull_nodes[part[other.pull_nodes] == sh.client_id]
                  for other in shards if other.client_id != sh.client_id]
        sh.push_nodes = np.unique(np.concatenate(wanted)) \
            if wanted else np.zeros(0, np.int64)
    for sh in shards:
        for gids in (sh.pull_nodes, sh.push_nodes):
            transport.register(gids)


def push_rows(shard: ClientShard) -> np.ndarray:
    """Shard-local row of each of the shard's push vertices."""
    local = np.asarray(shard.global_ids[: shard.num_local], np.int64)
    order = np.argsort(local, kind="stable")
    pos = np.searchsorted(local[order], shard.push_nodes)
    return order[pos].astype(np.int64)


def fill_cache(client: ExchangeClient, shard: ClientShard,
               num_layers: int) -> list[torch.Tensor]:
    """The shard's remote-slot tables (slot i ↔ ``pull_nodes[i]``) filled
    with the pulled h^1..h^{L-1} rows as seen after the wire; one zero
    row when the shard has no remote vertices."""
    dev = client.transport.device
    hidden = client.hidden
    if len(shard.pull_nodes) == 0:
        return [torch.zeros((1, hidden), dtype=torch.float32, device=dev)
                for _ in range(num_layers - 1)]
    vals = client.peek(shard.pull_nodes)
    return [v.contiguous() for v in vals]


def pretrain_push(model: GNN, shards: list[ClientShard],
                  transport: Transport, codec: str, *,
                  device: str = "cuda") -> None:
    """§3.2.1: push-vertex embeddings from the unexpanded local subgraphs
    (remote neighbours masked) seed the server."""
    client = ExchangeClient(transport, codec)
    L = model.num_layers
    for sh in shards:
        if len(sh.push_nodes) == 0:
            continue
        outs = model.full_propagate(shard_to_arrays(sh, device), None)
        rows = torch.from_numpy(push_rows(sh)).to(outs[0].device)
        client.push(sh.push_nodes, [outs[l][rows] for l in range(L - 1)])


def export_for_serving(model: GNN, shards: list[ClientShard],
                       part: np.ndarray, transport: Transport, codec: str,
                       *, device: str = "cuda") -> dict:
    """Publish the model's state for the serving plane.

    A query can land on any vertex, so every shard's local vertices are
    registered and their full h^1..h^{L-1} pushed through the codec
    (a full-neighbourhood propagate against the cache each client pulls
    first, in client order, as the JAX trainer does).  Returns the bundle
    :func:`repro_torch.gnnserve.build_serving` consumes."""
    pub = ExchangeClient(transport, codec)
    L = model.num_layers
    for sh in shards:
        caches = fill_cache(pub, sh, L)
        outs = model.full_propagate(shard_to_arrays(sh, device), caches)
        gids = np.asarray(sh.global_ids[: sh.num_local], np.int64)
        pub.register(gids)
        pub.push(gids, [outs[l] for l in range(L - 1)])
    return {
        "model": model,
        "conv": model.conv,
        "num_layers": L,
        "hidden": model.hidden,
        "part": np.asarray(part),
        "shards": {sh.client_id: sh for sh in shards},
        "transport": transport,
        "codec": codec,
    }
