"""Transports: where remote-embedding bytes travel.

Port of ``repro/exchange/transport.py``.  A :class:`Transport` separates
the *storage* of shared embeddings (the EmbeddingServer tables) from the
*wire model* that charges for moving them.  The port has the in-process
transport — one embedding server behind one modelled link, the seed
topology of §5.1 — with its tables on the device, so the fused int8
surface is always available.  Hash-sharded and TCP transports come in
later slices.

Time accounting is split into the pure :meth:`Transport.transfer_time`
query (a push is priced when planned, applied later) and
:meth:`Transport.account`, which also records into the shard logs.
"""

from __future__ import annotations

import abc

import numpy as np
import torch

from repro_torch.core.cost_model import NetworkModel, TransferLog
from repro_torch.core.embedding_server import EmbeddingServer


class Transport(abc.ABC):
    """Storage + modelled wire for one federated deployment."""

    num_layers: int
    hidden: int
    device: torch.device

    @abc.abstractmethod
    def register(self, global_ids: np.ndarray) -> None: ...

    @abc.abstractmethod
    def write(self, global_ids: np.ndarray, layer_values: list) -> None:
        """Raw store of decoded fp32 rows (no accounting)."""

    @abc.abstractmethod
    def gather(self, global_ids: np.ndarray,
               layers: list[int] | None = None) -> list[torch.Tensor]:
        """Raw read (no accounting), original id order."""

    @abc.abstractmethod
    def gather_quantized(self, global_ids: np.ndarray,
                         layers: list[int] | None = None) -> list[tuple]:
        """Fused pull response: per selected layer, (values int8
        (n, hidden), scales fp32 (n, 1)) in original id order."""

    @abc.abstractmethod
    def write_quantized(self, global_ids: np.ndarray,
                        layer_payloads: list[tuple]) -> None:
        """Fused push apply: store int8 payload rows via decode+scatter."""

    @abc.abstractmethod
    def gather_versioned(
        self, global_ids: np.ndarray, have_versions: np.ndarray,
        layers: list[int] | None = None,
    ) -> tuple[np.ndarray, np.ndarray, list[torch.Tensor]]:
        """Conditional gather for serving-side caches (no accounting):
        ``(versions, stale_pos, layer_values)``."""

    @abc.abstractmethod
    def transfer_time(self, global_ids: np.ndarray, layers: int,
                      bytes_per_scalar: float) -> float:
        """Pure time query for one batched transfer (no logging)."""

    @abc.abstractmethod
    def account(self, global_ids: np.ndarray, layers: int,
                bytes_per_scalar: float) -> float:
        """Record one batched transfer in the shard logs, return time."""


class InProcessTransport(Transport):
    """Single embedding server behind a single modelled link."""

    def __init__(self, num_layers: int, hidden: int,
                 net: NetworkModel | None = None, *, device: str = "cuda"):
        self.num_layers = num_layers
        self.hidden = hidden
        self.net = net or NetworkModel()
        self.server = EmbeddingServer(num_layers, hidden, device=device)
        self.device = self.server.device
        self._log = TransferLog()

    def register(self, global_ids):
        self.server.register(global_ids)

    def write(self, global_ids, layer_values):
        self.server.write(global_ids, layer_values)

    def gather(self, global_ids, layers=None):
        return self.server.gather(global_ids, layers)

    def gather_quantized(self, global_ids, layers=None):
        return self.server.gather_quantized(global_ids, layers)

    def write_quantized(self, global_ids, layer_payloads):
        self.server.write_quantized(global_ids, layer_payloads)

    def gather_versioned(self, global_ids, have_versions, layers=None):
        return self.server.gather_if_stale(global_ids, have_versions, layers)

    def transfer_time(self, global_ids, layers, bytes_per_scalar):
        if len(global_ids) == 0 or layers == 0:
            return 0.0
        return self.net.transfer_time(len(global_ids), self.hidden, layers,
                                      bytes_per_scalar=bytes_per_scalar)

    def account(self, global_ids, layers, bytes_per_scalar):
        t = self.transfer_time(global_ids, layers, bytes_per_scalar)
        if t == 0.0:
            return 0.0
        self._log.add(
            bytes=self.net.embedding_bytes(len(global_ids), self.hidden,
                                           layers,
                                           bytes_per_scalar=bytes_per_scalar),
            rpcs=1, embeddings=len(global_ids) * layers, seconds=t)
        return t

    @property
    def log(self) -> TransferLog:
        return self._log

    @property
    def num_embeddings_stored(self) -> int:
        return self.server.num_embeddings_stored


def make_transport(num_layers: int, hidden: int, *, kind: str = "inprocess",
                   net: NetworkModel | None = None,
                   device: str = "cuda") -> Transport:
    """The transport a deployment uses; ``kind='inprocess'`` (one
    modelled link, device tables on ``device``) is the one this port has
    so far."""
    if kind != "inprocess":
        raise ValueError(f"unknown transport kind {kind!r}; this port has "
                         "'inprocess' only")
    return InProcessTransport(num_layers, hidden, net, device=device)
