"""Network cost model for the federated runtime (copy of the embedding
and model-exchange part of ``repro/core/cost_model.py``; the transports
price every transfer with it, the trainer the FedAvg round trip).

The network is modelled after the paper's testbed: clients and the
embedding/aggregation servers connected by 1 Gbps Ethernet, Redis-style
batched+pipelined RPCs (§5.1–5.2).

Calibration targets from the paper (§5.4): pushing ≈100k embeddings takes
≈1.8 s on Reddit/GraphConv (hidden=32 ⇒ 128 B payload/embedding/layer,
2 layers shared for L=3) — 100k · 2 · 128 B = 25.6 MB ⇒ ≈0.2 s of pure
wire time on 1 Gbps; the remaining ≈1.6 s is serialization + Redis
pipeline overhead, which we fold into ``per_embedding_overhead``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    bandwidth_bytes_per_s: float = 125e6      # 1 Gbps
    rpc_overhead_s: float = 1.5e-3            # per round-trip (LAN + Redis)
    per_embedding_overhead_s: float = 6.0e-6  # ser/deser + pipeline cost
    bytes_per_scalar: float = 4               # fp32 wire default (no codec)

    def embedding_bytes(self, n: int, hidden: int, layers: int,
                        *, bytes_per_scalar: float | None = None) -> int:
        """Wire bytes for n embeddings × layers tables.  The exchange
        subsystem's codecs drive ``bytes_per_scalar`` (e.g. int8 rows pay
        1 B/scalar + an amortized 4 B/row scale); default is the model's
        own fp32 value."""
        bps = self.bytes_per_scalar if bytes_per_scalar is None \
            else bytes_per_scalar
        return int(round(n * hidden * layers * bps))

    def transfer_time(self, n_embeddings: int, hidden: int, layers: int,
                      *, n_rpcs: int = 1,
                      bytes_per_scalar: float | None = None) -> float:
        """Time for a batched+pipelined transfer of n embeddings ×
        ``layers`` embedding-table namespaces."""
        if n_embeddings <= 0:
            return 0.0
        wire = self.embedding_bytes(n_embeddings, hidden, layers,
                                    bytes_per_scalar=bytes_per_scalar) \
            / self.bandwidth_bytes_per_s
        return wire + n_rpcs * self.rpc_overhead_s \
            + n_embeddings * layers * self.per_embedding_overhead_s

    def model_transfer_time(self, n_params: int) -> float:
        """Client↔aggregation-server model exchange (one direction) of
        ``n_params`` raw fp32 weights."""
        return n_params * self.bytes_per_scalar / self.bandwidth_bytes_per_s \
            + self.rpc_overhead_s


@dataclasses.dataclass
class TransferLog:
    """Accumulated modelled traffic for one phase/entity."""
    bytes: int = 0
    rpcs: int = 0
    embeddings: int = 0
    seconds: float = 0.0

    def add(self, *, bytes: int = 0, rpcs: int = 0, embeddings: int = 0,
            seconds: float = 0.0) -> None:
        self.bytes += bytes
        self.rpcs += rpcs
        self.embeddings += embeddings
        self.seconds += seconds
