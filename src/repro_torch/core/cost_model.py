"""Network cost model for the federated runtime (copy of
``repro/core/cost_model.py``; the transports price every transfer with
it, the trainer and the coordinator the model exchange, and
:func:`fit_network_model` calibrates it from measured RPCs).

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

import numpy as np


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

    def model_transfer_time(self, n_params: int, *,
                            bytes_per_scalar: float | None = None) -> float:
        """Client↔aggregation-server model exchange (one direction).
        ``bytes_per_scalar`` makes the weight wire codec-aware: the
        coordinator passes the effective bytes/param of what it framed;
        default is the raw fp32 value."""
        bps = self.bytes_per_scalar if bytes_per_scalar is None \
            else bytes_per_scalar
        return n_params * bps / self.bandwidth_bytes_per_s \
            + self.rpc_overhead_s


@dataclasses.dataclass
class TransferLog:
    """Accumulated traffic statistics for one phase/entity.

    ``seconds`` is always the *modelled* time.  Transports that move
    real bytes (TcpTransport) also accumulate the measured wall time of
    the same RPCs into ``measured_seconds``; purely modelled transports
    leave it 0."""
    bytes: int = 0
    rpcs: int = 0
    embeddings: int = 0
    seconds: float = 0.0
    measured_seconds: float = 0.0

    def add(self, *, bytes: int = 0, rpcs: int = 0, embeddings: int = 0,
            seconds: float = 0.0, measured_seconds: float = 0.0) -> None:
        self.bytes += bytes
        self.rpcs += rpcs
        self.embeddings += embeddings
        self.seconds += seconds
        self.measured_seconds += measured_seconds


def fit_network_model(samples, *, base: NetworkModel | None = None,
                      relative: bool = False) -> NetworkModel:
    """Least-squares calibration of the analytic wire model from
    measured RPCs.

    ``samples`` is an iterable of ``(payload_bytes, n_rpcs,
    n_embeddings, measured_seconds)`` rows (e.g. unpacked from
    :class:`repro_torch.exchange.socket_transport.RpcSample`).  Fits

        t  ≈  bytes / bandwidth + rpcs · rpc_overhead
              + embeddings · per_embedding_overhead

    with all three coefficients non-negative (a negative unconstrained
    coefficient is dropped and the rest refit: a small active-set pass).
    ``relative=True`` weights each row by 1/t, minimising relative
    residuals so small RPCs are not drowned out by large ones.  With a
    fixed codec and hidden size, bytes and embeddings are collinear:
    vary the hidden size, and fit one model per codec.

    Returns a :class:`NetworkModel` carrying the fitted parameters
    (``bytes_per_scalar`` copied from ``base``: the codec, not the
    link, decides it)."""
    rows = [(float(b), float(r), float(e), float(t))
            for b, r, e, t in samples]
    if len(rows) < 3:
        raise ValueError(f"need >= 3 samples to fit 3 parameters, "
                         f"got {len(rows)}")
    A = np.array([[b, r, e] for b, r, e, _ in rows])
    y = np.array([t for *_, t in rows])
    if relative:
        w = 1.0 / np.maximum(y, 1e-12)
        A = A * w[:, None]
        y = y * w
    active = [0, 1, 2]
    coef = np.zeros(3)
    while active:
        sol, *_ = np.linalg.lstsq(A[:, active], y, rcond=None)
        if (sol >= 0).all():
            coef[:] = 0.0
            coef[active] = sol
            break
        active = [c for c, v in zip(active, sol) if v >= 0]
    base = base or NetworkModel()
    inv_bw, rpc_oh, emb_oh = coef
    return NetworkModel(
        bandwidth_bytes_per_s=(1.0 / inv_bw) if inv_bw > 0 else float("inf"),
        rpc_overhead_s=float(rpc_oh),
        per_embedding_overhead_s=float(emb_oh),
        bytes_per_scalar=base.bytes_per_scalar,
    )
