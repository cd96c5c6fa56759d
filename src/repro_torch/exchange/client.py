"""ExchangeClient: the per-client facade over codec × delta × transport.

Port of ``repro/exchange/client.py``.  Every remote-embedding interaction
of the training, publish and serve paths routes through here:

  peek            — cache-fill numerics: the values this client would see
                    after one wire crossing (no charge)
  pull_cost       — charge one batched upfront GET (§3.2.2 pull phase)
  dynamic_pull    — charge one on-demand per-minibatch GET (§4.3)
  pull_versioned  — conditional GET for serving caches
  plan_push       — error-feedback, delta-filter and encode the push rows
                    and price the SET without applying it
  apply_push      — commit a planned push: store the rows, refresh the
                    delta shadow and residuals, record the log

The transport's tables live on the device, so with the int8 codec pulls
and pushes ride the fused surface: gather+encode on the resident table
(``peek``) and decode+scatter of the planned payload (``apply_push``).
Values come back as tensors on the transport's device.  The delta
shadow and the error-feedback residuals live on the host
(:mod:`repro_torch.exchange.delta`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .codec import WireCodec, get_codec
from .delta import DeltaTracker, ErrorFeedback
from .transport import Transport


@dataclasses.dataclass
class PushPlan:
    """A priced, not-yet-applied push.  Abandoning a plan has no side
    effects: the delta shadow and error-feedback residuals are only
    refreshed when the plan is applied."""
    global_ids: np.ndarray            # delta-selected rows
    layer_values: list[torch.Tensor]  # decoded fp32 (post codec roundtrip)
    raw_values: list                  # pre-codec fp32 (shadow refresh);
                                      # EF-compensated when EF is on
    transfer_time: float
    n_selected: int
    n_total: int
    # int8 plans carry the encoded payload, so apply_push ships the wire
    # form to the fused decode+scatter and never re-encodes; decoding it
    # equals layer_values bit-exactly
    payloads: list | None = None


class ExchangeClient:
    def __init__(self, transport: Transport, codec: WireCodec | str = "fp32",
                 *, delta_threshold: float | None = None,
                 error_feedback: bool = False):
        self.transport = transport
        self.codec = get_codec(codec)
        self.hidden = transport.hidden
        self.shared_layers = transport.num_layers - 1
        self.delta = None if delta_threshold is None else DeltaTracker(
            delta_threshold, self.shared_layers, self.hidden)
        self.ef = ErrorFeedback(self.shared_layers, self.hidden) \
            if error_feedback else None

    @property
    def bytes_per_scalar(self) -> float:
        return self.codec.bytes_per_scalar(self.hidden)

    def register(self, global_ids: np.ndarray) -> None:
        self.transport.register(global_ids)

    def _fused_int8(self) -> bool:
        return self.codec.name == "int8"

    # -- pull side ---------------------------------------------------------

    def peek(self, global_ids: np.ndarray,
             layers: list[int] | None = None) -> list[torch.Tensor]:
        """Table rows as seen after one wire crossing, no wire charge."""
        if self._fused_int8():
            payloads = self.transport.gather_quantized(global_ids, layers)
            return [self.codec.decode(p) for p in payloads]
        raw = self.transport.gather(global_ids, layers)
        return [self.codec.roundtrip(v) for v in raw]

    def pull(self, global_ids: np.ndarray, layers: list[int] | None = None
             ) -> tuple[list[torch.Tensor], float]:
        """Batched GET: values after the wire + modelled time."""
        vals = self.peek(global_ids, layers)
        return vals, self.pull_cost(global_ids, len(vals))

    def pull_cost(self, global_ids: np.ndarray,
                  layers: int | None = None) -> float:
        """Charge one batched GET of ``layers`` tables (default all)."""
        layers = self.shared_layers if layers is None else layers
        return self.transport.account(global_ids, layers,
                                      self.bytes_per_scalar)

    def dynamic_pull(self, global_ids: np.ndarray) -> float:
        """Charge one on-demand miss RPC (one table row per id — ids may
        repeat across layers)."""
        return self.transport.account(global_ids, 1, self.bytes_per_scalar)

    def pull_versioned(
        self, global_ids: np.ndarray, have_versions: np.ndarray,
        layers: list[int] | None = None,
    ) -> tuple[np.ndarray, np.ndarray, list[torch.Tensor], float]:
        """Conditional GET for serving-side caches: row values cross the
        wire only where the server's version differs from
        ``have_versions`` (-1 = never seen), and only those rows are
        charged.  Returns ``(versions, stale_pos, stale_values, time)``
        with stale_values after the codec roundtrip."""
        ver, stale, vals = self.transport.gather_versioned(
            global_ids, have_versions, layers)
        vals = [self.codec.roundtrip(v) for v in vals]
        n_layers = len(vals) if layers is None else len(list(layers))
        t = self.transport.account(np.asarray(global_ids)[stale], n_layers,
                                   self.bytes_per_scalar)
        return ver, stale, vals, t

    # -- push side ---------------------------------------------------------

    def plan_push(self, global_ids: np.ndarray,
                  layer_values: list) -> PushPlan:
        """Error-feedback, delta-filter, codec-encode and price a push of
        h^1..h^{L-1} rows without touching the server."""
        dev = self.transport.device
        n_total = len(global_ids)
        global_ids = np.asarray(global_ids)
        raw = [torch.as_tensor(v, dtype=torch.float32).to(dev)
               for v in layer_values]
        host_raw = None
        if self.ef is not None or self.delta is not None:
            host_raw = [v.cpu().numpy() for v in raw]
            # EF folds the carried residual in *before* delta selection,
            # so the τ rule and the shadow both see the compensated
            # values the wire will actually carry.
            if self.ef is not None:
                host_raw = self.ef.compensate(global_ids, host_raw)
            if self.delta is not None:
                sel = self.delta.select(global_ids, host_raw)
                global_ids = global_ids[sel]
                host_raw = [v[sel] for v in host_raw]
            raw = [torch.from_numpy(v).to(dev) for v in host_raw]
        payloads = None
        if self._fused_int8():
            payloads = [self.codec.encode(v) for v in raw]
            decoded = [self.codec.decode(p) for p in payloads]
        else:
            decoded = [self.codec.roundtrip(v) for v in raw]
        t = self.transport.transfer_time(global_ids, self.shared_layers,
                                         self.bytes_per_scalar) \
            if len(global_ids) else 0.0
        return PushPlan(global_ids=global_ids, layer_values=decoded,
                        raw_values=raw if host_raw is None else host_raw,
                        transfer_time=t, n_selected=len(global_ids),
                        n_total=n_total, payloads=payloads)

    def apply_push(self, plan: PushPlan) -> float:
        """Commit a planned push: store what the server decodes, refresh
        the delta shadow and the residuals, record the transfer in the
        shard log."""
        if plan.n_selected == 0:
            return 0.0
        if plan.payloads is not None:
            self.transport.write_quantized(plan.global_ids, plan.payloads)
        else:
            self.transport.write(plan.global_ids, plan.layer_values)
        if self.delta is not None:
            self.delta.commit(plan.global_ids, plan.raw_values)
        if self.ef is not None:
            self.ef.commit(plan.global_ids, plan.raw_values,
                           [v.cpu().numpy() for v in plan.layer_values])
        return self.transport.account(plan.global_ids, self.shared_layers,
                                      self.bytes_per_scalar)

    def push(self, global_ids: np.ndarray, layer_values: list) -> float:
        """Immediate push (pre-training bootstrap, §3.2.1; publishing)."""
        return self.apply_push(self.plan_push(global_ids, layer_values))
