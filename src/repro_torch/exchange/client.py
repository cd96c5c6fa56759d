"""ExchangeClient: the per-client facade over codec × transport.

Port of ``repro/exchange/client.py``.  Every remote-embedding interaction
of the publish and serve paths routes through here:

  peek            — cache-fill numerics: the values this client would see
                    after one wire crossing (no charge)
  pull_cost       — charge one batched upfront GET
  pull_versioned  — conditional GET for serving caches
  plan_push       — encode the push rows and price the SET without
                    applying it
  apply_push      — commit a planned push: store the rows, record the log

The transport's tables live on the device, so with the int8 codec pulls
and pushes ride the fused surface: gather+encode on the resident table
(``peek``) and decode+scatter of the planned payload (``apply_push``).
Values come back as tensors on the transport's device.  Delta pushes and
error feedback belong to the training slice and are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .codec import WireCodec, get_codec
from .transport import Transport


@dataclasses.dataclass
class PushPlan:
    """A priced, not-yet-applied push."""
    global_ids: np.ndarray
    layer_values: list[torch.Tensor]  # decoded fp32 (post codec roundtrip)
    transfer_time: float
    n_selected: int
    # int8 plans carry the encoded payload, so apply_push ships the wire
    # form to the fused decode+scatter and never re-encodes; decoding it
    # equals layer_values bit-exactly
    payloads: list | None = None


class ExchangeClient:
    def __init__(self, transport: Transport, codec: WireCodec | str = "fp32",
                 *, delta_threshold: float | None = None,
                 error_feedback: bool = False):
        if delta_threshold is not None or error_feedback:
            raise NotImplementedError(
                "delta pushes and error feedback come with the training "
                "slice of the port")
        self.transport = transport
        self.codec = get_codec(codec)
        self.hidden = transport.hidden
        self.shared_layers = transport.num_layers - 1

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
        """Codec-encode and price a push of h^1..h^{L-1} rows without
        touching the server."""
        dev = self.transport.device
        raw = [torch.as_tensor(v, dtype=torch.float32).to(dev)
               for v in layer_values]
        payloads = None
        if self._fused_int8():
            payloads = [self.codec.encode(v) for v in raw]
            decoded = [self.codec.decode(p) for p in payloads]
        else:
            decoded = [self.codec.roundtrip(v) for v in raw]
        t = self.transport.transfer_time(global_ids, self.shared_layers,
                                         self.bytes_per_scalar) \
            if len(global_ids) else 0.0
        return PushPlan(global_ids=np.asarray(global_ids),
                        layer_values=decoded, transfer_time=t,
                        n_selected=len(global_ids), payloads=payloads)

    def apply_push(self, plan: PushPlan) -> float:
        """Commit a planned push: store what the server decodes, record
        the transfer in the shard log."""
        if plan.n_selected == 0:
            return 0.0
        if plan.payloads is not None:
            self.transport.write_quantized(plan.global_ids, plan.payloads)
        else:
            self.transport.write(plan.global_ids, plan.layer_values)
        return self.transport.account(plan.global_ids, self.shared_layers,
                                      self.bytes_per_scalar)

    def push(self, global_ids: np.ndarray, layer_values: list) -> float:
        """Immediate push (pre-training bootstrap, §3.2.1; publishing)."""
        return self.apply_push(self.plan_push(global_ids, layer_values))
