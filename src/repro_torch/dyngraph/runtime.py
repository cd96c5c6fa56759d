"""Growth runtime: schedule → overlay → partition, round by round.

Port of ``repro/dyngraph/runtime.py``.  Its gauges and counter are
``pt_dyngraph.segments``, ``pt_dyngraph.edge_cut`` and
``pt_dyngraph.boundary_registrations`` (the JAX module owns the
``dyngraph.*`` series); the spans keep the JAX names.

``GrowthRuntime`` is the single object the trainer (and the fedsvc
eval harness) holds: it owns the merged graph view, the evolving
partition and the applied-epoch watermark, and turns "round ``r`` is
starting" into "apply events ``applied+1 .. epoch_for_round(r)``".
Every step is deterministic in ``(schedule, partition seed, restream
config)``, so independent worker processes advance identical replicas
without exchanging graph state — the coordinator only synchronizes
*when* they advance, not *what* they apply.
"""

from __future__ import annotations

import numpy as np

from repro_torch.obsv.metrics import REGISTRY
from repro_torch.obsv.trace import TRACE

from .delta import GraphOverlay
from .events import GrowthSchedule
from .restream import RestreamConfig, edge_cut_stream, repartition

_SEGMENTS = REGISTRY.gauge("pt_dyngraph.segments")
_EDGE_CUT = REGISTRY.gauge("pt_dyngraph.edge_cut")
_BOUNDARY = REGISTRY.counter("pt_dyngraph.boundary_registrations")


class GrowthRuntime:
    """Applies a :class:`GrowthSchedule` to a base graph over rounds."""

    def __init__(self, schedule: GrowthSchedule, base_graph,
                 num_clients: int, *, method: str = "ldg",
                 passes: int = 0, seed: int = 0):
        self.schedule = schedule
        self.base = base_graph
        self.graph = base_graph        # overlay after the first event
        self.num_clients = int(num_clients)
        self.restream_cfg = RestreamConfig(method=method,
                                           passes=passes, seed=seed)
        self.part: np.ndarray | None = None
        self.applied_epoch = 0
        self._overlay: GraphOverlay | None = None

    def epoch_for_round(self, round_idx: int) -> int:
        return self.schedule.epoch_for_round(round_idx)

    def record_boundary(self, n: int) -> None:
        """New boundary vertices registered with the exchange."""
        _BOUNDARY.inc(int(n))

    def advance_to(self, epoch: int, part: np.ndarray = None) -> bool:
        """Apply every event up to ``epoch``; → True if the graph (and
        partition) changed.  ``part`` seeds the partition the first
        time the caller (who ran the initial static partitioning)
        hands it over."""
        if part is not None and self.part is None:
            self.part = np.asarray(part, dtype=np.int32).copy()
        target = min(max(int(epoch), 0), self.schedule.num_events)
        if target <= self.applied_epoch:
            return False
        if self._overlay is None:
            self._overlay = GraphOverlay(self.base)
            self.graph = self._overlay
        for e in range(self.applied_epoch + 1, target + 1):
            src, dst, nodes = self.schedule.event_batch(e)
            with TRACE.span("dyngraph.apply",
                            args={"epoch": e, "edges": len(src)}):
                self._overlay.apply(src, dst, nodes)
            if self.part is not None:
                with TRACE.span("dyngraph.restream",
                                args={"epoch": e,
                                      "passes": self.restream_cfg.passes}):
                    self.part = repartition(
                        self._overlay, self.part, self.num_clients,
                        self.restream_cfg)
                _EDGE_CUT.set(edge_cut_stream(self._overlay, self.part))
            _SEGMENTS.set(len(self._overlay.segments))
        self.applied_epoch = target
        return True
