"""Dynamic-graph plane: delta segments, growth schedules, restreaming.

Port of ``repro/dyngraph``: :mod:`repro_torch.dyngraph.delta` (overlay
and compaction), :mod:`repro_torch.dyngraph.events` (seeded growth
schedules), :mod:`repro_torch.dyngraph.restream` (incremental
re-partitioning), :mod:`repro_torch.dyngraph.runtime` (the per-run
growth driver) and :mod:`repro_torch.dyngraph.wire` (the fedsvc growth
barrier's frame).  Everything but the wire is numpy only.
"""

from .delta import DeltaLog, GraphOverlay, Segment, compact
from .events import GrowthSchedule
from .restream import RestreamConfig, admit, edge_cut_stream, \
    repartition, restream_pass
from .runtime import GrowthRuntime

__all__ = [
    "DeltaLog", "GraphOverlay", "Segment", "compact",
    "GrowthSchedule", "RestreamConfig", "admit", "edge_cut_stream",
    "repartition", "restream_pass", "GrowthRuntime",
]
