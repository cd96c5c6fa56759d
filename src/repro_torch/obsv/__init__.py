"""Observability plane of the port: trace spans and a metrics registry.

Port of ``repro.obsv``'s two in-process modules:

  :mod:`~repro_torch.obsv.trace`   — low-overhead span recorder (Chrome
      trace-event export; the ``REPRO_TRACE`` environment variable turns
      it on, as in the JAX package).
  :mod:`~repro_torch.obsv.metrics` — named registry of counters, gauges
      and log-bucketed histograms with snapshot/delta semantics.

The wire telemetry (``teleserve``) waits for the port's TCP wire
(``ROADMAP.md`` Queue A item 3).  Instrumented code calls the
module-level singletons (:data:`repro_torch.obsv.trace.TRACE`,
:data:`repro_torch.obsv.metrics.REGISTRY`); disabled tracing is a
zero-allocation no-op, and metrics are always on.
"""

from . import metrics, trace  # noqa: F401
