"""Named metrics registry: counters, gauges, log-bucketed histograms.

The port's copy of ``repro/obsv/metrics.py``.  The port's instrumented
modules register their names under the ``pt_`` plane prefix (for
example ``pt_gnnserve.cache.hits``): the JAX modules own the unprefixed
names, and the analyzer's TL003 flags a name registered from two
modules.

Design goals, in order:

1. *Cheap on the hot path.*  Instrumented modules bind their metric
   objects once at import (``_REQS = REGISTRY.counter("embed.requests")``)
   so a hot-path tick is one attribute add — no name lookup, no lock.
   CPython's GIL makes the occasional lost increment under thread races
   possible in principle; telemetry tolerates that, ledgers that must be
   exact (TransferLog, coordinator history) stay where they are.
2. *Snapshot/delta semantics.*  ``REGISTRY.snapshot()`` is a plain
   JSON-able dict; ``REGISTRY.delta(prev)`` subtracts counter values and
   histogram counts so benchmarks can charge one phase (one round, one
   deployment) without resetting global state out from under everyone
   else.
3. *Text exposition.*  ``render_text()`` emits a Prometheus-style flat
   text form — one line per scalar, ``_bucket{le="…"}`` lines per
   histogram — which is what the JAX package's ``launch/obs_dump.py``
   prints as the merged metrics table.

Histograms are log-bucketed: bucket upper bounds are ``lo·factor^k``
up to ``hi`` plus a ``+Inf`` overflow, and a value lands in the first
bucket whose upper bound is ≥ the value (computed by bisection on the
precomputed bounds, so boundary behaviour is exact, not
floating-log-rounded).
"""

from __future__ import annotations

import bisect
import collections
import math
import threading
from typing import Callable, Iterator, Optional


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins level; optionally backed by a callable (read at
    snapshot time — e.g. a jit cache size or a queue length)."""

    __slots__ = ("name", "_value", "fn")

    def __init__(self, name: str, fn: Optional[Callable[[], float]] = None):
        self.name = name
        self._value = 0.0
        self.fn = fn

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:
                return float("nan")
        return self._value


def log_bounds(lo: float, hi: float, factor: float) -> list[float]:
    """Bucket upper bounds ``lo·factor^k`` for k = 0.. until ≥ hi.
    The implicit final bucket is +Inf (overflow)."""
    assert lo > 0 and hi > lo and factor > 1
    out, b = [], lo
    # the epsilon keeps float drift (b = lo·factor^k accumulated by
    # multiplication) from emitting one bound just past hi
    while b < hi * (1 - 1e-12):
        out.append(b)
        b *= factor
    out.append(b)
    return out


class Histogram:
    """Log-bucketed distribution with count/sum/min/max sidecars."""

    __slots__ = ("name", "bounds", "counts", "count", "sum", "vmin", "vmax")

    def __init__(self, name: str, *, lo: float = 1e-6, hi: float = 100.0,
                 factor: float = 2.0):
        self.name = name
        self.bounds = log_bounds(lo, hi, factor)
        self.counts = [0] * (len(self.bounds) + 1)   # +1: +Inf overflow
        self.count = 0
        self.sum = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        # first bucket whose upper bound is ≥ v; values past the last
        # bound land in the +Inf overflow slot
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-upper-bound estimate of the q-quantile (0 < q ≤ 1)."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return self.bounds[i] if i < len(self.bounds) else self.vmax
        return self.vmax

    def snapshot(self) -> dict:
        out = {"count": self.count, "sum": self.sum,
               "buckets": list(self.counts)}
        if self.count:
            out["min"] = self.vmin
            out["max"] = self.vmax
        return out


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    Creation takes a lock; reads and updates on the returned objects do
    not.  A name maps to exactly one metric type — asking for the same
    name with a different type is a programming error and raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}   # guarded-by: self._lock

    def _get(self, name: str, kind, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get(name, Gauge, lambda: Gauge(name, fn))
        if fn is not None:
            g.fn = fn           # re-registering rebinds the callable
        return g

    def histogram(self, name: str, *, lo: float = 1e-6, hi: float = 100.0,
                  factor: float = 2.0) -> Histogram:
        return self._get(name, Histogram,
                         lambda: Histogram(name, lo=lo, hi=hi,
                                           factor=factor))

    def names(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(n for n in self._metrics if n.startswith(prefix))

    def snapshot(self, prefix: str = "") -> dict:
        """JSON-able {name: scalar | histogram dict}."""
        out = {}
        with self._lock:
            items = sorted(self._metrics.items())
        for name, m in items:
            if not name.startswith(prefix):
                continue
            if isinstance(m, Histogram):
                out[name] = m.snapshot()
            else:
                out[name] = m.value
        return out

    @staticmethod
    def delta(now: dict, prev: dict) -> dict:
        """Elementwise difference of two snapshots: histogram counts,
        sums and buckets subtract, scalars subtract (a snapshot cannot
        tell a gauge from a counter — consumers of a delta should only
        read names they know are monotonic)."""
        out = {}
        for name, cur in now.items():
            old = prev.get(name)
            if isinstance(cur, dict):                       # histogram
                oldd = old if isinstance(old, dict) else {}
                ob = oldd.get("buckets", [])
                out[name] = {
                    "count": cur["count"] - oldd.get("count", 0),
                    "sum": cur["sum"] - oldd.get("sum", 0.0),
                    "buckets": [c - (ob[i] if i < len(ob) else 0)
                                for i, c in enumerate(cur["buckets"])],
                }
            elif isinstance(old, (int, float)) \
                    and isinstance(cur, (int, float)):
                out[name] = cur - old
            else:
                out[name] = cur
        return out

    def render_text(self, prefix: str = "") -> str:
        """Prometheus-style flat exposition (names keep their dots)."""
        snap = self.snapshot(prefix)
        with self._lock:
            bounds = {n: m.bounds for n, m in self._metrics.items()
                      if isinstance(m, Histogram)}
        lines = []
        for name, val in snap.items():
            if isinstance(val, dict):
                hb = bounds.get(name, ())
                cum = 0
                for i, c in enumerate(val["buckets"]):
                    cum += c
                    le = f"{hb[i]:.6g}" if i < len(hb) \
                        else "+Inf"
                    lines.append(f'{name}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{name}_count {val['count']}")
                lines.append(f"{name}_sum {val['sum']:.9g}")
            else:
                lines.append(f"{name} {val:.9g}" if isinstance(val, float)
                             else f"{name} {val}")
        return "\n".join(lines)

    def clear(self) -> None:
        """Drop every metric (tests only — instrumented modules that
        bound objects at import keep their stale references)."""
        with self._lock:
            self._metrics.clear()


class SampleWindow:
    """Bounded deque of structured samples that feeds per-op registry
    histograms on the same ``observe`` call.

    This is the single bookkeeping point for ``TcpTransport`` RPC
    samples: ``fit_network_model`` calibration iterates the window (it
    needs joint per-sample (bytes, time) rows), while ``OP_METRICS``
    scrapes read the histograms — both views come from the same
    ``observe``, never parallel ledgers.  The deque API that
    benchmarks/tests rely on (clear, iteration, len) is preserved."""

    def __init__(self, prefix: str, maxlen: int, *,
                 registry: MetricsRegistry | None = None):
        self.prefix = prefix
        self._dq: collections.deque = collections.deque(maxlen=maxlen)
        self._reg = registry if registry is not None else REGISTRY
        self._hists: dict[str, tuple[Histogram, Histogram]] = {}

    def observe(self, sample) -> None:
        """Append a sample carrying ``.op``, ``.measured_s`` and
        ``.payload_bytes``; its latency/bytes land in the per-op
        histograms in the same call."""
        self._dq.append(sample)
        op = sample.op
        pair = self._hists.get(op)
        if pair is None:
            # bounded: one series per wire opcode name, a fixed set
            # repro-lint: disable=TL001
            pair = (self._reg.histogram(f"{self.prefix}.latency_s.{op}",
                                        lo=1e-6, hi=100.0, factor=2.0),
                    # repro-lint: disable=TL001
                    self._reg.histogram(f"{self.prefix}.bytes.{op}",
                                        lo=64.0, hi=2.0 ** 31, factor=4.0))
            self._hists[op] = pair
        pair[0].observe(sample.measured_s)
        pair[1].observe(sample.payload_bytes)

    # deque-compatible surface (bench_wire.py / test_wire.py contract)
    append = observe

    def clear(self) -> None:
        self._dq.clear()

    def __iter__(self) -> Iterator:
        return iter(self._dq)

    def __len__(self) -> int:
        return len(self._dq)

    @property
    def maxlen(self) -> int | None:
        return self._dq.maxlen


#: process-global registry — what the wire telemetry opcodes expose.
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
