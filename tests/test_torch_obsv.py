"""The port's trace and metrics planes against the JAX package's.

Held equal, for the same observations and the same clock readings:
``Histogram.quantile`` and ``snapshot``, ``MetricsRegistry.snapshot``,
``delta`` and ``render_text``, a recorder's snapshot and Chrome export,
and ``merge_snapshots``.  The port's trainer records the JAX trainer's
span sequence over two rounds (names and arguments, in order), and a
drain of the port's serving plane moves its ``pt_gnnserve.*`` metrics as
a drain of the JAX plane moves ``gnnserve.*`` (deltas: both registries
are process-global).  The ``REPRO_TRACE`` switch turns the port's
recorder on in a fresh process, as it does the JAX package's.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.federated import FederatedGNNTrainer as JTrainer
from repro.core.strategies import default_strategies as jstrategies
from repro.gnnserve import build_serving as jbuild_serving
from repro.graphs import make_graph as jmake_graph
from repro.obsv import metrics as jmetrics
from repro.obsv import trace as jtrace
from repro_torch.core.federated import FederatedGNNTrainer as TTrainer
from repro_torch.core.strategies import default_strategies as tstrategies
from repro_torch.gnnserve import build_serving as tbuild_serving
from repro_torch.graphs import make_graph as tmake_graph
from repro_torch.models.gnn import from_jax_leaves
from repro_torch.obsv import metrics as tmetrics
from repro_torch.obsv import trace as ttrace

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")
torch.set_num_threads(1)


def _observations(seed):
    rng = np.random.default_rng(seed)
    xs = list(rng.lognormal(-7, 3, 300))
    # exact bucket bounds, zero, a negative and values past the top
    return xs + [1e-6, 2e-6, 0.0, -1.0, 64e-6, 1e3, 200.0]


@pytest.mark.parametrize("kw", [{}, dict(lo=1.0, hi=4096.0, factor=2.0),
                                dict(lo=64.0, hi=2.0 ** 31, factor=4.0),
                                dict(lo=1e-3, hi=10.0, factor=1.5)])
def test_histogram_matches_jax(kw):
    jh, th = jmetrics.Histogram("a.b", **kw), tmetrics.Histogram("a.b", **kw)
    assert th.bounds == jh.bounds == jmetrics.log_bounds(
        *(kw.get(k, d) for k, d in (("lo", 1e-6), ("hi", 100.0),
                                    ("factor", 2.0))))
    assert th.quantile(0.5) == jh.quantile(0.5) == 0.0
    for x in _observations(len(kw)):
        jh.observe(x)
        th.observe(x)
    assert th.snapshot() == jh.snapshot()
    for q in (0.01, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)
    assert th.mean == jh.mean


def _fill_registry(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("plane.events")
    g = reg.gauge("plane.level")
    h = reg.histogram("plane.latency_s")
    reg.gauge("plane.fn_level", fn=lambda: 7.5)
    reg.gauge("plane.broken", fn=lambda: 1 / 0)
    c.inc(3)
    g.set(2)
    for x in _observations(1)[:50]:
        h.observe(x)
    snap0 = reg.snapshot()
    c.inc()
    g.set(5)
    for x in _observations(2)[:20]:
        h.observe(x)
    reg.counter("plane.late").inc(2)
    with pytest.raises(TypeError):
        reg.gauge("plane.events")
    return reg, snap0


def test_registry_snapshot_delta_and_text_match_jax():
    (jreg, j0), (treg, t0) = _fill_registry(jmetrics), \
        _fill_registry(tmetrics)
    jsnap, tsnap = jreg.snapshot(), treg.snapshot()

    def text(x):                # NaN (the broken gauge) equals itself
        return json.dumps(x, sort_keys=True)

    assert text(tsnap) == text(jsnap)
    assert text(treg.delta(tsnap, t0)) == text(jreg.delta(jsnap, j0))
    assert treg.render_text() == jreg.render_text()
    assert treg.render_text("plane.l") == jreg.render_text("plane.l")
    assert treg.names("plane.") == jreg.names("plane.")
    treg.clear()
    assert treg.snapshot() == {}


def test_sample_window_feeds_histograms_as_jax():
    class Sample:
        def __init__(self, op, s, b):
            self.op, self.measured_s, self.payload_bytes = op, s, b

    out = []
    for mod in (jmetrics, tmetrics):
        reg = mod.MetricsRegistry()
        win = mod.SampleWindow("wire", 3, registry=reg)
        for i in range(5):
            win.observe(Sample("gather" if i % 2 else "push", 1e-3 * i,
                               100 * i))
        out.append((len(win), win.maxlen, [s.op for s in win],
                    reg.snapshot()))
    assert out[0] == out[1]


class _Clock:
    """Deterministic stand-in for ``time.perf_counter``."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _record(mod, monkeypatch):
    monkeypatch.setattr(mod, "_perf", _Clock())
    rec = mod.TraceRecorder(capacity=4, process="worker")
    assert rec.span("x.off") is mod.NOOP_SPAN
    rec.instant("x.off")
    rec.enable()
    rec.set_context(round=3)
    with rec.span("client.pull", args={"client": 1, "rows": 9}):
        with rec.span("inner.step", cat="k"):
            pass
    rec.instant("x.mark", args={"why": "test"})
    rec.set_context(round=None, worker=2)
    for i in range(3):                  # the ring keeps the newest four
        with rec.span("round.aggregate", args={"round": i}):
            pass
    snap = rec.snapshot()
    return snap, rec.chrome_events(offset_s=1.5, pid=7)


def test_trace_export_matches_jax(monkeypatch):
    js, jc = _record(jtrace, monkeypatch)
    ts, tc = _record(ttrace, monkeypatch)
    assert ts == js
    assert len(ts["events"]) == 4
    assert tc == jc
    offsets = [0.0, -2.0]
    assert ttrace.merge_snapshots([ts, js], offsets) == \
        jtrace.merge_snapshots([js, ts], offsets) != {}
    assert json.dumps(ttrace.merge_snapshots([ts, js])) == \
        json.dumps(jtrace.merge_snapshots([ts, js]))


def test_traced_records_on_the_global_recorder():
    rec = ttrace.get_recorder()
    assert rec is ttrace.TRACE

    @ttrace.traced("unit.work")
    def work(x):
        return 2 * x

    was = rec.enabled
    rec.clear()
    try:
        rec.disable()
        assert work(2) == 4 and not rec.events
        rec.enable()
        assert work(3) == 6
        assert [e[0] for e in rec.events] == ["unit.work"]
    finally:
        rec.enabled = was
        rec.clear()


@pytest.mark.parametrize("value,enabled", [("1", True), ("0", False),
                                           ("", False)])
def test_repro_trace_switch(value, enabled):
    env = dict(os.environ, REPRO_TRACE=value, REPRO_TRACE_PROCESS="w3")
    out = subprocess.run(
        [sys.executable, "-c", "from repro_torch.obsv.trace import TRACE; "
         "print(TRACE.enabled, TRACE.process)"],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.split() == [str(enabled), "w3"]


# -- the instrumented planes -----------------------------------------------------

@pytest.fixture(scope="module")
def traced_pair():
    """Two rounds of O (overlapped push, 2 epochs) on each package from
    the JAX trainer's parameters, with both recorders on; returns the
    trainers and each recorder's events."""
    strat = dataclasses.replace(jstrategies()["O"], codec="int8")
    kw = dict(num_layers=3, hidden=16, seed=0, epochs_per_round=2)
    jt = JTrainer(jmake_graph("arxiv", scale=0.1, seed=7), 2, strat, **kw)
    model = from_jax_leaves(jt.params_leaves(), "graphconv", device="cpu")
    tt = TTrainer(tmake_graph("arxiv", scale=0.1, seed=7), 2,
                  dataclasses.replace(tstrategies()["O"], codec="int8"),
                  model=model, device="cpu", **kw)
    events = {}
    for name, tr, rec in (("jax", jt, jtrace.TRACE),
                          ("port", tt, ttrace.TRACE)):
        was, ctx = rec.enabled, dict(rec.context)
        rec.clear()
        # tags an earlier test in this process left (a fedsvc worker's
        # "worker") would tag these spans too
        rec.context.clear()
        rec.enable()
        try:
            tr.train(2)
            events[name] = list(rec.events)
        finally:
            rec.enabled = was
            rec.context.clear()
            rec.context.update(ctx)
            rec.clear()
    return jt, tt, events


def test_span_sequence_matches_jax(traced_pair):
    _, _, events = traced_pair
    seq = {k: [(e[0], e[5]) for e in v] for k, v in events.items()}
    assert seq["port"] == seq["jax"]
    names = [n for n, _ in seq["port"]]
    assert names.count("client.pull") == 2 * 2
    assert names.count("client.train_epoch") == 2 * 2 * 2
    assert names.count("client.push_compute") == 2 * 2
    assert names.count("round.aggregate") == 2
    # the overlapped push is computed after the next-to-last epoch
    assert names[:4] == ["client.pull", "client.train_epoch",
                         "client.push_compute", "client.train_epoch"]
    assert all(e[4] >= 0.0 for e in events["port"])


def test_serving_metrics_move_as_jax(traced_pair):
    """The same drain (threshold 1.0, so every request exits at full
    depth on both) moves each ``pt_gnnserve.*`` counter and histogram
    count by what it moves the JAX ``gnnserve.*`` one, and leaves the
    lane-depth gauges at the same values."""
    jt, tt, _ = traced_pair
    kw = dict(cache_rows=64, serve_fanout=5, batch_size=16,
              depth_schedule=[1, 2, 3])
    planes = {"jax": (jbuild_serving(jt.export_for_serving(), **kw),
                      jmetrics.REGISTRY, "gnnserve."),
              "port": (tbuild_serving(tt.export_for_serving(),
                                      device="cpu", **kw),
                       tmetrics.REGISTRY, "pt_gnnserve.")}
    vids = np.random.default_rng(8).integers(0, jt.g.num_vertices, 150)
    moved = {}
    for side, (plane, reg, prefix) in planes.items():
        before = reg.snapshot(prefix)
        for v in vids:
            plane.submit(int(v), 1.0)
        assert len(plane.drain()) == len(vids)
        now = reg.snapshot(prefix)
        delta = reg.delta(now, before)
        out = {}
        for name, d in delta.items():
            key = name[len(prefix):]
            if isinstance(d, dict):
                out[key + ".count"] = d["count"]
                if not key.startswith("queue_wait"):
                    out[key + ".buckets"] = d["buckets"]
            elif key.startswith("lane_depth."):
                out[key] = now[name]
            elif d:
                out[key] = d
        moved[side] = out
        st = plane.stats()
        assert out["served"] == st["served"] == len(vids)
        assert out["forwards"] == st["forwards"]
        for k in ("hits", "misses", "stale_refreshes", "evictions"):
            assert out.get(f"cache.{k}", 0) == st["cache"][k]
    assert moved["port"] == moved["jax"]
    assert moved["port"]["exits.d3"] == len(vids)
    assert moved["port"]["cache.evictions"] > 0
