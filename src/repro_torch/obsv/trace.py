"""Low-overhead span recorder with Chrome trace-event export.

The port's copy of ``repro/obsv/trace.py``: the same recorder, span
names and export format, so a merged trace of a deployment that mixes
JAX and PyTorch processes lines up.

Usage::

    from repro_torch.obsv import trace

    with trace.TRACE.span("client.train", args={"client": ci}):
        ...                      # or @trace.traced("client.train")

Spans are complete-events: name, category, thread id, start and
duration on the ``time.perf_counter`` clock, plus optional args merged
with the recorder's *context tags* (e.g. the current round, set once
per round by the worker instead of threading a round index through
every call site).  Events live in a bounded ring buffer — a long run
keeps the most recent window instead of growing without bound.

The port adds three things, none of them in :meth:`TraceRecorder.snapshot`,
whose format stays the JAX package's.  A span given ``fine=True`` (the
sampler's and the training step's, several per minibatch) goes to a ring
of its own, so their rate cannot push the round-level spans out of
``events``.  ``dropped`` counts what either full ring pushed out, and a
snapshot taken after a drop says so on stderr: the trace then lacks its
oldest spans.  A span given ``sync`` (a device synchronise) calls it at
both ends while recording, so its duration covers the device work
enqueued inside it.

Disabled is the default and costs (almost) nothing: ``span()`` returns
a shared no-op context manager — one attribute check, zero allocation —
so instrumentation can stay in hot paths permanently.  Enable with
``TRACE.enable()`` or the ``REPRO_TRACE`` environment variable (any
non-empty value ≠ "0"), which is how the launch CLIs turn tracing on in
child processes.

Export is Chrome trace-event JSON (the Perfetto / ``chrome://tracing``
format): ``ph:"X"`` duration events with microsecond timestamps, plus
``process_name`` metadata so every process of a federated deployment
gets its own named track.  Cross-process merging —
:func:`merge_snapshots` — maps each scraped process to a deterministic
synthetic pid and applies the per-process monotonic-clock offset
measured at scrape time (``perf_counter`` origins differ per process,
so raw timestamps are only comparable after alignment).
"""

from __future__ import annotations

import collections
import functools
import heapq
import json
import os
import sys
import threading
import time
from typing import Callable, Optional

_perf = time.perf_counter


class _NoopSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("_rec", "name", "cat", "args", "_sync", "_ring", "_t0")

    def __init__(self, rec: "TraceRecorder", name: str, cat: str,
                 args: Optional[dict], sync: Optional[Callable[[], None]],
                 ring: collections.deque):
        self._rec = rec
        self.name = name
        self.cat = cat
        self.args = args
        self._sync = sync
        self._ring = ring

    def __enter__(self):
        if self._sync is not None:
            self._sync()
        self._t0 = _perf()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            self._sync()
        t0 = self._t0
        dur = _perf() - t0
        rec = self._rec
        args = self.args
        if rec.context:
            args = {**rec.context, **(args or {})}
        rec._append(self._ring, (self.name, self.cat, threading.get_ident(),
                                 t0, dur, args))
        return False


#: default capacity of each ring: ~100 B/event → some 25 MB worst case
#: a ring, taken only as it fills.  The round-level spans make ~21
#: events a round, so ``events`` holds some 12,000 rounds.  The fine
#: spans make 6 a minibatch: a full-epoch reddit round (4 clients × 3
#: epochs × ~600 minibatches) makes ~43,000, so ``fine_events`` holds
#: its last ~6 such rounds.
DEFAULT_CAPACITY = 1 << 18


class TraceRecorder:
    """One per process (module singleton :data:`TRACE`)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, *,
                 process: str | None = None):
        self.enabled = False
        self.events: collections.deque = collections.deque(maxlen=capacity)
        #: the ``fine=True`` spans, in a ring of the same capacity
        self.fine_events: collections.deque = collections.deque(
            maxlen=capacity)
        self.context: dict = {}          # tags merged into every span
        self.process = process or "proc"
        #: events the full rings pushed out since they were last emptied
        self.dropped = 0

    # -- switches ----------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self.events.clear()
        self.fine_events.clear()
        self.dropped = 0

    def set_process(self, label: str) -> None:
        self.process = str(label)

    def set_context(self, **tags) -> None:
        """Merge tags into every subsequent span's args (round index,
        worker id, …).  A value of ``None`` removes the tag."""
        for k, v in tags.items():
            if v is None:
                self.context.pop(k, None)
            else:
                self.context[k] = v

    # -- recording ---------------------------------------------------------

    def span(self, name: str, cat: str = "",
             args: Optional[dict] = None,
             sync: Optional[Callable[[], None]] = None,
             fine: bool = False):
        """Context manager for one span.  Disabled ⇒ the shared no-op
        (zero allocation — which is why tags travel via the ``args``
        dict parameter rather than ``**kwargs``: no-kwarg calls must
        not build a dict either), and ``sync`` is never called.
        Enabled, ``sync`` (e.g. a device synchronise) runs before the
        start stamp and before the end stamp, so the span holds the
        device work enqueued inside it and none from before it, and a
        ``fine`` span goes to :attr:`fine_events`."""
        if not self.enabled:
            return NOOP_SPAN
        return _Span(self, name, cat, args, sync,
                     self.fine_events if fine else self.events)

    def _append(self, ring: collections.deque, event: tuple) -> None:
        if len(ring) == ring.maxlen:
            self.dropped += 1
        ring.append(event)

    def instant(self, name: str, cat: str = "",
                args: Optional[dict] = None) -> None:
        """Zero-duration marker event."""
        if not self.enabled:
            return
        if self.context:
            args = {**self.context, **(args or {})}
        self._append(self.events,
                     (name, cat, threading.get_ident(), _perf(), 0.0, args))

    # -- export ------------------------------------------------------------

    def snapshot(self, clear: bool = False) -> dict:
        """JSON-able dump for the wire: raw ``perf_counter`` seconds
        (this process's clock — the scraper aligns), plus the identity
        and the clock reading the offset handshake needs.  Both rings'
        events, in the order they ended."""
        if self.dropped:
            print(f"trace: the rings dropped {self.dropped} events; the "
                  f"trace lacks its oldest spans", file=sys.stderr)
        events = [list(e) for e in heapq.merge(
            self.events, self.fine_events, key=lambda e: e[3] + e[4])]
        if clear:
            self.clear()
        return {"process": self.process, "pid": os.getpid(),
                "t_mono": _perf(), "events": events}

    def chrome_events(self, *, offset_s: float = 0.0,
                      pid: int | None = None) -> list[dict]:
        """This recorder's events in Chrome trace-event form."""
        return _snapshot_to_chrome(self.snapshot(), offset_s=offset_s,
                                   pid=pid)

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events(),
                       "displayTimeUnit": "ms"}, f)


def traced(name: str, cat: str = ""):
    """Decorator form of :meth:`TraceRecorder.span` on the global
    recorder; disabled overhead is one attribute check per call."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not TRACE.enabled:
                return fn(*a, **kw)
            # bounded: `name` is the decorator's literal argument, fixed
            # per decorated function  # repro-lint: disable=TL001
            with TRACE.span(name, cat):
                return fn(*a, **kw)
        return wrapper
    return deco


# -- cross-process merge ------------------------------------------------------

def _snapshot_to_chrome(snap: dict, *, offset_s: float = 0.0,
                        pid: int | None = None) -> list[dict]:
    """One process snapshot → Chrome events (no metadata row)."""
    pid = snap.get("pid", 0) if pid is None else pid
    out = []
    for name, cat, tid, t0, dur, args in snap.get("events", ()):
        ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
              "ts": (t0 + offset_s) * 1e6, "dur": dur * 1e6}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        out.append(ev)
    return out


def merge_snapshots(snaps: list[dict],
                    offsets: Optional[list[float]] = None) -> dict:
    """Merge per-process trace snapshots into one Chrome trace.

    ``offsets[i]`` (seconds, added to process i's timestamps) aligns
    each process's private ``perf_counter`` clock onto the merger's —
    the scrape-time handshake of the wire telemetry
    (:mod:`repro_torch.obsv.teleserve`) measures them.  Each process
    gets a deterministic synthetic pid (its index;
    Chrome pids are just track keys), so merging the same snapshots
    twice yields byte-identical output even when the sources are
    threads of one OS process sharing a real pid."""
    if offsets is None:
        offsets = [0.0] * len(snaps)
    events: list[dict] = []
    for i, (snap, off) in enumerate(zip(snaps, offsets)):
        pid = i + 1
        label = snap.get("process", f"proc{i}")
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0,
                       "args": {"name": f"{label} "
                                        f"(pid {snap.get('pid', '?')})"}})
        events.extend(_snapshot_to_chrome(snap, offset_s=off, pid=pid))
    # stable deterministic order: metadata first, then by time/track
    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0),
                               e["pid"], e["tid"], e["name"]))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


#: process-global recorder — what the wire telemetry opcodes expose.
TRACE = TraceRecorder(
    process=os.environ.get("REPRO_TRACE_PROCESS") or "proc")
if os.environ.get("REPRO_TRACE", "0") not in ("", "0"):
    TRACE.enable()


def get_recorder() -> TraceRecorder:
    return TRACE
