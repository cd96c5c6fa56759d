"""What every cell shares: finding the cell's files by name, the card, the
host regions and the device trace of a traced run, the result line.

A driver (``drivers/<kind>.py``) defines ``setup(ctx)``, ``window(ctx,
state)``, ``release(state)`` and ``check(ctx, state)``; :func:`run`
calls them in that order.  The window's end-to-end metrics come back
from ``window``; with ``--trace 1`` the harness turns on the device
profiler and the host regions around the window and hands the records
to each per-layer metric's reader (``metrics/<metric>.py``).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import importlib.util
import json
import math
import pathlib
import sys
import time

from perfbench import host

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: top-level module names that must not be loaded in a benchmark process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(Exception):
    """A run that cannot report: no card, a missing file, a JAX import."""


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path, tag: str):
    """A module of the benchmark loaded from its file (names may hold
    dots and dashes)."""
    if not path.exists():
        raise BenchError(f"no file {path.relative_to(ROOT)}")
    name = "perfbench_" + tag + "_" + "".join(
        c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_reader(root: pathlib.Path, metric: str):
    """The reader of per-layer metric ``metric``: ``metrics/<metric>.py``."""
    return load_module(root / "perfbench" / "metrics" / f"{metric}.py",
                       "metric")


@dataclasses.dataclass
class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads`` with its files."""
    name: str
    chips: int
    workload: dict
    config: dict
    end_to_end: list
    per_layer: list

    @property
    def kind(self) -> str:
        return self.workload["kind"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` with its workload and configuration
    files and the metrics it reports."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise BenchError(f"BENCHMARK.json has no workload {name!r}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = root / "perfbench"
    workload = load_json(here / "workloads" / f"{entry['traffic']}.json")
    config = load_json(root / cfg_entry["file"])
    return Cell(name, entry["chips"], workload, config,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


@dataclasses.dataclass
class Ctx:
    """What a driver is given."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    rec: "Recorder"
    #: where generated inputs are cached (``build/perfbench/`` below it)
    root: pathlib.Path = ROOT
    #: (label, host time) at the end of each phase of set-up
    phases: list = dataclasses.field(default_factory=list)

    def mark(self, label: str) -> None:
        """End set-up's phase ``label`` now."""
        self.phases.append((label, time.perf_counter()))


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# -- host regions and the device trace ----------------------------------------

class Recorder:
    """Host intervals of the harness's own regions (``perf_counter``
    seconds) and the records the per-layer readers take."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.regions: dict[str, list] = {}
        self.data: dict = {}

    @contextlib.contextmanager
    def region(self, label: str | None):
        if not self.enabled or label is None:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.regions.setdefault(label, []).append(
                (t0, time.perf_counter()))

    def wrap(self, owner, attr: str, label: str, sync=None, on_call=None):
        """Time every call of ``owner.attr`` as region ``label`` (none
        when None; ending in ``sync()`` when given); ``on_call(args, kw, out)`` sees each
        call.  Returns a function that restores the original."""
        inner = getattr(owner, attr)
        rec = self

        def wrapper(*args, **kw):
            with rec.region(label):
                out = inner(*args, **kw)
                if sync is not None and rec.enabled:
                    sync()
            if on_call is not None:
                on_call(args, kw, out)
            return out

        setattr(owner, attr, wrapper)
        return lambda: setattr(owner, attr, inner)


MARKER = "FillFunctor<double>"


def _marker(torch, device) -> float:
    """Launch a kernel no path uses on an idle device and return the host
    time of its launch: it aligns the profiler's clock with the host's."""
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    torch.empty(1, dtype=torch.float64, device=device).fill_(1.0)
    torch.cuda.synchronize(device)
    return t


def device_events(prof, device_type) -> list:
    """(name, start s, seconds) of the profiler's events on the device,
    read from its raw records: building its event tree for a window of
    some hundred thousand launches takes minutes, so there is no other
    path.  A profiler without raw records is a :class:`BenchError`."""
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        raise BenchError("the profiler kept no raw records "
                         "(kineto_results) to read the device events from")
    return [(e.name(), e.start_ns() / 1e9, e.duration_ns() / 1e9)
            for e in results.events() if e.device_type() == device_type]


@contextlib.contextmanager
def device_trace(torch, device, out: dict):
    """torch.profiler over the block, device activity only.  Fills
    ``out`` with ``events`` [(name, host start s, seconds)], ``t0``,
    ``t1`` (host seconds of the traced window) and ``aligned``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        h0 = _marker(torch, device)
        yield
        h1 = _marker(torch, device)
    raw = device_events(prof, DeviceType.CUDA)
    marks = sorted(s for n, s, _ in raw if MARKER in n)
    aligned = len(marks) >= 2
    if aligned:
        offset = ((h0 - marks[0]) + (h1 - marks[-1])) / 2
    else:   # no marker seen: start the first event at the window's start
        offset = h0 - min((s for _, s, _ in raw), default=0.0)
    out.update(t0=h0, t1=h1, aligned=aligned,
               events=[(n, s + offset, d) for n, s, d in raw
                       if MARKER not in n])


def busy_intervals(events: list, t0: float, t1: float) -> list:
    """The union of the device events' intervals inside [t0, t1]."""
    spans = sorted((max(s, t0), min(s + d, t1)) for _, s, d in events
                   if s + d > t0 and s < t1)
    merged: list = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_seconds(events: list, t0: float, t1: float) -> float:
    """Seconds in [t0, t1] in which some operation ran on the device:
    ``chip_smoke.py`` ``busy_share``'s device time, with overlapping events
    counted once."""
    return sum(b - a for a, b in busy_intervals(events, t0, t1))


def _innermost(regions: dict):
    """A function of a host time giving the label of the shortest region
    holding it (calls of one label never overlap, so each label is a
    sorted list searched by bisection), or ``other``."""
    by_label = {lab: sorted(iv) for lab, iv in regions.items() if iv}
    starts = {lab: [a for a, _ in iv] for lab, iv in by_label.items()}

    def label(t: float) -> str:
        best, width = "other", math.inf
        for lab, iv in by_label.items():
            i = bisect.bisect_right(starts[lab], t) - 1
            if i >= 0 and iv[i][1] >= t and iv[i][1] - iv[i][0] < width:
                best, width = lab, iv[i][1] - iv[i][0]
        return best

    return label


def breakdown(trace: dict, regions: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    the harness region the host was in (innermost, by midpoint)."""
    per_op: dict[str, float] = {}
    for name, _, d in trace["events"]:
        per_op[name[:120]] = per_op.get(name[:120], 0.0) + d
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(trace["events"], trace["t0"], trace["t1"])
    gaps, prev = [], trace["t0"]
    for a, b in busy + [[trace["t1"], trace["t1"]]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    label = _innermost(regions) if trace["aligned"] else \
        (lambda t: "unaligned")
    idle: dict[str, float] = {}
    for a, b in gaps:
        lab = label((a + b) / 2)
        idle[lab] = idle.get(lab, 0.0) + (b - a)
    gaps_by = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps_by]}


def phase_seconds(phases: list, t_start: float) -> dict:
    """Seconds of each phase of set-up, from the process's start."""
    out, prev = {}, t_start
    for label, t in phases:
        out[label] = t - prev
        prev = t
    return out


# -- numbers and limits --------------------------------------------------------

def quantile(xs, q: float) -> float:
    """The ``q`` quantile (0..1) of ``xs`` by linear interpolation, as
    ``chip_smoke.py`` ``percentiles`` takes it with ``np.percentile``; inf
    counts as larger than every number."""
    a = sorted(xs)
    if not a:
        return math.nan
    pos = q * (len(a) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(a) - 1)
    if math.isinf(a[hi]):
        return a[hi] if pos > lo else a[lo]
    return a[lo] + (a[hi] - a[lo]) * (pos - lo)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number that has a limit beside it; correct when every one is
    finite and within its limit.  The cell's limits name what it
    compares: a number without one is not compared."""
    out = {}
    ok = True
    for name, lim in limits.items():
        if name not in numbers:
            raise BenchError(f"the limit {name!r} has no number")
        value = numbers[name]
        good = value is not None and math.isfinite(value) and value <= lim
        ok &= good
        out[name] = {"value": value, "limit": lim}
    return ok, out


# -- a run ----------------------------------------------------------------------

def execute(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
            t_start: float, root: pathlib.Path = ROOT,
            data_root: pathlib.Path | None = None) -> dict:
    """Set up, measure and check one run of ``cell``; the result line as
    a dict.  On the card the traced run profiles the window; elsewhere
    (the CPU tests) it records the host regions alone.  Generated inputs
    are cached under ``data_root`` (default ``root``)."""
    import torch

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    prec = cell.config["precision"]
    torch.backends.cuda.matmul.allow_tf32 = bool(prec["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(prec["tf32"])
    driver = load_module(root / "perfbench" / "drivers" / f"{cell.kind}.py",
                         "driver")
    readers = {m["name"]: load_reader(root, m["name"])
               for m in cell.per_layer} if trace else {}
    rec = Recorder(False)
    ctx = Ctx(cell, seed, seconds, trace, device, rec,
              root if data_root is None else data_root)
    say("host: " + json.dumps({"cpu_model": host.cpu_model(),
                               "allowed": host.allowed()}))
    ctx.mark("imports")
    state = driver.setup(ctx)
    sync()
    setup_s = time.perf_counter() - t_start
    say("setup phases: " + json.dumps(phase_seconds(ctx.phases, t_start)))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tr: dict = {"events": [], "aligned": False}
    gc_clock = host.GcClock()
    before = host.snapshot()
    gc_clock.start()
    with (device_trace(torch, 0, tr) if trace and cuda
          else contextlib.nullcontext()):
        rec.enabled = trace
        t0 = time.perf_counter()
        e2e = driver.window(ctx, state)
        sync()
        tr.setdefault("t0", t0)
        tr.setdefault("t1", time.perf_counter())
        rec.enabled = False
    gc_clock.stop()
    say("window host: " + json.dumps(dict(
        host.describe(before, host.snapshot()), gc_count=gc_clock.count,
        gc_s=gc_clock.seconds)))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    attempted, failed = e2e.pop("attempted"), e2e.pop("failed")
    driver.release(state)
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = driver.check(ctx, state)
    say(f"check: {time.perf_counter() - t_check} s")
    ok, checks = judge(numbers, cell.workload["limits"])
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok and failed == 0), "attempted": attempted,
              "failed": failed}
    if trace:
        dev["busy_s"] = busy_seconds(tr["events"], tr["t0"], tr["t1"])
        dev["window_s"] = tr["t1"] - tr["t0"]
        records = dict(rec.data, regions=rec.regions, trace=tr,
                       config=cell.config, busy_s=dev["busy_s"],
                       window_s=dev["window_s"])
        metrics = {}
        for m in cell.per_layer:
            value = readers[m["name"]].read(records)
            if value is None:
                say(f"{m['name']}: nothing to read")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result.update(metrics=metrics, device=dev,
                      breakdown=breakdown(tr, rec.regions))
    else:
        e2e["setup_s"] = setup_s
        result.update(metrics={m["name"]: {"value": e2e[m["name"]],
                                           "unit": m["unit"]}
                               for m in cell.end_to_end},
                      device=dev)
    result["checks"] = checks
    return result


def run(args, t_start: float, bench: dict) -> int:
    """The command: the card or a non-zero exit, then :func:`execute`,
    the JAX check, the numbers on standard error and the result line."""
    import torch

    torch.set_num_threads(1)
    cell = find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        say(f"the cell needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count()={torch.cuda.device_count()}")
        return 3
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                     t_start)
    found = forbidden_modules()
    if found:
        say(f"modules loaded in the benchmark process: {found}")
        return 4
    for name, c in result["checks"].items():
        say(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
