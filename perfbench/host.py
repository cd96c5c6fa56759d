"""The host around a run, read from ``/proc`` alone (nothing of the machine
is set): the CPU model, the CPUs the run may use and ran on, their clock,
the load, the machine's steal time, the process's CPU time and the
interpreter's garbage collections, so that a run that reads far off can
be told apart from its set's others on standard error.

Every reader returns None (or an empty value) where ``/proc`` lacks the
file, as it does off Linux.
"""

from __future__ import annotations

import gc
import os
import time


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def cpu_model() -> str | None:
    for line in _read("/proc/cpuinfo").splitlines():
        if line.startswith("model name"):
            return line.split(":", 1)[1].strip()
    return None


def mhz(cpu: int | None) -> float | None:
    """The clock ``/proc/cpuinfo`` gives for processor ``cpu``."""
    proc = None
    for line in _read("/proc/cpuinfo").splitlines():
        if line.startswith("processor"):
            proc = int(line.split(":", 1)[1])
        elif line.startswith("cpu MHz") and proc == cpu:
            return float(line.split(":", 1)[1])
    return None


def allowed() -> list[int]:
    try:
        return sorted(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return []


def current_cpu() -> int | None:
    """The CPU the calling thread last ran on (``stat`` field 39)."""
    stat = _read("/proc/thread-self/stat")
    if not stat:
        return None
    return int(stat.rsplit(")", 1)[1].split()[36])


def _machine() -> list[int]:
    """The ``cpu`` line of ``/proc/stat``: user, nice, system, idle,
    iowait, irq, softirq, steal, in clock ticks."""
    for line in _read("/proc/stat").splitlines():
        if line.startswith("cpu "):
            return [int(x) for x in line.split()[1:9]]
    return []


class GcClock:
    """Collections of the cyclic garbage collector and the seconds they
    took, from :meth:`start` to :meth:`stop`."""

    def __init__(self):
        self.count = 0
        self.seconds = 0.0
        self._t = 0.0

    def _hook(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.count += 1
            self.seconds += time.perf_counter() - self._t

    def start(self) -> None:
        gc.callbacks.append(self._hook)

    def stop(self) -> None:
        if self._hook in gc.callbacks:
            gc.callbacks.remove(self._hook)


def snapshot() -> dict:
    """The readings of this moment, for :func:`describe`."""
    cpu = current_cpu()
    load = _read("/proc/loadavg").split()[:3]
    times = os.times()
    tasks = "/proc/self/task"
    return {"t": time.perf_counter(), "cpu": cpu, "mhz": mhz(cpu),
            "user_s": times.user, "system_s": times.system,
            "load": [float(x) for x in load], "machine": _machine(),
            "threads": len(os.listdir(tasks)) if os.path.isdir(tasks)
            else None}


def describe(a: dict, b: dict) -> dict:
    """What the host did between snapshots ``a`` and ``b``: the process's
    user and system CPU seconds, the machine's busy and steal shares, and
    the CPU, its clock and the load at both ends."""
    out = {"wall_s": b["t"] - a["t"], "user_s": b["user_s"] - a["user_s"],
           "system_s": b["system_s"] - a["system_s"],
           "cpu": [a["cpu"], b["cpu"]], "mhz": [a["mhz"], b["mhz"]],
           "load": [a["load"], b["load"]], "threads": b["threads"]}
    ma, mb = a["machine"], b["machine"]
    if ma and mb:
        d = [y - x for x, y in zip(ma, mb)]
        total = sum(d)
        if total > 0:
            out["machine_busy"] = 1 - (d[3] + d[4]) / total
            out["steal"] = d[7] / total
    return out
