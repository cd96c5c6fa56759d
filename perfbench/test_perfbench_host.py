"""What a run says about its host and its set-up on standard error, and
where it keeps the bytecode it compiles: inside its checkout, written by
the first run and read by the next."""

from __future__ import annotations

import gc
import os
import pathlib
import shutil
import subprocess
import sys

from perfbench import harness, host

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_readings_of_a_window():
    a = host.snapshot()
    sum(range(100_000))
    out = host.describe(a, host.snapshot())
    assert out["wall_s"] > 0 and out["user_s"] >= 0 and out["system_s"] >= 0
    assert {"cpu", "mhz", "load", "threads"} <= set(out)


def test_readings_without_proc(monkeypatch):
    """Off Linux, or where ``/proc`` lacks a file, a reading is None or
    left out, and nothing raises."""
    monkeypatch.setattr(host, "_read", lambda path: "")
    assert host.cpu_model() is None and host.mhz(0) is None
    assert host.current_cpu() is None
    out = host.describe(host.snapshot(), host.snapshot())
    assert out["cpu"] == [None, None] and out["load"] == [[], []]
    assert "steal" not in out


def test_gc_clock_counts_collections():
    clock = host.GcClock()
    clock.start()
    gc.collect()
    clock.stop()
    gc.collect()
    assert clock.count == 1 and clock.seconds >= 0


def test_phase_seconds():
    assert harness.phase_seconds([("imports", 3.0), ("graph", 3.5)], 1.0) \
        == {"imports": 2.0, "graph": 0.5}


def test_bytecode_is_cached_in_the_checkout(tmp_path):
    """In a directory with only ``BENCHMARK.json`` and ``perfbench/``, a run
    without a card exits non-zero with no result; under
    PYTHONDONTWRITEBYTECODE its first run writes the bytecode of what it
    imported (torch's too) below ``build/pycache``, and the second
    compiles nothing."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONDONTWRITEBYTECODE="1", CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "perfbench/run.py", "--workload", "reddit-d-train",
           "--seed", "2147483659", "--seconds", "1", "--trace", "0"]
    cache = tmp_path / "build" / "pycache"

    def pyc() -> dict:
        return {p: p.stat().st_mtime_ns for p in cache.rglob("*.pyc")}

    seen = []
    for _ in range(2):
        run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                             text=True, timeout=600)
        assert run.returncode != 0 and run.stdout == "", run.stderr
        seen.append(pyc())
    names = {p.name for p in seen[0]}
    assert any(n.startswith("harness.") for n in names)
    assert any(p.parent.name == "torch" and p.name.startswith("__init__.")
               for p in seen[0])
    assert seen[1] == seen[0]
    assert not list((tmp_path / "perfbench").rglob("__pycache__"))
