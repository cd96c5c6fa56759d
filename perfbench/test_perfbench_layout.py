"""``BENCHMARK.json`` against the contract's shape, and the harness finding
every cell, configuration, driver and metric by name — a new one
dropped into a copy included, with no file edited."""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from perfbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_shape(bench):
    assert set(bench) == TOP_KEYS
    assert bench["paths"] == ["perfbench"]
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(bench, section):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    for e in bench[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


def test_every_cell_reports_enough(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        assert w["chips"] == 1
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in [x["name"] for x in cell.end_to_end]


def test_files_are_found_by_name(bench):
    for c in bench["configs"]:
        cfg = harness.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg["reduced"])
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        assert (ROOT / "perfbench" / "drivers" / f"{cell.kind}.py").exists()
        assert set(cell.workload["limits"])
    for m in bench["per_layer"]:
        assert callable(harness.load_reader(ROOT, m["name"]).read)


#: a per-layer metric's reader as a later change adds it: ``read`` and
#: its example, built on the shared base record
NEW_READER = '''"""The window's rounds."""

from perfbench.metrics._example import base


def read(rec):
    return float(len(rec["rounds"])) or None


def example():
    return base(), 2.0
'''


def test_a_new_cell_config_and_metric_are_picked_up(bench, tmp_path):
    """Adding files and entries is all a later cell or metric needs: the
    harness finds them, and the readers' test, run in the copy, checks
    the new reader on its own example with no test edited."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = tmp_path / "perfbench"
    cfg = harness.load_json(here / "configs" / "arxiv-gcn3.json")
    cfg["name"] = "arxiv-sage3"
    (here / "configs" / "arxiv-sage3.json").write_text(json.dumps(cfg))
    wl = harness.load_json(here / "workloads" / "arxiv-e-train.json")
    wl["name"] = "arxiv-sage3-e-train"
    (here / "workloads" / "arxiv-sage3-e-train.json").write_text(
        json.dumps(wl))
    (here / "metrics" / "rounds.train.py").write_text(NEW_READER)
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "arxiv-sage3", "source": "x",
                           "file": "perfbench/configs/arxiv-sage3.json",
                           "reduced": [], "why": "x"})
    new["workloads"].append({"name": "arxiv-sage3-e-train",
                             "config": "arxiv-sage3",
                             "traffic": "arxiv-sage3-e-train", "chips": 1,
                             "why": "x"})
    new["per_layer"].append({"name": "rounds.train", "unit": "rounds",
                             "better": "higher", "source": "host_clock",
                             "layer": "x", "moves": "train_vertices_per_s",
                             "workloads": ["arxiv-sage3-e-train"]})
    for m in new["end_to_end"]:
        if m["name"] == "train_vertices_per_s":
            m["workloads"].append("arxiv-sage3-e-train")
    cell = harness.find_cell(new, "arxiv-sage3-e-train", root=tmp_path)
    assert cell.config["name"] == "arxiv-sage3" and cell.kind == "train"
    assert [m["name"] for m in cell.per_layer] == ["rounds.train"]
    reader = harness.load_reader(tmp_path, "rounds.train")
    assert reader.read({"rounds": [{}, {}]}) == 2.0
    # the copy's own readers' test takes the new metric as it stands
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new, indent=1))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         str(here / "test_perfbench_readers.py")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    for test in ("test_reader", "test_reader_with_nothing_to_read"):
        assert f"{test}[rounds.train] PASSED" in run.stdout, run.stdout
