"""Fixtures of the benchmark's CPU tests: its cells cut to a tiny graph,
run through the harness on the CPU with the kernels' plain versions."""

from __future__ import annotations

import copy
import pathlib
import time

import pytest
import torch

from perfbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: a graph and a round small enough for a test: the cells' shapes at a
#: few hundred vertices
TINY_GRAPH = {"vertices": 600, "edge_draws": 7200, "feat_dim": 24}
TINY_SEED = 2147483659


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the control's size: the configuration's own feature width, so that
#: TF32's error in the wide first layer shows as on the card
CONTROL_GRAPH = {"vertices": 1500, "edge_draws": 45000}


def tiny(cell: harness.Cell, graph: dict = TINY_GRAPH) -> harness.Cell:
    """``cell`` with its configuration cut to a small graph (``graph``'s
    sizes) and a tiny round."""
    cell = copy.deepcopy(cell)
    cfg = cell.config
    cfg["graph"].update(graph)
    cfg["model"]["eval_max_edges"] = 3000
    cfg["minibatches_per_epoch"] = 2
    return cell


@pytest.fixture(scope="session")
def bench() -> dict:
    return harness.load_json(ROOT / "BENCHMARK.json")


@pytest.fixture(scope="session")
def data_root(tmp_path_factory) -> pathlib.Path:
    return tmp_path_factory.mktemp("perfbench-data")


@pytest.fixture
def run_tiny(bench, data_root):
    """Run a cell of ``BENCHMARK.json`` at the tiny size on the CPU; the
    result line as a dict."""

    def run(name: str, *, trace: bool = False, seconds: float = 0.1,
            seed: int = TINY_SEED) -> dict:
        cell = tiny(harness.find_cell(bench, name))
        return harness.execute(cell, seed, seconds, trace, "cpu",
                               time.perf_counter(), data_root=data_root)

    return run
