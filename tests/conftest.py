"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests must see the real
single CPU device; only launch/dryrun.py forces 512 placeholder devices.

If ``hypothesis`` is not installed (the container image does not ship
it), fall back to the deterministic shim in ``_hypothesis_shim`` so the
suite still collects and the property tests still run."""

import sys

try:
    import hypothesis  # noqa: F401
except ImportError:
    import _hypothesis_shim  # conftest's dir is on sys.path (no __init__.py)
    sys.modules["hypothesis"] = _hypothesis_shim

import numpy as np
import pytest

from repro.graphs import bfs_partition, make_client_shards, make_graph


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy control-plane deployments (multi-process "
                   "CLI smokes, full multi-round thread deployments) and "
                   "≥100k-vertex graph-plane builds — run in CI's "
                   "control-plane / graph-plane jobs, not tier1")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device and nvcc (the PyTorch port's "
                   "kernels); skips elsewhere")


@pytest.fixture(scope="session")
def small_graph():
    return make_graph("arxiv", scale=0.15, seed=7)


@pytest.fixture(scope="session")
def dense_graph():
    return make_graph("reddit", scale=0.2, seed=7)


@pytest.fixture(scope="session")
def small_shards(small_graph):
    part = bfs_partition(small_graph, 4, seed=0)
    return make_client_shards(small_graph, part), part
