"""Each per-layer reader that ``BENCHMARK.json`` names on the example it
carries and on a record with nothing to read, the device timeline's
arithmetic, and ``census.py`` against hand counts."""

from __future__ import annotations

import math
import pathlib

import pytest

from perfbench import census, harness
from perfbench.metrics import _example

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the per-layer metrics ``BENCHMARK.json`` names: one reader file each,
#: carrying its own example, so a new metric needs no edit here
METRICS = sorted(m["name"] for m in harness.load_json(
    ROOT / "BENCHMARK.json")["per_layer"])


def test_every_metric_has_an_expected_reading(bench):
    assert {m["name"] for m in bench["per_layer"]} == set(METRICS)
    for metric in METRICS:
        rec, want = harness.load_reader(ROOT, metric).example()
        assert isinstance(want, float) and math.isfinite(want), metric


@pytest.mark.parametrize("metric", METRICS)
def test_reader(metric):
    reader = harness.load_reader(ROOT, metric)
    rec, want = reader.example()
    assert reader.read(rec) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric", METRICS)
def test_reader_with_nothing_to_read(metric):
    assert harness.load_reader(ROOT, metric).read(_example.empty()) is None


def test_busy_and_breakdown():
    tr = _example.base()["trace"]
    assert harness.busy_seconds(tr["events"], 0.0, 8.0) == pytest.approx(1.1)
    b = harness.breakdown(tr, {"sample": [(0.0, 0.9)], "push": [(4.0, 8.0)],
                               "step": [(0.0, 8.0)]})
    assert b["device_ops"][0] == ["gemm", 0.5]
    idle = dict(b["idle_gaps"])
    assert idle["push"] == pytest.approx(4.4)
    assert idle["sample"] == pytest.approx(1.0)
    assert sum(idle.values()) == pytest.approx(8.0 - 1.1)


def test_quantile_counts_failures_as_over_every_limit():
    assert harness.quantile([1.0, 2.0, 3.0, 4.0, 5.0], 0.5) == 3.0
    assert harness.quantile([1.0] * 19 + [float("inf")], 0.95) == \
        float("inf")


def test_census_by_hand():
    # a block reading 5 source rows of width 3, 2 destinations, 4 kept
    # edges; its backward over a table of 5 rows, 2 destinations read
    assert census.agg_bytes(5, 3, 2, 4) == 60 + 24 + 16 + 8 + 32
    assert census.agg_bwd_bytes(5, 3, 2, 4) == 24 + 8 + 48 + 16 + 60
    assert census.quantize_bytes(2, 4) == 32 + 8 + 8
    assert census.dequantize_bytes(2, 4) == 8 + 8 + 32
    assert census.gather_quantize_bytes(2, 4) == 8 + 32 + 8 + 8
    assert census.dequant_scatter_bytes(2, 4) == 8 + 8 + 8 + 32
    # two layers 3 -> 4 -> 2 over (dst rows, kept edges) (6, 10), (2, 5)
    dims = census.layer_dims(_example.CONFIG)
    assert dims == [3, 4, 2]
    fwd = (2 * 6 * 3 * 4 + 10 * 3) + (2 * 2 * 4 * 2 + 5 * 4)
    assert census.blocks_flops(dims, [(6, 10), (2, 5)], 1) == fwd
    assert census.train_flops(dims, [(6, 10), (2, 5)]) == 3 * fwd
    assert census.blocks_flops(dims, [(2, 5)], 2) == 2 * 2 * 4 * 2 + 5 * 4


@pytest.mark.parametrize("grad", [False, True])
def test_aggregation_bytes_count_the_rows_read(grad):
    """A padded table of 8 rows whose 5 kept edges read rows 0, 2 and 5,
    into 4 destinations of which 3 have an edge."""
    import torch
    from types import SimpleNamespace

    from perfbench.drivers import train

    csr = SimpleNamespace(indptr=torch.tensor([0, 2, 2, 4, 5]),
                          indices=torch.tensor([0, 2, 2, 5, 0],
                                               dtype=torch.int32))
    data = {"agg_calls": [train.agg_call(torch.zeros(8, 3), 4, csr, grad)]}
    train.resolve_kernel_bytes(data)
    fwd = census.agg_bytes(3, 3, 4, 5)
    assert fwd == 3 * 12 + 5 * 8 + 5 * 4 + 4 * 4 + 4 * 16
    bwd = census.agg_bwd_bytes(8, 3, 3, 5)
    assert bwd == 3 * 12 + 3 * 4 + 9 * 8 + 5 * 4 + 8 * 12
    assert data == {"agg_bytes": fwd + (bwd if grad else 0)}


def test_device_events_need_the_raw_records():
    from types import SimpleNamespace

    with pytest.raises(harness.BenchError):
        harness.device_events(SimpleNamespace(profiler=SimpleNamespace()),
                              None)
