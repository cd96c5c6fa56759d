"""Each per-layer reader on a small recorded trace, the device timeline's
arithmetic, and ``census.py`` against hand counts."""

from __future__ import annotations

import pathlib

import pytest

from perfbench import census, harness

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = {"peaks": {"fp32_flops_per_s": 1e6, "hbm_bytes_per_s": 1e3},
       "model": {"hidden": 4, "num_layers": 2}, "graph": {"feat_dim": 3,
                                                        "classes": 2}}


def recorded() -> dict:
    """Two rounds of 1 s and 3 s with 4 minibatches each; kernels of 0.5 s
    of aggregation and 0.25 s of codec on the device; 8 s traced."""
    events = [("segment_mean_csr_kernel(float const*)", 1.0, 0.25),
              ("segment_mean_csr_bwd_kernel(x)", 2.0, 0.25),
              ("quantize_quads_kernel(y)", 3.0, 0.25),
              ("gemm", 3.1, 0.5)]
    return {"config": CFG,
            "rounds": [{"t0": 0.0, "t1": 1.0, "minibatches": 4},
                       {"t0": 1.0, "t1": 4.0, "minibatches": 4}],
            "regions": {"sample": [(0.0, 0.5), (1.0, 2.0)],
                        "pull": [(2.0, 2.25)], "push": [(2.5, 2.75)]},
            "spans": [("client.train_epoch", 0.0, 0.02),
                      ("client.train_epoch", 1.0, 0.06),
                      ("round.aggregate", 3.0, 0.4)],
            "trace": {"events": events, "t0": 0.0, "t1": 8.0,
                      "aligned": True},
            "busy_s": 1.0, "window_s": 8.0,
            "flops": 2_000_000, "agg_bytes": 250, "codec_bytes": 125}


EXPECTED = {
    "sample_share.train": 1.5 / 4 * 100,
    "step_ms.train": 0.08 / 8 * 1e3,
    "exchange_share.train": 0.5 / 4 * 100,
    "aggregate_share.train": 0.4 / 4 * 100,
    "idle_share.train": 7 / 8 * 100,
    "agg_roofline.train": (250 / 1e3) / 0.5 * 100,
    "codec_roofline.train": (125 / 1e3) / 0.25 * 100,
    "mfu.train": 2.0 / 4 * 100,
}


def test_every_metric_has_an_expected_reading(bench):
    assert {m["name"] for m in bench["per_layer"]} == set(EXPECTED)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader(metric):
    got = harness.load_reader(ROOT, metric).read(recorded())
    assert got == pytest.approx(EXPECTED[metric], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_with_nothing_to_read(metric):
    empty = {"config": CFG, "rounds": [], "regions": {}, "spans": [],
             "trace": {"events": [], "t0": 0.0, "t1": 1.0, "aligned": True},
             "busy_s": 0.0, "window_s": 1.0}
    assert harness.load_reader(ROOT, metric).read(empty) is None


def test_busy_and_breakdown():
    rec = recorded()
    tr = rec["trace"]
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
    dims = census.layer_dims(CFG)
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
