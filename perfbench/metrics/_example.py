"""The records that every reader's example starts from.

A reader ``metrics/<metric>.py`` defines, beside ``read(rec)``,
``example()``: a record built from :func:`base` (with what the reader
needs added) and the reading it must give.  The readers' test runs each
reader that ``BENCHMARK.json`` names on its example and on :func:`empty`,
so a metric comes in as a reader file and an entry, with no test edited.
"""

from __future__ import annotations

#: peaks of 1 MFLOP/s and 1 kB/s, a model 3 -> 4 -> 2
CONFIG = {"peaks": {"fp32_flops_per_s": 1e6, "hbm_bytes_per_s": 1e3},
          "model": {"hidden": 4, "num_layers": 2},
          "graph": {"feat_dim": 3, "classes": 2}}


def base() -> dict:
    """Two rounds of 1 s and 3 s with 4 minibatches each, their host
    regions and epoch spans; kernels of 0.5 s of aggregation and 0.25 s
    of codec on the device; 8 s traced, 1 s of it busy."""
    events = [("segment_mean_csr_kernel(float const*)", 1.0, 0.25),
              ("segment_mean_csr_bwd_kernel(x)", 2.0, 0.25),
              ("quantize_quads_kernel(y)", 3.0, 0.25),
              ("gemm", 3.1, 0.5)]
    return {"config": CONFIG,
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


def with_spans(name: str, *seconds: float) -> dict:
    """:func:`base` with a span ``name`` of each of ``seconds`` added,
    one a second from the window's start."""
    rec = base()
    rec["spans"] += [(name, float(i), d) for i, d in enumerate(seconds)]
    return rec


def empty() -> dict:
    """A traced run that recorded nothing: no round, region, span or
    device event."""
    return {"config": CONFIG, "rounds": [], "regions": {}, "spans": [],
            "trace": {"events": [], "t0": 0.0, "t1": 1.0, "aligned": True},
            "busy_s": 0.0, "window_s": 1.0}
