"""The program's own spans in a traced run at a tiny size on the CPU:
each cell's records hold the spans of the sampler, the training step and
the exchange, every metric that reads spans finds them, and the spans
land on the harness's clock inside the host regions that time the same
work."""

from __future__ import annotations

import time

import pytest

from perfbench import harness
from perfbench.conftest import TINY_SEED, tiny

CELLS = ["reddit-opg-int8-train", "arxiv-e-train", "reddit-d-train"]
#: the spans recorded once per minibatch trained
PER_MINIBATCH = ("sampler.batch", "sampler.draw", "step.copy",
                 "step.forward", "step.backward", "step.optim")
#: the synchronised spans of the embedding exchange
EXCHANGE = ("client.pull", "client.push_compute", "client.push_apply")


def traced_run(bench, data_root, name: str, monkeypatch) -> tuple:
    """A tiny traced run of cell ``name``: its result line and the
    records the harness handed its readers."""
    handed = []
    load_reader = harness.load_reader

    def spy(root, metric):
        reader = load_reader(root, metric)

        class Spy:
            @staticmethod
            def read(rec):
                handed.append(rec)
                return reader.read(rec)
        return Spy

    monkeypatch.setattr(harness, "load_reader", spy)
    cell = tiny(harness.find_cell(bench, name))
    res = harness.execute(cell, TINY_SEED, 0.1, True, "cpu",
                          time.perf_counter(), data_root=data_root)
    assert handed and all(rec is handed[0] for rec in handed)
    return res, handed[0]


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_records_the_program_spans(bench, data_root, name,
                                             monkeypatch):
    res, rec = traced_run(bench, data_root, name, monkeypatch)
    assert res["correct"], res["checks"]
    steps = sum(r["minibatches"] for r in rec["rounds"])
    names = [n for n, _, _ in rec["spans"]]
    for span in PER_MINIBATCH:
        assert names.count(span) == steps, span
    # the D strategy pulls and pushes no remote embeddings
    exchanges = name != "reddit-d-train"
    for span in EXCHANGE:
        assert (span in names) == exchanges, span
    # every metric that reads the program's spans finds them
    cell = harness.find_cell(bench, name)
    span_metrics = {m["name"] for m in cell.per_layer
                    if m["source"] == "program_span"}
    assert span_metrics <= set(res["metrics"]), span_metrics


def _inside(inner: tuple, outer: tuple) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_spans_and_regions_share_one_clock(bench, data_root, monkeypatch):
    """Every ``sampler.batch`` span lies inside a ``sample`` region (the
    harness times each cut epoch's ``next()``, which samples one
    minibatch), and every ``copy`` region inside a ``step.copy`` span
    (the harness times ``blocks_to_arrays``, the call the span holds):
    one for one, on the ``perf_counter`` clock of both."""
    _, rec = traced_run(bench, data_root, "reddit-opg-int8-train",
                        monkeypatch)

    def spans(name):
        return sorted((t0, t0 + d) for n, t0, d in rec["spans"] if n == name)

    for inner, outer in ((spans("sampler.batch"), rec["regions"]["sample"]),
                         (sorted(rec["regions"]["copy"]),
                          spans("step.copy"))):
        assert inner and len(inner) == len(outer)
        assert all(_inside(i, o) for i, o in zip(inner, sorted(outer)))
