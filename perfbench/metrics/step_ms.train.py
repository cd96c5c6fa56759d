"""Milliseconds of a training step: the program's ``client.train_epoch``
spans (copy, forward, backward, Adam, ending in a synchronise) over the
window's minibatches."""

from perfbench.metrics._read import span_seconds


def read(rec):
    steps = sum(r["minibatches"] for r in rec.get("rounds", ()))
    t = span_seconds(rec, "client.train_epoch")
    if not steps or t <= 0:
        return None
    return t / steps * 1e3
