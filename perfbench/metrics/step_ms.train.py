"""Milliseconds of a training step: the program's ``client.train_epoch``
spans (copy, forward, backward, Adam, ending in a synchronise) over the
window's minibatches."""

from perfbench.metrics._example import base
from perfbench.metrics._read import span_seconds


def read(rec):
    steps = sum(r["minibatches"] for r in rec.get("rounds", ()))
    t = span_seconds(rec, "client.train_epoch")
    if not steps or t <= 0:
        return None
    return t / steps * 1e3


def example():
    """Epochs of 20 and 60 ms over 8 minibatches."""
    return base(), 0.08 / 8 * 1e3
