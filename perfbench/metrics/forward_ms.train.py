"""Milliseconds of a step's forward: the mean of the program's
``step.forward`` spans (``loss_fn``).  The ``step.*`` spans are not
synchronised: they time the host's dispatch."""

from perfbench.metrics._example import with_spans
from perfbench.metrics._read import span_mean


def read(rec):
    s = span_mean(rec, "step.forward")
    return None if s is None else s * 1e3


def example():
    """Spans of 2 and 4 ms."""
    return with_spans("step.forward", 0.002, 0.004), 3.0
