"""Milliseconds of a step's optimizer: the mean of the program's
``step.optim`` spans (Adam's step and the in-place copy).  The
``step.*`` spans are not synchronised: they time the host's dispatch."""

from perfbench.metrics._example import with_spans
from perfbench.metrics._read import span_mean


def read(rec):
    s = span_mean(rec, "step.optim")
    return None if s is None else s * 1e3


def example():
    """Spans of 2 and 4 ms."""
    return with_spans("step.optim", 0.002, 0.004), 3.0
