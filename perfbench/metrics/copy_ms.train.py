"""Milliseconds of a step's copy of its blocks to the card: the mean of
the program's ``step.copy`` spans (``blocks_to_arrays``).  The
``step.*`` spans are not synchronised: they time the host's dispatch."""

from perfbench.metrics._example import with_spans
from perfbench.metrics._read import span_mean


def read(rec):
    s = span_mean(rec, "step.copy")
    return None if s is None else s * 1e3


def example():
    """Spans of 2 and 4 ms."""
    return with_spans("step.copy", 0.002, 0.004), 3.0
