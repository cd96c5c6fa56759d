"""Milliseconds of a client's pull into its cache: the mean of the
program's ``client.pull`` spans (``_fill_cache``, synchronised at both
ends)."""

from perfbench.metrics._example import with_spans
from perfbench.metrics._read import span_mean


def read(rec):
    s = span_mean(rec, "client.pull")
    return None if s is None else s * 1e3


def example():
    """Spans of 2 and 4 ms."""
    return with_spans("client.pull", 0.002, 0.004), 3.0
