"""Milliseconds the sampler takes for a minibatch: the mean of the
program's ``sampler.batch`` spans (the whole of
``NeighborSampler.sample_batch``)."""

from perfbench.metrics._example import with_spans
from perfbench.metrics._read import span_mean


def read(rec):
    s = span_mean(rec, "sampler.batch")
    return None if s is None else s * 1e3


def example():
    """Spans of 2 and 4 ms."""
    return with_spans("sampler.batch", 0.002, 0.004), 3.0
