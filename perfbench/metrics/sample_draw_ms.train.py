"""Milliseconds of the sampler's draws for a minibatch: the mean of the
program's ``sampler.draw`` spans (``sample_batch``'s hop loop: the
compiled draw, ``np.unique`` and the frontier's mark table)."""

from perfbench.metrics._example import with_spans
from perfbench.metrics._read import span_mean


def read(rec):
    s = span_mean(rec, "sampler.draw")
    return None if s is None else s * 1e3


def example():
    """Spans of 2 and 4 ms."""
    return with_spans("sampler.draw", 0.002, 0.004), 3.0
