"""Host sampling (``graphs/sampler.py`` ``NeighborSampler``, the cut
epochs' iteration) as a share of the window's rounds."""

from perfbench.metrics._example import base
from perfbench.metrics._read import region_seconds, rounds_seconds, share


def read(rec):
    return share(region_seconds(rec, "sample"), rounds_seconds(rec))


def example():
    """Sampling 0.5 s and 1 s of the rounds' 4 s."""
    return base(), 1.5 / 4 * 100
