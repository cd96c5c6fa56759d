"""The exchange (pull into the client caches, push compute and apply,
each ending in a synchronise) as a share of the window's rounds."""

from perfbench.metrics._example import base
from perfbench.metrics._read import region_seconds, rounds_seconds, share


def read(rec):
    return share(region_seconds(rec, "pull", "push"), rounds_seconds(rec))


def example():
    """A pull and a push of 0.25 s each in 4 s."""
    return base(), 0.5 / 4 * 100
