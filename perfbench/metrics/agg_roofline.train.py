"""The aggregation kernels' (rows 5 and 5b) share of their roofline over
the window's launches: compulsory bytes at the card's memory rate over
their device time."""

from perfbench.metrics._example import base
from perfbench.metrics._read import AGG_KERNELS, roofline


def read(rec):
    return roofline(rec, "agg_bytes", AGG_KERNELS)


def example():
    """250 bytes at 1 kB/s over 0.5 s of its kernels."""
    return base(), (250 / 1e3) / 0.5 * 100
