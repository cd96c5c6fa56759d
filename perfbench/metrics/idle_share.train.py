"""The share of the traced window in which no operation ran on the
device (training)."""

from perfbench.metrics._example import base
from perfbench.metrics._read import share


def read(rec):
    if rec["busy_s"] <= 0:
        return None
    return share(rec["window_s"] - rec["busy_s"], rec["window_s"])


def example():
    """1 s busy of the 8 s traced."""
    return base(), 7 / 8 * 100
