"""The whole training step's share of the card's float32 peak: model
FLOPs of the window's minibatches over the wall time of its rounds."""

from perfbench.metrics._example import base
from perfbench.metrics._read import mfu, rounds_seconds


def read(rec):
    return mfu(rec, rounds_seconds(rec))


def example():
    """2 MFLOP at 1 MFLOP/s over 4 s of rounds."""
    return base(), 2.0 / 4 * 100
