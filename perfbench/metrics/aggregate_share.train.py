"""FedAvg and the evaluation (the program's ``round.aggregate`` span) as
a share of the window's rounds."""

from perfbench.metrics._example import base
from perfbench.metrics._read import rounds_seconds, share, span_seconds


def read(rec):
    return share(span_seconds(rec, "round.aggregate"), rounds_seconds(rec))


def example():
    """0.4 s of FedAvg and evaluation in 4 s."""
    return base(), 0.4 / 4 * 100
