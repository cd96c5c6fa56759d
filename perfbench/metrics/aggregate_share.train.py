"""FedAvg and the evaluation (the program's ``round.aggregate`` span) as
a share of the window's rounds."""

from perfbench.metrics._read import rounds_seconds, share, span_seconds


def read(rec):
    return share(span_seconds(rec, "round.aggregate"), rounds_seconds(rec))
