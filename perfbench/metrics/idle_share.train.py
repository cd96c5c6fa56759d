"""The share of the traced window in which no operation ran on the
device (training)."""

from perfbench.metrics._read import share


def read(rec):
    if rec["busy_s"] <= 0:
        return None
    return share(rec["window_s"] - rec["busy_s"], rec["window_s"])
