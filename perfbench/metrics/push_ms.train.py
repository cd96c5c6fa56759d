"""Milliseconds of a client's push: the mean of the program's
``client.push_compute`` spans (``_compute_push``: propagate and the
encode) plus the mean of its ``client.push_apply`` spans (each
``apply_push``), both synchronised at both ends."""

from perfbench.metrics._example import with_spans
from perfbench.metrics._read import span_mean


def read(rec):
    compute = span_mean(rec, "client.push_compute")
    apply = span_mean(rec, "client.push_apply")
    if compute is None or apply is None:
        return None
    return (compute + apply) * 1e3


def example():
    """A compute of 3 ms and applies of 1 and 2 ms."""
    rec = with_spans("client.push_apply", 0.001, 0.002)
    rec["spans"].append(("client.push_compute", 0.5, 0.003))
    return rec, 4.5
