"""The numbers that decide ``correct``: the program's readings against the
reference's.

Training (the first round, whose first three steps are client 0's):

- ``loss_gap``: the largest relative gap of the first three steps' losses;
- ``grad_gap``: by the worst leaf, the gap between the norms of the first
  step's gradient (the program's as its Adam state holds it after one
  step), over the larger of the reference leaf's norm and the median
  leaf's;
- ``step3_gap``: the same of each leaf's change after three steps;
- ``round_gap``: the median leaf's gap of the global model's change over
  the round (every client's 24 steps, then FedAvg): the worst leaf's
  swings from seed to seed by twenty times, as rounding grows through
  the later steps;
- ``table_gap``: by the worst layer, the norm of the difference of the
  server's pushed rows after the round over the reference's norm;
- ``acc_gap``: the gap of the accuracy the round's model evaluates to;
- ``window_acc_gap``: the gap between the accuracy the window's last
  round reports and the reference's evaluation of the model that round
  left (the reference judges the program's output here: it follows the
  window's rounds no further).

A leaf whose reference gradient is under a thousandth of the median
leaf's moves under Adam by rounding alone and is left out of the change
gaps.
"""

from __future__ import annotations

import numpy as np

#: a leaf whose gradient is under this share of the median leaf's is not
#: compared by its change
GRAD_FLOOR = 1e-3


def _leaf_gaps(prog: list[float], ref: list[float],
               keep: np.ndarray) -> np.ndarray:
    """Each kept leaf's gap between the program's norm and the
    reference's, over the larger of the reference leaf's and the median
    leaf's norm."""
    prog, ref = np.asarray(prog), np.asarray(ref)
    den = np.maximum(ref, float(np.median(ref)))
    gaps = np.abs(prog - ref) / np.where(den > 0, den, 1.0)
    return gaps[keep] if keep.any() else np.zeros(1)


def train_numbers(prog: dict, ref: dict) -> dict:
    g_ref = np.asarray(ref["grad_norms"])
    keep = g_ref >= GRAD_FLOOR * np.median(g_ref)
    loss_p, loss_r = np.asarray(prog["loss"]), np.asarray(ref["loss"])
    out = {
        "loss_gap": float(np.max(np.abs(loss_p - loss_r) / np.abs(loss_r))),
        "grad_gap": float(_leaf_gaps(prog["grad_norms"], ref["grad_norms"],
                                     np.ones(len(g_ref), bool)).max()),
        "step3_gap": float(_leaf_gaps(prog["step3_norms"],
                                      ref["step3_norms"], keep).max()),
        "round_gap": float(np.median(_leaf_gaps(
            prog["round_norms"], ref["round_norms"], keep))),
        "acc_gap": abs(prog["acc"] - ref["acc"]),
    }
    if "window_acc" in ref:
        out["window_acc_gap"] = abs(prog["window_acc"] - ref["window_acc"])
    if "table" in ref:
        out["table_gap"] = table_gap(prog["table"], ref["table"])
    return out


def table_gap(prog: list, ref: list) -> float:
    """By the worst layer, the norm of the rows' difference over the
    reference's norm."""
    return max(float(np.linalg.norm(p - r) / max(np.linalg.norm(r), 1e-30))
               for p, r in zip(prog, ref))
