"""Weight aggregation over leaves (copy of ``fedavg_leaves`` from
``repro/fedsvc/aggregation.py``).

Leaves are the flat list of numpy arrays a model flattens to, in the JAX
package's ``tree_flatten`` order (per layer ``b``, ``w_neigh``,
``w_self``).  All arithmetic stays in float32 and the clients are added
in a canonical order, so FedAvg gives the JAX trainer's bytes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def fedavg_leaves(leaves_list: Sequence[Sequence[np.ndarray]],
                  weights: Sequence[float]) -> list[np.ndarray]:
    """Weighted FedAvg over per-client leaf lists.

    ``leaves_list[k][i]`` is client k's i-th leaf; ``weights[k]`` its
    aggregation weight (train-vertex count).  Clients must be passed in
    a canonical order (ascending client id) — float addition is not
    associative, and the order is part of the contract."""
    if not len(leaves_list) == len(weights) > 0:
        raise ValueError(f"{len(leaves_list)} leaf lists for "
                         f"{len(weights)} weights")
    wsum = np.float32(sum(weights))
    out = []
    for group in zip(*leaves_list):
        acc = sum(np.float32(w) * np.asarray(l)
                  for w, l in zip(weights, group))
        out.append(np.asarray(acc / wsum))
    return out
