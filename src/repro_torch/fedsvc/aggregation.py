"""Weight-aggregation math, shared by trainer and coordinator (copy of
``repro/fedsvc/aggregation.py``).

Leaves are the flat list of numpy arrays a model flattens to, in the JAX
package's ``tree_flatten`` order (per layer ``b``, ``w_neigh``,
``w_self``).  The in-process trainer and the TCP coordinator both call
:func:`fedavg_leaves`, so the two paths cannot drift.  All arithmetic
stays in float32, weights are rounded to float32 before they multiply,
and the terms are added in the JAX package's order, so every function
here gives the JAX package's bytes.
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


def leaf_sub(a: Sequence[np.ndarray],
             b: Sequence[np.ndarray]) -> list[np.ndarray]:
    """Leaf-wise ``a − b`` in float32 — the model delta a worker ships."""
    if len(a) != len(b):
        raise ValueError(f"{len(a)} leaves minus {len(b)} leaves")
    return [np.asarray(x, np.float32) - np.asarray(y, np.float32)
            for x, y in zip(a, b)]


def leaf_add(base: Sequence[np.ndarray],
             delta: Sequence[np.ndarray]) -> list[np.ndarray]:
    """Leaf-wise ``base + delta`` in float32.

    Worker and coordinator both rebuild a delta-shipped model with this
    function (same float ops, same order), which keeps the coordinator's
    per-worker served view bit-identical to the model the worker
    holds."""
    if len(base) != len(delta):
        raise ValueError(f"{len(base)} leaves plus {len(delta)} leaves")
    return [np.asarray(b, np.float32) + np.asarray(d, np.float32)
            for b, d in zip(base, delta)]


def staleness_scale(staleness: int, decay: float) -> float:
    """FedBuff-style staleness discount: ``decay ** staleness``, the
    staleness being how many aggregations the global model advanced
    between the worker's pull of its base model and its update."""
    return float(decay) ** max(0, int(staleness))


def apply_buffered_deltas(
        model_leaves: Sequence[np.ndarray],
        updates: Sequence[tuple[float, float, Sequence[np.ndarray]]],
) -> list[np.ndarray]:
    """Fold one buffer of async updates into the global model.

    ``updates`` rows are ``(weight, scale, delta_leaves)``; the model
    moves by the scaled-weighted mean of the deltas:

        model += Σ_k w_k·s_k·Δ_k / Σ_k w_k·s_k

    which is sync FedAvg when every update is fresh and every client is
    in the buffer.  A drain whose scaled weights all vanish moves the
    model by nothing (the limit, not a NaN)."""
    if not updates:
        raise ValueError("an empty buffer has nothing to fold")
    ws = [np.float32(w) * np.float32(s) for w, s, _ in updates]
    wsum = np.float32(sum(float(w) for w in ws))
    if wsum == 0.0:
        return [np.asarray(b) for b in model_leaves]
    out = []
    for i, base in enumerate(model_leaves):
        step = sum(w * np.asarray(d[i]) for w, (_, _, d) in
                   zip(ws, updates))
        out.append(np.asarray(np.asarray(base) + step / wsum))
    return out
