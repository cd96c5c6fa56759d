"""Trees of tensors in JAX's flattening order.

The JAX package flattens a tree of parameters or optimizer state with
``jax.tree_util``: dict keys sorted, lists and tuples by index, a
NamedTuple's fields in order, None no leaf.  The port's optimizers,
checkpoints and fedopt walk trees in the same order, so a leaf list, a
checkpoint's ``leaf_<i>`` and its path line up with JAX's.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _children(tree) -> list | None:
    """A node's (path key, child) pairs in JAX's flattening order (dict
    keys sorted, sequences by index, a NamedTuple's fields as ``.name``),
    or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [("." + f, v) for f, v in zip(tree._fields, tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _walk(tree, path: tuple, is_leaf=None):
    if tree is None:                   # a missing bias: no leaf, no path
        return
    kids = None if is_leaf is not None and is_leaf(tree) \
        else _children(tree)
    if kids is None:
        yield path, tree
        return
    for key, child in kids:
        yield from _walk(child, path + (key,), is_leaf)


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves of a tree of dicts, lists, tuples and NamedTuples in
    ``jax.tree_util.tree_flatten`` order; None is no leaf, and neither
    is a node for which ``is_leaf`` is true taken apart."""
    return [leaf for _, leaf in _walk(tree, (), is_leaf)]


def tree_paths(tree) -> list[str]:
    """Each leaf's path, its keys joined with ``/`` as the JAX package's
    checkpoint writes them (``opt/.mu/blocks/attn/wq``)."""
    return ["/".join(path) for path, _ in _walk(tree, ())]


def tree_unflatten(like, leaves, is_leaf=None) -> Any:
    """``like``'s structure with its leaves replaced, in
    :func:`tree_leaves` order, by ``leaves``."""
    leaves = list(leaves)
    want = len(tree_leaves(like, is_leaf))
    if len(leaves) != want:
        raise ValueError(f"{len(leaves)} leaves for a tree of {want}")
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if is_leaf is not None and is_leaf(t):
            return next(it)
        if isinstance(t, dict):
            new = {k: build(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(v) for v in t])
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def to_tensor(a, device) -> torch.Tensor:
    """A leaf of a JAX tree, as numpy, as a tensor on ``device``
    (bfloat16 from ``ml_dtypes``, which torch cannot read, by its bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: same 16 bits
        return torch.from_numpy(a.view(np.uint16).copy()) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)
