"""Checkpointing: flat-npz snapshots of a tree with a JSON manifest.

Port of ``repro/checkpoint/checkpoint.py``, file for file: one ``.npz``
of ``leaf_<i>`` entries in JAX's leaf order (bfloat16 stored as float32,
which npz lacks) and a ``.json`` manifest of the step, each leaf's path,
dtype and shape, and the caller's ``extra``.  A tree saved by either
package loads in the other.

The port's optimizer states hold one list of tensors per statistic where
JAX's hold parameter-shaped trees.  In a tree ``{"params": p, "opt":
state, ...}`` each such list is written re-nested into ``p``'s tree, so
the paths are JAX's (``opt/.mu/blocks/attn/wq``); the leaves are the same
in either form, in the same order.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten


def _nest(state, params):
    """An optimizer state with each per-leaf list nested into the
    parameter tree (an ``AdamState``'s ``mu`` and ``nu``, an
    ``AdafactorState``'s ``vr`` and ``vc``, SGD's velocity)."""
    if isinstance(state, list):
        return tree_unflatten(params, state)
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*[_nest(v, params) for v in state])
    return state


def _jax_view(tree):
    if isinstance(tree, dict) and "params" in tree and "opt" in tree:
        return {**tree, "opt": _nest(tree["opt"], tree["params"])}
    return tree


def _np(leaf: torch.Tensor) -> np.ndarray:
    """A leaf as numpy, bfloat16 widened to float32 (exactly)."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def save_pytree(path: str | pathlib.Path, tree: Any, *, step: int = 0,
                extra: Optional[dict] = None) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = tree_leaves(tree)
    arrays = {f"leaf_{i}": _np(leaf) for i, leaf in enumerate(leaves)}
    np.savez(path.with_suffix(".npz"), **arrays)
    manifest = {
        "step": step,
        "paths": tree_paths(_jax_view(tree)),
        "dtypes": [str(leaf.dtype).removeprefix("torch.")
                   for leaf in leaves],
        "shapes": [list(leaf.shape) for leaf in leaves],
        "extra": extra or {},
    }
    path.with_suffix(".json").write_text(json.dumps(manifest))


def load_pytree(path: str | pathlib.Path, like: Any, *,
                device: str = "cuda") -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (tensors, meta-device ones
    included): each leaf cast to the dtype of ``like``'s leaf on
    ``device``.  Raises ValueError when the paths differ from the
    manifest's, or a leaf's shape from the manifest's or ``like``'s."""
    path = pathlib.Path(path)
    manifest = json.loads(path.with_suffix(".json").read_text())
    paths = tree_paths(_jax_view(like))
    if paths != manifest["paths"]:
        raise ValueError("checkpoint/model structure mismatch")
    out = []
    with np.load(path.with_suffix(".npz")) as data:
        for i, leaf in enumerate(tree_leaves(like)):
            arr = data[f"leaf_{i}"]
            if not list(arr.shape) == manifest["shapes"][i] \
                    == list(leaf.shape):
                raise ValueError(f"{paths[i]}: shape {list(arr.shape)}, "
                                 f"manifest {manifest['shapes'][i]}, "
                                 f"model {list(leaf.shape)}")
            out.append(torch.from_numpy(arr).to(device=device,
                                                dtype=leaf.dtype))
    return tree_unflatten(like, out), manifest


# convenience aliases
save = save_pytree
restore = load_pytree
