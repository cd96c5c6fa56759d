"""A census of one rank's work in an eagerly run step: FLOPs, memory
traffic, collective bytes and the peak of live memory.

The port's counterpart of ``repro/launch/hlo_census.py``, which parses a
partitioned HLO module.  Here the step runs (for a dry-run, on
meta-device shards) under a ``TorchDispatchMode`` that sees every ATen op one rank
executes:

  flops            — ``torch.utils.flop_counter``'s formula of each op
                     (2·M·N·K a matrix product), from the shapes the rank
                     multiplies: DTensor ops are let through to the
                     tensor subclass first (the mode returns
                     ``NotImplemented`` for them), so the mode counts the
                     local ops they become, not the global shapes
  hbm_bytes        — operand and result bytes of each eager op that is
                     not a view.  Every op is its own kernel here: this
                     is an upper bound, not XLA's estimate at fusion
                     boundaries
  collective_bytes — the bytes of the c10d functional collectives that
                     DTensor's redistributions issue, by JAX's five
                     names: the larger of operand and result (an
                     all-reduce's tensor once; JAX's census counts it
                     twice, as ring wire bytes); no op of DTensor's maps
                     to "collective-permute"
  peak_bytes       — the most bytes that ops of the step held alive at
                     once (results of ops that are not views)

A Python loop runs its body once per trip, so nothing needs JAX's
trip-count recovery.  DTensor's sharding propagation runs each new op on
fake global tensors to learn the output's shape; those calls are
skipped.
"""

from __future__ import annotations

import sys
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_COLLECTIVE_OPS = {"all_gather_into_tensor": "all-gather",
                   "all_gather_into_tensor_coalesced": "all-gather",
                   "all_reduce": "all-reduce",
                   "all_reduce_coalesced": "all-reduce",
                   "reduce_scatter_tensor": "reduce-scatter",
                   "reduce_scatter_tensor_coalesced": "reduce-scatter",
                   "all_to_all_single": "all-to-all"}

#: ops that move no data of their own
_FREE = {"wait_tensor", "empty", "empty_strided", "empty_like", "device",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "_local_scalar_dense", "is_same_size"}

#: DTensor's shape propagation (``_propagate_tensor_meta`` and its cached
#: and uncached variants) runs ops on fake global tensors
_PROPAGATION = "_propagate_tensor_meta"


def _check_propagation_name() -> None:
    """Fail loudly where a torch release renames the propagation: its
    global-shape ops would be counted as one rank's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    if not any(n.startswith(_PROPAGATION) for n in dir(ShardingPropagator)):
        raise RuntimeError(f"DTensor's ShardingPropagator has no "
                           f"{_PROPAGATION}*: the census cannot tell its "
                           "global-shape ops from a rank's")


def _propagating() -> bool:
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name.startswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


def _nbytes(t) -> int:
    return t.numel() * t.element_size() \
        if isinstance(t, torch.Tensor) else 0


class Census(TorchDispatchMode):
    """The census as a context manager: ``with Census() as c: ...``, then
    ``c.record()``."""

    def __init__(self):
        super().__init__()
        _check_propagation_name()
        self.flops = 0
        self.hbm = 0
        self.coll = dict.fromkeys(COLLECTIVES, 0)
        self.ops = dict.fromkeys(COLLECTIVES, 0)
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # count the local ops it becomes
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if name in _FREE or _propagating():
            return out
        if func.namespace == "_c10d_functional" and name in _COLLECTIVE_OPS:
            moved = max(sum(_nbytes(t) for t in tree_leaves((args, kwargs))),
                        sum(_nbytes(t) for t in tree_leaves(out)))
            self.coll[_COLLECTIVE_OPS[name]] += moved
            self.ops[_COLLECTIVE_OPS[name]] += 1
        elif not func.is_view:
            self.hbm += sum(_nbytes(t) for t in tree_leaves((args, kwargs))) \
                + sum(_nbytes(t) for t in tree_leaves(out))
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not any(r.alias_info for r in func._schema.returns):
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    n = _nbytes(t)
                    self.live += n
                    weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
        return out

    def record(self) -> dict:
        """``flops``, ``hbm_bytes``, ``collective_bytes`` by JAX's names,
        ``collective_total``, ``collective_ops`` (the count of each kind)
        and ``peak_bytes``."""
        return {"flops": float(self.flops), "hbm_bytes": float(self.hbm),
                "collective_bytes": {k: float(v)
                                     for k, v in self.coll.items()},
                "collective_total": float(sum(self.coll.values())),
                "collective_ops": dict(self.ops),
                "peak_bytes": int(self.peak)}


def census(fn, *args, **kwargs) -> dict:
    """The census record of ``fn(*args, **kwargs)``."""
    with Census() as c:
        fn(*args, **kwargs)
    return c.record()
