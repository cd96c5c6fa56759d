"""CUDA wrappers of the top-k threshold selection.

Counterpart of ``repro/kernels/topk_mask.py``.  Scored pruning (§4.1.2)
and prefetch (§4.3) keep the top-f% of remote-vertex scores; the
selection threshold is found by 24 counting passes of a bisection rather
than a sort.  ``count_ge`` launches ``csrc/count_ge.cu`` (one pass);
``topk_mask`` replays the JAX bisection over it in fp32
(:func:`repro_torch.kernels.ref.topk_mask`), 25 count launches in all,
each writing its own slot of one zeroed buffer, with the threshold left
on the card between passes.
"""

from __future__ import annotations

import torch

from . import ref
from ._build import launch
from .quantize import check_cuda


def count_ge(scores: torch.Tensor, thr: torch.Tensor, *,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """#(scores ≥ thr) on the card: scores (n,) fp32, thr a one-element
    fp32 tensor; → int32 0-dim.  ``out`` is a zeroed one-element int32
    tensor to count into (allocated when not given)."""
    check_cuda(scores, torch.float32, "scores", 1)
    if thr.device != scores.device or thr.dtype != torch.float32 \
            or thr.numel() != 1:
        raise ValueError("thr must be one fp32 value on the scores' device")
    if out is None:
        out = torch.zeros(1, dtype=torch.int32, device=scores.device)
    check_cuda(out, torch.int32, "out", 1)
    if scores.shape[0]:
        launch("count_ge", "count_ge", scores, scores.shape[0],
               thr.contiguous(), out)
    return out.reshape(())


def topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of at least the ``k`` largest of ``scores`` (n,) fp32
    on the card; bit-equal to ``ref.topk_mask``."""
    check_cuda(scores, torch.float32, "scores", 1)
    slots = torch.zeros(ref.TOPK_ITERS + 1, dtype=torch.int32,
                        device=scores.device)
    used = iter(range(ref.TOPK_ITERS + 1))

    def count(s, thr):
        i = next(used)
        return count_ge(s, thr, out=slots[i: i + 1])

    return ref.topk_mask(scores, k, count=count)
