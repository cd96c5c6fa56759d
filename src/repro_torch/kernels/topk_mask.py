"""CUDA wrappers of the top-k threshold selection.

Counterpart of ``repro/kernels/topk_mask.py``.  Scored pruning (§4.1.2)
and prefetch (§4.3) keep the top-f% of remote-vertex scores; the
selection threshold is found by 24 counting passes of a bisection rather
than a sort.  ``topk_mask`` runs the whole bisection, mask included, in
one launch of ``csrc/topk_select.cu`` (a cooperative grid that keeps the
scores in shared memory across the passes), bit-equal to
:func:`repro_torch.kernels.ref.topk_mask`.  ``count_ge`` launches
``csrc/count_ge.cu``, a single counting pass that no path of the port
launches any more; it stays as an entry point of its own.
"""

from __future__ import annotations

import torch

from ._build import launch
from .quantize import check_cuda

#: int32 words of scratch ``csrc/topk_select.cu`` needs (its kScratchInts:
#: 32 count slots, then a min and a max per block for up to 1024 blocks)
SCRATCH_INTS = 32 + 2 * 1024


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
    on the card, in one launch; bit-equal to ``ref.topk_mask``.  ``k ≤ 0``
    and ``k ≥ n`` need no selection and launch nothing."""
    check_cuda(scores, torch.float32, "scores", 1)
    n = scores.shape[0]
    if k <= 0:
        return torch.zeros(n, dtype=torch.bool, device=scores.device)
    if k >= n:
        return torch.ones(n, dtype=torch.bool, device=scores.device)
    if n >= 2**31:
        raise ValueError(f"topk_mask counts in int32: {n} scores is too many")
    mask = torch.empty(n, dtype=torch.bool, device=scores.device)
    scratch = torch.empty(SCRATCH_INTS, dtype=torch.int32,
                          device=scores.device)
    launch("topk_mask", "topk_select", scores, n, k, mask, scratch,
           SCRATCH_INTS)
    return mask
