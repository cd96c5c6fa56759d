"""Dispatch between the CUDA kernels and their plain versions.

Counterpart of ``repro/kernels/ops.py``.  The choice follows the device
of the data: a CPU tensor takes the plain PyTorch version in
:mod:`repro_torch.kernels.ref`, a CUDA tensor launches the hand-written
kernel (which builds on first use and raises on any failure — there is
no fallback).  Every launch is counted per entry point; read the counts
with :func:`launch_counts` to show that a run went through the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, ref
from . import exchange_fused as _fused
from . import gnn_aggregate as _agg
from . import quantize as _quant
from . import topk_mask as _topk


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def launch_counts() -> dict[str, int]:
    """Kernel launches per entry point since the last reset."""
    return dict(_build.LAUNCHES)


def reset_launch_counts() -> None:
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0


def row_index(rows, R: int, device, *, check: bool) -> torch.Tensor:
    """Host row ids → an int32 index tensor on ``device``.  ``check``
    demands every id in [0, R) (gathers); without it ids outside the
    range pass as -1 or R, which the scatter drops."""
    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    rows = np.asarray(rows, np.int64)
    if check and len(rows) and (rows.min() < 0 or rows.max() >= R):
        raise IndexError(f"row ids [{rows.min()}, {rows.max()}] outside a "
                         f"table of {R} rows")
    return torch.from_numpy(np.clip(rows, -1, R).astype(np.int32)) \
        .to(device)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if _on_cuda(x):
        return _quant.quantize_int8(x)
    return ref.quantize_int8(x)


def dequantize_int8(values: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    if _on_cuda(values):
        return _quant.dequantize_int8(values, scales)
    return ref.dequantize_int8(values, scales)


def gather_quantize(table: torch.Tensor, rows
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused pull response ``quantize_int8(table[rows])``; ``rows`` are
    host ids, checked against the table."""
    idx = row_index(rows, table.shape[0], table.device, check=True)
    if _on_cuda(table):
        return _fused.gather_quantize(table, idx)
    return ref.gather_quantize(table, idx)


def dequant_scatter_(table: torch.Tensor, rows, values: torch.Tensor,
                     scales: torch.Tensor, *,
                     accumulate: bool = False) -> torch.Tensor:
    """Fused push apply into ``table`` in place; ``rows`` are host ids
    (unique unless ``accumulate``), ids outside [0, R) dropped."""
    idx = row_index(rows, table.shape[0], table.device, check=False)
    if _on_cuda(table):
        return _fused.dequant_scatter_(table, idx, values, scales,
                                       accumulate=accumulate)
    return ref.dequant_scatter_(table, idx, values, scales,
                                accumulate=accumulate)


def gnn_aggregate(src: torch.Tensor, edge_src: torch.Tensor,
                  edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                  n_dst: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked neighbour mean over a destination-grouped edge list →
    (mean (n_dst, F), cnt (n_dst,) fp32), differentiable in ``src``
    through :class:`GnnAggregate` (the kernels on the card, the plain
    versions on the CPU)."""
    if _on_cuda(src):
        return _agg.gnn_aggregate(src, edge_src, edge_dst, edge_mask, n_dst)
    return _agg.GnnAggregate.apply(src, edge_src, edge_dst, edge_mask, n_dst)


def count_ge(scores: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """#(scores ≥ thr) as an int32 0-dim tensor."""
    if _on_cuda(scores):
        return _topk.count_ge(scores, thr)
    return ref.count_ge(scores, thr)


def topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of at least the ``k`` largest fp32 ``scores`` (ties
    at the threshold kept), bit-equal to the JAX ``topk_mask``."""
    if _on_cuda(scores):
        return _topk.topk_mask(scores, k)
    return ref.topk_mask(scores, k)
