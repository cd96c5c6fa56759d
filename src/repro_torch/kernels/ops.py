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
from . import swa_attention as _swa
from . import topk_mask as _topk


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
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


def host_to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  To the card it goes
    through page-locked memory without waiting for the copy, so a pull
    or a push that builds its indices this way never syncs the host."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


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
    return host_to_device(np.clip(rows, -1, R).astype(np.int32), device)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if _on_cuda(x):
        return _quant.quantize_int8(x)
    return ref.quantize_int8(x)


def dequantize_int8(values: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    if _on_cuda(values):
        return _quant.dequantize_int8(values, scales)
    return ref.dequantize_int8(values, scales)


def _index(rows, table: torch.Tensor, *, check: bool) -> torch.Tensor:
    """``rows`` as the int32 index of ``table``'s rows: an int32 tensor
    already on the table's device as it is (made by :func:`row_index`),
    anything else through :func:`row_index`."""
    if (isinstance(rows, torch.Tensor) and rows.dtype == torch.int32
            and rows.device == table.device):
        return rows
    return row_index(rows, table.shape[0], table.device, check=check)


def gather_quantize(table: torch.Tensor, rows
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused pull response ``quantize_int8(table[rows])``; ``rows`` are
    host ids, checked against the table, or an int32 index on the
    table's device that :func:`row_index` made with ``check=True``."""
    idx = _index(rows, table, check=True)
    if _on_cuda(table):
        return _fused.gather_quantize(table, idx)
    return ref.gather_quantize(table, idx)


def dequant_scatter_(table: torch.Tensor, rows, values: torch.Tensor,
                     scales: torch.Tensor, *,
                     accumulate: bool = False) -> torch.Tensor:
    """Fused push apply into ``table`` in place; ``rows`` are host ids or
    an int32 index on the table's device (:func:`row_index`), unique
    unless ``accumulate``, ids outside [0, R) dropped."""
    idx = _index(rows, table, check=False)
    if _on_cuda(table):
        return _fused.dequant_scatter_(table, idx, values, scales,
                                       accumulate=accumulate)
    return ref.dequant_scatter_(table, idx, values, scales,
                                accumulate=accumulate)


def gnn_aggregate(src: torch.Tensor, edge_src: torch.Tensor,
                  edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                  n_dst: int, csr: _agg.Csr | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked neighbour mean over a destination-grouped edge list →
    (mean (n_dst, F), cnt (n_dst,) fp32), differentiable in ``src``
    through :class:`GnnAggregate` (the kernels on the card, the plain
    versions on the CPU).  ``csr``, the :class:`Csr` of the same kept
    edges built on the host, spares the card the glue that builds it."""
    if _on_cuda(src):
        return _agg.gnn_aggregate(src, edge_src, edge_dst, edge_mask, n_dst,
                                  csr)
    return _agg.GnnAggregate.apply(src, edge_src, edge_dst, edge_mask, n_dst,
                                   csr)


def dequant_aggregate(values: torch.Tensor, scales: torch.Tensor,
                      edge_src: torch.Tensor, edge_dst: torch.Tensor,
                      edge_mask: torch.Tensor, n_dst: int,
                      csr: _agg.Csr | None = None) -> torch.Tensor:
    """Masked neighbour mean over an int8 source table (values (N_src, F)
    int8, scales (N_src, 1) fp32) and a destination-grouped edge list →
    mean (n_dst, F) fp32, equal to ``gnn_aggregate(dequantize_int8(values,
    scales), …)[0]``.  Forward only, as in the JAX package.  ``csr``, the
    :class:`Csr` of the same kept edges built on the host, spares the
    card the glue that builds it; it is checked against the table on
    either device, and the CPU's plain version runs over the edge lists."""
    if _on_cuda(values):
        return _agg.dequant_aggregate(values, scales, edge_src, edge_dst,
                                      edge_mask, n_dst, csr)
    if csr is not None:
        _agg._device_csr(csr, values, n_dst)
    return ref.dequant_aggregate(values, scales, edge_src, edge_dst,
                                 edge_mask, n_dst)


def swa_attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_pos: torch.Tensor, kv_valid: torch.Tensor,
                         q_pos: torch.Tensor, *, window: int | None
                         ) -> torch.Tensor:
    """One-token GQA decode attention against a ring-buffer cache: q (B,
    H, dh), k/v (B, T, Hkv, dh), kv_pos / kv_valid (B, T), q_pos (B,) →
    (B, H, dh); ``window=None`` is plain causal decode."""
    if _on_cuda(q):
        return _swa.swa_attention_decode(q, k, v, kv_pos, kv_valid, q_pos,
                                         window=window)
    return ref.swa_attention_decode(q, k, v, kv_pos, kv_valid, q_pos,
                                    window)


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
