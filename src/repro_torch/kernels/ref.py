"""Plain PyTorch versions of the port's kernels.

Each function computes exactly what its CUDA kernel computes, op for op
with the JAX package's references (``repro.kernels.ref`` and the numpy
mirrors in ``repro.kernels.ops``), on any device.  The dispatchers in
:mod:`repro_torch.kernels.ops` run these on CPU tensors; on the card they
are what each kernel is held against.
"""

from __future__ import annotations

import numpy as np
import torch

#: fp32(1/127): the encode multiplies by it rather than dividing by 127,
#: which keeps every implementation of the codec bit-identical.
INV127 = float(np.float32(1.0 / 127.0))


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: (n, h) fp32 → (values int8
    (n, h), scales fp32 (n, 1)) with scale = row absmax · fp32(1/127), 0
    for an all-zero row; values round half to even."""
    x = x.to(torch.float32)
    n, h = x.shape
    if n == 0 or h == 0:
        return (torch.zeros((n, h), dtype=torch.int8, device=x.device),
                torch.zeros((n, 1), dtype=torch.float32, device=x.device))
    absmax = x.abs().amax(dim=1, keepdim=True)
    scale = absmax * torch.tensor(INV127, dtype=torch.float32,
                                  device=x.device)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_int8(values: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    """(n, h) int8 × (n, 1) fp32 scales → (n, h) fp32."""
    return values.to(torch.float32) * scales.to(torch.float32)


def gather_quantize(table: torch.Tensor, rows: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_int8(table[rows])``: the pull response in wire form."""
    return quantize_int8(table[rows.to(torch.int64)])


def dequant_scatter_(table: torch.Tensor, rows: torch.Tensor,
                     values: torch.Tensor, scales: torch.Tensor, *,
                     accumulate: bool = False) -> torch.Tensor:
    """Decode int8 rows and store them into ``table`` at ``rows`` in
    place: overwrite (push apply; rows unique) or add.  Row ids outside
    [0, R) are dropped.  Returns ``table``."""
    rows = rows.to(torch.int64)
    keep = (rows >= 0) & (rows < table.shape[0])
    new = dequantize_int8(values, scales)[keep]
    rows = rows[keep]
    if accumulate:
        table.index_add_(0, rows, new)
    else:
        table[rows] = new
    return table


def segment_mean(src: torch.Tensor, edge_src: torch.Tensor,
                 edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                 n_dst: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked neighbour mean over an edge list, op for op the JAX model's
    ``_segment_mean`` (``repro/models/gnn.py``): gather the source rows,
    weight them by the mask, segment-sum by destination and divide by
    ``max(cnt, 1)``.  Returns (mean (n_dst, F), cnt (n_dst,) fp32)."""
    vals = src[edge_src.to(torch.int64)]
    w = edge_mask.to(vals.dtype)
    dst = edge_dst.to(torch.int64)
    summed = torch.zeros((n_dst, src.shape[1]), dtype=vals.dtype,
                         device=src.device)
    summed.index_add_(0, dst, vals * w[:, None])
    cnt = torch.zeros(n_dst, dtype=vals.dtype, device=src.device)
    cnt.index_add_(0, dst, w)
    return summed / torch.clamp_min(cnt, 1.0)[:, None], cnt
