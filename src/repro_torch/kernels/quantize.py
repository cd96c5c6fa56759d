"""CUDA wrappers of the per-row symmetric int8 codec.

Counterpart of ``repro/kernels/quantize.py``.  The JAX version pads rows
to a power-of-two bucket ladder so XLA compiles few programs; a CUDA
kernel takes the row count at run time, so the port has no ladder.  The
kernel source is ``csrc/quantize_rows.cu`` (encode) and
``csrc/dequantize_rows.cu`` (decode); the plain versions are
:func:`repro_torch.kernels.ref.quantize_int8` and ``dequantize_int8``.
"""

from __future__ import annotations

import torch

from ._build import launch


def check_cuda(t: torch.Tensor, dtype: torch.dtype, name: str,
               ndim: int, *, rows_only: bool = False) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` with
    ``ndim`` dimensions — the only layout the kernels take — or, with
    ``rows_only``, a 2-dim one whose rows are contiguous and at least a
    row apart (a column slice of a wider table)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if rows_only and ndim == 2:
        if t.numel() and (t.stride(1) != 1 or t.stride(0) < t.shape[1]):
            raise ValueError(f"{name} must have contiguous rows")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def encode_rows(counter: str, x: torch.Tensor, rows: torch.Tensor | None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8-encode ``x`` (rows 0..n-1) or ``x[rows]``; shared by the codec
    and the fused pull-response gather.  ``x`` may be a view whose rows
    are ``x.stride(0) >= h`` floats apart (its columns contiguous)."""
    check_cuda(x, torch.float32, "x", 2, rows_only=True)
    n = x.shape[0] if rows is None else rows.shape[0]
    h = x.shape[1]
    if rows is not None:
        check_cuda(rows, torch.int32, "rows", 1)
    q = torch.empty((n, h), dtype=torch.int8, device=x.device)
    s = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    if n == 0 or h == 0:
        return q, s.zero_()
    launch(counter, "quantize_rows", x, rows, n, h, x.stride(0), q, s)
    return q, s


def decode_rows(counter: str, values: torch.Tensor, scales: torch.Tensor,
                out: torch.Tensor, rows: torch.Tensor | None,
                accumulate: bool) -> torch.Tensor:
    """Decode int8 rows into ``out`` (rows 0..n-1) or ``out[rows]`` (set
    or add, row ids outside [0, R) dropped); shared by the codec and the
    fused push-apply scatter.  The add sorts the row ids stably first, so
    the kernel adds duplicates in index order, as ``index_add_`` does on
    the CPU."""
    check_cuda(values, torch.int8, "values", 2)
    check_cuda(scales, torch.float32, "scales", 2)
    check_cuda(out, torch.float32, "out", 2)
    n, h = values.shape
    if scales.shape != (n, 1) or out.shape[1] != h:
        raise ValueError(f"shape mismatch: values {tuple(values.shape)}, "
                         f"scales {tuple(scales.shape)}, out "
                         f"{tuple(out.shape)}")
    if rows is not None:
        check_cuda(rows, torch.int32, "rows", 1)
        if rows.shape[0] != n:
            raise ValueError(f"{rows.shape[0]} rows for {n} values")
    elif out.shape[0] != n:
        raise ValueError(f"out has {out.shape[0]} rows for {n} values")
    if n == 0 or h == 0:
        return out
    order = None
    if accumulate and rows is not None:
        rows, order = torch.sort(rows, stable=True)
    launch(counter, "dequantize_rows", values, scales, out, rows, order, n,
           h, out.shape[0], int(accumulate))
    return out


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, h) fp32 → (values int8 (n, h), scales fp32 (n, 1)) on the card;
    bit-identical to ``ref.quantize_int8``."""
    return encode_rows("quantize_int8", x, None)


def dequantize_int8(values: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    """(n, h) int8 × (n, 1) fp32 → (n, h) fp32 on the card."""
    out = torch.empty_like(values, dtype=torch.float32)
    return decode_rows("dequantize_int8", values, scales, out, None, False)
