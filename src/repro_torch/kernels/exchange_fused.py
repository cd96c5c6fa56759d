"""CUDA wrappers of the fused exchange-plane ops.

Counterpart of ``repro/kernels/exchange_fused.py``:

  gather_quantize   — pull responses: row gather out of the embedding
      server's resident table fused with the int8 encode; equals
      ``quantize_int8(table[rows])`` bit for bit.
  dequant_scatter_  — push applies: int8 decode fused with a scatter
      into the table, set (rows unique) or add.  The JAX version returns
      a new table through ``input_output_aliases``; the port updates the
      table in place.

They launch the codec's kernels (``csrc/quantize_rows.cu``,
``csrc/dequantize_rows.cu``) with a row-index vector.  ``rows`` is an
int32 CUDA tensor; :mod:`repro_torch.kernels.ops` builds it from host ids
and checks their range first.
"""

from __future__ import annotations

import torch

from .quantize import decode_rows, encode_rows


def gather_quantize(table: torch.Tensor, rows: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """table (R, h) fp32 × rows (n,) int32 in [0, R) → (values int8
    (n, h), scales fp32 (n, 1))."""
    return encode_rows("gather_quantize", table, rows)


def dequant_scatter_(table: torch.Tensor, rows: torch.Tensor,
                     values: torch.Tensor, scales: torch.Tensor, *,
                     accumulate: bool = False) -> torch.Tensor:
    """Store ``values · scales`` into ``table[rows]`` in place (set, or
    add with ``accumulate``); row ids outside [0, R) are dropped.
    Returns ``table``."""
    return decode_rows("dequant_scatter", values, scales, table, rows,
                       accumulate)
