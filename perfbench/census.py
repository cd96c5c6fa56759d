"""Bytes and operations worked out from shapes: the benchmark's rooflines
and model FLOPs.

Each kernel's compulsory bytes count every input the function needs read
once and every output written once.  ``agg_bytes`` follows
``chip_smoke.py`` ``agg_bytes`` (the aggregation, row 5, over the
host-built CSR: the int64 row pointer, the kept edges' int32 source ids,
the int32 row order, and the mean and count out), except that of the
source table it counts only the rows the kept edges read, not the
padded table; the codec rows' counts are those ``chip_smoke.py`` gives
its rows 1–4 (``PERF.md``'s kernel table: the fp32 rows, the int8 rows,
the fp32 scales and the int32 row index where one is read).
"""

from __future__ import annotations


def agg_bytes(rows: int, f: int, n_dst: int, kept: int) -> int:
    """Row 5: the mean over the CSR of ``kept`` edges, which read
    ``rows`` distinct source rows of width ``f``."""
    return rows * f * 4 + (n_dst + 1) * 8 + kept * 4 + n_dst * 4 \
        + n_dst * (f + 1) * 4


def agg_bwd_bytes(n_src: int, f: int, rows: int, kept: int) -> int:
    """Row 5b: the gradient of the mean over the transposed CSR: the
    incoming gradient and the counts of the ``rows`` destinations that
    have a kept edge, the int64 row pointer over the sources, the kept
    edges' int32 destinations, the source gradient out (every row of
    the ``n_src``-row table)."""
    return rows * f * 4 + rows * 4 + (n_src + 1) * 8 + kept * 4 \
        + n_src * f * 4


def quantize_bytes(n: int, h: int) -> int:
    """Row 1: fp32 rows in, int8 rows and fp32 scales out."""
    return n * h * 4 + n * h + n * 4


def dequantize_bytes(n: int, h: int) -> int:
    """Row 2: int8 rows and scales in, fp32 rows out."""
    return n * h + n * 4 + n * h * 4


def gather_quantize_bytes(n: int, h: int) -> int:
    """Row 3: the index and the gathered fp32 rows in, int8 rows and
    scales out."""
    return n * 4 + n * h * 4 + n * h + n * 4


def dequant_scatter_bytes(n: int, h: int) -> int:
    """Row 4: the index, int8 rows and scales in, fp32 rows stored."""
    return n * 4 + n * h + n * 4 + n * h * 4


def layer_flops(n_dst: int, kept: int, d_in: int, d_out: int) -> int:
    """One GraphConv layer's forward: the product ``2 · n_dst · d_in ·
    d_out`` and one add per kept edge and feature."""
    return 2 * n_dst * d_in * d_out + kept * d_in


def layer_dims(cfg: dict) -> list[int]:
    """Widths in and out of every layer: features, hidden…, classes."""
    m, g = cfg["model"], cfg["graph"]
    return [g["feat_dim"]] + [m["hidden"]] * (m["num_layers"] - 1) \
        + [g["classes"]]


def blocks_flops(dims: list[int], blocks: list[tuple[int, int]],
                 first_layer: int) -> int:
    """Forward FLOPs of consecutive layers from ``first_layer`` (1-based)
    over blocks given as (destination rows, kept edges)."""
    return sum(layer_flops(n_dst, kept, dims[l - 1], dims[l])
               for l, (n_dst, kept) in enumerate(blocks, start=first_layer))


def train_flops(dims: list[int], blocks: list[tuple[int, int]]) -> int:
    """A training step's model FLOPs: the forward three times over
    (forward and backward), no recomputation."""
    return 3 * blocks_flops(dims, blocks, 1)
