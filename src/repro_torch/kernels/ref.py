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


def dequant_aggregate(values: torch.Tensor, scales: torch.Tensor,
                      edge_src: torch.Tensor, edge_dst: torch.Tensor,
                      edge_mask: torch.Tensor, n_dst: int) -> torch.Tensor:
    """Masked neighbour mean straight off the wire form: decode the int8
    source table, then :func:`segment_mean` — the two-step path the
    fused kernel replaces (JAX's ``ref.dequant_aggregate``).  Returns the
    mean (n_dst, F) fp32."""
    return segment_mean(dequantize_int8(values, scales), edge_src,
                        edge_dst, edge_mask, n_dst)[0]


def segment_mean_backward(grad_mean: torch.Tensor, edge_src: torch.Tensor,
                          edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                          cnt: torch.Tensor, n_src: int) -> torch.Tensor:
    """Gradient of :func:`segment_mean`'s mean with respect to ``src``,
    op for op JAX's transpose of ``_segment_mean``: each kept edge adds
    ``grad_mean[dst] / max(cnt[dst], 1)`` (times its mask weight) into
    row ``src`` of a zeroed (n_src, F) table."""
    w = edge_mask.to(grad_mean.dtype)
    per_dst = grad_mean / torch.clamp_min(cnt, 1.0)[:, None]
    terms = per_dst[edge_dst.to(torch.int64)] * w[:, None]
    grad_src = torch.zeros((n_src, grad_mean.shape[1]),
                           dtype=grad_mean.dtype, device=grad_mean.device)
    grad_src.index_add_(0, edge_src.to(torch.int64), terms)
    return grad_src


def segment_mean_backward_csc(grad_mean: torch.Tensor,
                              t_indptr: torch.Tensor, t_dst: torch.Tensor,
                              cnt: torch.Tensor, n_src: int) -> torch.Tensor:
    """:func:`segment_mean_backward` over the transposed CSR of the kept
    edges (``t_indptr`` over the sources, ``t_dst`` each edge's
    destination, grouped by source in ascending edge order): the function
    of ``csrc/segment_mean_csr_bwd.cu``.  On the CPU ``index_add_`` adds
    the terms one by one in order, so this is bit-equal to
    :func:`segment_mean_backward` there."""
    per_dst = grad_mean / torch.clamp_min(cnt, 1.0)[:, None]
    src = torch.repeat_interleave(
        torch.arange(n_src, device=grad_mean.device),
        t_indptr[1:] - t_indptr[:-1], output_size=t_dst.shape[0])
    grad_src = torch.zeros((n_src, grad_mean.shape[1]),
                           dtype=grad_mean.dtype, device=grad_mean.device)
    grad_src.index_add_(0, src, per_dst[t_dst.to(torch.int64)])
    return grad_src


#: Bisection steps of the top-k threshold search (``topk_mask.py:ITERS``).
TOPK_ITERS = 24


def count_ge(scores: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """Number of ``scores >= thr`` as an int32 0-dim tensor on the
    scores' device; ``thr`` is a 0-dim fp32 tensor."""
    return (scores >= thr).sum().to(torch.int32)


def topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask holding at least the ``k`` largest scores: the JAX
    kernel's threshold bisection (``repro/kernels/topk_mask.py``) replayed
    in fp32 step for step, so the mask is bit-equal to it.  Ties at the
    threshold are all kept.

    Every scalar stays a fp32 tensor on the scores' device (Python floats
    are float64), and the 24 decisions are taken with ``torch.where``, so
    the loop never waits on the host."""
    n = scores.shape[0]
    if k <= 0:
        return torch.zeros(n, dtype=torch.bool, device=scores.device)
    if k >= n:
        return torch.ones(n, dtype=torch.bool, device=scores.device)
    s = scores.to(torch.float32).contiguous()

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=s.device)

    lo = s.min()
    hi = s.max() + f32(1e-6)
    half = f32(0.5)
    for _ in range(TOPK_ITERS):
        mid = half * (lo + hi)
        above = count_ge(s, mid) > k
        lo, hi = torch.where(above, mid, lo), torch.where(above, hi, mid)
    thr = torch.where(count_ge(s, hi) >= k, hi, lo)
    return s >= thr


#: The finite "minus infinity" of masked attention scores
#: (``repro/models/layers.py:NEG_INF``): a fully masked row gives the
#: uniform average of its values, never NaN.
NEG_INF = -1e30


def swa_attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_pos: torch.Tensor, kv_valid: torch.Tensor,
                         q_pos: torch.Tensor, window: int | None
                         ) -> torch.Tensor:
    """One-token GQA attention against a (ring-buffer) cache, op for op
    the JAX model's ``layers.decode_attention``: ``q · 1/sqrt(dh)`` in
    fp32, the fp32 dot with K, slots kept where ``kv_valid & pos ≤ q_pos
    & (window is None or pos > q_pos − window)`` and the rest set to
    :data:`NEG_INF`, an fp32 softmax, ``p · V`` in fp32, cast to q's dtype.

    q (B, H, dh); k/v (B, T, Hkv, dh) with H = G·Hkv; kv_pos int32 and
    kv_valid bool (B, T); q_pos int32 (B,).  Returns (B, H, dh)."""
    B, H, dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, dh).to(torch.float32) \
        * float(1.0 / np.sqrt(dh))
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.to(torch.float32))
    mask = kv_valid & (kv_pos <= q_pos[:, None])
    if window is not None:
        mask = mask & (kv_pos > q_pos[:, None] - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.to(torch.float32))
    return out.reshape(B, H, dh).to(q.dtype)
