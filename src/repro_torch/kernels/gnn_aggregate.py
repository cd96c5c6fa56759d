"""CUDA wrapper of the neighbour mean-aggregation and its gradient.

Counterpart of ``repro/kernels/gnn_aggregate.py``.  The JAX kernel takes
a fanout-bounded ELL adjacency; the GNN layers of both packages hold
padded edge lists (``edge_src``, ``edge_dst``, ``edge_mask``), so the
port's wrapper takes those directly.  It drops masked edges, builds the
CSR row pointer with torch glue (``bincount``, ``cumsum``) and launches
``csrc/segment_mean_csr.cu``, which sums every kept edge — nothing is
truncated, unlike ``ell_from_csr``.

Both callers already list edges grouped by ascending destination: the
shard CSR flattened by ``full_propagate``, and the serving blocks, whose
padded tail carries ``dst=0`` with the mask off.  The wrapper checks that
grouping and raises rather than sorting behind the caller's back.

:class:`GnnAggregate` is the autograd Function both devices go through.
On the card its forward builds the CSR once (one grouping check per
call); where the source needs a gradient it also builds the transposed
CSR (:func:`transpose_csr`) and saves it, and its backward launches
``csrc/segment_mean_csr_bwd.cu`` on it: a gather per source row with no
atomics, bit-equal to the plain version on the CPU.  On the CPU both
directions are the plain versions (``ref.segment_mean`` and
``ref.segment_mean_backward``).  Layer 1, whose source is the feature
table, and serving (no gradient) build no transposed CSR and run no
backward.

:func:`dequant_aggregate` is the same mean over an int8 source table
with per-row scales (the wire form of a pull), through
``csrc/segment_mean_csr_int8.cu``; forward only, like the JAX kernel.
"""

from __future__ import annotations

import torch

from . import ref
from ._build import launch
from .quantize import check_cuda


def segment_mean_csr(src: torch.Tensor, indptr: torch.Tensor,
                     indices: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """src (N_src, F) fp32, indptr (n_dst + 1,) int64, indices int32 →
    (mean (n_dst, F), cnt (n_dst,) fp32); the raw kernel launch."""
    check_cuda(src, torch.float32, "src", 2)
    check_cuda(indptr, torch.int64, "indptr", 1)
    check_cuda(indices, torch.int32, "indices", 1)
    n_dst = indptr.shape[0] - 1
    f = src.shape[1]
    mean = torch.empty((n_dst, f), dtype=torch.float32, device=src.device)
    cnt = torch.empty(n_dst, dtype=torch.float32, device=src.device)
    if n_dst == 0:
        return mean, cnt
    launch("gnn_aggregate", "segment_mean_csr", src, indptr, indices, n_dst,
           f, mean, cnt)
    return mean, cnt


def csr_from_edges(n_src: int, edge_src: torch.Tensor,
                   edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                   n_dst: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kept edges of a destination-grouped padded edge list → (indptr
    int64, indices int32).  Raises when the kept edges are not grouped by
    ascending destination or an id is out of range."""
    keep = edge_mask.to(torch.bool)
    es = edge_src[keep].to(torch.int32)
    ed = edge_dst[keep].to(torch.int64)
    if ed.numel():
        # one host sync for all four checks
        unsorted, lo_d, hi_d, lo_s, hi_s = torch.stack([
            (ed[1:] < ed[:-1]).any().to(torch.int64), ed.min(), ed.max(),
            es.min().to(torch.int64), es.max().to(torch.int64)]).tolist()
        if unsorted:
            raise ValueError("gnn_aggregate needs the kept edges grouped by "
                             "ascending destination")
        if lo_d < 0 or hi_d >= n_dst or lo_s < 0 or hi_s >= n_src:
            raise ValueError(f"edge ids out of range: dst [{lo_d}, {hi_d}] "
                             f"for {n_dst} rows, src [{lo_s}, {hi_s}] for "
                             f"{n_src} rows")
    indptr = torch.zeros(n_dst + 1, dtype=torch.int64, device=ed.device)
    indptr[1:] = torch.cumsum(torch.bincount(ed, minlength=n_dst), 0)
    return indptr, es


def transpose_csr(indptr: torch.Tensor, indices: torch.Tensor,
                  n_src: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The CSR of :func:`csr_from_edges` (rows = destinations) turned
    over: (t_indptr (n_src + 1,) int64, t_dst int32), the destination of
    each kept edge grouped by source, in ascending edge order within a
    source (a stable sort).  Four launches of torch glue, none of which
    waits on the host."""
    src_sorted, order = torch.sort(indices, stable=True)
    t_indptr = torch.searchsorted(
        src_sorted, torch.arange(n_src + 1, dtype=torch.int32,
                                 device=indptr.device))
    # edge e belongs to the destination d with indptr[d] <= e < indptr[d+1]
    t_dst = torch.searchsorted(indptr[1:], order, right=True,
                               out_int32=True)
    return t_indptr, t_dst


def _segment_mean_bwd(grad_mean: torch.Tensor, t_indptr: torch.Tensor,
                      t_dst: torch.Tensor, cnt: torch.Tensor,
                      n_src: int) -> torch.Tensor:
    """The backward's launch on a transposed CSR the caller built."""
    check_cuda(grad_mean, torch.float32, "grad_mean", 2)
    n_dst, f = grad_mean.shape
    grad_src = torch.empty((n_src, f), dtype=torch.float32,
                           device=grad_mean.device)
    if n_src and f:
        quotient = torch.empty_like(grad_mean)
        launch("segment_mean_bwd", "segment_mean_csr_bwd", grad_mean,
               t_indptr, t_dst, cnt, n_dst, n_src, f, quotient, grad_src)
    return grad_src


def segment_mean_csr_bwd(grad_mean: torch.Tensor, t_indptr: torch.Tensor,
                         t_dst: torch.Tensor, cnt: torch.Tensor,
                         n_src: int) -> torch.Tensor:
    """grad_mean (n_dst, F) fp32 over the transposed CSR of the forward
    (:func:`transpose_csr`) and its counts → grad_src (n_src, F) fp32;
    the raw kernel launch, with every input checked."""
    check_cuda(grad_mean, torch.float32, "grad_mean", 2)
    check_cuda(t_indptr, torch.int64, "t_indptr", 1)
    check_cuda(t_dst, torch.int32, "t_dst", 1)
    check_cuda(cnt, torch.float32, "cnt", 1)
    if t_indptr.shape[0] != n_src + 1 or cnt.shape[0] != grad_mean.shape[0]:
        raise ValueError(f"t_indptr {tuple(t_indptr.shape)} for {n_src} "
                         f"source rows, cnt {tuple(cnt.shape)} for grad_mean "
                         f"{tuple(grad_mean.shape)}")
    return _segment_mean_bwd(grad_mean, t_indptr, t_dst, cnt, n_src)


class GnnAggregate(torch.autograd.Function):
    """Masked neighbour mean with its gradient: the kernels on the card,
    the plain versions on the CPU.  ``cnt`` depends on the mask alone and
    is not differentiable."""

    @staticmethod
    def forward(ctx, src, edge_src, edge_dst, edge_mask, n_dst):
        ctx.n_src = src.shape[0]
        if src.device.type == "cuda":
            indptr, indices = csr_from_edges(src.shape[0], edge_src,
                                             edge_dst, edge_mask, n_dst)
            mean, cnt = segment_mean_csr(src, indptr, indices)
            if ctx.needs_input_grad[0]:
                ctx.save_for_backward(
                    *transpose_csr(indptr, indices, src.shape[0]), cnt)
        else:
            mean, cnt = ref.segment_mean(src, edge_src, edge_dst, edge_mask,
                                         n_dst)
            ctx.save_for_backward(edge_src, edge_dst, edge_mask, cnt)
        ctx.mark_non_differentiable(cnt)
        return mean, cnt

    @staticmethod
    def backward(ctx, grad_mean, _grad_cnt):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        saved = ctx.saved_tensors
        if grad_mean.device.type == "cuda":
            t_indptr, t_dst, cnt = saved
            grad_src = _segment_mean_bwd(grad_mean.contiguous(), t_indptr,
                                         t_dst, cnt, ctx.n_src)
        else:
            edge_src, edge_dst, edge_mask, cnt = saved
            grad_src = ref.segment_mean_backward(grad_mean, edge_src,
                                                 edge_dst, edge_mask, cnt,
                                                 ctx.n_src)
        return grad_src, None, None, None, None


def gnn_aggregate(src: torch.Tensor, edge_src: torch.Tensor,
                  edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                  n_dst: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked neighbour mean on the card: (mean (n_dst, F), cnt (n_dst,)),
    the function of ``ref.segment_mean``, differentiable in ``src``."""
    check_cuda(src, torch.float32, "src", 2)
    return GnnAggregate.apply(src, edge_src, edge_dst, edge_mask, n_dst)


def dequant_aggregate(values: torch.Tensor, scales: torch.Tensor,
                      edge_src: torch.Tensor, edge_dst: torch.Tensor,
                      edge_mask: torch.Tensor, n_dst: int) -> torch.Tensor:
    """Masked neighbour mean over an int8 table on the card: values
    (N_src, F) int8, scales (N_src, 1) fp32 → mean (n_dst, F) fp32,
    bit-equal to ``gnn_aggregate(dequantize_int8(values, scales), …)``
    through the port's kernels."""
    check_cuda(values, torch.int8, "values", 2)
    check_cuda(scales, torch.float32, "scales", 2)
    n_src, f = values.shape
    if scales.shape != (n_src, 1):
        raise ValueError(f"scales {tuple(scales.shape)} for values "
                         f"{tuple(values.shape)}")
    indptr, indices = csr_from_edges(n_src, edge_src, edge_dst, edge_mask,
                                     n_dst)
    mean = torch.empty((n_dst, f), dtype=torch.float32, device=values.device)
    if n_dst == 0:
        return mean
    launch("dequant_aggregate", "segment_mean_csr_int8", values, scales,
           indptr, indices, n_dst, f, mean)
    return mean
