"""CUDA wrapper of the neighbour mean-aggregation and its gradient.

Counterpart of ``repro/kernels/gnn_aggregate.py``.  The JAX kernel takes
a fanout-bounded ELL adjacency; the GNN layers of both packages hold
padded edge lists (``edge_src``, ``edge_dst``, ``edge_mask``), so the
port aggregates over the CSR of the kept edges with
``csrc/segment_mean_csr.cu``, which sums every kept edge — nothing is
truncated, unlike ``ell_from_csr``.

The edge lists never change once made, so the CSR is built once, on the
host, where they are made (:func:`csr_arrays`, called by
``models/gnn.py`` for sampled and serving blocks and shards and by
``core/federated.py`` for the evaluation graph), and travels to the card
with them as a :class:`Csr`.  Given one, :class:`GnnAggregate` launches
the kernels with no glue and no host sync.  A direct caller without one
gets the same CSR from torch glue on the card (:func:`csr_from_edges`,
:func:`transpose_csr`; two host syncs for the checks): both builds give
the same bytes.

Every caller lists edges grouped by ascending destination: the shard CSR
flattened by ``full_propagate``, the sampled blocks, and the serving
blocks, whose padded tail carries ``dst=0`` with the mask off.  Both
builds check that grouping and the id ranges and raise rather than sort
behind the caller's back.

:class:`GnnAggregate` is the autograd Function both devices go through.
Where the source needs a gradient it keeps the transposed CSR (the one
the block carries, else :func:`transpose_csr`) and its backward launches
``csrc/segment_mean_csr_bwd.cu`` on it: a gather per source row with no
atomics, bit-equal to the plain version on the CPU.  On the CPU both
directions are the plain versions (``ref.segment_mean`` and
``ref.segment_mean_backward``) over the edge lists.  Layer 1, whose
source is the feature table, and serving (no gradient) run no backward.

:func:`dequant_aggregate` is the same mean over an int8 source table
with per-row scales (the wire form of a pull), through
``csrc/segment_mean_csr_int8.cu``, over the same :class:`Csr` where the
caller has one; forward only, like the JAX kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import ref
from ._build import launch
from .quantize import check_cuda

class Csr(NamedTuple):
    """The CSR of a block's kept edges (rows = destinations), built once
    by :func:`csr_arrays`: numpy arrays on the host, tensors on the
    device after the block's one copy there.  ``src_rows`` is the fewest
    rows a source table must have (largest id + 1), checked against the
    table on the host.  ``t_indptr`` / ``t_dst`` (the transposed CSR, see
    :func:`transpose_csr`) are there where the block's source needs a
    gradient, else None."""

    indptr: object           # (n_dst + 1,) int64
    indices: object          # (kept,) int32 source rows
    order: object            # (n_dst,) int32 rows by falling degree
    src_rows: int
    t_indptr: object = None  # (n_src + 1,) int64
    t_dst: object = None     # (kept,) int32


def _check_edges(n_src: int, n_dst: int, lo_d, hi_d, lo_s, hi_s,
                 unsorted) -> None:
    if unsorted:
        raise ValueError("gnn_aggregate needs the kept edges grouped by "
                         "ascending destination")
    if lo_d < 0 or hi_d >= n_dst or lo_s < 0 or hi_s >= n_src:
        raise ValueError(f"edge ids out of range: dst [{lo_d}, {hi_d}] "
                         f"for {n_dst} rows, src [{lo_s}, {hi_s}] for "
                         f"{n_src} rows")


def csr_arrays(n_src: int, edge_src, edge_dst, edge_mask, n_dst: int, *,
               transposed: bool = False) -> Csr:
    """The host build: a destination-grouped padded edge list (numpy) →
    the :class:`Csr` of its kept edges in numpy, byte-equal to
    :func:`csr_from_edges` (and, with ``transposed``, to
    :func:`transpose_csr` over ``n_src`` sources).  Raises as
    :func:`csr_from_edges` does on ungrouped kept edges or ids out of
    range."""
    keep = np.flatnonzero(np.asarray(edge_mask, bool))
    es = np.asarray(edge_src).take(keep).astype(np.int32, copy=False)
    ed = np.asarray(edge_dst).take(keep)
    src_rows = 0
    if ed.size:   # grouped, the first and last are the least and most
        _check_edges(n_src, n_dst, ed[0], ed[-1], es.min(), es.max(),
                     bool(np.any(ed[1:] < ed[:-1])))
        src_rows = int(es.max()) + 1
    indptr = np.zeros(n_dst + 1, np.int64)
    np.cumsum(np.bincount(ed, minlength=n_dst), out=indptr[1:])
    csr = csr_of(indptr, es, src_rows)
    if not transposed:
        return csr
    t_indptr = np.zeros(n_src + 1, np.int64)
    np.cumsum(np.bincount(es, minlength=n_src), out=t_indptr[1:])
    t_dst = ed[np.argsort(es, kind="stable")].astype(np.int32)
    return csr._replace(t_indptr=t_indptr, t_dst=t_dst)


def csr_of(indptr: np.ndarray, indices: np.ndarray, src_rows: int) -> Csr:
    """The :class:`Csr` of an adjacency already in CSR form on the host
    (indptr int64, indices int32 below ``src_rows``), its rows ordered by
    falling degree (ties by row) for the kernel's warps."""
    order = np.argsort(-np.diff(indptr), kind="stable").astype(np.int32)
    return Csr(indptr, indices, order, src_rows)


def segment_mean_csr(src: torch.Tensor, indptr: torch.Tensor,
                     indices: torch.Tensor, order: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """src (N_src, F) fp32, indptr (n_dst + 1,) int64, indices int32 and,
    optionally, the order in which the kernel takes the rows (n_dst int32)
    → (mean (n_dst, F), cnt (n_dst,) fp32); the raw kernel launch."""
    check_cuda(src, torch.float32, "src", 2)
    check_cuda(indptr, torch.int64, "indptr", 1)
    check_cuda(indices, torch.int32, "indices", 1)
    n_dst = indptr.shape[0] - 1
    if order is not None:
        check_cuda(order, torch.int32, "order", 1)
        if order.shape[0] != n_dst:
            raise ValueError(f"order has {order.shape[0]} rows for {n_dst}")
    f = src.shape[1]
    mean = torch.empty((n_dst, f), dtype=torch.float32, device=src.device)
    cnt = torch.empty(n_dst, dtype=torch.float32, device=src.device)
    if n_dst == 0:
        return mean, cnt
    launch("gnn_aggregate", "segment_mean_csr", src, indptr, indices, order,
           n_dst, f, mean, cnt)
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
        _check_edges(n_src, n_dst, lo_d, hi_d, lo_s, hi_s, unsorted)
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


def _device_csr(csr: Csr, src: torch.Tensor, n_dst: int) -> None:
    """Host-side checks of a prebuilt CSR against the table and the
    destination count: shapes only, so nothing waits on the card."""
    if csr.indptr.shape[0] != n_dst + 1:
        raise ValueError(f"the CSR has {csr.indptr.shape[0] - 1} rows for "
                         f"{n_dst} destinations")
    if src.shape[0] < csr.src_rows:
        raise ValueError(f"a source id reaches row {csr.src_rows - 1} of a "
                         f"table of {src.shape[0]} rows")


def _launch_csr(src: torch.Tensor, edge_src, edge_dst, edge_mask,
                n_dst: int, csr: Csr | None) -> tuple:
    """(indptr, indices, order) to launch on: the host-built ``csr``,
    checked against the table ``src`` on the host, or, without one, the
    glue's CSR of the edge lists (taken in row order)."""
    if csr is None:
        return (*csr_from_edges(src.shape[0], edge_src, edge_dst, edge_mask,
                                n_dst), None)
    _device_csr(csr, src, n_dst)
    return csr.indptr, csr.indices, csr.order


class GnnAggregate(torch.autograd.Function):
    """Masked neighbour mean with its gradient: the kernels on the card
    (over ``csr`` where the block carries one), the plain versions over
    the edge lists on the CPU.  ``cnt`` depends on the mask alone and is
    not differentiable."""

    @staticmethod
    def forward(ctx, src, edge_src, edge_dst, edge_mask, n_dst, csr=None):
        ctx.n_src = src.shape[0]
        if src.device.type == "cuda":
            indptr, indices, order = _launch_csr(src, edge_src, edge_dst,
                                                 edge_mask, n_dst, csr)
            mean, cnt = segment_mean_csr(src, indptr, indices, order)
            if ctx.needs_input_grad[0]:
                if csr is not None and csr.t_indptr is not None:
                    n_t = csr.t_indptr.shape[0] - 1
                    if n_t != src.shape[0]:
                        raise ValueError(f"the transposed CSR has {n_t} "
                                         f"sources for a table of "
                                         f"{src.shape[0]} rows")
                    transposed = (csr.t_indptr, csr.t_dst)
                else:
                    transposed = transpose_csr(indptr, indices, src.shape[0])
                ctx.save_for_backward(*transposed, cnt)
        else:
            mean, cnt = ref.segment_mean(src, edge_src, edge_dst, edge_mask,
                                         n_dst)
            ctx.save_for_backward(edge_src, edge_dst, edge_mask, cnt)
        ctx.mark_non_differentiable(cnt)
        return mean, cnt

    @staticmethod
    def backward(ctx, grad_mean, _grad_cnt):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None
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
        return grad_src, None, None, None, None, None


def gnn_aggregate(src: torch.Tensor, edge_src: torch.Tensor,
                  edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                  n_dst: int, csr: Csr | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked neighbour mean on the card: (mean (n_dst, F), cnt (n_dst,)),
    the function of ``ref.segment_mean``, differentiable in ``src``; over
    ``csr`` (a :class:`Csr` on the card) where given."""
    check_cuda(src, torch.float32, "src", 2)
    return GnnAggregate.apply(src, edge_src, edge_dst, edge_mask, n_dst, csr)


def dequant_aggregate(values: torch.Tensor, scales: torch.Tensor,
                      edge_src: torch.Tensor, edge_dst: torch.Tensor,
                      edge_mask: torch.Tensor, n_dst: int,
                      csr: Csr | None = None) -> torch.Tensor:
    """Masked neighbour mean over an int8 table on the card: values
    (N_src, F) int8, scales (N_src, 1) fp32 → mean (n_dst, F) fp32,
    bit-equal to ``gnn_aggregate(dequantize_int8(values, scales), …)``
    through the port's kernels; over ``csr`` (a :class:`Csr` of the same
    kept edges on the card) where given, with no glue and no host
    sync."""
    check_cuda(values, torch.int8, "values", 2)
    check_cuda(scales, torch.float32, "scales", 2)
    n_src, f = values.shape
    if scales.shape != (n_src, 1):
        raise ValueError(f"scales {tuple(scales.shape)} for values "
                         f"{tuple(values.shape)}")
    indptr, indices, order = _launch_csr(values, edge_src, edge_dst,
                                         edge_mask, n_dst, csr)
    mean = torch.empty((n_dst, f), dtype=torch.float32, device=values.device)
    if n_dst == 0:
        return mean
    launch("dequant_aggregate", "segment_mean_csr_int8", values, scales,
           indptr, indices, order, n_dst, f, mean)
    return mean
