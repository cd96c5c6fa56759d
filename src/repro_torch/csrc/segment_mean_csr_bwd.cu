// Gradient of the neighbour mean-aggregation over a CSR adjacency.
//
// Not a TPU kernel: the JAX package differentiates its aggregation (the
// model's _segment_mean, src/repro/models/gnn.py) through XLA's
// segment_sum and has no Pallas backward.  This is the backward of
// segment_mean_csr.cu (which replaces src/repro/kernels/gnn_aggregate.py
// gnn_aggregate -> _kernel), so training on the card keeps both
// directions of the aggregation in hand-written code.
//
//   grad_src[indices[e]] += grad_mean[d] / max(cnt[d], 1)
//       for every kept edge e of destination row d;  grad_src zeroed.
//
// The quotient is the one JAX's transpose of `summed / max(cnt, 1)` forms
// (division, not a multiply by a reciprocal), so each term is bit-equal to
// the reference's; only the order of the sums differs.
//
// What bounds it on the H100: bytes.  Each kept edge reads one int32 index
// and adds one row of f floats into grad_src, a handful of operations per
// byte.  Design: one warp per destination row with the lanes across the
// features: the row's quotient is formed once per lane and added into each
// source row with one coalesced warp-wide atomicAdd per edge.  Source rows
// shared by several destinations meet in the atomics, whose order is not
// fixed, so the result (and training on the card) is not bit-reproducible
// run to run; it is held to the plain version within 1e-6 of each row's
// summed term magnitudes.  A deterministic design (a transposed CSR with
// one warp per source row) is later work.

#include "common.cuh"

namespace {

__global__ void segment_mean_csr_bwd_kernel(
    const float* __restrict__ grad_mean, const int64_t* __restrict__ indptr,
    const int32_t* __restrict__ indices, const float* __restrict__ cnt,
    int64_t n_dst, int f, float* __restrict__ grad_src) {
  const int64_t d = repro::warp_row();
  if (d >= n_dst) return;
  const int lane = repro::lane_id();
  const int64_t beg = indptr[d];
  const int64_t end = indptr[d + 1];
  if (beg == end) return;
  const float denom = fmaxf(cnt[d], 1.0f);
  for (int j = lane; j < f; j += repro::kWarpSize) {
    const float g = __fdiv_rn(grad_mean[d * f + j], denom);
    for (int64_t e = beg; e < end; ++e)
      atomicAdd(grad_src + static_cast<int64_t>(indices[e]) * f + j, g);
  }
}

}  // namespace

// grad_mean: (n_dst, f) fp32; indptr: (n_dst + 1,) int64; indices: int32
// rows of grad_src; cnt: (n_dst,) fp32; grad_src: (n_src, f) fp32, zeroed
// by the caller.  n_dst must be > 0.
REPRO_EXPORT int segment_mean_csr_bwd(const void* grad_mean,
                                      const void* indptr,
                                      const void* indices, const void* cnt,
                                      int64_t n_dst, int f, void* grad_src,
                                      void* stream) {
  segment_mean_csr_bwd_kernel<<<repro::row_blocks(n_dst),
                                repro::kThreadsPerBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grad_mean),
      static_cast<const int64_t*>(indptr),
      static_cast<const int32_t*>(indices), static_cast<const float*>(cnt),
      n_dst, f, static_cast<float*>(grad_src));
  return static_cast<int>(cudaGetLastError());
}
