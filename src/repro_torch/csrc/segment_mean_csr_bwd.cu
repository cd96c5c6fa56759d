// Gradient of the neighbour mean-aggregation, as a deterministic gather
// over the transposed adjacency.
//
// Not a TPU kernel: the JAX package differentiates its aggregation (the
// model's _segment_mean, src/repro/models/gnn.py) through XLA's
// segment_sum and has no Pallas backward.  This is the backward of
// segment_mean_csr.cu (which replaces src/repro/kernels/gnn_aggregate.py
// gnn_aggregate -> _kernel), so training on the card keeps both
// directions of the aggregation in hand-written code.
//
//   grad_src[s] = sum over the kept edges e of source s, in ascending
//                 edge order, of grad_mean[dst(e)] / max(cnt[dst(e)], 1)
//
// The transposed CSR (t_indptr over the sources, t_dst the destination of
// each kept edge, grouped by source in ascending edge order) is built on
// the host with the training block (repro_torch/kernels/gnn_aggregate.py
// csr_arrays), or for a direct caller by the forward's glue
// (transpose_csr); both give the same bytes.
// Each term is the quotient JAX's transpose of `summed / max(cnt, 1)`
// forms (__fdiv_rn, not a multiply by a reciprocal), and the sum starts
// at +0.0 and adds the terms one by one in edge order with __fadd_rn:
// the same additions, in the same order, as the plain version's
// index_add_ on the CPU, so the result is bit-equal to it and does not
// depend on scheduling.  A source row with no edge is written as zero.
//
// What bounds it on the H100: bytes.  Each kept edge reads one int32
// destination and one row of f floats (mostly from L2: the rows repeat)
// and adds it.  Design, in two launches from one entry point.  First the
// quotients grad_mean[d] / max(cnt[d], 1), once per destination element:
// n_dst * f divisions, not one per edge (with a division per edge the
// gather took 0.244 ms on an H100 at 2.86M edges of 32 floats, with the
// table 0.134 ms).  Then one warp per source row, lanes across the
// features, sums its rows of the quotient table.  The lanes load 32 of
// the row's destinations at a time and pass them round with shuffles, so
// each term is one coalesced row read.  The adds must stay in edge order
// but the reads need not: a chunk issues its 32 reads (a partial one 8
// at a time) before its adds, so a source with a thousand edges or more
// (a hub of the power-law graph, which sets the tail) keeps 32 reads in
// flight.  Every grad_src element is written once: no atomics, no
// zeroing launch.

#include "common.cuh"

namespace {

constexpr int kChunk = repro::kWarpSize;   // edges whose ids a warp holds

// quotient[d] = grad_mean[d] / max(cnt[d], 1): one warp per row of
// grad_mean, lanes across the features.
__global__ void segment_mean_csr_bwd_quotient_kernel(
    const float* __restrict__ grad_mean, const float* __restrict__ cnt,
    int64_t n_dst, int f, float* __restrict__ quotient) {
  const int64_t d = repro::warp_row();
  if (d >= n_dst) return;
  const float den = fmaxf(cnt[d], 1.0f);
  for (int j = repro::lane_id(); j < f; j += repro::kWarpSize)
    quotient[d * f + j] = __fdiv_rn(grad_mean[d * f + j], den);
}

// acc plus the terms of edges i0 .. i0+N-1 of the chunk the warp holds
// (lane i holds edge i's destination), those below m only, added in
// order after all N row reads have been issued.
template <int N>
__device__ __forceinline__ float add_terms(float acc,
                                           const float* __restrict__ quotient,
                                           int d_lane, int i0, int m, int f,
                                           int j) {
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int d = __shfl_sync(0xffffffffu, d_lane, i0 + i);
    v[i] = i0 + i < m && j < f
               ? quotient[static_cast<int64_t>(d) * f + j] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i0 + i < m) acc = __fadd_rn(acc, v[i]);
  return acc;
}

__global__ void segment_mean_csr_bwd_kernel(
    const float* __restrict__ quotient, const int64_t* __restrict__ t_indptr,
    const int32_t* __restrict__ t_dst, int64_t n_src, int f,
    float* __restrict__ grad_src) {
  const int64_t s = repro::warp_row();
  if (s >= n_src) return;
  const int lane = repro::lane_id();
  const int64_t beg = t_indptr[s];
  const int64_t end = t_indptr[s + 1];
  for (int j0 = 0; j0 < f; j0 += repro::kWarpSize) {
    const int j = j0 + lane;
    float acc = 0.0f;
    for (int64_t e0 = beg; e0 < end; e0 += kChunk) {
      const int d_lane = e0 + lane < end ? t_dst[e0 + lane] : 0;
      const int m = static_cast<int>(end - e0 < kChunk ? end - e0 : kChunk);
      if (m == kChunk) {
        acc = add_terms<kChunk>(acc, quotient, d_lane, 0, m, f, j);
      } else {
        for (int i0 = 0; i0 < m; i0 += 8)
          acc = add_terms<8>(acc, quotient, d_lane, i0, m, f, j);
      }
    }
    if (j < f) grad_src[s * f + j] = acc;
  }
}

}  // namespace

// segment_mean_csr_bwd's arguments, in the order of kernels/_build.py's
// SIGNATURES, which packs them.  grad_mean: (n_dst, f) fp32; t_indptr:
// (n_src + 1,) int64; t_dst: int32 rows of grad_mean, grouped by source in
// ascending edge order; cnt: (n_dst,) fp32; quotient: (n_dst, f) fp32
// scratch, any contents; grad_src: (n_src, f) fp32, written in full.
// n_src must be > 0.  Two launches on the stream: the quotients, then the
// gather.
struct SegmentMeanCsrBwdArgs {
  const void* grad_mean;
  const void* t_indptr;
  const void* t_dst;
  const void* cnt;
  int64_t n_dst;
  int64_t n_src;
  int f;
  void* quotient;
  void* grad_src;
  void* stream;
};

REPRO_EXPORT int segment_mean_csr_bwd(const SegmentMeanCsrBwdArgs* args) {
  const SegmentMeanCsrBwdArgs& a = *args;
  const cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  float* q = static_cast<float*>(a.quotient);
  if (a.n_dst > 0) {
    segment_mean_csr_bwd_quotient_kernel<<<repro::row_blocks(a.n_dst),
                                           repro::kThreadsPerBlock, 0, st>>>(
        static_cast<const float*>(a.grad_mean),
        static_cast<const float*>(a.cnt), a.n_dst, a.f, q);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  segment_mean_csr_bwd_kernel<<<repro::row_blocks(a.n_src),
                                repro::kThreadsPerBlock, 0, st>>>(
      q, static_cast<const int64_t*>(a.t_indptr),
      static_cast<const int32_t*>(a.t_dst), a.n_src, a.f,
      static_cast<float*>(a.grad_src));
  return static_cast<int>(cudaGetLastError());
}
