// Neighbour mean-aggregation over a CSR adjacency.
//
// Replaces the TPU kernel src/repro/kernels/gnn_aggregate.py
// gnn_aggregate -> _kernel (ELL masked mean, count clamped >= 1, isolated
// rows exactly 0).  The port serves the edge-list form the GNN layers use
// (the JAX model's _segment_mean, src/repro/models/gnn.py): the Python
// wrapper drops masked edges and builds indptr, so a destination row d
// owns edges indptr[d] .. indptr[d+1]-1 and no row is truncated (the ELL
// form cuts rows past max_deg).
//
//   mean[d] = sum_{e in row d} src[indices[e]] / max(cnt_d, 1)
//   cnt[d]  = indptr[d+1] - indptr[d]
//
// What bounds it on the H100: bytes.  Each edge reads one int32 index and
// one source row of f floats for f adds, so it sits far below the card's
// ratio of operations to bytes; the source rows are read irregularly, and
// rows shared by several destinations are served from L2.  Design: one
// warp per destination row with the lanes across the features, so each
// edge's source row is one coalesced load and the index is a broadcast.
// The sum runs in ascending edge order in a register with no float
// atomics, so the result is deterministic and follows the order of the
// CPU reference's sequential segment sum.

#include "common.cuh"

namespace {

__global__ void segment_mean_csr_kernel(const float* __restrict__ src,
                                        const int64_t* __restrict__ indptr,
                                        const int32_t* __restrict__ indices,
                                        int64_t n_dst, int f,
                                        float* __restrict__ mean,
                                        float* __restrict__ cnt) {
  const int64_t d = repro::warp_row();
  if (d >= n_dst) return;
  const int lane = repro::lane_id();
  const int64_t beg = indptr[d];
  const int64_t end = indptr[d + 1];
  const float c = static_cast<float>(end - beg);
  const float denom = fmaxf(c, 1.0f);
  for (int j = lane; j < f; j += repro::kWarpSize) {
    float acc = 0.0f;
    for (int64_t e = beg; e < end; ++e)
      acc = __fadd_rn(acc, src[static_cast<int64_t>(indices[e]) * f + j]);
    mean[d * f + j] = __fdiv_rn(acc, denom);
  }
  if (lane == 0) cnt[d] = c;
}

}  // namespace

// segment_mean_csr's arguments, in the order of kernels/_build.py's
// SIGNATURES, which packs them.  src: (n_src, f) fp32; indptr: (n_dst + 1,)
// int64; indices: int32 rows of src; mean: (n_dst, f) fp32; cnt: (n_dst,)
// fp32.  n_dst must be > 0.
struct SegmentMeanCsrArgs {
  const void* src;
  const void* indptr;
  const void* indices;
  int64_t n_dst;
  int f;
  void* mean;
  void* cnt;
  void* stream;
};

REPRO_EXPORT int segment_mean_csr(const SegmentMeanCsrArgs* args) {
  const SegmentMeanCsrArgs& a = *args;
  segment_mean_csr_kernel<<<repro::row_blocks(a.n_dst),
                            repro::kThreadsPerBlock, 0,
                            static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const float*>(a.src), static_cast<const int64_t*>(a.indptr),
      static_cast<const int32_t*>(a.indices), a.n_dst, a.f,
      static_cast<float*>(a.mean), static_cast<float*>(a.cnt));
  return static_cast<int>(cudaGetLastError());
}
