// Neighbour mean-aggregation over a CSR adjacency, straight off an int8
// source table with per-row fp32 scales.
//
// Replaces the TPU kernel src/repro/kernels/gnn_aggregate.py
// dequant_aggregate -> _dequant_kernel: segment_mean_csr.cu with the
// gather reading values[r] * scales[r], so the fp32 source table never
// exists.  The wrapper drops masked edges and builds indptr, as for the
// fp32 aggregation:
//
//   mean[d] = sum_{e in row d} values[indices[e]] * scales[indices[e]]
//             / max(indptr[d+1] - indptr[d], 1)
//
// Bit-equal on the card to dequantize_rows.cu followed by
// segment_mean_csr.cu: both round the same int8 * scale product once
// (__fmul_rn, never contracted into an FMA with the add), add in
// ascending edge order (__fadd_rn) and divide once (__fdiv_rn).  The
// product is not exact in fp32 in general (7 bits times 24 bits), so an
// FMA here would round differently and break that equality.
//
// What bounds it on the H100: bytes, as for segment_mean_csr.cu, with a
// quarter of the source-row bytes (int8 instead of fp32) plus one scale
// per edge.  Design: one warp per destination row, lanes across the
// features; the scale of each edge's source row is one broadcast load.

#include "common.cuh"

namespace {

__global__ void segment_mean_csr_int8_kernel(
    const int8_t* __restrict__ values, const float* __restrict__ scales,
    const int64_t* __restrict__ indptr, const int32_t* __restrict__ indices,
    int64_t n_dst, int f, float* __restrict__ mean) {
  const int64_t d = repro::warp_row();
  if (d >= n_dst) return;
  const int lane = repro::lane_id();
  const int64_t beg = indptr[d];
  const int64_t end = indptr[d + 1];
  const float denom = fmaxf(static_cast<float>(end - beg), 1.0f);
  for (int j = lane; j < f; j += repro::kWarpSize) {
    float acc = 0.0f;
    for (int64_t e = beg; e < end; ++e) {
      const int64_t r = indices[e];
      acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(values[r * f + j]),
                                     scales[r]));
    }
    mean[d * f + j] = __fdiv_rn(acc, denom);
  }
}

}  // namespace

// segment_mean_csr_int8's arguments, in the order of kernels/_build.py's
// SIGNATURES, which packs them.  values: (n_src, f) int8; scales: (n_src,)
// fp32; indptr: (n_dst + 1,) int64; indices: int32 rows of values; mean:
// (n_dst, f) fp32.  n_dst must be > 0.
struct SegmentMeanCsrInt8Args {
  const void* values;
  const void* scales;
  const void* indptr;
  const void* indices;
  int64_t n_dst;
  int f;
  void* mean;
  void* stream;
};

REPRO_EXPORT int segment_mean_csr_int8(const SegmentMeanCsrInt8Args* args) {
  const SegmentMeanCsrInt8Args& a = *args;
  segment_mean_csr_int8_kernel<<<repro::row_blocks(a.n_dst),
                                 repro::kThreadsPerBlock, 0,
                                 static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const int8_t*>(a.values),
      static_cast<const float*>(a.scales),
      static_cast<const int64_t*>(a.indptr),
      static_cast<const int32_t*>(a.indices), a.n_dst, a.f,
      static_cast<float*>(a.mean));
  return static_cast<int>(cudaGetLastError());
}
