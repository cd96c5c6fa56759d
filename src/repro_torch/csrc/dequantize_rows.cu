// Per-row int8 decode, optionally fused with a scatter into a table.
//
// Replaces two TPU kernels of the JAX package:
//   src/repro/kernels/quantize.py        dequantize_padded -> _dequantize_kernel
//   src/repro/kernels/exchange_fused.py  _dequant_scatter_padded -> _make_scatter_kernel
// With rows == nullptr it writes out[i] = q[i] * scale[i] for i < n; with
// rows it writes (or, with accumulate, adds into) out[rows[i]], which is
// the push apply into the embedding server's resident table, in place.
// A row id outside [0, R) is dropped, like the JAX scatter's mode="drop".
//
// What bounds it on the H100: bytes.  One int8 byte and one multiply in,
// four bytes out, per element.  Design: one warp per row with lanes across
// the columns, so stores of a destination row are coalesced even though
// the rows themselves are scattered; the per-row scale is one broadcast
// load.  Set mode with unique rows is a plain store and bit-exact.  Add
// mode uses atomicAdd so duplicate rows are safe; their order is not
// fixed, so duplicates are held to a tolerance and unique rows stay exact
// (one correctly rounded add each).

#include "common.cuh"

namespace {

__global__ void dequantize_rows_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scale,
                                       float* __restrict__ out,
                                       const int32_t* __restrict__ rows,
                                       int64_t n, int h, int64_t R,
                                       int accumulate) {
  const int64_t i = repro::warp_row();
  if (i >= n) return;
  const int64_t r = rows == nullptr ? i : static_cast<int64_t>(rows[i]);
  if (r < 0 || r >= R) return;  // dropped, like mode="drop"
  const int lane = repro::lane_id();
  const float s = scale[i];
  const int8_t* qi = q + i * h;
  float* o = out + r * h;
  for (int j = lane; j < h; j += repro::kWarpSize) {
    const float v = __fmul_rn(static_cast<float>(qi[j]), s);
    if (accumulate)
      atomicAdd(o + j, v);
    else
      o[j] = v;
  }
}

}  // namespace

// q: (n, h) int8; scale: (n,) fp32; out: (R, h) fp32 table (R == n when
// rows is null); rows: n int32 row ids or null.  n must be > 0.
REPRO_EXPORT int dequantize_rows(const void* q, const void* scale, void* out,
                                 const void* rows, int64_t n, int h,
                                 int64_t R, int accumulate, void* stream) {
  dequantize_rows_kernel<<<repro::row_blocks(n), repro::kThreadsPerBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<float*>(out), static_cast<const int32_t*>(rows), n, h, R,
      accumulate);
  return static_cast<int>(cudaGetLastError());
}
