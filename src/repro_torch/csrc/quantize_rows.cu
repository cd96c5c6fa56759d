// Per-row symmetric int8 encode, optionally fused with a row gather.
//
// Replaces two TPU kernels of the JAX package:
//   src/repro/kernels/quantize.py        quantize_padded -> _quantize_kernel
//   src/repro/kernels/exchange_fused.py  _gather_quantize_padded -> _gather_quantize_kernel
// With rows == nullptr it encodes rows 0..n-1 of x; otherwise it encodes
// x[rows[i]], which is the pull response gathered straight out of the
// embedding server's resident table.
//
//   scale_i = absmax_j |x_ij| * fp32(1/127)       (0 for an all-zero row)
//   q_ij    = clip(rint(x_ij / safe_i), -127, 127) safe_i = scale_i or 1
//
// What bounds it on the H100: bytes.  Each element is read once (4 B) and
// written once as int8 (1 B) with one fp32 scale per row; there are a
// handful of float operations per byte, far below the ~20 FLOP/B at which
// the card stops being memory-bound.  Design: one warp per row with the
// lanes across the columns, so a warp reads a 32-float row segment in one
// coalesced 128-byte transaction and the absmax is a register-only shuffle
// reduction; the row is read a second time for the encode, which hits L1.
// The gathered form never materialises the fp32 rows in device memory.
//
// Bit-exactness against the CPU reference needs the reciprocal constant as
// a multiply (0x1.020408p-7f == np.float32(1/127)), IEEE division
// (__fdiv_rn) and rintf (round half to even, like jnp.round).

#include "common.cuh"

namespace {

constexpr float kInv127 = 0x1.020408p-7f;

__global__ void quantize_rows_kernel(const float* __restrict__ x,
                                     const int32_t* __restrict__ rows,
                                     int64_t n, int h, int64_t ld,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ scale) {
  const int64_t i = repro::warp_row();
  if (i >= n) return;  // warp-uniform: the whole warp leaves together
  const int lane = repro::lane_id();
  const int64_t r = rows == nullptr ? i : static_cast<int64_t>(rows[i]);
  const float* xr = x + r * ld;

  float m = 0.0f;
  for (int j = lane; j < h; j += repro::kWarpSize) m = fmaxf(m, fabsf(xr[j]));
  m = repro::warp_max(m);

  const float s = __fmul_rn(m, kInv127);
  const float safe = s > 0.0f ? s : 1.0f;
  int8_t* qr = q + i * h;
  for (int j = lane; j < h; j += repro::kWarpSize) {
    float v = rintf(__fdiv_rn(xr[j], safe));
    v = fminf(fmaxf(v, -127.0f), 127.0f);
    qr[j] = static_cast<int8_t>(static_cast<int>(v));
  }
  if (lane == 0) scale[i] = s;
}

}  // namespace

// quantize_rows's arguments, in the order of kernels/_build.py's
// SIGNATURES, which packs them.  x: rows of `ld` floats (ld >= h); rows: n
// int32 row ids into x, or null; q: (n, h) int8; scale: (n,) fp32.  n must
// be > 0.
struct QuantizeRowsArgs {
  const void* x;
  const void* rows;
  int64_t n;
  int h;
  int64_t ld;
  void* q;
  void* scale;
  void* stream;
};

REPRO_EXPORT int quantize_rows(const QuantizeRowsArgs* args) {
  const QuantizeRowsArgs& a = *args;
  quantize_rows_kernel<<<repro::row_blocks(a.n), repro::kThreadsPerBlock, 0,
                         static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const float*>(a.x), static_cast<const int32_t*>(a.rows),
      a.n, a.h, a.ld, static_cast<int8_t*>(a.q),
      static_cast<float*>(a.scale));
  return static_cast<int>(cudaGetLastError());
}
