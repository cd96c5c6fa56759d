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
// the card stops being memory-bound.  Design where h % 4 == 0, h <= 128
// and the rows are 16-byte aligned (ld % 4 == 0, x aligned): a group of g
// lanes per row (h / 4 rounded up to a power of two; 8 at h = 32, so four
// rows a warp), each lane reading its four columns once as a float4 into
// registers; the group reduces the absmax with shuffles, and each lane
// encodes its four values from registers and stores one char4.  Other
// shapes (h = 3, h > 128, a view at an odd float) take one warp per row
// with the lanes across the columns, so a warp reads a 32-float row
// segment in one coalesced 128-byte transaction, the absmax is a shuffle
// reduction and the row is read a second time for the encode (from L1);
// both write the same bytes.  The gathered form never materialises the
// fp32 rows in device memory.
//
// Bit-exactness against the CPU reference needs the reciprocal constant as
// a multiply (0x1.020408p-7f == np.float32(1/127)), IEEE division
// (__fdiv_rn) and rintf (round half to even, like jnp.round).

#include "common.cuh"

namespace {

constexpr float kInv127 = 0x1.020408p-7f;
constexpr int kQuadThreads = 256;

__device__ __forceinline__ int8_t encode(float x, float safe) {
  const float v = fminf(fmaxf(rintf(__fdiv_rn(x, safe)), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(v));
}

// Rows of h = 4 * h4 columns (h4 <= 32), row r of x starting at float4
// r * ld4; row i is encoded by the g lanes of one group (g a power of two
// >= h4), lane c of the group holding columns 4c .. 4c + 3.  No lane
// leaves early: every lane of a warp takes part in the group's shuffles.
__global__ void __launch_bounds__(kQuadThreads)
quantize_quads_kernel(const float4* __restrict__ x,
                      const int32_t* __restrict__ rows, int64_t n, int h4,
                      int64_t ld4, int g, char4* __restrict__ q,
                      float* __restrict__ scale) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kQuadThreads
                    + threadIdx.x;
  const int64_t i = t / g;
  const int c = static_cast<int>(t % g);
  const bool on = i < n && c < h4;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (on) {
    const int64_t r = rows == nullptr ? i : static_cast<int64_t>(rows[i]);
    v = x[r * ld4 + c];
  }
  float m = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                  fmaxf(fabsf(v.z), fabsf(v.w)));
  for (int off = g / 2; off > 0; off /= 2)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off, g));

  const float s = __fmul_rn(m, kInv127);
  const float safe = s > 0.0f ? s : 1.0f;
  if (on) {
    q[i * h4 + c] = make_char4(encode(v.x, safe), encode(v.y, safe),
                               encode(v.z, safe), encode(v.w, safe));
    if (c == 0) scale[i] = s;
  }
}

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
  for (int j = lane; j < h; j += repro::kWarpSize) qr[j] = encode(xr[j], safe);
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
  const cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  if (a.h % 4 == 0 && a.h <= 128 && a.ld % 4 == 0
      && reinterpret_cast<uintptr_t>(a.x) % 16 == 0
      && reinterpret_cast<uintptr_t>(a.q) % 4 == 0) {
    const int h4 = a.h / 4;
    int g = 1;
    while (g < h4) g *= 2;
    const int64_t threads = a.n * g;
    quantize_quads_kernel<<<static_cast<unsigned int>(
                                (threads + kQuadThreads - 1) / kQuadThreads),
                            kQuadThreads, 0, st>>>(
        static_cast<const float4*>(a.x), static_cast<const int32_t*>(a.rows),
        a.n, h4, a.ld / 4, g, static_cast<char4*>(a.q),
        static_cast<float*>(a.scale));
    return static_cast<int>(cudaGetLastError());
  }
  quantize_rows_kernel<<<repro::row_blocks(a.n), repro::kThreadsPerBlock, 0,
                         st>>>(
      static_cast<const float*>(a.x), static_cast<const int32_t*>(a.rows),
      a.n, a.h, a.ld, static_cast<int8_t*>(a.q),
      static_cast<float*>(a.scale));
  return static_cast<int>(cudaGetLastError());
}
