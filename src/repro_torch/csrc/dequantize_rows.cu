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
// four bytes out, per element.  Design without rows (the codec's decode)
// and in set mode (the push apply): each thread moves 4 values, one
// 32-bit load in and one 16-byte store out, with the row's scale (and in
// set mode its output row, dropped outside [0, R)) from a cached load;
// at h = 32 a warp covers 4 rows, and each destination row of a set is
// one whole 128-byte line, so the scattered stores stay full lines.  At
// h = 32, on an H100 80GB HBM3 at 700 W (chip_smoke.py), the decode
// reaches 86 % of its bound and the set 83 % (3.6 us for 59,803 rows,
// where a warp a row took 7.6 us).  Both
// need h % 4 == 0, q 4-byte and out 16-byte aligned (and fewer than 2^32
// quads), which a view that starts some rows into a block keeps where
// h % 4 == 0; other shapes (h = 3, q at an odd byte, an out view off a
// 16-byte boundary) take the warp-per-row kernel below, which writes the
// same values: one warp per row with lanes across the columns, so stores
// of a destination row are coalesced even though the rows themselves
// are scattered, the per-row scale one broadcast load.  Add mode takes
// the row ids sorted stably by the wrapper, with each sorted position's
// value row in `order`: one warp per run of equal ids adds the run's
// rows in ascending value-row order onto the old table row, the
// correctly rounded adds of a sequential index_add_, with no atomics.
// Every mode is bit-exact and the same launch after launch.

#include "common.cuh"

namespace {

constexpr int kQuadThreads = 256;

__device__ __forceinline__ float4 decode_quad(char4 v, float s) {
  return make_float4(__fmul_rn(static_cast<float>(v.x), s),
                     __fmul_rn(static_cast<float>(v.y), s),
                     __fmul_rn(static_cast<float>(v.z), s),
                     __fmul_rn(static_cast<float>(v.w), s));
}

// out[e] = q[e] * scale[e / h] for the quads e = 4i .. 4i + 3 of a flat
// (n, h) block with h % 4 == 0, so a quad never straddles two rows.
__global__ void __launch_bounds__(kQuadThreads)
dequantize_quads_kernel(const char4* __restrict__ q,
                        const float* __restrict__ scale,
                        float4* __restrict__ out, unsigned int quads,
                        unsigned int quads_per_row) {
  const unsigned int i = blockIdx.x * kQuadThreads + threadIdx.x;
  if (i >= quads) return;
  out[i] = decode_quad(q[i], __ldg(scale + i / quads_per_row));
}

// Set mode: the quads of value row i go to row rows[i] of the (R, h)
// table, a row id outside [0, R) dropping the row.
__global__ void __launch_bounds__(kQuadThreads)
scatter_quads_kernel(const char4* __restrict__ q,
                     const float* __restrict__ scale,
                     const int32_t* __restrict__ rows,
                     float4* __restrict__ out, unsigned int quads,
                     unsigned int quads_per_row, int64_t R) {
  const unsigned int i = blockIdx.x * kQuadThreads + threadIdx.x;
  if (i >= quads) return;
  const unsigned int row = i / quads_per_row;
  const int64_t r = __ldg(rows + row);
  if (r < 0 || r >= R) return;  // dropped, like mode="drop"
  out[r * quads_per_row + (i - row * quads_per_row)] =
      decode_quad(q[i], __ldg(scale + row));
}

__global__ void dequantize_rows_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scale,
                                       float* __restrict__ out,
                                       const int32_t* __restrict__ rows,
                                       int64_t n, int h, int64_t R) {
  const int64_t i = repro::warp_row();
  if (i >= n) return;
  const int64_t r = rows == nullptr ? i : static_cast<int64_t>(rows[i]);
  if (r < 0 || r >= R) return;  // dropped, like mode="drop"
  const int lane = repro::lane_id();
  const float s = scale[i];
  const int8_t* qi = q + i * h;
  float* o = out + r * h;
  for (int j = lane; j < h; j += repro::kWarpSize)
    o[j] = __fmul_rn(static_cast<float>(qi[j]), s);
}

// Add mode: rows sorted stably (duplicates together, in ascending value
// row), order[p] the value row of sorted position p.  The warp of a run's
// first position adds every value row of the run, in order, onto the old
// table row.
__global__ void dequantize_add_sorted_kernel(const int8_t* __restrict__ q,
                                             const float* __restrict__ scale,
                                             float* __restrict__ out,
                                             const int32_t* __restrict__ rows,
                                             const int64_t* __restrict__ order,
                                             int64_t n, int h, int64_t R) {
  const int64_t p = repro::warp_row();
  if (p >= n) return;
  const int64_t r = rows[p];
  if ((p > 0 && rows[p - 1] == r) || r < 0 || r >= R) return;
  const int lane = repro::lane_id();
  float* o = out + r * h;
  for (int j = lane; j < h; j += repro::kWarpSize) {
    float acc = o[j];
    for (int64_t k = p; k < n && rows[k] == r; ++k) {
      const int64_t i = order[k];
      acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(q[i * h + j]),
                                     scale[i]));
    }
    o[j] = acc;
  }
}

}  // namespace

// dequantize_rows's arguments, in the order of kernels/_build.py's
// SIGNATURES, which packs them.  q: (n, h) int8; scale: (n,) fp32; out:
// (R, h) fp32 table (R == n when rows is null); rows: n int32 row ids or
// null (sorted stably with accumulate); order: with accumulate, the n
// int64 value rows of the sorted positions, else null.  n must be > 0.
struct DequantizeRowsArgs {
  const void* q;
  const void* scale;
  void* out;
  const void* rows;
  const void* order;
  int64_t n;
  int h;
  int64_t R;
  int accumulate;
  void* stream;
};

REPRO_EXPORT int dequantize_rows(const DequantizeRowsArgs* args) {
  const DequantizeRowsArgs& a = *args;
  const cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const int64_t quads = a.n * a.h / 4;
  const bool quad_shape = a.h % 4 == 0
                          && quads <= 0xffffffffLL - kQuadThreads
                          && reinterpret_cast<uintptr_t>(a.q) % 4 == 0
                          && reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  const unsigned int quad_blocks =
      static_cast<unsigned int>((quads + kQuadThreads - 1) / kQuadThreads);
  if (quad_shape && a.rows == nullptr) {
    dequantize_quads_kernel<<<quad_blocks, kQuadThreads, 0, st>>>(
        static_cast<const char4*>(a.q), static_cast<const float*>(a.scale),
        static_cast<float4*>(a.out), static_cast<unsigned int>(quads),
        static_cast<unsigned int>(a.h / 4));
    return static_cast<int>(cudaGetLastError());
  }
  if (quad_shape && !a.accumulate) {
    scatter_quads_kernel<<<quad_blocks, kQuadThreads, 0, st>>>(
        static_cast<const char4*>(a.q), static_cast<const float*>(a.scale),
        static_cast<const int32_t*>(a.rows), static_cast<float4*>(a.out),
        static_cast<unsigned int>(quads), static_cast<unsigned int>(a.h / 4),
        a.R);
    return static_cast<int>(cudaGetLastError());
  }
  if (a.accumulate) {
    if (a.rows == nullptr || a.order == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    dequantize_add_sorted_kernel<<<repro::row_blocks(a.n),
                                   repro::kThreadsPerBlock, 0, st>>>(
        static_cast<const int8_t*>(a.q), static_cast<const float*>(a.scale),
        static_cast<float*>(a.out), static_cast<const int32_t*>(a.rows),
        static_cast<const int64_t*>(a.order), a.n, a.h, a.R);
    return static_cast<int>(cudaGetLastError());
  }
  dequantize_rows_kernel<<<repro::row_blocks(a.n), repro::kThreadsPerBlock, 0,
                           st>>>(
      static_cast<const int8_t*>(a.q), static_cast<const float*>(a.scale),
      static_cast<float*>(a.out), static_cast<const int32_t*>(a.rows), a.n,
      a.h, a.R);
  return static_cast<int>(cudaGetLastError());
}
