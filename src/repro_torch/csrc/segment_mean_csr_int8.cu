// Neighbour mean-aggregation over a CSR adjacency, straight off an int8
// source table with per-row fp32 scales.
//
// Replaces the TPU kernel src/repro/kernels/gnn_aggregate.py
// dequant_aggregate -> _dequant_kernel: segment_mean_csr.cu with the
// gather reading values[r] * scales[r], so the fp32 source table never
// exists.  It takes the CSR of the kept edges, built once on the host
// where the edges are made (or, for a direct caller, by the Python
// wrapper), and the order in which to take the rows:
//
//   mean[d] = sum_{e in row d} values[indices[e]] * scales[indices[e]]
//             / max(indptr[d+1] - indptr[d], 1)
//
// Bit-equal on the card to dequantize_rows.cu followed by
// segment_mean_csr.cu: both round the same int8 * scale product once
// (__fmul_rn, never contracted into an FMA with the add), add in
// ascending edge order (__fadd_rn) and divide once (__fdiv_rn).  The
// product is not exact in fp32 in general (7 bits times 24 bits), so an
// FMA here would round differently and break that equality.  No atomics.
//
// What bounds it on the H100: bytes at most, nearly all from L2, but in
// practice the rate at which random rows come back.  Each kept edge reads
// one int32 id, one fp32 scale and one source row of f bytes.  At the
// pull chain's shape (85,185 x 32 int8 -> 59,803 rows, 2.86M kept edges)
// the table and scales are 3 MB and stay in L2, each edge costs two random
// 32-byte sectors (its row and its scale), and the compulsory bytes take
// 6.8 us.  A warp per row with a byte a lane, walking the edges one
// dependent chain of loads at a time, took 0.219 ms.
//
// Design: a group of G lanes per destination row, each lane moving 4
// int8 columns (4 fp32 chains) where f % 4 == 0 and values is 4-byte
// aligned, else one byte; G is the least power of two that covers the
// row (8 at f = 32, so a warp takes 4 rows), and wider rows are walked
// once per tile of 32 lanes.  The group reads its row's ids 32 at a time
// in one coalesced load (32 / G a lane), the next 32 while this chunk's
// rows are in flight; the lane that read id r also loads scales[r], and
// shuffles hand each (id, scale) pair to the group, so no lane waits on
// a dependent scale load an edge.  Each group issues kUnroll independent
// row loads before it adds them in edge order.  Rows are taken in the
// caller's order (the host CSR orders them by falling degree), so the
// longest chains start first and the 4 rows of a warp have near-equal
// degrees: the warp walks them in lockstep, as far as the longest.  On an
// H100 80GB HBM3 at 700 W it takes 0.113 ms at that shape
// (tools/agg_sweep.py --kernel int8 at the local edges: kUnroll 8 / 16 /
// 32 at 0.141 / 0.123 / 0.110 ms).  Shuffles under each group's own mask
// made the compiler split the warp into its groups at every shuffle
// (0.25-0.30 ms), and I2F conversions took 16-21 % longer than the PRMT
// below.
// The fp32 aggregation of the decoded table over the same CSR, one
// 128-byte row an edge, takes longer (0.157 ms): what holds this kernel
// at 6 % of its bound is not the count of requests an edge.

#include "common.cuh"

namespace {

// Row loads in flight a group, warps a block, and ids a group reads at a
// time.
constexpr int kUnroll = 32;
constexpr int kWarps = 4;
constexpr int kChunk = 32;
constexpr int kThreads = kWarps * repro::kWarpSize;
static_assert(kChunk % kUnroll == 0, "a chunk holds whole groups of loads");
constexpr unsigned kFull = 0xffffffffu;

// W int8 columns of a source row, zero-extended into a word.
template <int W>
__device__ __forceinline__ unsigned load_row(const int8_t* p) {
  if constexpr (W == 4)
    return __ldg(reinterpret_cast<const unsigned*>(p));
  else
    return __ldg(reinterpret_cast<const unsigned char*>(p));
}

// Byte i of w as the int8 it holds, exactly: the byte biased by 128 is
// placed under the exponent of 2^23 and 2^23 + 128 taken off, which is
// exact in fp32 and equals static_cast<float>(int8) bit for bit, without
// the I2F conversion (16 a clock an SM, a quarter of PRMT's rate).
template <int i>
__device__ __forceinline__ float byte_value(unsigned w) {
  return __fsub_rn(__int_as_float(static_cast<int>(__byte_perm(
                       w ^ 0x80808080u, 0x4B000000u, 0x7540u | i))),
                   8388736.0f);
}

__device__ __forceinline__ void add(float (&acc)[1], unsigned v, float s) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(byte_value<0>(v), s));
}

__device__ __forceinline__ void add(float (&acc)[4], unsigned v, float s) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(byte_value<0>(v), s));
  acc[1] = __fadd_rn(acc[1], __fmul_rn(byte_value<1>(v), s));
  acc[2] = __fadd_rn(acc[2], __fmul_rn(byte_value<2>(v), s));
  acc[3] = __fadd_rn(acc[3], __fmul_rn(byte_value<3>(v), s));
}

__device__ __forceinline__ void store(float* p, const float (&v)[1]) {
  *p = v[0];
}

__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// G: lanes a row (a power of two up to 32); W: int8 columns a lane loads
// at once (4 needs f % 4 == 0 and a 4-byte aligned values).  The groups of
// a warp walk in lockstep, as far as the longest of their rows, under
// full-warp shuffles: a shuffle under one group's mask would make the
// compiler split the warp into its groups at every shuffle.
template <int G, int W>
__global__ void __launch_bounds__(kThreads)
segment_mean_csr_int8_group_kernel(const int8_t* __restrict__ values,
                                   const float* __restrict__ scales,
                                   const int64_t* __restrict__ indptr,
                                   const int32_t* __restrict__ indices,
                                   const int32_t* __restrict__ order,
                                   int64_t n_dst, int f,
                                   float* __restrict__ mean) {
  constexpr int kIds = kChunk / G;  // ids a lane reads from each chunk
  const int64_t first = static_cast<int64_t>(blockIdx.x) * (kThreads / G)
                        + threadIdx.x / repro::kWarpSize
                              * (repro::kWarpSize / G);
  if (first >= n_dst) return;  // warp-uniform: the whole warp leaves
  const int64_t w = first + threadIdx.x % repro::kWarpSize / G;
  const bool live = w < n_dst;  // a group past the last row walks no edge
  const int g = threadIdx.x % G;
  const int64_t d = !live ? 0
                    : order == nullptr ? w : static_cast<int64_t>(order[w]);
  const int64_t beg = live ? indptr[d] : 0;
  const int len = live ? static_cast<int>(indptr[d + 1] - beg) : 0;
  const int span = static_cast<int>(
      __reduce_max_sync(kFull, static_cast<unsigned>(len)));
  const float denom = fmaxf(static_cast<float>(len), 1.0f);
  for (int col0 = 0; col0 < f; col0 += G * W) {
    const int col = col0 + g * W;
    const bool on = col < f;
    float acc[W];
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = 0.0f;
    int next[kIds];
#pragma unroll
    for (int k = 0; k < kIds; ++k) {
      const int e = g + G * k;
      next[k] = e < len ? __ldg(indices + beg + e) : 0;
    }
    for (int base = 0; base < span; base += kChunk) {
      const int left = len - base;
      const int n = left < 0 ? 0 : left < kChunk ? left : kChunk;
      const int n_warp = span - base < kChunk ? span - base : kChunk;
      int id[kIds];
      float sc[kIds];
#pragma unroll
      for (int k = 0; k < kIds; ++k) {
        id[k] = next[k];
        sc[k] = g + G * k < n ? __ldg(scales + id[k]) : 0.0f;
      }
      // the next chunk's ids, read while this chunk's rows are in flight
#pragma unroll
      for (int k = 0; k < kIds; ++k) {
        const int e = base + kChunk + g + G * k;
        next[k] = e < len ? __ldg(indices + beg + e) : 0;
      }
#pragma unroll
      for (int u0 = 0; u0 < kChunk; u0 += kUnroll) {
        if (u0 >= n_warp) break;
        unsigned v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int p = u0 + u;  // edge p of the chunk: lane p % G holds it
          const int r = __shfl_sync(kFull, id[p / G], p % G, G);
          v[u] = 0;
          if (p < n && on)
            v[u] = load_row<W>(values + static_cast<int64_t>(r) * f + col);
        }
        // the adds, in edge order, after all kUnroll loads were issued
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int p = u0 + u;
          const float s = __shfl_sync(kFull, sc[p / G], p % G, G);
          if (p < n) add(acc, v[u], s);
        }
      }
    }
    if (live && on) {
      float out[W];
#pragma unroll
      for (int j = 0; j < W; ++j) out[j] = __fdiv_rn(acc[j], denom);
      store(mean + d * f + col, out);
    }
  }
}

}  // namespace

// segment_mean_csr_int8's arguments, in the order of kernels/_build.py's
// SIGNATURES, which packs them.  values: (n_src, f) int8 with rows f bytes
// apart; scales: (n_src,) fp32; indptr: (n_dst + 1,) int64; indices:
// int32 rows of values; order: n_dst int32 rows, the order in which
// groups take them, or null for 0 .. n_dst-1; mean: (n_dst, f) fp32.
// n_dst must be > 0.
struct SegmentMeanCsrInt8Args {
  const void* values;
  const void* scales;
  const void* indptr;
  const void* indices;
  const void* order;
  int64_t n_dst;
  int f;
  void* mean;
  void* stream;
};

namespace {

template <int G, int W>
cudaError_t launch_group(const SegmentMeanCsrInt8Args& a) {
  constexpr int rows = kThreads / G;
  const unsigned int blocks =
      static_cast<unsigned int>((a.n_dst + rows - 1) / rows);
  segment_mean_csr_int8_group_kernel<G, W>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(a.stream)>>>(
          static_cast<const int8_t*>(a.values),
          static_cast<const float*>(a.scales),
          static_cast<const int64_t*>(a.indptr),
          static_cast<const int32_t*>(a.indices),
          static_cast<const int32_t*>(a.order), a.n_dst, a.f,
          static_cast<float*>(a.mean));
  return cudaGetLastError();
}

// The least group that covers a row of f columns, W a lane.
template <int W>
cudaError_t launch_width(const SegmentMeanCsrInt8Args& a) {
  const int lanes = (a.f + W - 1) / W;
  if (lanes <= 1) return launch_group<1, W>(a);
  if (lanes <= 2) return launch_group<2, W>(a);
  if (lanes <= 4) return launch_group<4, W>(a);
  if (lanes <= 8) return launch_group<8, W>(a);
  if (lanes <= 16) return launch_group<16, W>(a);
  return launch_group<32, W>(a);
}

}  // namespace

REPRO_EXPORT int segment_mean_csr_int8(const SegmentMeanCsrInt8Args* args) {
  const SegmentMeanCsrInt8Args& a = *args;
  if (a.f < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool quads = a.f % 4 == 0
                     && reinterpret_cast<uintptr_t>(a.values) % 4 == 0;
  return static_cast<int>(quads ? launch_width<4>(a) : launch_width<1>(a));
}
