// Neighbour mean-aggregation over a CSR adjacency.
//
// Replaces the TPU kernel src/repro/kernels/gnn_aggregate.py
// gnn_aggregate -> _kernel (ELL masked mean, count clamped >= 1, isolated
// rows exactly 0).  The port serves the edge-list form the GNN layers use
// (the JAX model's _segment_mean, src/repro/models/gnn.py) as a CSR of the
// kept edges, built once on the host where the edges are made (or, for a
// direct caller, by the Python wrapper): a destination row d owns edges
// indptr[d] .. indptr[d+1]-1 and no row is truncated (the ELL form cuts
// rows past max_deg).
//
//   mean[d] = sum_{e in row d} src[indices[e]] / max(cnt_d, 1)
//   cnt[d]  = indptr[d+1] - indptr[d]
//
// Every column's sum runs in ascending edge order in one fp32 chain
// (__fadd_rn, then one __fdiv_rn; nothing is contracted into an FMA and
// nothing is added with atomics), so the result is deterministic and
// bit-equal to the CPU reference's sequential segment sum, and
// segment_mean_csr_int8.cu stays bit-equal to the codec's decode followed
// by this kernel.
//
// What bounds it on the H100: bytes, most of them from L2.  Each kept edge
// reads one int32 id and one source row of f floats for f adds.  At the
// training path's layer-1 shape (2.74M kept edges, f = 96) the row reads
// are about 1 GB, and the 23 MB table fits in the 50 MB L2.  A warp that
// walks a row's edges one dependent pair of loads at a time (the id, then
// the row) keeps one load in flight and reached 2.2 TB/s: latency, not
// bytes, set its time.  Design: one warp per destination row.  The warp
// reads 32 edge ids in one coalesced load (the next 32 while this chunk's
// rows are in flight) and broadcasts them with shuffles, then issues
// kUnroll independent row loads before it adds them in edge order, so
// kUnroll rows a warp are in flight.  Each lane owns its columns for the
// whole walk (16-byte loads of 4 columns where f % 4 == 0 and src is
// 16-byte aligned, else single floats), so one walk over the edges serves
// 32*K*W columns: all of them up to f = 128 (256 with 16-byte loads), and
// wider rows are walked once per tile of that width.  Rows may be taken
// in an order the caller gives (the host CSR orders them by falling
// degree), so the longest serial chains start first instead of setting
// the kernel's tail.  At that shape, on an H100 80GB HBM3 at 700 W,
// kUnroll = 16 with kWarps = 4 and rows by falling degree reads rows at
// 5.5-6.3 TB/s (0.17-0.19 ms); 8 at 4.3, and without the order 16 loses
// its gain to the heaviest rows (tools/agg_sweep.py, which rebuilds this
// file with other constants).  16 holds 127 registers a thread (16 warps
// an SM, against 32 at 8: the same bytes in flight), the most the
// register file allows, and the rate still rose there: a warp's round
// trips (one per kUnroll edges, one per 32 ids) bound it, not a ceiling
// of L2's rate.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load(float (&v)[1], const float* p) {
  v[0] = __ldg(p);
}

__device__ __forceinline__ void load(float (&v)[4], const float* p) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void store(float* p, const float (&v)[1]) {
  *p = v[0];
}

__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Row loads in flight a lane, and warps a block.  A lane that holds 8
// columns (f > 128 with 16-byte loads) keeps half as many rows in flight:
// 16 rows of 8 floats would not fit its registers.
constexpr int kUnroll = 16;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * repro::kWarpSize;
// at least 16 warps an SM, so a thread holds at most 128 registers
constexpr int kMinBlocks = 16 / kWarps;

// K: column groups per lane; W: floats per load (4 needs f % 4 == 0 and a
// 16-byte aligned src).
template <int K, int W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
segment_mean_csr_kernel(const float* __restrict__ src,
                        const int64_t* __restrict__ indptr,
                        const int32_t* __restrict__ indices,
                        const int32_t* __restrict__ order, int64_t n_dst,
                        int f, float* __restrict__ mean,
                        float* __restrict__ cnt) {
  constexpr int U = K * W <= 4 ? kUnroll : kUnroll / 2;
  static_assert(32 % U == 0, "a chunk of 32 ids holds whole groups of U");
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps
                    + threadIdx.x / 32;
  if (w >= n_dst) return;  // warp-uniform: the whole warp leaves together
  const int lane = repro::lane_id();
  const int64_t d = order == nullptr ? w : static_cast<int64_t>(order[w]);
  const int64_t beg = indptr[d];
  const int64_t end = indptr[d + 1];
  const float c = static_cast<float>(end - beg);
  const float denom = fmaxf(c, 1.0f);
  constexpr int kTile = 32 * K * W;
  for (int col0 = 0; col0 < f; col0 += kTile) {
    int col[K];
    bool on[K];
    float acc[K][W];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      col[k] = col0 + (lane + 32 * k) * W;
      on[k] = col[k] < f;
#pragma unroll
      for (int j = 0; j < W; ++j) acc[k][j] = 0.0f;
    }
    int next = beg + lane < end ? indices[beg + lane] : 0;
    for (int64_t base = beg; base < end; base += 32) {
      const int64_t left = end - base;
      const int n = left < 32 ? static_cast<int>(left) : 32;
      const int my = next;
      // the next chunk's ids, read while this chunk's rows are in flight
      const int64_t ahead = base + 32 + lane;
      next = ahead < end ? indices[ahead] : 0;
      for (int u0 = 0; u0 < n; u0 += U) {
        float v[U][K][W];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t r = __shfl_sync(kFull, my, u0 + u);
          const float* row = src + r * f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int j = 0; j < W; ++j) v[u][k][j] = 0.0f;
            if (u0 + u < n && on[k]) load(v[u][k], row + col[k]);
          }
        }
        // the adds, in edge order, after all U loads were issued
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u0 + u < n) {
#pragma unroll
            for (int k = 0; k < K; ++k)
#pragma unroll
              for (int j = 0; j < W; ++j)
                acc[k][j] = __fadd_rn(acc[k][j], v[u][k][j]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!on[k]) continue;
      float out[W];
#pragma unroll
      for (int j = 0; j < W; ++j) out[j] = __fdiv_rn(acc[k][j], denom);
      store(mean + d * f + col[k], out);
    }
  }
  if (lane == 0) cnt[d] = c;
}

}  // namespace

// segment_mean_csr's arguments, in the order of kernels/_build.py's
// SIGNATURES, which packs them.  src: (n_src, f) fp32; indptr: (n_dst + 1,)
// int64; indices: int32 rows of src; order: n_dst int32 rows, the order in
// which warps take them, or null for 0 .. n_dst-1; mean: (n_dst, f) fp32;
// cnt: (n_dst,) fp32.  n_dst must be > 0.
struct SegmentMeanCsrArgs {
  const void* src;
  const void* indptr;
  const void* indices;
  const void* order;
  int64_t n_dst;
  int f;
  void* mean;
  void* cnt;
  void* stream;
};

namespace {

template <int K, int W>
cudaError_t launch_variant(const SegmentMeanCsrArgs& a) {
  const unsigned int blocks =
      static_cast<unsigned int>((a.n_dst + kWarps - 1) / kWarps);
  segment_mean_csr_kernel<K, W>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(a.stream)>>>(
          static_cast<const float*>(a.src),
          static_cast<const int64_t*>(a.indptr),
          static_cast<const int32_t*>(a.indices),
          static_cast<const int32_t*>(a.order), a.n_dst, a.f,
          static_cast<float*>(a.mean), static_cast<float*>(a.cnt));
  return cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int segment_mean_csr(const SegmentMeanCsrArgs* args) {
  const SegmentMeanCsrArgs& a = *args;
  if (a.f < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool quads = a.f % 4 == 0
                     && reinterpret_cast<uintptr_t>(a.src) % 16 == 0;
  cudaError_t err;
  if (quads)
    err = a.f <= 128 ? launch_variant<1, 4>(a) : launch_variant<2, 4>(a);
  else
    err = launch_variant<4, 1>(a);
  return static_cast<int>(err);
}
