// Top-k threshold selection in one launch: the whole bisection of the JAX
// topk_mask, from the first read of the scores to the mask.
//
// Replaces the TPU kernel src/repro/kernels/topk_mask.py _count_ge ->
// _count_kernel and the JAX topk_mask around it (topk_mask.py:58-87),
// which streams the scores through VMEM once per count and keeps the
// bisection's scalars in XLA between the 25 counts.  This kernel computes
// that function, not the Pallas body:
//
//   lo = min(s);  hi = max(s) + 1e-6
//   24 times:     mid = 0.5 * (lo + hi);  c = #(s >= mid)
//                 c > k ? lo = mid : hi = mid
//   thr = #(s >= hi) >= k ? hi : lo;   mask[i] = s[i] >= thr
//
// Every fp32 operation is an _rn intrinsic, so nvcc cannot contract or
// reorder it and the threshold is the reference's bit for bit; counts are
// integers, so their sums are exact in any order.  k <= 0 and k >= n are
// answered by the wrapper and never reach the card.
//
// Design: one persistent cooperative grid (cudaLaunchCooperativeKernel,
// never more blocks than are co-resident), the passes separated by
// cooperative_groups grid barriers.  Each block owns a contiguous slice
// of the scores and reads it from device memory once, into dynamic shared
// memory, up to its capacity (227 KB a block); the rest of its slice, if
// any, is read from device memory on every pass.  Pass 1 reduces min and
// max into per-block partials, which every block then reduces in the same
// order.  Each bisection step counts its slice in registers, reduces the
// count across the block and adds it with one integer atomicAdd into that
// step's slot of a small scratch (zeroed by the kernel itself before the
// first barrier); after the barrier every block reads the slot and takes
// the same decision.  The last pass writes the mask.
//
// What bounds it on the H100.  At the path's size (101,526 scores, 406
// KB) every score sits in shared memory after one read, so each of the 26
// passes is a few shared-memory loads per thread and the run is bound by
// its 26 grid barriers, not by bytes (n*4 + n bytes take 0.15 us).  The
// design keeps that cost low by using few blocks for a small n (one per
// kMinPerBlock scores, so the barrier has few arrivals) and by keeping the
// host out of the loop: one launch in place of 25 launches and some 75
// small tensor ops.  At 40M scores (160 MB, more than the grid's 30 MB of
// shared memory) it is bound by bytes: the part that does not fit is read
// from device memory on every pass, 16 bytes a thread per load.

#include <cooperative_groups.h>
#include <math_constants.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / repro::kWarpSize;
constexpr int kIters = 24;                  // topk_mask.py:ITERS
constexpr int kSlotInts = 32;               // kIters + 1 count slots, padded
constexpr int kMaxGrid = 1024;              // <= kThreads: a thread per partial
// int32 words of scratch: the count slots, then min and max per block
constexpr int kScratchInts = kSlotInts + 2 * kMaxGrid;
// scores per block before another block is added: few blocks for a small
// n keep the barriers cheap
constexpr int64_t kMinPerBlock = 8192;

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = repro::kWarpSize / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = repro::kWarpSize / 2; off > 0; off /= 2)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The block's (min, max) of (mn, mx), returned to every thread.
__device__ void block_min_max(float& mn, float& mx, float* red) {
  const int warp = threadIdx.x / repro::kWarpSize;
  const int lane = repro::lane_id();
  mn = warp_min(mn);
  mx = repro::warp_max(mx);
  if (lane == 0) {
    red[warp] = mn;
    red[kWarps + warp] = mx;
  }
  __syncthreads();
  mn = warp_min(lane < kWarps ? red[lane] : CUDART_INF_F);
  mx = repro::warp_max(lane < kWarps ? red[kWarps + lane] : -CUDART_INF_F);
  __syncthreads();
}

// The block's total of c, valid in thread 0.
__device__ int block_sum(int c, int* red) {
  const int warp = threadIdx.x / repro::kWarpSize;
  c = warp_sum(c);
  if (repro::lane_id() == 0) red[warp] = c;
  __syncthreads();
  if (warp == 0) c = warp_sum(repro::lane_id() < kWarps ? red[repro::lane_id()] : 0);
  return c;
}

// f(v) for every score of [a, b) in device memory; 16-byte loads when
// `vec` (the scores are 16-byte aligned, and a is a multiple of 4).
template <class F>
__device__ __forceinline__ void visit_global(const float* __restrict__ s,
                                             int64_t a, int64_t b, bool vec,
                                             F f) {
  int64_t i = a;
  if (vec) {
    const int64_t n4 = (b - a) / 4;
    const float4* s4 = reinterpret_cast<const float4*>(s + a);
    for (int64_t j = threadIdx.x; j < n4; j += kThreads) {
      const float4 v = s4[j];
      f(v.x); f(v.y); f(v.z); f(v.w);
    }
    i = a + 4 * n4;
  }
  for (i += threadIdx.x; i < b; i += kThreads) f(s[i]);
}

// f(v) for the first n scores held in shared memory.
template <class F>
__device__ __forceinline__ void visit_shared(const float* sm, int64_t n, F f) {
  const int64_t n4 = n / 4;
  const float4* s4 = reinterpret_cast<const float4*>(sm);
  for (int64_t j = threadIdx.x; j < n4; j += kThreads) {
    const float4 v = s4[j];
    f(v.x); f(v.y); f(v.z); f(v.w);
  }
  for (int64_t i = 4 * n4 + threadIdx.x; i < n; i += kThreads) f(sm[i]);
}

__global__ void __launch_bounds__(kThreads, 1)
topk_select_kernel(const float* __restrict__ scores, int64_t n, int64_t k,
                   uint8_t* __restrict__ mask, int* __restrict__ scratch,
                   int64_t per_block, int64_t cap, bool vec) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ float red_f[2 * kWarps];
  __shared__ int red_i[kWarps];
  cg::grid_group grid = cg::this_grid();

  // this block's slice [beg, end): [beg, beg + n_sm) in shared memory,
  // [beg + n_sm, end) read from device memory on every pass
  const int64_t beg = imin(static_cast<int64_t>(blockIdx.x) * per_block, n);
  const int64_t end = imin(beg + per_block, n);
  const int64_t n_sm = imin(end - beg, cap);
  const int64_t rest = beg + n_sm;
  int* slots = scratch;
  float* part_min = reinterpret_cast<float*>(scratch + kSlotInts);
  float* part_max = part_min + kMaxGrid;

  if (blockIdx.x == 0 && threadIdx.x < kIters + 1) slots[threadIdx.x] = 0;

  // pass 1: load the slice into shared memory, min and max
  float mn = CUDART_INF_F, mx = -CUDART_INF_F;
  {
    int64_t i = 0;
    if (vec) {
      const int64_t n4 = n_sm / 4;
      const float4* g4 = reinterpret_cast<const float4*>(scores + beg);
      for (int64_t j = threadIdx.x; j < n4; j += kThreads) {
        const float4 v = g4[j];
        smem4[j] = v;
        mn = fminf(fminf(mn, v.x), fminf(v.y, fminf(v.z, v.w)));
        mx = fmaxf(fmaxf(mx, v.x), fmaxf(v.y, fmaxf(v.z, v.w)));
      }
      i = 4 * n4;
    }
    for (i += threadIdx.x; i < n_sm; i += kThreads) {
      const float v = scores[beg + i];
      sm[i] = v;
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
  }
  visit_global(scores, rest, end, vec, [&](float v) {
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  });
  block_min_max(mn, mx, red_f);
  if (threadIdx.x == 0) {
    part_min[blockIdx.x] = mn;
    part_max[blockIdx.x] = mx;
  }
  grid.sync();
  // every block reduces the partials in the same order
  mn = CUDART_INF_F;
  mx = -CUDART_INF_F;
  if (threadIdx.x < gridDim.x) {
    mn = __ldcg(part_min + threadIdx.x);
    mx = __ldcg(part_max + threadIdx.x);
  }
  block_min_max(mn, mx, red_f);

  float lo = mn;
  float hi = __fadd_rn(mx, 1e-6f);
  auto count = [&](float t) {
    int c = 0;
    visit_shared(sm, n_sm, [&](float v) { c += v >= t ? 1 : 0; });
    visit_global(scores, rest, end, vec, [&](float v) { c += v >= t ? 1 : 0; });
    c = block_sum(c, red_i);
    return c;
  };
  for (int it = 0; it < kIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const int c = count(mid);
    if (threadIdx.x == 0 && c != 0) atomicAdd(slots + it, c);
    grid.sync();
    // every thread reads the step's total and takes the same decision
    if (__ldcg(slots + it) > k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  {
    const int c = count(hi);
    if (threadIdx.x == 0 && c != 0) atomicAdd(slots + kIters, c);
  }
  grid.sync();
  const float thr = __ldcg(slots + kIters) >= k ? hi : lo;

  // last pass: the mask
  {
    int64_t i = 0;
    if (vec) {
      const int64_t n4 = n_sm / 4;
      uchar4* m4 = reinterpret_cast<uchar4*>(mask + beg);
      for (int64_t j = threadIdx.x; j < n4; j += kThreads) {
        const float4 v = smem4[j];
        m4[j] = make_uchar4(v.x >= thr, v.y >= thr, v.z >= thr, v.w >= thr);
      }
      i = 4 * n4;
    }
    for (i += threadIdx.x; i < n_sm; i += kThreads) mask[beg + i] = sm[i] >= thr;
  }
  {
    int64_t i = rest;
    if (vec) {
      const int64_t n4 = (end - rest) / 4;
      const float4* g4 = reinterpret_cast<const float4*>(scores + rest);
      uchar4* m4 = reinterpret_cast<uchar4*>(mask + rest);
      for (int64_t j = threadIdx.x; j < n4; j += kThreads) {
        const float4 v = g4[j];
        m4[j] = make_uchar4(v.x >= thr, v.y >= thr, v.z >= thr, v.w >= thr);
      }
      i = rest + 4 * n4;
    }
    for (i += threadIdx.x; i < end; i += kThreads) mask[i] = scores[i] >= thr;
  }
}

// Launch limits of one device, found once: the dynamic shared memory a
// block may take and the blocks that fit on the card together at it.
struct Limits {
  int dyn_smem = 0;
  int max_grid = 0;
};

constexpr int kMaxDevices = 64;
Limits g_limits[kMaxDevices];

cudaError_t limits(Limits* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Limits& l = g_limits[dev];
  if (l.max_grid == 0) {
    int coop = 0, optin = 0, sms = 0, per_sm = 0;
    cudaFuncAttributes attr;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                      dev)) != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    if ((err = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
        cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess) return err;
    if ((err = cudaFuncGetAttributes(&attr, topk_select_kernel)) !=
        cudaSuccess) return err;
    const int dyn = (optin - static_cast<int>(attr.sharedSizeBytes)) & ~15;
    if ((err = cudaFuncSetAttribute(
             topk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             dyn)) != cudaSuccess) return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, topk_select_kernel, kThreads, dyn)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    l.dyn_smem = dyn;
    l.max_grid = per_sm * sms < kMaxGrid ? per_sm * sms : kMaxGrid;
  }
  *out = l;
  return cudaSuccess;
}

}  // namespace

// topk_select's arguments, in the order of kernels/_build.py's
// SIGNATURES, which packs them.  scores: (n,) fp32; mask: (n,) bool (one
// byte each), written in full; scratch: scratch_ints >= kScratchInts (2080)
// int32 words on the device, any contents.  Needs 0 < k < n < 2^31.
struct TopkSelectArgs {
  const void* scores;
  int64_t n;
  int64_t k;
  void* mask;
  void* scratch;
  int scratch_ints;
  void* stream;
};

REPRO_EXPORT int topk_select(const TopkSelectArgs* args) {
  int64_t n = args->n;
  int64_t k = args->k;
  if (n <= 0 || k <= 0 || k >= n || n > 0x7fffffff ||
      args->scratch_ints < kScratchInts)
    return static_cast<int>(cudaErrorInvalidValue);
  Limits l;
  cudaError_t err = limits(&l);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t grid = (n + kMinPerBlock - 1) / kMinPerBlock;
  if (grid > l.max_grid) grid = l.max_grid;
  // a multiple of 4, so every slice starts 16-byte aligned
  int64_t per_block = ((n + grid - 1) / grid + 3) / 4 * 4;
  int64_t smem = per_block * 4;
  if (smem > l.dyn_smem) smem = l.dyn_smem;
  int64_t cap = smem / 4 / 4 * 4;
  bool vec = (reinterpret_cast<uintptr_t>(args->scores) % 16 == 0) &&
             (reinterpret_cast<uintptr_t>(args->mask) % 4 == 0);
  const float* s = static_cast<const float*>(args->scores);
  uint8_t* m = static_cast<uint8_t*>(args->mask);
  int* sc = static_cast<int*>(args->scratch);
  void* kargs[] = {&s, &n, &k, &m, &sc, &per_block, &cap, &vec};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(topk_select_kernel),
      dim3(static_cast<unsigned int>(grid)), dim3(kThreads), kargs,
      static_cast<size_t>(smem), static_cast<cudaStream_t>(args->stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
