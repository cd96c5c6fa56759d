// Shared helpers of the hand-written Hopper kernels.
//
// Every kernel library is built on its own (one nvcc per .cu) into a
// shared object with a plain C interface, loaded from Python with ctypes.
// Each C entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns cudaGetLastError() so that a refused
// launch surfaces in the Python wrapper instead of being lost.
//
// Built without --use_fast_math on purpose: the int8 codec must match the
// CPU reference bit for bit, which needs IEEE division and rintf.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

// One warp handles one row; a block holds kWarpsPerBlock rows.
constexpr int kWarpSize = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreadsPerBlock = kWarpSize * kWarpsPerBlock;

__device__ __forceinline__ int64_t warp_row() {
  return static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x / kWarpSize);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x % kWarpSize; }

__device__ __forceinline__ float warp_max(float v) {
  for (int off = kWarpSize / 2; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

inline unsigned int row_blocks(int64_t rows) {
  return static_cast<unsigned int>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace repro

REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
