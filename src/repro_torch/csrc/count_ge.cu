// Count of the scores at or above a threshold: one step of the top-k
// threshold bisection.
//
// Replaces the TPU kernel src/repro/kernels/topk_mask.py _count_ge ->
// _count_kernel, which tiles the score vector through VMEM and carries a
// running count from one grid step to the next.  Blocks on the card run in
// no order, so nothing carries over: each block counts a grid-stride slice
// in registers, reduces it across its warps and adds it to the total with
// one integer atomicAdd.  Integer addition is exact and commutative, so
// the count is deterministic whatever order the blocks finish in.
//
//   out[0] += #{ i < n : scores[i] >= thr[0] }      (out zeroed by caller)
//
// The threshold is read from device memory, so the bisection that drives
// this kernel (repro_torch/kernels/topk_mask.py) keeps its 24 decisions on
// the card and never waits on the host.
//
// What bounds it on the H100: bytes.  One compare and one add per 4-byte
// score.  A reduction this simple would serve as well in Triton; it is
// CUDA so that the port keeps one toolchain, one loader and one launch
// counter.

#include "common.cuh"

namespace {

// Enough blocks to fill the 132 SMs several times over; the grid-stride
// loop covers the rest.
constexpr int64_t kMaxBlocks = 132 * 8;

__global__ void count_ge_kernel(const float* __restrict__ scores, int64_t n,
                                const float* __restrict__ thr,
                                int* __restrict__ out) {
  const float t = *thr;
  int c = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    c += scores[i] >= t ? 1 : 0;
  for (int off = repro::kWarpSize / 2; off > 0; off /= 2)
    c += __shfl_xor_sync(0xffffffffu, c, off);
  __shared__ int warp_counts[repro::kWarpsPerBlock];
  const int warp = threadIdx.x / repro::kWarpSize;
  if (repro::lane_id() == 0) warp_counts[warp] = c;
  __syncthreads();
  if (warp == 0) {
    c = repro::lane_id() < repro::kWarpsPerBlock ? warp_counts[repro::lane_id()]
                                                 : 0;
    for (int off = repro::kWarpSize / 2; off > 0; off /= 2)
      c += __shfl_xor_sync(0xffffffffu, c, off);
    if (repro::lane_id() == 0 && c != 0) atomicAdd(out, c);
  }
}

}  // namespace

// count_ge's arguments, in the order of kernels/_build.py's SIGNATURES,
// which packs them.  scores: (n,) fp32; thr: one fp32 on the device; out:
// one int32 on the device, zeroed by the caller.  n must be > 0.
struct CountGeArgs {
  const void* scores;
  int64_t n;
  const void* thr;
  void* out;
  void* stream;
};

REPRO_EXPORT int count_ge(const CountGeArgs* args) {
  const CountGeArgs& a = *args;
  int64_t blocks =
      (a.n + repro::kThreadsPerBlock - 1) / repro::kThreadsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  count_ge_kernel<<<static_cast<unsigned int>(blocks), repro::kThreadsPerBlock,
                    0, static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const float*>(a.scores), a.n,
      static_cast<const float*>(a.thr), static_cast<int*>(a.out));
  return static_cast<int>(cudaGetLastError());
}
