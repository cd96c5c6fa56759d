// Sliding-window GQA decode attention for one query token per sequence.
//
// Replaces the TPU kernel src/repro/kernels/swa_attention.py
// swa_attention_decode -> _kernel, and computes what the function on the
// serving path computes, src/repro/models/layers.py decode_attention:
//
//   s[g, t] = (q[g] * scale) . k[t]              (fp32, scale = 1/sqrt(dh))
//   keep(t) = valid[t] && pos[t] <= q_pos
//             && (window < 0 || pos[t] > q_pos - window)
//   s[g, t] = keep(t) ? s[g, t] : -1e30           (finite: a fully masked
//                                                  row averages V, never NaN)
//   out[g]  = softmax_t(s[g]) . v                  (fp32, cast to q's type)
//
// for the G query heads that share kv head h.  q is (B, H, dh), k and v are
// (B, T, Hkv, dh) ring buffers, kv_pos / kv_valid are (B, T), q_pos is (B,).
//
// What bounds it on the H100: bytes.  Every K and V element of the cache is
// read once for about 2*G fp32 operations, far below the card's ratio of
// operations to bytes.  Design (a simple one; see PERF.md for its share of
// the bound): one block per (kv head, sequence, chunk of up to kHeads query
// heads), its kWarps warps splitting T into tiles of 32 slots.  For q.k a
// lane owns one slot and reads its K row in 16-byte loads when the rows are
// aligned, against q held scaled in shared memory; for p.v the lanes span
// dh and the tile's probabilities come from shared memory.  Each warp keeps
// an online-softmax state (max, sum, accumulator) per query head, and the
// warps' states merge in shared memory at the end, so no memory grows with
// T.  The Pallas kernel instead holds the whole window in VMEM and divides
// after the p.v product; both differ from decode_attention by rounding only.
// No fast math: expf and IEEE division.  At B = 8 and Hkv = 5 the grid has
// only 40 blocks for 132 SMs; a split of T across blocks is later work.

#include "common.cuh"

#include <cstring>

#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * repro::kWarpSize;
constexpr int kHeads = 4;        // query heads of one kv head per block
constexpr int kMaxDim = 256;     // widest head: up to 8 dims per lane
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of a row as floats: 4 fp32 or 8 bf16 values.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const unsigned int w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 pair;
      memcpy(&pair, &w[i], sizeof(pair));
      const float2 f = __bfloat1622float2(pair);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = repro::kWarpSize / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int kDimsPerLane, bool kVec>
__global__ void __launch_bounds__(kThreads)
swa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int32_t* __restrict__ kv_pos,
                  const uint8_t* __restrict__ kv_valid,
                  const int32_t* __restrict__ q_pos, int t_len, int hkv,
                  int groups, int dh, int window, float scale,
                  T* __restrict__ out) {
  __shared__ float q_s[kHeads][kMaxDim];
  __shared__ float p_s[kWarps][kHeads][repro::kWarpSize];
  __shared__ float m_s[kWarps][kHeads];
  __shared__ float l_s[kWarps][kHeads];
  __shared__ float acc_s[kWarps][kHeads][kMaxDim];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g0 = blockIdx.z * kHeads;
  const int n_heads = min(kHeads, groups - g0);
  const int warp = threadIdx.x / repro::kWarpSize;
  const int lane = repro::lane_id();
  const int64_t n_q_heads = static_cast<int64_t>(hkv) * groups;
  const int64_t q_off =
      (static_cast<int64_t>(b) * n_q_heads + static_cast<int64_t>(h) * groups
       + g0) * dh;

  for (int i = threadIdx.x; i < kHeads * kMaxDim; i += kThreads) {
    const int g = i / kMaxDim;
    const int d = i % kMaxDim;
    const bool used = g < n_heads && d < dh;
    q_s[g][d] = used ? __fmul_rn(to_float(q[q_off + g * dh + d]), scale)
                     : 0.0f;
  }
  __syncthreads();

  const int qp = q_pos[b];
  const int64_t stride = static_cast<int64_t>(hkv) * dh;  // slot to slot
  const int64_t kv_off = static_cast<int64_t>(b) * t_len * stride
                         + static_cast<int64_t>(h) * dh;
  const T* k_bh = k + kv_off;
  const T* v_bh = v + kv_off;
  const int32_t* pos_b = kv_pos + static_cast<int64_t>(b) * t_len;
  const uint8_t* valid_b = kv_valid + static_cast<int64_t>(b) * t_len;

  float m[kHeads], l[kHeads], acc[kHeads][kDimsPerLane];
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    m[g] = kMasked;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) acc[g][e] = 0.0f;
  }

  for (int t0 = warp * repro::kWarpSize; t0 < t_len;
       t0 += kWarps * repro::kWarpSize) {
    const int t = t0 + lane;
    const bool in_range = t < t_len;
    bool keep = false;
    if (in_range) {
      const int p = pos_b[t];
      keep = valid_b[t] != 0 && p <= qp && (window < 0 || p > qp - window);
    }
    float s[kHeads];
#pragma unroll
    for (int g = 0; g < kHeads; ++g) s[g] = kMasked;
    if (keep) {
      const T* k_t = k_bh + static_cast<int64_t>(t) * stride;
      float dot[kHeads];
#pragma unroll
      for (int g = 0; g < kHeads; ++g) dot[g] = 0.0f;
      if constexpr (kVec) {
        for (int d = 0; d < dh; d += Chunk<T>::kN) {
          float kf[Chunk<T>::kN];
          Chunk<T>::load(k_t + d, kf);
#pragma unroll
          for (int i = 0; i < Chunk<T>::kN; ++i)
#pragma unroll
            for (int g = 0; g < kHeads; ++g) dot[g] += q_s[g][d + i] * kf[i];
        }
      } else {
        for (int d = 0; d < dh; ++d) {
          const float kf = to_float(k_t[d]);
#pragma unroll
          for (int g = 0; g < kHeads; ++g) dot[g] += q_s[g][d] * kf;
        }
      }
#pragma unroll
      for (int g = 0; g < kHeads; ++g) s[g] = dot[g];
    }
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      const float m_new = fmaxf(m[g], repro::warp_max(s[g]));
      const float p = in_range ? expf(s[g] - m_new) : 0.0f;
      const float corr = expf(m[g] - m_new);
      l[g] = l[g] * corr + warp_sum(p);
      m[g] = m_new;
      p_s[warp][g][lane] = p;
#pragma unroll
      for (int e = 0; e < kDimsPerLane; ++e) acc[g][e] *= corr;
    }
    __syncwarp();
    const int n_t = min(repro::kWarpSize, t_len - t0);
    for (int j = 0; j < n_t; ++j) {
      const T* v_t = v_bh + static_cast<int64_t>(t0 + j) * stride;
      float pj[kHeads];
#pragma unroll
      for (int g = 0; g < kHeads; ++g) pj[g] = p_s[warp][g][j];
#pragma unroll
      for (int e = 0; e < kDimsPerLane; ++e) {
        const int d = lane + repro::kWarpSize * e;
        if (d < dh) {
          const float vf = to_float(v_t[d]);
#pragma unroll
          for (int g = 0; g < kHeads; ++g) acc[g][e] += pj[g] * vf;
        }
      }
    }
    __syncwarp();
  }

  // merge the warps' online-softmax states
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < kHeads; ++g)
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) {
      const int d = lane + repro::kWarpSize * e;
      if (d < dh) acc_s[warp][g][d] = acc[g][e];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < n_heads * dh; i += kThreads) {
    const int g = i / dh;
    const int d = i % dh;
    float mx = kMasked;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    float den = 0.0f, num = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w][g] - mx);
      den += l_s[w][g] * c;
      num += acc_s[w][g][d] * c;
    }
    out[q_off + static_cast<int64_t>(g) * dh + d] = from_float<T>(num / den);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* kv_pos;
  const void* kv_valid;
  const void* q_pos;
  int t_len, hkv, groups, dh, window;
  float scale;
  void* out;
};

template <typename T, int kDimsPerLane, bool kVec>
void launch_one(const Args& a, dim3 grid, cudaStream_t stream) {
  swa_decode_kernel<T, kDimsPerLane, kVec><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int32_t*>(a.kv_pos),
      static_cast<const uint8_t*>(a.kv_valid),
      static_cast<const int32_t*>(a.q_pos), a.t_len, a.hkv, a.groups, a.dh,
      a.window, a.scale, static_cast<T*>(a.out));
}

template <typename T, int kDimsPerLane>
void launch_dims(const Args& a, bool vec, dim3 grid, cudaStream_t stream) {
  if (vec)
    launch_one<T, kDimsPerLane, true>(a, grid, stream);
  else
    launch_one<T, kDimsPerLane, false>(a, grid, stream);
}

template <typename T>
void launch_typed(const Args& a, bool vec, dim3 grid, cudaStream_t stream) {
  if (a.dh <= 32)
    launch_dims<T, 1>(a, vec, grid, stream);
  else if (a.dh <= 64)
    launch_dims<T, 2>(a, vec, grid, stream);
  else if (a.dh <= 128)
    launch_dims<T, 4>(a, vec, grid, stream);
  else
    launch_dims<T, 8>(a, vec, grid, stream);
}

}  // namespace

// q: (B, hkv*groups, dh); k, v: (B, t_len, hkv, dh), all fp32 or all bf16
// (bf16 != 0); kv_pos: (B, t_len) int32; kv_valid: (B, t_len) bool;
// q_pos: (B,) int32; window < 0 means none; out like q.  B, t_len > 0,
// 1 <= dh <= 256.
REPRO_EXPORT int swa_decode(const void* q, const void* k, const void* v,
                            const void* kv_pos, const void* kv_valid,
                            const void* q_pos, int B, int t_len, int hkv,
                            int groups, int dh, int window, int bf16,
                            float scale, void* out, void* stream) {
  const dim3 grid(hkv, B, (groups + kHeads - 1) / kHeads);
  const int elem = bf16 ? 2 : 4;
  const bool vec = (dh * elem) % 16 == 0
                   && reinterpret_cast<uintptr_t>(k) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, kv_pos, kv_valid, q_pos, t_len, hkv, groups, dh,
               window, scale, out};
  if (bf16)
    launch_typed<__nv_bfloat16>(a, vec, grid, st);
  else
    launch_typed<float>(a, vec, grid, st);
  return static_cast<int>(cudaGetLastError());
}
