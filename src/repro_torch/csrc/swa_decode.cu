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
// operations to bytes, so tensor cores buy nothing at G = 3 and the design
// is about keeping enough warps, and bytes, in flight on every SM:
//
// * T is split across the S blocks of a thread-block cluster (grid
//   (S, Hkv * ceil(G / kHeads), B)); block r takes a contiguous range of
//   ceil(T / S) slots rounded up to a tile.  One block holds up to kHeads
//   query heads of its kv head, so each K and V row is read once.
// * Each warp of a block walks every n_warps-th tile of 32 slots of that
//   range through its own ring of kStages tiles in shared memory, filled
//   with 16-byte cp.async copies kStages - 1 tiles ahead (plain loads when
//   a row is not 16-byte aligned in device memory).  A shared row is padded
//   to an odd number of 16-byte chunks, so eight lanes reading eight rows
//   hit eight different bank groups.  The K row of a masked slot is copied
//   too (its score is replaced by -1e30); the V row of every in-range slot
//   is needed, since a fully masked row averages V.
// * For q.k a lane owns one slot of the tile and reads its K row from
//   shared memory against q, held scaled in shared memory.  For p.v a V
//   row's 16-byte chunks are spread over kRowLanes lanes, and the warp's
//   32 / kRowLanes groups of lanes take different slots of the tile; the
//   groups' sums are added by shuffles, in a fixed order, once at the end.
//   Each warp keeps an online-softmax state (max, sum, accumulator) per
//   query head; the positions and validity of its next tile are loaded
//   one tile ahead.  A warp's compute per tile, not its copies, bounds
//   it, so a ring of two stages is enough and leaves room for more warps
//   on each SM.
// * At the end each block merges its warps' states in warp order into one
//   state in its shared memory; cluster.sync(); then the blocks merge the
//   cluster's states through distributed shared memory in rank order
//   (every peer's loads issued before any is used), each block writing a
//   share of the outputs; a second cluster.sync() keeps every block alive
//   until its peers have read it.  No workspace, no second launch, and the
//   same bytes on every launch.
//
// A block whose range holds no slot keeps max -1e30 and sum 0, so it adds
// nothing; an in-range slot that is masked has score -1e30 and, when every
// slot is masked, weight 1 like the others, as in decode_attention.  No
// fast math: expf and IEEE division.

#include "common.cuh"

#include <cstring>

#include <cooperative_groups.h>
#include <cuda_bf16.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;         // slots per tile: one per lane for q.k
constexpr int kStages = 2;        // tiles in each warp's ring
constexpr int kMaxWarps = 4;
constexpr int kMaxThreads = kMaxWarps * repro::kWarpSize;
constexpr int kMaxCluster = 16;   // 8 is portable; 16 is allowed on sm_90
constexpr int kSmemPerBlock = 232448;  // 227 KB, the H100's per-block limit
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

// 16 bytes of a shared row as floats: 4 fp32 or 8 bf16 values.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* out) {
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
  __device__ __forceinline__ static void load(const unsigned char* p,
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* kv_pos;
  const uint8_t* kv_valid;
  const int32_t* q_pos;
  void* out;
  int t_len, hkv, groups, dh, window;
  float scale;
  int chunk;      // slots per block of a cluster, a multiple of kTile
  int row_bytes;  // shared row stride: an odd number of 16-byte chunks
  int n_chunks;   // 16-byte chunks of a row that q.k reads
  int chunk_shift;  // log2(n_chunks) when it is a power of two, else -1
  int vec;        // K and V rows 16-byte aligned in device memory
};

template <typename T, int kDims, int kHeads>
__global__ void __launch_bounds__(kMaxThreads)
swa_decode_kernel(const Params p) {
  constexpr int kWidth = kDims * repro::kWarpSize;  // dh rounded up to 32
  constexpr int kN = Chunk<T>::kN;
  constexpr int kChunks = kWidth / kN;  // 16-byte chunks of the widest row
  // p.v: a row's chunks are spread over kRowLanes lanes (kCols chunks
  // each), and the warp's kGroups groups of them take different slots
  constexpr int kRowLanes = kChunks >= 32 ? 32
                            : kChunks > 8 ? 16
                            : kChunks > 4 ? 8
                            : kChunks > 2 ? 4 : kChunks;
  constexpr int kGroups = repro::kWarpSize / kRowLanes;
  constexpr int kCols = (kChunks + kRowLanes - 1) / kRowLanes;
  constexpr int kAcc = kCols * kN;  // accumulated values per lane and head
  __shared__ __align__(16) float q_s[kHeads][kWidth];
  __shared__ float p_s[kMaxWarps][kHeads][kTile];
  extern __shared__ __align__(16) unsigned char ring[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int head_chunks = (p.groups + kHeads - 1) / kHeads;
  const int h = blockIdx.y / head_chunks;
  const int g0 = (blockIdx.y % head_chunks) * kHeads;
  const int n_heads = min(kHeads, p.groups - g0);
  const int b = blockIdx.z;
  const int warp = threadIdx.x / repro::kWarpSize;
  const int n_warps = blockDim.x / repro::kWarpSize;
  const int lane = repro::lane_id();
  const int dh = p.dh;
  const int64_t n_q_heads = static_cast<int64_t>(p.hkv) * p.groups;
  const int64_t q_off =
      (static_cast<int64_t>(b) * n_q_heads
       + static_cast<int64_t>(h) * p.groups + g0) * dh;

  const T* q = static_cast<const T*>(p.q);
  for (int i = threadIdx.x; i < kHeads * kWidth; i += blockDim.x) {
    const int g = i / kWidth;
    const int d = i % kWidth;
    const bool used = g < n_heads && d < dh;
    q_s[g][d] = used ? __fmul_rn(to_float(q[q_off + g * dh + d]), p.scale)
                     : 0.0f;
  }

  const int lo = rank * p.chunk;
  const int hi = min(p.t_len, lo + p.chunk);
  const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
  const int mine =
      n_tiles > warp ? (n_tiles - warp + n_warps - 1) / n_warps : 0;
  const int tile_bytes = kTile * p.row_bytes;
  unsigned char* my_ring = ring + warp * kStages * 2 * tile_bytes;
  if (!p.vec) {
    // the plain copies write dh values of a row; q.k reads whole 16-byte
    // chunks, so the rest of each chunk must be zero, not stale
    for (int i = lane * 16; i < kStages * 2 * tile_bytes; i += 16 * 32)
      *reinterpret_cast<uint4*>(my_ring + i) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(p.hkv) * dh;  // slot to slot
  const int64_t kv_off = static_cast<int64_t>(b) * p.t_len * stride
                         + static_cast<int64_t>(h) * dh;
  const T* k_bh = static_cast<const T*>(p.k) + kv_off;
  const T* v_bh = static_cast<const T*>(p.v) + kv_off;
  const int32_t* pos_b = p.kv_pos + static_cast<int64_t>(b) * p.t_len;
  const uint8_t* valid_b = p.kv_valid + static_cast<int64_t>(b) * p.t_len;
  const int qp = p.q_pos[b];

  // the warp's i-th tile: slots [t0, t0 + n_t) into stage i % kStages
  auto tile_start = [&](int i) { return lo + (warp + i * n_warps) * kTile; };
  auto issue = [&](int i) {
    if (i < mine) {
      const int t0 = tile_start(i);
      const int n_t = min(kTile, hi - t0);
      unsigned char* kt = my_ring + (i % kStages) * 2 * tile_bytes;
      unsigned char* vt = kt + tile_bytes;
      if (p.vec) {
        const int per_row = p.n_chunks;
        for (int c = lane; c < n_t * per_row; c += repro::kWarpSize) {
          const int r =
              p.chunk_shift >= 0 ? c >> p.chunk_shift : c / per_row;
          const int j = c - r * per_row;
          const int64_t off = static_cast<int64_t>(t0 + r) * stride
                              + j * (16 / static_cast<int>(sizeof(T)));
          cp_async16(kt + r * p.row_bytes + j * 16, k_bh + off);
          cp_async16(vt + r * p.row_bytes + j * 16, v_bh + off);
        }
      } else {
        for (int c = lane; c < n_t * dh; c += repro::kWarpSize) {
          const int r = c / dh;
          const int d = c % dh;
          const int64_t off = static_cast<int64_t>(t0 + r) * stride + d;
          reinterpret_cast<T*>(kt + r * p.row_bytes)[d] = k_bh[off];
          reinterpret_cast<T*>(vt + r * p.row_bytes)[d] = v_bh[off];
        }
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

  float m[kHeads], l[kHeads], acc[kHeads][kAcc];
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    m[g] = kMasked;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[g][e] = 0.0f;
  }

  const int group = lane / kRowLanes;  // p.v: the lane's slots and chunks
  const int col = lane % kRowLanes;

  // positions and validity of the lane's slot in the warp's next tile
  int pos_next = 0;
  uint8_t valid_next = 0;
  auto load_keep = [&](int i) {
    const int t = i < mine ? tile_start(i) + lane : hi;
    pos_next = t < hi ? pos_b[t] : 0;
    valid_next = t < hi ? valid_b[t] : 0;
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  load_keep(0);
  for (int i = 0; i < mine; ++i) {
    const int pos_t = pos_next;
    const uint8_t valid_t = valid_next;
    load_keep(i + 1);
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();  // this lane's copies of tile i landed
    __syncwarp();                  // and every other lane's

    const int t0 = tile_start(i);
    const int n_t = min(kTile, hi - t0);
    const bool in_range = lane < n_t;
    const bool keep = in_range && valid_t != 0 && pos_t <= qp
                      && (p.window < 0 || pos_t > qp - p.window);
    const unsigned char* kt = my_ring + (i % kStages) * 2 * tile_bytes;
    const unsigned char* vt = kt + tile_bytes;

    float s[kHeads];
#pragma unroll
    for (int g = 0; g < kHeads; ++g) s[g] = kMasked;
    if (keep) {
      const unsigned char* k_row = kt + lane * p.row_bytes;
      float dot[kHeads];
#pragma unroll
      for (int g = 0; g < kHeads; ++g) dot[g] = 0.0f;
      // unrolled with a guard, so the shared loads of several chunks are
      // in flight at once
#pragma unroll 8
      for (int c = 0; c < kChunks; ++c) {
        if (c < p.n_chunks) {
          float kf[kN];
          Chunk<T>::load(k_row + c * 16, kf);
#pragma unroll
          for (int g = 0; g < kHeads; ++g) {
#pragma unroll
            for (int i4 = 0; i4 < kN; i4 += 4) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(&q_s[g][c * kN + i4]);
              dot[g] += qv.x * kf[i4];
              dot[g] += qv.y * kf[i4 + 1];
              dot[g] += qv.z * kf[i4 + 2];
              dot[g] += qv.w * kf[i4 + 3];
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kHeads; ++g) s[g] = dot[g];
    }
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      const float m_new = fmaxf(m[g], repro::warp_max(s[g]));
      const float pr = in_range ? expf(s[g] - m_new) : 0.0f;
      const float corr = expf(m[g] - m_new);
      l[g] = l[g] * corr + warp_sum(pr);
      m[g] = m_new;
      p_s[warp][g][lane] = pr;
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[g][e] *= corr;
    }
    __syncwarp();
#pragma unroll 8
    for (int j0 = 0; j0 < kTile; j0 += kGroups) {
      const int j = j0 + group;
      if (j < n_t) {
        float pj[kHeads];
#pragma unroll
        for (int g = 0; g < kHeads; ++g) pj[g] = p_s[warp][g][j];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          const int c = col + cc * kRowLanes;
          if (c < p.n_chunks) {
            float vf[kN];
            Chunk<T>::load(vt + j * p.row_bytes + c * 16, vf);
#pragma unroll
            for (int e = 0; e < kN; ++e)
#pragma unroll
              for (int g = 0; g < kHeads; ++g)
                acc[g][cc * kN + e] += pj[g] * vf[e];
          }
        }
      }
    }
    __syncwarp();  // the stage is refilled by the next iteration's issue
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: reuse it for states

  // each warp's state, then the block's: m[kHeads], l[kHeads],
  // acc[kHeads][dh]; the block's merges its warps in warp order
  const int st_size = kHeads * (2 + dh);
  float* states = reinterpret_cast<float*>(ring);
  float* block_st = states + n_warps * st_size;
  float* st = states + warp * st_size;
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      st[g] = m[g];
      st[kHeads + g] = l[g];
    }
  }
  // the groups' sums of each column, added in a fixed order
#pragma unroll
  for (int g = 0; g < kHeads; ++g)
#pragma unroll
    for (int e = 0; e < kAcc; ++e) {
      float a = acc[g][e];
      for (int off = kRowLanes; off < repro::kWarpSize; off *= 2)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      const int d = (col + (e / kN) * kRowLanes) * kN + e % kN;
      if (group == 0 && d < dh) st[2 * kHeads + g * dh + d] = a;
    }
  __syncthreads();
  for (int i = threadIdx.x; i < n_heads * dh; i += blockDim.x) {
    const int g = i / dh;
    const int d = i % dh;
    float mx = kMasked;
    for (int w = 0; w < n_warps; ++w) mx = fmaxf(mx, states[w * st_size + g]);
    float den = 0.0f, num = 0.0f;
    for (int w = 0; w < n_warps; ++w) {
      const float* sw = states + w * st_size;
      const float c = expf(sw[g] - mx);
      den += sw[kHeads + g] * c;
      num += sw[2 * kHeads + g * dh + d] * c;
    }
    block_st[2 * kHeads + g * dh + d] = num;
    if (d == 0) {
      block_st[g] = mx;
      block_st[kHeads + g] = den;
    }
  }
  cluster.sync();  // every block's state is visible to the cluster

  // the cluster's merge, in rank order; each block writes a share of the
  // outputs, and every peer's loads are issued before any is used
  T* out = static_cast<T*>(p.out);
  for (int i = rank * blockDim.x + threadIdx.x; i < n_heads * dh;
       i += n_ranks * blockDim.x) {
    const int g = i / dh;
    const int d = i % dh;
    float m_r[kMaxCluster], l_r[kMaxCluster], a_r[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < n_ranks) {
        const float* peer = cluster.map_shared_rank(block_st, r);
        m_r[r] = peer[g];
        l_r[r] = peer[kHeads + g];
        a_r[r] = peer[2 * kHeads + g * dh + d];
      }
    }
    float mx = kMasked;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n_ranks) mx = fmaxf(mx, m_r[r]);
    float den = 0.0f, num = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < n_ranks) {
        const float c = expf(m_r[r] - mx);
        den += l_r[r] * c;
        num += a_r[r] * c;
      }
    }
    out[q_off + static_cast<int64_t>(g) * dh + d] = from_float<T>(num / den);
  }
  cluster.sync();  // no block exits while a peer may still read it
}

// A variant's attributes, read and set once (the first launch of that
// variant): room for dynamic shared memory up to the block's limit, and
// clusters of up to 16 blocks.
struct Variant {
  cudaError_t err;
  cudaFuncAttributes attr;
};

template <typename T, int kDims, int kHeads>
Variant configure() {
  const auto kernel = swa_decode_kernel<T, kDims, kHeads>;
  Variant v{};
  v.err = cudaFuncGetAttributes(&v.attr, kernel);
  if (v.err != cudaSuccess) return v;
  v.err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemPerBlock - static_cast<int>(v.attr.sharedSizeBytes));
  if (v.err != cudaSuccess) return v;
  v.err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return v;
}

// Shared memory a block of `warps` warps needs beyond its static arrays.
template <int kHeads>
size_t dynamic_smem(const Params& p, int warps) {
  const size_t ring = static_cast<size_t>(warps) * kStages * 2 * kTile
                      * p.row_bytes;
  const size_t states = static_cast<size_t>(warps + 1) * kHeads
                        * (2 + p.dh) * sizeof(float);
  return ring > states ? ring : states;
}

struct Launch {
  dim3 grid;
  int cluster, warps;
  cudaStream_t stream;
};

template <typename T, int kDims, int kHeads>
cudaError_t launch_one(const Params& p, Launch ln, int* info) {
  const auto kernel = swa_decode_kernel<T, kDims, kHeads>;
  static const Variant variant = configure<T, kDims, kHeads>();
  if (variant.err != cudaSuccess) return variant.err;
  const cudaFuncAttributes& attr = variant.attr;
  const size_t room = kSmemPerBlock - attr.sharedSizeBytes;
  int warps = ln.warps;
  while (warps > 1 && dynamic_smem<kHeads>(p, warps) > room) warps /= 2;
  const size_t smem = dynamic_smem<kHeads>(p, warps);
  if (smem > room) return cudaErrorInvalidValue;
  if (info != nullptr) {  // describe the variant instead of launching
    info[0] = attr.numRegs;
    info[1] = static_cast<int>(attr.sharedSizeBytes);
    info[2] = static_cast<int>(attr.localSizeBytes);
    info[3] = warps;
    info[4] = static_cast<int>(smem);
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = ln.grid;
  cfg.blockDim = dim3(warps * repro::kWarpSize);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = ln.stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = ln.cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

template <typename T, int kHeads>
cudaError_t launch_dims(const Params& p, Launch ln, int* info) {
  if (p.dh <= 32) return launch_one<T, 1, kHeads>(p, ln, info);
  if (p.dh <= 64) return launch_one<T, 2, kHeads>(p, ln, info);
  if (p.dh <= 128) return launch_one<T, 4, kHeads>(p, ln, info);
  return launch_one<T, 8, kHeads>(p, ln, info);
}

// Query heads a block holds: G itself up to 4 (smollm-360m's 3), else 8
// (hymba-1.5b's 5, command-r-35b's 8) or 12 (starcoder2-15b's and
// nemotron-4-340b's 12); more than 12 take more blocks.
constexpr int heads_per_block(int groups) {
  return groups <= 4 ? (groups < 2 ? 2 : groups) : groups <= 8 ? 8 : 12;
}

template <typename T>
cudaError_t launch_typed(const Params& p, Launch ln, int* info) {
  switch (heads_per_block(p.groups)) {
    case 2:
      return launch_dims<T, 2>(p, ln, info);
    case 3:
      return launch_dims<T, 3>(p, ln, info);
    case 4:
      return launch_dims<T, 4>(p, ln, info);
    case 8:
      return launch_dims<T, 8>(p, ln, info);
    default:
      return launch_dims<T, 12>(p, ln, info);
  }
}

}  // namespace

// swa_decode's arguments, in the order of kernels/_build.py's SIGNATURES,
// which packs them.  q: (B, hkv*groups, dh); k, v: (B, t_len, hkv, dh), all
// fp32 or all bf16 (bf16 != 0); kv_pos: (B, t_len) int32; kv_valid: (B,
// t_len) bool; q_pos: (B,) int32; window < 0 means none; out like q.
// B, t_len > 0, 1 <= dh <= 256; cluster in [1, 16] blocks share T; warps in
// [1, 4] per block (fewer when a wide row's ring would not fit in shared
// memory).
struct SwaDecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* kv_pos;
  const void* kv_valid;
  const void* q_pos;
  int B;
  int t_len;
  int hkv;
  int groups;
  int dh;
  int window;
  int bf16;
  int cluster;
  int warps;
  float scale;
  void* out;
  void* stream;
};

namespace {

// Launches the variant for `a`, or with info describes it instead.
cudaError_t run(const SwaDecodeArgs& a, int* info) {
  if (a.cluster < 1 || a.cluster > kMaxCluster || a.warps < 1
      || a.warps > kMaxWarps)
    return cudaErrorInvalidValue;
  const int head_chunks =
      (a.groups + heads_per_block(a.groups) - 1) / heads_per_block(a.groups);
  if (a.B > 65535 || static_cast<int64_t>(a.hkv) * head_chunks > 65535)
    return cudaErrorInvalidValue;  // the grid's y and z limits
  const int elem = a.bf16 ? 2 : 4;
  const int row = a.dh * elem;
  const int chunks = (row + 15) / 16;
  const bool vec = row % 16 == 0
                   && reinterpret_cast<uintptr_t>(a.k) % 16 == 0
                   && reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  const int per_block = (a.t_len + a.cluster - 1) / a.cluster;
  Params p{a.q, a.k, a.v, static_cast<const int32_t*>(a.kv_pos),
           static_cast<const uint8_t*>(a.kv_valid),
           static_cast<const int32_t*>(a.q_pos), a.out, a.t_len, a.hkv,
           a.groups, a.dh, a.window, a.scale,
           (per_block + kTile - 1) / kTile * kTile,
           (chunks % 2 ? chunks : chunks + 1) * 16, chunks,
           (chunks & (chunks - 1)) == 0 ? __builtin_ctz(chunks) : -1,
           vec ? 1 : 0};
  const Launch ln{dim3(a.cluster, a.hkv * head_chunks, a.B), a.cluster,
                  a.warps, static_cast<cudaStream_t>(a.stream)};
  if (a.bf16) return launch_typed<__nv_bfloat16>(p, ln, info);
  return launch_typed<float>(p, ln, info);
}

}  // namespace

REPRO_EXPORT int swa_decode(const SwaDecodeArgs* args) {
  const cudaError_t err = run(*args, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The variant swa_decode would launch for (bf16, dh, groups, warps):
// info[0..4] = registers per thread, static shared bytes, local (spill)
// bytes per thread, warps per block, dynamic shared bytes.  Launches
// nothing.
REPRO_EXPORT int swa_decode_info(int bf16, int dh, int groups, int warps,
                                 int* info) {
  SwaDecodeArgs a{};
  a.B = a.t_len = a.hkv = a.cluster = 1;
  a.groups = groups;
  a.dh = dh;
  a.window = -1;
  a.bf16 = bf16;
  a.warps = warps;
  a.scale = 1.0f;
  return static_cast<int>(run(a, info));
}
