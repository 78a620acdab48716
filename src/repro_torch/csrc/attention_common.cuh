// Device helpers shared by the decode (paged and dense) and flash forward
// kernels.  Each has its own grid, addressing and entry point; what they
// share is the inner loop of a flash-style walk over 32-key tiles on the CUDA cores, the
// loop the ragged kernel (ragged_paged_attention.cu, kept as measured in
// its own source) runs too:
//
//   * TileStage: one K/V tile staged through registers.  `fetch` issues
//     every 16-byte global load of a tile (zeros where the kernel's row map
//     says there is no key); `stash` widens them to f32 in shared memory.
//     A kernel fetches tile n+1 before it computes on tile n, so the walk
//     pays about one memory latency per tile.
//   * Rows: the online-softmax state (m, l, acc) of the kR query rows one
//     warp owns.  In `update` lane j scores key j of the tile against each
//     of the warp's rows (a full dot product over D from shared memory),
//     the warp reduces max and sum with shuffles, and lane j accumulates
//     output dims j + 32 c.  The finite NEG_INF makes a row with no visible
//     key end with l == 0, which `out` turns into a zero output, as the
//     plain versions' nan_to_num does.
//   * decode_combine_kernel: the second pass of the split-KV decodes.
//
// Shared-memory layout of a staged tile: K rows padded to d + 4 floats (so
// lane j's float4 reads of row j spread over the banks), V rows unpadded.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileN = 32;  // key positions per tile
constexpr float kNegInf = -0.7f * 3.402823466e38f;
constexpr unsigned kFull = 0xffffffffu;

// 16 raw bytes (one register-staged load) widened to f32 in shared memory
__device__ __forceinline__ void widen16(const uint4& raw, float* dst,
                                        float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&raw);
}

__device__ __forceinline__ void widen16(const uint4& raw, float* dst,
                                        __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// 16-byte load of T values, widened to f32 in shared memory
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  widen16(*reinterpret_cast<const uint4*>(src), dst, T());
}

template <typename T>
__device__ __forceinline__ void zero16(float* dst) {
#pragma unroll
  for (int i = 0; i < int(16 / sizeof(T)); ++i) dst[i] = 0.f;
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Shared floats of a block: kBlockM staged query rows + one K and one V
// tile (K padded).
__host__ __device__ constexpr size_t smem_floats(int block_m, int d) {
  return (size_t)block_m * d + (size_t)kTileN * (d + 4) + (size_t)kTileN * d;
}

// One K/V tile in flight through registers.  kC = ceil(D / 32) bounds the
// head dim of the instantiation, which fixes the loads per thread.
template <typename T, int kC>
struct TileStage {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  static constexpr int kLoads =
      (kTileN * 32 * kC / kVec + kThreads - 1) / kThreads;
  uint4 kbuf[kLoads], vbuf[kLoads];

  // row_off(t): element offset of tile key t's D values in k and v, or a
  // negative value for "no key here" (read as zeros)
  template <typename RowOff>
  __device__ __forceinline__ void fetch(const T* __restrict__ k,
                                        const T* __restrict__ v, int d,
                                        int tid, RowOff row_off) {
    const int vec_per_row = d / kVec;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int idx = tid + l * kThreads;
      const int t = idx / vec_per_row;
      kbuf[l] = make_uint4(0u, 0u, 0u, 0u);
      vbuf[l] = make_uint4(0u, 0u, 0u, 0u);
      if (t < kTileN) {
        const long long off = row_off(t);
        if (off >= 0) {
          const size_t o = (size_t)off + (idx % vec_per_row) * kVec;
          kbuf[l] = *reinterpret_cast<const uint4*>(k + o);
          vbuf[l] = *reinterpret_cast<const uint4*>(v + o);
        }
      }
    }
  }

  __device__ __forceinline__ void stash(float* k_s, float* v_s, int d,
                                        int tid) const {
    const int vec_per_row = d / kVec;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int idx = tid + l * kThreads;
      const int t = idx / vec_per_row;
      if (t < kTileN) {
        const int c = (idx % vec_per_row) * kVec;
        widen16(kbuf[l], k_s + t * (d + 4) + c, T());
        widen16(vbuf[l], v_s + t * d + c, T());
      }
    }
  }
};

// Online-softmax state of the kR query rows a warp owns; lane holds output
// dims lane + 32 c.
template <int kR, int kC>
struct Rows {
  float m[kR], l[kR], acc[kR][kC];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[r][c] = 0.f;
    }
  }

  // q_s: this warp's kR staged query rows (kR, d); k_s/v_s: the staged
  // tile; jmax: keys of the tile that exist (the rest are zeros);
  // valid(r, j): may row r see tile key j.
  template <typename Valid>
  __device__ __forceinline__ void update(const float* q_s, const float* k_s,
                                         const float* v_s, int d, int lane,
                                         int jmax, float sm_scale,
                                         Valid valid) {
    float sc[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) sc[r] = 0.f;
    const float* krow = k_s + lane * (d + 4);
    for (int c = 0; c < d; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + r * d + c);
        sc[r] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
    float p[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const bool ok = valid(r, lane);
      const float sv = ok ? sc[r] * sm_scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      p[r] = ok ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[r][c] *= alpha;
    }
    for (int j = 0; j < jmax; ++j) {
      float vj[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int dd = lane + 32 * c;
        vj[c] = dd < d ? v_s[j * d + dd] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[r][c] += pj * vj[c];
      }
    }
  }

  // normalized output of row r, dim lane + 32 c (0 for a row that saw no
  // key)
  __device__ __forceinline__ float out(int r, int c) const {
    return acc[r][c] / (l[r] == 0.f ? 1.f : l[r]);
  }
};

// Keys slot b sees: its length clamped to [0, max_keys].
__device__ __forceinline__ int slot_keys(const int* lengths, int b,
                                         int max_keys) {
  return min(max(lengths[b], 0), max_keys);
}

// Second pass of a split-KV decode (the paged and the dense decode
// kernels): grid (B * Hkv), one block per (slot, KV head).  The split pass
// left, for each used split s of the slot (split_keys keys each) and each
// of the G query heads, the unnormalised partial (m, l, acc) in f32
// scratch laid out (B * Hkv, n_split, G[, D]); this rescales them to their
// common max and writes the normalised output (zeros for a slot that saw
// no key).  Dynamic shared memory: n_split * G floats.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ m_part,
                      const float* __restrict__ l_part,
                      const float* __restrict__ acc_part,
                      const int* __restrict__ lengths, T* __restrict__ out,
                      int hq, int hkv, int d, int max_keys, int split_keys,
                      int n_split) {
  extern __shared__ float w_s[];  // (n_split, G) weight of each partial
  const int g = hq / hkv;
  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int h = bh % hkv;
  const int n_used =
      (slot_keys(lengths, b, max_keys) + split_keys - 1) / split_keys;
  const size_t base = (size_t)bh * n_split * g;

  // per head: the common max, the total sum, then each split's weight
  // exp(m_s - m) / l (every used split saw at least one key, so l > 0)
  for (int row = threadIdx.x; row < g; row += blockDim.x) {
    float m = kNegInf;
    for (int s = 0; s < n_used; ++s) m = fmaxf(m, m_part[base + s * g + row]);
    float l = 0.f;
    for (int s = 0; s < n_used; ++s) {
      const float w = expf(m_part[base + s * g + row] - m);
      w_s[s * g + row] = w;
      l += w * l_part[base + s * g + row];
    }
    const float inv = l == 0.f ? 0.f : 1.f / l;
    for (int s = 0; s < n_used; ++s) w_s[s * g + row] *= inv;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < g * d; idx += blockDim.x) {
    const int row = idx / d;
    const int dd = idx % d;
    float o = 0.f;
    for (int s = 0; s < n_used; ++s) {
      o += w_s[s * g + row] * acc_part[(base + s * g + row) * d + dd];
    }
    store(out + ((size_t)b * hq + h * g + row) * d + dd, o);
  }
}

}  // namespace attn
