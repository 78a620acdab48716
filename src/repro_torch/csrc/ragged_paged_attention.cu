// Ragged paged attention for Hopper (sm_90a): the unified serving step's
// one attention kernel, mixed decode + prefill segments in one launch.
//
// Replaces the Pallas TPU kernel `_ragged_kernel` behind
// `pallas_ragged_paged_attention` (src/repro/kernels/ragged_attention.py).
// It computes the same function, not the same block structure:
//
//   * q (T, Hq, D) is token-packed: segment s owns rows
//     [q_start[s], q_start[s] + q_len[s]) and its query i sits at global
//     position kv_len[s] - q_len[s] + i.  It sees keys at positions
//     p <= that position and p < kv_len[s] (causal within a prefill chunk;
//     a decode segment has q_len == 1 and sees everything valid).
//   * K/V live in the resident pools (P, Hkv, page_size, D); key position
//     p of segment s is row p % page_size of page page_table[s, p / ps].
//   * f32 online softmax with the finite NEG_INF, so a fully masked row has
//     l == 0 and writes zeros, as the reference does.
//   * Rows past a segment's q_len (and every row of an idle segment) are
//     neither read nor written: the next segment's rows follow them.  The
//     wrapper zero-fills the output, so packing gaps stay finite.
//
// What bounds it on the H100: at a decode segment (G rows per KV head) the
// bytes of its valid pages' K and V; at a 128-query prefill chunk the 4 D
// operations per visible query-key pair, which only the tensor cores run
// at the card's rate.  Two routes, chosen from the dtype and D alone:
//
//   * bf16 with D % 16 == 0 and D <= 128 (every served model's heads): the
//     tensor-core walk of attention_tc.cuh with its paged policy and packed
//     rows.  mma.sync products on bf16 64-key tiles that cp.async copies
//     from the pages into a ring, the segment's page ids staged once per
//     block; 16-row blocks whose warps split each tile's keys for decode
//     segments (G <= 16 rows), 64-row blocks for prefill chunks; and a
//     split of each block's visible keys over n_split blocks with a
//     combine pass where the (segment x KV head x row block) grid leaves
//     the 132 SMs short, planned from the shapes (kernels/attention_tc.py).
//     What bounds it now: at decode each block's chain of dependent tiles
//     and the combine's second launch, as for the dense decode; at
//     prefill one causal block's chain of tiles on mma.sync (not wgmma).
//   * f32, and bf16 at any other D (a multiple of 8 up to 256): the
//     CUDA-core walk below, which serve_parity and the f32 checks hold
//     exactly.  Grid (S * Hkv, ceil(max_q * G / 16)); a block owns 16
//     flattened rows of one segment and one KV head, loops over 32-key
//     tiles staged through registers and widened to f32, and stops at the
//     causal bound of its last query, so pages past kv_len are never
//     read.  Products on the CUDA cores in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockM = kWarps * kRowsPerWarp;  // flattened rows per block
constexpr int kTileN = 32;                      // key positions per tile
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

// kC = ceil(D / 32): output dims each lane accumulates (dim lane + 32 c)
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, T* __restrict__ out,
    const int* __restrict__ page_table, const int* __restrict__ q_start,
    const int* __restrict__ q_len, const int* __restrict__ kv_len,
    int n_tokens, int hq, int hkv, int d, int n_pool, int ps, int max_pages,
    int max_q, float sm_scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  // 16-byte loads per thread per tile of K (and of V) at this instance's
  // widest head dim, all issued before any is used
  constexpr int kLoads = (kTileN * 32 * kC / kVec + kThreads - 1) / kThreads;

  const int g = hq / hkv;
  const int s = blockIdx.x / hkv;
  const int h = blockIdx.x % hkv;
  const int qs = q_start[s];
  // rows with a query: q_len clamped to max_q and to the packed batch
  const int ql = min(min(q_len[s], max_q), n_tokens - qs);
  const int row0 = blockIdx.y * kBlockM;
  if (ql <= 0 || row0 >= ql * g) return;  // whole block masked
  const int kl = kv_len[s];
  const int q_off = kl - q_len[s];  // global position of query 0
  const int row_end = min(row0 + kBlockM, ql * g);
  const int last_q = (row_end - 1) / g;
  // key positions this block can see: the causal bound of its last query
  const int n_keys = max(0, min(kl, q_off + last_q + 1));

  const int dk = d + 4;  // padded K row: float4 reads across lanes
  float* q_s = smem;                     // (kBlockM, d)
  float* k_s = q_s + kBlockM * d;        // (kTileN, d + 4)
  float* v_s = k_s + kTileN * dk;        // (kTileN, d)
  int* pt_s = reinterpret_cast<int*>(v_s + kTileN * d);  // page ids walked

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int vec_per_row = d / kVec;

  // stage the block's query rows as f32; rows past row_end are zero
  for (int idx = tid; idx < kBlockM * vec_per_row; idx += kThreads) {
    const int r = idx / vec_per_row;
    const int c = (idx % vec_per_row) * kVec;
    const int row = row0 + r;
    float* dst = q_s + r * d + c;
    if (row < row_end) {
      const int i = row / g;
      const int head = h * g + row % g;
      load16(q + ((size_t)(qs + i) * hq + head) * d + c, dst);
    } else {
      zero16<T>(dst);
    }
  }

  float m_i[kRowsPerWarp], l_i[kRowsPerWarp], acc[kRowsPerWarp][kC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[r][c] = 0.f;
  }
  const int wrow0 = row0 + warp * kRowsPerWarp;  // this warp's first row
  const bool warp_live = wrow0 < row_end;

  // the segment's page ids the walk needs, once per block (a bad id reads
  // as zeros rather than out of the pool)
  const int n_pg = min((n_keys + ps - 1) / ps, max_pages);
  for (int i = tid; i < n_pg; i += kThreads) {
    const int p = page_table[(size_t)s * max_pages + i];
    pt_s[i] = (p < 0 || p >= n_pool) ? -1 : p;
  }
  __syncthreads();  // q_s and pt_s are staged

  // register staging of one K/V tile: `fetch` issues every global load of
  // the tile at `base` (zeros past n_keys), `stash` widens them into
  // shared memory.  The next tile's loads are in flight while the current
  // tile's math runs.
  uint4 kbuf[kLoads], vbuf[kLoads];
  auto fetch = [&](int base) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int idx = tid + l * kThreads;
      const int t = idx / vec_per_row;
      const int pos = base + t;
      kbuf[l] = make_uint4(0u, 0u, 0u, 0u);
      vbuf[l] = make_uint4(0u, 0u, 0u, 0u);
      const int page = (t < kTileN && pos < n_keys && pos / ps < max_pages)
                           ? pt_s[pos / ps] : -1;
      if (page >= 0) {
        const size_t off = (((size_t)page * hkv + h) * ps + pos % ps) * d
                           + (idx % vec_per_row) * kVec;
        kbuf[l] = *reinterpret_cast<const uint4*>(k_pool + off);
        vbuf[l] = *reinterpret_cast<const uint4*>(v_pool + off);
      }
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int idx = tid + l * kThreads;
      const int t = idx / vec_per_row;
      if (t < kTileN) {
        const int c = (idx % vec_per_row) * kVec;
        widen16(kbuf[l], k_s + t * dk + c, T());
        widen16(vbuf[l], v_s + t * d + c, T());
      }
    }
  };

  if (n_keys > 0) fetch(0);
  for (int base = 0; base < n_keys; base += kTileN) {
    __syncthreads();  // every warp is done with the previous tile
    stash();
    __syncthreads();  // the tile at `base` is in shared memory
    if (base + kTileN < n_keys) fetch(base + kTileN);
    if (!warp_live) continue;

    // scores: lane j owns key position base + j, for the warp's 4 rows
    const int pos = base + lane;
    float sc[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = 0.f;
    const float* krow = k_s + lane * dk;
    const float* qrow = q_s + (warp * kRowsPerWarp) * d;
    for (int c = 0; c < d; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + r * d + c);
        sc[r] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
    float p[kRowsPerWarp], alpha[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = wrow0 + r;
      const int qpos = q_off + row / g;
      const bool valid = row < row_end && pos < kl && pos <= qpos;
      const float sv = valid ? sc[r] * sm_scale : kNegInf;
      const float m_new = fmaxf(m_i[r], warp_max(sv));
      p[r] = valid ? expf(sv - m_new) : 0.f;
      alpha[r] = expf(m_i[r] - m_new);
      l_i[r] = l_i[r] * alpha[r] + warp_sum(p[r]);
      m_i[r] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[r][c] *= alpha[r];
    }
    // acc += P V: lane accumulates dims lane + 32 c
    const int jmax = min(kTileN, n_keys - base);
    for (int j = 0; j < jmax; ++j) {
      float vj[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int dd = lane + 32 * c;
        vj[c] = dd < d ? v_s[j * d + dd] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[r][c] += pj * vj[c];
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = wrow0 + r;
    if (row >= row_end) break;
    const int i = row / g;
    const int head = h * g + row % g;
    const float l_safe = l_i[r] == 0.f ? 1.f : l_i[r];
    T* dst = out + ((size_t)(qs + i) * hq + head) * d;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int dd = lane + 32 * c;
      if (dd < d) store(dst + dd, acc[r][c] / l_safe);
    }
  }
}

template <typename T, int kC>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   void* out, const void* page_table, const void* q_start,
                   const void* q_len, const void* kv_len, int n_tokens,
                   int n_segs, int hq, int hkv, int d, int n_pool, int ps,
                   int max_pages, int max_q, float sm_scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBlockM * d + (size_t)kTileN * (d + 4)
                       + (size_t)kTileN * d)
      + sizeof(int) * (size_t)max_pages;
  auto kernel = ragged_paged_attention_kernel<T, kC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int g = hq / hkv;
  dim3 grid(n_segs * hkv, (max_q * g + kBlockM - 1) / kBlockM);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<T*>(out),
      static_cast<const int*>(page_table), static_cast<const int*>(q_start),
      static_cast<const int*>(q_len), static_cast<const int*>(kv_len),
      n_tokens, hq, hkv, d, n_pool, ps, max_pages, max_q, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k_pool,
                     const void* v_pool, void* out, const void* page_table,
                     const void* q_start, const void* q_len,
                     const void* kv_len, int n_tokens, int n_segs, int hq,
                     int hkv, int n_pool, int ps, int max_pages, int max_q,
                     float sm_scale, cudaStream_t stream) {
#define RPA_LAUNCH(C)                                                       \
  return launch<T, C>(q, k_pool, v_pool, out, page_table, q_start, q_len,  \
                      kv_len, n_tokens, n_segs, hq, hkv, d, n_pool, ps,     \
                      max_pages, max_q, sm_scale, stream)
  if (d <= 32) RPA_LAUNCH(1);
  if (d <= 64) RPA_LAUNCH(2);
  if (d <= 128) RPA_LAUNCH(4);
  RPA_LAUNCH(8);
#undef RPA_LAUNCH
}

}  // namespace

// The tensor-core walk's addressing for this kernel: the paged policy with
// packed rows (its own type, so that a profile names the caller)
struct ragged_paged_addressing : attn_tc::PagedKV {};

// Plain C entry point (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16.  Every pointer is a device pointer of a contiguous tensor;
// the launches go on `stream` and nothing is synchronised.  block_rows and
// n_split: the tensor-core route's row block (16 or 64) and key split, from
// the wrapper's plan; with n_split > 1, m_part/l_part hold
// S * Hkv * ceil(max_q G / block_rows) * n_split * block_rows floats and
// acc_part that times D (else they may be null).  The CUDA-core route
// takes n_split == 1.  Returns the cudaError_t of the launches
// (0 = cudaSuccess).
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, void* out,
    const void* page_table, const void* q_start, const void* q_len,
    const void* kv_len, void* m_part, void* l_part, void* acc_part,
    int n_tokens, int n_segs, int hq, int hkv, int d, int n_pool, int ps,
    int max_pages, int max_q, int dtype, int block_rows, int n_split,
    float sm_scale, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || d <= 0 || d > 256 || d % 8 != 0
      || ps <= 0 || max_pages <= 0 || max_q <= 0 || n_split < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tokens == 0 || n_segs == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (attn_tc::takes_walk(dtype, d)) {
    attn_tc::PagedParams p;
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.k = static_cast<const __nv_bfloat16*>(k_pool);
    p.v = static_cast<const __nv_bfloat16*>(v_pool);
    p.out = static_cast<__nv_bfloat16*>(out);
    p.m_part = static_cast<float*>(m_part);
    p.l_part = static_cast<float*>(l_part);
    p.acc_part = static_cast<float*>(acc_part);
    p.kv_len = static_cast<const int*>(kv_len);
    p.q_offset = nullptr;  // query i sits at kv_len - q_len + i
    p.sq = max_q;
    p.skv = max_pages * ps;
    p.hq = hq;
    p.hkv = hkv;
    p.causal = 1;
    p.window = 0;
    p.n_split = n_split;
    p.scale_log2 = sm_scale * attn_tc::kLog2e;
    p.page_table = static_cast<const int*>(page_table);
    p.ps = ps;
    p.max_pages = max_pages;
    p.n_pool = n_pool;
    p.q_start = static_cast<const int*>(q_start);
    p.q_len = static_cast<const int*>(q_len);
    p.n_tokens = n_tokens;
    return (int)attn_tc::launch<ragged_paged_addressing>(p, n_segs, d,
                                                         block_rows, st);
  }
  if (n_split != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 0) {
    err = launch_d<float>(d, q, k_pool, v_pool, out, page_table, q_start,
                          q_len, kv_len, n_tokens, n_segs, hq, hkv, n_pool,
                          ps, max_pages, max_q, sm_scale, st);
  } else if (dtype == 1) {
    err = launch_d<__nv_bfloat16>(d, q, k_pool, v_pool, out, page_table,
                                  q_start, q_len, kv_len, n_tokens, n_segs,
                                  hq, hkv, n_pool, ps, max_pages, max_q,
                                  sm_scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
