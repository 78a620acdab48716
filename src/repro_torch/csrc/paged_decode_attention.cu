// Paged decode attention for Hopper (sm_90a): the two-dispatch engine's
// decode attention, one query token per slot against that slot's pages.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel` behind
// `pallas_paged_decode_attention` (src/repro/kernels/decode_attention.py).
// It computes the same function:
//
//   * q (B, 1, Hq, D); K/V in the resident pools (P, Hkv, page_size, D);
//     key position p of slot b is row p % page_size of page
//     page_table[b, p / page_size].
//   * Slot b sees keys p < lengths[b] (clamped to max_pages * page_size,
//     the width of its table row); pages at or past ceil(lengths / ps) are
//     never read.  lengths == 0 writes zeros.
//   * f32 online softmax with the finite NEG_INF.
//
// What bounds it on the H100: bytes.  A decode step reads every live
// page's K and V once; its arithmetic (4 D operations per key per query
// head) is two orders of magnitude below the tensor-core line.  The TPU
// kernel walks (slot x KV head, page) in order on one core; here 8 slots x
// 8 KV heads would be 64 blocks for 132 SMs, so the walk is split
// (flash-decode) and a second pass combines the splits.  Two routes,
// chosen from the dtype and D alone:
//
//   * bf16 with D % 16 == 0 and D <= 128: the ragged kernel's function at
//     q_len = 1, run on the tensor-core walk of attention_tc.cuh with its
//     paged policy (rows b * 1 + 0, not packed).  The G query heads of a
//     KV head form one 16-row tile whose 4 warps split each 64-key tile;
//     each of n_split blocks takes a tile-aligned share of its slot's own
//     length, read on the card, and attn_tc_combine_kernel merges the
//     shares.  n_split and the scratch come from the shared plan
//     (kernels/attention_tc.py).  What bounds it now: each block's short
//     chain of dependent tiles and the combine's second launch.
//   * f32 and every other D: `paged_decode_split_kernel` below, grid
//     (B * Hkv, n_split): block (slot, KV head, split) walks the
//     split_keys key positions of its split in 32-key tiles widened to f32
//     (register-staged, next tile in flight while the current one
//     computes) and writes the unnormalised partial (m, l, acc) of each of
//     the G query heads into f32 scratch; blocks past the slot's length
//     return at once; then `decode_combine_kernel` (attention_common.cuh)
//     rescales the used splits and writes the output.
//
// The wrapper allocates the scratch (torch.empty) and counts the two
// launches as one call.

#include "attention_common.cuh"
#include "attention_tc.cuh"

namespace {

using namespace attn;

// kC = ceil(D / 32); kR = query heads per warp (G <= 4 kR)
template <typename T, int kC, int kR>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool,
                          const int* __restrict__ page_table,
                          const int* __restrict__ lengths,
                          float* __restrict__ m_part,
                          float* __restrict__ l_part,
                          float* __restrict__ acc_part, int hq, int hkv,
                          int d, int n_pool, int ps, int max_pages,
                          int split_keys, int n_split, float sm_scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kBlockM = kWarps * kR;

  const int g = hq / hkv;
  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int h = bh % hkv;
  const int split = blockIdx.y;
  const int n_keys = slot_keys(lengths, b, max_pages * ps);
  const int k0 = split * split_keys;
  if (k0 >= n_keys) return;  // the combine reads only used splits
  const int k1 = min(n_keys, k0 + split_keys);

  float* q_s = smem;                     // (kBlockM, d)
  float* k_s = q_s + kBlockM * d;        // (kTileN, d + 4)
  float* v_s = k_s + kTileN * (d + 4);   // (kTileN, d)
  int* pt_s = reinterpret_cast<int*>(v_s + kTileN * d);  // page of each key

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int vec_per_row = d / kVec;

  // the G query heads of KV head h, as f32; rows past G are zero
  for (int idx = tid; idx < kBlockM * vec_per_row; idx += kThreads) {
    const int r = idx / vec_per_row;
    const int c = (idx % vec_per_row) * kVec;
    float* dst = q_s + r * d + c;
    if (r < g) {
      load16(q + ((size_t)b * hq + h * g + r) * d + c, dst);
    } else {
      zero16<T>(dst);
    }
  }
  // the page of every key of the split, once (a bad id reads as zeros)
  for (int t = tid; t < k1 - k0; t += kThreads) {
    const int p = page_table[(size_t)b * max_pages + (k0 + t) / ps];
    pt_s[t] = (p < 0 || p >= n_pool) ? -1 : p;
  }
  __syncthreads();

  Rows<kR, kC> st;
  st.init();
  const int wrow0 = warp * kR;
  const bool warp_live = wrow0 < g;

  TileStage<T, kC> stage;
  auto fetch = [&](int base) {
    stage.fetch(k_pool, v_pool, d, tid, [=](int t) -> long long {
      const int pos = base + t;
      const int page = pos < k1 ? pt_s[pos - k0] : -1;
      return page < 0 ? -1
                      : (((long long)page * hkv + h) * ps + pos % ps) * d;
    });
  };

  fetch(k0);
  for (int base = k0; base < k1; base += kTileN) {
    __syncthreads();  // every warp is done with the previous tile
    stage.stash(k_s, v_s, d, tid);
    __syncthreads();  // the tile at `base` is in shared memory
    if (base + kTileN < k1) fetch(base + kTileN);
    if (!warp_live) continue;
    const int pos = base + lane;
    st.update(q_s + wrow0 * d, k_s, v_s, d, lane, min(kTileN, k1 - base),
              sm_scale,
              [=](int r, int) { return wrow0 + r < g && pos < k1; });
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int row = wrow0 + r;
    if (row >= g) break;
    const size_t idx = ((size_t)bh * n_split + split) * g + row;
    if (lane == 0) {
      m_part[idx] = st.m[r];
      l_part[idx] = st.l[r];
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int dd = lane + 32 * c;
      if (dd < d) acc_part[idx * d + dd] = st.acc[r][c];
    }
  }
}

template <typename T, int kC, int kR>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   void* out, const void* page_table, const void* lengths,
                   float* m_part, float* l_part, float* acc_part, int b,
                   int hq, int hkv, int d, int n_pool, int ps, int max_pages,
                   int split_keys, int n_split, float sm_scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(kWarps * kR, d)
                      + sizeof(int) * (size_t)split_keys;
  auto split = paged_decode_split_kernel<T, kC, kR>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const size_t smem_w = sizeof(float) * (size_t)n_split * (hq / hkv);
  auto combine = decode_combine_kernel<T>;
  if (smem_w > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        combine, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_w);
    if (err != cudaSuccess) return err;
  }
  split<<<dim3(b * hkv, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), m_part, l_part, acc_part, hq, hkv, d,
      n_pool, ps, max_pages, split_keys, n_split, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine<<<b * hkv, kThreads, smem_w, stream>>>(
      m_part, l_part, acc_part, static_cast<const int*>(lengths),
      static_cast<T*>(out), hq, hkv, d, max_pages * ps, split_keys, n_split);
  return cudaGetLastError();
}

template <typename T, int kC>
cudaError_t launch_g(int g, const void* q, const void* k_pool,
                     const void* v_pool, void* out, const void* page_table,
                     const void* lengths, float* m_part, float* l_part,
                     float* acc_part, int b, int hq, int hkv, int d,
                     int n_pool, int ps, int max_pages, int split_keys,
                     int n_split, float sm_scale, cudaStream_t stream) {
#define PDA_LAUNCH(R)                                                      \
  return launch<T, kC, R>(q, k_pool, v_pool, out, page_table, lengths,    \
                          m_part, l_part, acc_part, b, hq, hkv, d, n_pool, \
                          ps, max_pages, split_keys, n_split, sm_scale,    \
                          stream)
  if (g <= 4) PDA_LAUNCH(1);
  if (g <= 8) PDA_LAUNCH(2);
  PDA_LAUNCH(4);
#undef PDA_LAUNCH
}

template <typename T>
cudaError_t launch_d(int d, int g, const void* q, const void* k_pool,
                     const void* v_pool, void* out, const void* page_table,
                     const void* lengths, float* m_part, float* l_part,
                     float* acc_part, int b, int hq, int hkv, int n_pool,
                     int ps, int max_pages, int split_keys, int n_split,
                     float sm_scale, cudaStream_t stream) {
#define PDA_LAUNCH_D(C)                                                    \
  return launch_g<T, C>(g, q, k_pool, v_pool, out, page_table, lengths,   \
                        m_part, l_part, acc_part, b, hq, hkv, d, n_pool,   \
                        ps, max_pages, split_keys, n_split, sm_scale,      \
                        stream)
  if (d <= 32) PDA_LAUNCH_D(1);
  if (d <= 64) PDA_LAUNCH_D(2);
  if (d <= 128) PDA_LAUNCH_D(4);
  PDA_LAUNCH_D(8);
#undef PDA_LAUNCH_D
}

}  // namespace

// The tensor-core walk's addressing for this kernel: the paged policy,
// one unpacked row per slot (its own type, so that a profile names the
// caller)
struct paged_decode_addressing : attn_tc::PagedKV {};

// Plain C entry point (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16.  Every pointer is a device pointer of a contiguous tensor.
// On the tensor-core route (bf16, D % 16 == 0, D <= 128) split_keys is 0
// and n_split (1 to 32) shares cut each slot's valid keys; m_part/l_part
// hold B * Hkv * n_split * 16 floats and acc_part that times D, all null
// when n_split == 1.  On the other route split_keys is a multiple of 32,
// n_split = ceil(max_pages * ps / split_keys), and the scratch holds
// B * Hkv * n_split * G floats (acc_part that times D).  Both launches go
// on `stream` and nothing is synchronised.  Returns the cudaError_t of the
// launches (0 = cudaSuccess).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, void* out,
    const void* page_table, const void* lengths, void* m_part, void* l_part,
    void* acc_part, int b, int hq, int hkv, int d, int n_pool, int ps,
    int max_pages, int split_keys, int n_split, int dtype, float sm_scale,
    void* stream) {
  const bool tc = attn_tc::takes_walk(dtype, d);
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > 16 || d <= 0 || d > 256
      || d % 8 != 0 || ps <= 0 || max_pages <= 0 || n_split < 1
      || (tc ? split_keys != 0
             : split_keys <= 0 || split_keys % kTileN != 0
                   || n_split != (max_pages * ps + split_keys - 1)
                                     / split_keys)) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  if (tc) {
    attn_tc::PagedParams p;
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.k = static_cast<const __nv_bfloat16*>(k_pool);
    p.v = static_cast<const __nv_bfloat16*>(v_pool);
    p.out = static_cast<__nv_bfloat16*>(out);
    p.m_part = mp;
    p.l_part = lp;
    p.acc_part = ap;
    p.kv_len = static_cast<const int*>(lengths);
    p.q_offset = nullptr;  // the query sits at lengths - 1
    p.sq = 1;
    p.skv = max_pages * ps;
    p.hq = hq;
    p.hkv = hkv;
    p.causal = 0;
    p.window = 0;
    p.n_split = n_split;
    p.scale_log2 = sm_scale * attn_tc::kLog2e;
    p.page_table = static_cast<const int*>(page_table);
    p.ps = ps;
    p.max_pages = max_pages;
    p.n_pool = n_pool;
    p.q_start = nullptr;  // one row per slot: b * 1 + 0
    p.q_len = nullptr;
    p.n_tokens = 0;
    return (int)attn_tc::launch<paged_decode_addressing>(p, b, d, 16, st);
  }
  const int g = hq / hkv;
  cudaError_t err;
  if (dtype == 0) {
    err = launch_d<float>(d, g, q, k_pool, v_pool, out, page_table, lengths,
                          mp, lp, ap, b, hq, hkv, n_pool, ps, max_pages,
                          split_keys, n_split, sm_scale, st);
  } else if (dtype == 1) {
    err = launch_d<__nv_bfloat16>(d, g, q, k_pool, v_pool, out, page_table,
                                  lengths, mp, lp, ap, b, hq, hkv, n_pool, ps,
                                  max_pages, split_keys, n_split, sm_scale,
                                  st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
