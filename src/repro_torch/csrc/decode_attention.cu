// Dense decode attention for Hopper (sm_90a): one query token per row
// against a contiguous (B, T, Hkv, D) KV cache.
//
// Replaces the Pallas TPU kernel `_decode_kernel` behind
// `pallas_decode_attention` (src/repro/kernels/decode_attention.py).  It
// computes the same function:
//
//   * q (B, 1, Hq, D); k, v (B, T, Hkv, D); key position p of row b is
//     k[b, p].
//   * Row b sees keys p < lengths[b] (clamped to [0, T]); the query sits at
//     position lengths[b] - 1, so every key it sees is causal.  Keys at or
//     past lengths[b] are never read.  lengths == 0 writes zeros, as the
//     TPU kernel's l_safe does.
//   * G = Hq / Hkv query heads share each K/V tile; f32 online softmax
//     with the finite NEG_INF.
//
// What bounds it on the H100: bytes, each row's valid K and V once; its
// arithmetic (4 D operations per key per query head) is two orders of
// magnitude below the tensor-core line.  The TPU kernel walks (row x KV
// head, 512-key block) in order on one core; on Hopper that order gives 64
// blocks for 8 rows x 8 KV heads, so the keys are split over n_split
// blocks (the wrapper's `_plan` sizes the split from B Hkv and T so that
// the grid holds several blocks per SM), and:
//
//   1. a split pass, grid (B * Hkv, n_split): block (row, KV head, split)
//      walks its share of the row's keys and writes the unnormalised
//      partial (m, l, acc) of each of the G query heads into f32 scratch.
//      Blocks whose share lies past the row's length return at once.
//        * bf16 with D % 16 == 0 and D <= 128: the flash forward's
//          tensor-core walk (attention_tc.cuh) at Sq = 1 with the G heads
//          as one 16-row m16 tile (padded; the waste is free in a kernel
//          bound by bytes): 64-key bf16 tiles staged by cp.async in a 2-3
//          stage ring, each of the 4 warps taking 16 keys of every tile,
//          the warps' partials merged through shared memory before the
//          block writes its split.  Split s takes the s-th tile-aligned
//          share of the row's own lengths[b] keys (read on the card), so a
//          short row spreads over the splits as a long one does.
//        * f32 and every other D: `decode_split_kernel` below, 32-key tiles
//          widened to f32 and register-staged (the next tile in flight
//          while the current one computes), products on the CUDA cores;
//          split s takes the fixed keys [s split_keys, (s + 1) split_keys).
//   2. the combine, grid (B * Hkv): rescales the used splits of each head
//      to their common max and writes the output (attn_tc's combine for
//      the tensor-core route, decode_combine_kernel of
//      attention_common.cuh for the other).
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
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int* __restrict__ lengths,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    float* __restrict__ acc_part, int hq, int hkv, int d,
                    int t_max, int split_keys, int n_split,
                    float sm_scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kBlockM = kWarps * kR;

  const int g = hq / hkv;
  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int h = bh % hkv;
  const int split = blockIdx.y;
  const int n_keys = slot_keys(lengths, b, t_max);
  const int k0 = split * split_keys;
  if (k0 >= n_keys) return;  // the combine reads only used splits
  const int k1 = min(n_keys, k0 + split_keys);

  float* q_s = smem;                    // (kBlockM, d)
  float* k_s = q_s + kBlockM * d;       // (kTileN, d + 4)
  float* v_s = k_s + kTileN * (d + 4);  // (kTileN, d)

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

  Rows<kR, kC> st;
  st.init();
  const int wrow0 = warp * kR;
  const bool warp_live = wrow0 < g;

  TileStage<T, kC> stage;
  auto fetch = [&](int base) {
    stage.fetch(k, v, d, tid, [=](int t) -> long long {
      const int pos = base + t;
      return pos < k1 ? (((long long)b * t_max + pos) * hkv + h) * d : -1;
    });
  };

  fetch(k0);
  for (int base = k0; base < k1; base += kTileN) {
    __syncthreads();  // every warp is done with the previous tile (and q_s
                      // is staged, on the first pass)
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
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const void* lengths, float* m_part, float* l_part,
                   float* acc_part, int b, int hq, int hkv, int d,
                   int t_max, int split_keys, int n_split, float sm_scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(kWarps * kR, d);
  auto split = decode_split_kernel<T, kC, kR>;
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
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths), m_part,
      l_part, acc_part, hq, hkv, d, t_max, split_keys, n_split, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine<<<b * hkv, kThreads, smem_w, stream>>>(
      m_part, l_part, acc_part, static_cast<const int*>(lengths),
      static_cast<T*>(out), hq, hkv, d, t_max, split_keys, n_split);
  return cudaGetLastError();
}

template <typename T, int kC>
cudaError_t launch_g(int g, const void* q, const void* k, const void* v,
                     void* out, const void* lengths, float* m_part,
                     float* l_part, float* acc_part, int b, int hq, int hkv,
                     int d, int t_max, int split_keys, int n_split,
                     float sm_scale, cudaStream_t stream) {
#define DA_LAUNCH(R)                                                       \
  return launch<T, kC, R>(q, k, v, out, lengths, m_part, l_part, acc_part, \
                          b, hq, hkv, d, t_max, split_keys, n_split,       \
                          sm_scale, stream)
  if (g <= 4) DA_LAUNCH(1);
  if (g <= 8) DA_LAUNCH(2);
  DA_LAUNCH(4);
#undef DA_LAUNCH
}

template <typename T>
cudaError_t launch_d(int d, int g, const void* q, const void* k,
                     const void* v, void* out, const void* lengths,
                     float* m_part, float* l_part, float* acc_part, int b,
                     int hq, int hkv, int t_max, int split_keys, int n_split,
                     float sm_scale, cudaStream_t stream) {
#define DA_LAUNCH_D(C)                                                    \
  return launch_g<T, C>(g, q, k, v, out, lengths, m_part, l_part,         \
                        acc_part, b, hq, hkv, d, t_max, split_keys,       \
                        n_split, sm_scale, stream)
  if (d <= 32) DA_LAUNCH_D(1);
  if (d <= 64) DA_LAUNCH_D(2);
  if (d <= 128) DA_LAUNCH_D(4);
  DA_LAUNCH_D(8);
#undef DA_LAUNCH_D
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16.  Every pointer is a device pointer of a contiguous tensor.
// On the tensor-core route (bf16, D % 16 == 0, D <= 128) split_keys is 0
// and n_split (1 to 32) shares cut each row's valid keys; m_part/l_part
// hold B * Hkv * n_split * 16 floats and acc_part that times D, all null
// when n_split == 1.  On the other route split_keys is a multiple of 32,
// n_split = ceil(t_max / split_keys), and the scratch holds
// B * Hkv * n_split * G floats (acc_part that times D).  Both launches go
// on `stream` and nothing is synchronised.  Returns the cudaError_t of the
// launches (0 = cudaSuccess).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* out,
    const void* lengths, void* m_part, void* l_part, void* acc_part, int b,
    int hq, int hkv, int d, int t_max, int split_keys, int n_split,
    int dtype, float sm_scale, void* stream) {
  const bool tc = attn_tc::takes_walk(dtype, d);
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > 16 || d <= 0 || d > 256
      || d % 8 != 0 || t_max <= 0
      || (tc ? split_keys != 0
             : split_keys <= 0 || split_keys % kTileN != 0
                   || n_split != (t_max + split_keys - 1) / split_keys)) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  if (tc) {
    attn_tc::Params p;
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.k = static_cast<const __nv_bfloat16*>(k);
    p.v = static_cast<const __nv_bfloat16*>(v);
    p.out = static_cast<__nv_bfloat16*>(out);
    p.m_part = mp;
    p.l_part = lp;
    p.acc_part = ap;
    p.kv_len = static_cast<const int*>(lengths);
    p.q_offset = nullptr;  // the query sits at lengths - 1
    p.sq = 1;
    p.skv = t_max;
    p.hq = hq;
    p.hkv = hkv;
    p.causal = 0;
    p.window = 0;
    p.n_split = n_split;
    p.scale_log2 = sm_scale * attn_tc::kLog2e;
    return (int)attn_tc::launch<attn_tc::DenseKV>(p, b, d, 16, st);
  }
  const int g = hq / hkv;
  cudaError_t err;
  if (dtype == 0) {
    err = launch_d<float>(d, g, q, k, v, out, lengths, mp, lp, ap, b, hq,
                          hkv, t_max, split_keys, n_split, sm_scale, st);
  } else if (dtype == 1) {
    err = launch_d<__nv_bfloat16>(d, g, q, k, v, out, lengths, mp, lp, ap, b,
                                  hq, hkv, t_max, split_keys, n_split,
                                  sm_scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
