// Flash attention forward for Hopper (sm_90a): the two-dispatch engine's
// attention on dense K/V, for the chunked prefill on the scratch rows, the
// fresh full-width prefill and the dense-layout decode (Sq = 1).
//
// Replaces the forward of the Pallas TPU kernel `_flash_kernel` behind
// `_pallas_fwd` / `pallas_flash_attention`
// (src/repro/kernels/flash_attention.py).  It computes the same function:
//
//   * q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D), G = Hq / Hkv query heads per
//     KV head.  Query i of row b sits at position q_offset[b] + i.
//   * A key at position p is visible when p < kv_len[b] (clamped to Skv),
//     and, if causal, p <= q_offset[b] + i, and, with a sliding window,
//     q_offset[b] + i - p < window.
//   * f32 online softmax with the finite NEG_INF, so a row with no visible
//     key writes zeros, as the reference does.
//
// What bounds it on the H100: at decode (Sq = 1) bytes, every valid key's K
// and V once; at a 128-query prefill chunk the arithmetic, 4 D operations
// per visible query-key pair and head, which only the tensor cores run at
// the card's rate.  Two routes, chosen from the dtype and D alone:
//
//   * bf16 with D % 16 == 0 and D <= 128 (every served model's heads, and
//     the reduced configs' D = 16): the tensor-core walk of
//     attention_tc.cuh.  mma.sync m16n8k16 products on bf16 tiles staged by
//     cp.async in a 2-3 stage ring; blocks of 64 rows (4 warps x 16) for a
//     prefill chunk, of 16 rows with the warps splitting each tile's keys
//     for a decode (Sq G <= 16); and, where the (B Hkv, row block) grid
//     would leave the 132 SMs short, a split of each block's visible key
//     range over n_split blocks with a combine pass.  The wrapper's `_plan`
//     sizes block rows, n_split and the f32 scratch from the shapes.
//   * f32, and bf16 at any other D (a multiple of 8 up to 256): the
//     CUDA-core walk below, which serve_parity and the f32 checks hold
//     exactly.  Grid (B * Hkv, ceil(Sq * G / (4 kR))); a block owns 4 kR
//     flattened (query i, head g) rows of one batch row and one KV head
//     (row r is query r / G, head h * G + r % G), each of the 4 warps kR of
//     them (kR = 4 for prefill; a decode takes the smallest kR with
//     4 kR >= G).  The Pallas grid's sequential kv axis becomes a loop over
//     32-key tiles inside the block, K/V widened to f32 in shared memory and
//     dot products on the CUDA cores.  The walk starts at the window's lower
//     bound for the block's first query and stops at the causal bound of
//     its last, so tiles outside both are never read.

#include "attention_common.cuh"
#include "attention_tc.cuh"

namespace {

using namespace attn;

// kC = ceil(D / 32); kR = rows per warp
template <typename T, int kC, int kR>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       const int* __restrict__ kv_len,
                       const int* __restrict__ q_offset, int sq, int skv,
                       int hq, int hkv, int d, int causal, int window,
                       float sm_scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kBlockM = kWarps * kR;

  const int g = hq / hkv;
  const int b = blockIdx.x / hkv;
  const int h = blockIdx.x % hkv;
  const int row0 = blockIdx.y * kBlockM;
  const int row_end = min(row0 + kBlockM, sq * g);
  if (row0 >= row_end) return;
  const int kl = min(max(kv_len[b], 0), skv);
  const int qo = q_offset[b];
  const int first_q = row0 / g;
  const int last_q = (row_end - 1) / g;
  // keys any row of the block can see: [lo, hi), lo on a tile boundary
  int hi = kl;
  if (causal) hi = min(hi, qo + last_q + 1);
  int lo = 0;
  if (window > 0) lo = max(0, qo + first_q - window + 1) / kTileN * kTileN;

  float* q_s = smem;                     // (kBlockM, d)
  float* k_s = q_s + kBlockM * d;        // (kTileN, d + 4)
  float* v_s = k_s + kTileN * (d + 4);   // (kTileN, d)

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
      load16(q + (((size_t)b * sq + i) * hq + head) * d + c, dst);
    } else {
      zero16<T>(dst);
    }
  }
  __syncthreads();

  Rows<kR, kC> st;
  st.init();
  const int wrow0 = row0 + warp * kR;  // this warp's first row
  const bool warp_live = wrow0 < row_end;

  TileStage<T, kC> stage;
  auto fetch = [&](int base) {
    stage.fetch(k, v, d, tid, [=](int t) -> long long {
      const int pos = base + t;
      return pos < hi ? (((long long)b * skv + pos) * hkv + h) * d : -1;
    });
  };

  if (lo < hi) fetch(lo);
  for (int base = lo; base < hi; base += kTileN) {
    __syncthreads();  // every warp is done with the previous tile
    stage.stash(k_s, v_s, d, tid);
    __syncthreads();  // the tile at `base` is in shared memory
    if (base + kTileN < hi) fetch(base + kTileN);
    if (!warp_live) continue;
    const int pos = base + lane;
    st.update(q_s + warp * kR * d, k_s, v_s, d, lane, min(kTileN, hi - base),
              sm_scale, [=](int r, int) {
                const int row = wrow0 + r;
                const int qpos = qo + row / g;
                return row < row_end && pos < hi
                       && (!causal || pos <= qpos)
                       && (window <= 0 || qpos - pos < window);
              });
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int row = wrow0 + r;
    if (row >= row_end) break;
    const int i = row / g;
    const int head = h * g + row % g;
    T* dst = out + (((size_t)b * sq + i) * hq + head) * d;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int dd = lane + 32 * c;
      if (dd < d) store(dst + dd, st.out(r, c));
    }
  }
}

template <typename T, int kC, int kR>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const void* kv_len, const void* q_offset, int b, int sq,
                   int skv, int hq, int hkv, int d, int causal, int window,
                   float sm_scale, cudaStream_t stream) {
  constexpr int kBlockM = kWarps * kR;
  const size_t smem = sizeof(float) * smem_floats(kBlockM, d);
  auto kernel = flash_attention_kernel<T, kC, kR>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int rows = sq * (hq / hkv);
  dim3 grid(b * hkv, (rows + kBlockM - 1) / kBlockM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<const int*>(kv_len), static_cast<const int*>(q_offset), sq,
      skv, hq, hkv, d, causal, window, sm_scale);
  return cudaGetLastError();
}

template <typename T, int kC>
cudaError_t launch_r(int rows, const void* q, const void* k, const void* v,
                     void* out, const void* kv_len, const void* q_offset,
                     int b, int sq, int skv, int hq, int hkv, int d,
                     int causal, int window, float sm_scale,
                     cudaStream_t stream) {
#define FA_LAUNCH(R)                                                      \
  return launch<T, kC, R>(q, k, v, out, kv_len, q_offset, b, sq, skv, hq, \
                          hkv, d, causal, window, sm_scale, stream)
  if (rows <= 4) FA_LAUNCH(1);
  if (rows <= 8) FA_LAUNCH(2);
  FA_LAUNCH(4);
#undef FA_LAUNCH
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     void* out, const void* kv_len, const void* q_offset,
                     int b, int sq, int skv, int hq, int hkv, int causal,
                     int window, float sm_scale, cudaStream_t stream) {
  const int rows = sq * (hq / hkv);
#define FA_LAUNCH_D(C)                                                   \
  return launch_r<T, C>(rows, q, k, v, out, kv_len, q_offset, b, sq, skv, \
                        hq, hkv, d, causal, window, sm_scale, stream)
  if (d <= 32) FA_LAUNCH_D(1);
  if (d <= 64) FA_LAUNCH_D(2);
  if (d <= 128) FA_LAUNCH_D(4);
  FA_LAUNCH_D(8);
#undef FA_LAUNCH_D
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16; kv_len and q_offset are (B,) int32; window <= 0 means no
// sliding window.  Every pointer is a device pointer of a contiguous
// tensor; the launches go on `stream` and nothing is synchronised.
// block_rows and n_split: the tensor-core route's row block (16 or 64) and
// key split, from the wrapper's `_plan`; with n_split > 1, m_part/l_part
// hold B * Hkv * ceil(Sq G / block_rows) * n_split * block_rows floats and
// acc_part that times D (else they may be null).  The CUDA-core route takes
// n_split == 1.  Returns the cudaError_t of the launches (0 = cudaSuccess).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out,
    const void* kv_len, const void* q_offset, void* m_part, void* l_part,
    void* acc_part, int b, int sq, int skv, int hq, int hkv, int d,
    int causal, int window, int dtype, int block_rows, int n_split,
    float sm_scale, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || d <= 0 || d > 256 || d % 8 != 0
      || sq < 0 || skv < 0 || n_split < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0 || sq == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (attn_tc::takes_walk(dtype, d)) {
    attn_tc::Params p;
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.k = static_cast<const __nv_bfloat16*>(k);
    p.v = static_cast<const __nv_bfloat16*>(v);
    p.out = static_cast<__nv_bfloat16*>(out);
    p.m_part = static_cast<float*>(m_part);
    p.l_part = static_cast<float*>(l_part);
    p.acc_part = static_cast<float*>(acc_part);
    p.kv_len = static_cast<const int*>(kv_len);
    p.q_offset = static_cast<const int*>(q_offset);
    p.sq = sq;
    p.skv = skv;
    p.hq = hq;
    p.hkv = hkv;
    p.causal = causal;
    p.window = window;
    p.n_split = n_split;
    p.scale_log2 = sm_scale * attn_tc::kLog2e;
    return (int)attn_tc::launch<attn_tc::DenseKV>(p, b, d, block_rows, st);
  }
  if (n_split != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 0) {
    err = launch_d<float>(d, q, k, v, out, kv_len, q_offset, b, sq, skv, hq,
                          hkv, causal, window, sm_scale, st);
  } else if (dtype == 1) {
    err = launch_d<__nv_bfloat16>(d, q, k, v, out, kv_len, q_offset, b, sq,
                                  skv, hq, hkv, causal, window, sm_scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
