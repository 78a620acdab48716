// Flash attention backward for Hopper (sm_90a): the gradients of the flash
// forward (flash_attention.cu) that training takes through
// kernels/ops.py's FlashAttention autograd function.
//
// Replaces the backward of the Pallas TPU kernel's custom_vjp,
// flash_jnp._bwd_core (src/repro/kernels/flash_jnp.py), which
// pallas_flash_attention (src/repro/kernels/flash_attention.py) runs as
// its backward.  It computes the same function, FlashAttention-2's
// recompute scheme:
//
//   * q, o, do (B, Sq, Hq, D); k, v (B, Skv, Hkv, D); lse (B, Hq, Sq) f32,
//     the forward's log-sum-exp of each row's scaled scores.  G = Hq / Hkv
//     query heads share a KV head.  Query i of row b sits at q_offset[b] +
//     i; a key at p is visible when p < kv_len[b] (clamped to Skv), p <=
//     q_offset[b] + i if causal, and q_offset[b] + i - p < window with a
//     sliding window (window <= 0: none), as in the forward.
//   * P = exp(scale q.k - lse) on visible pairs and 0 elsewhere (so a row
//     with no visible key, lse = NEG_INF, has zero gradients);
//     delta = rowsum(o * do); dP = do . v; dS = P (dP - delta) scale;
//     dq = dS k, dk = sum over the G heads of dS^T q, dv = the same of
//     P^T do.
//
// Two passes, deterministic, with no atomics (so that a restarted run
// retraces the uninterrupted one's weights on the card):
//
//   * dq pass: grid (B * Hkv, ceil(Sq G / 64)), one block per 64
//     flattened (query i, head g) rows of one batch row and KV head (row r
//     is query r / G, head h * G + r % G, as in the forward).  It writes
//     delta of its rows (scratch the wrapper allocates, (B, Hq, Sq) f32),
//     then walks the 64-key tiles its rows can see, from the window's
//     lower bound of its first query to the causal bound of its last, and
//     accumulates dq in registers.
//   * dk/dv pass (after the dq pass on the same stream, which wrote
//     delta): grid (B * Hkv, ceil(Skv / 64)), one block per 64 keys of one
//     KV head.  It walks the 64-row tiles of the G heads' queries that can
//     see its keys (from the causal bound of its first key to the window's
//     bound of its last) and accumulates dk and dv in registers.
//
// What bounds it on the H100: at training shapes the operations, 10 D per
// visible query-key pair and query head (the five products: S and dP
// twice, dq, dk, dv), which only the tensor cores run at the card's rate.
// Two routes, chosen from the dtype and D alone (the forward's rule):
//
//   * bf16 with D % 16 == 0 and D <= 128: mma.sync m16n8k16 products (bf16
//     in, f32 accumulators) on bf16 tiles that cp.async stages in shared
//     memory, rows padded by 8 bf16 so ldmatrix reads hit distinct banks.
//     4 warps a block, each owning 16 rows (dq pass) or 16 keys (dk/dv
//     pass); S and dP stay in registers, and P and dS go from the
//     accumulator layout straight into A fragments, split into a bf16
//     high and low part (both through the tensor cores, so they keep about
//     16 bits, as the forward's P does).  Each staged 64-key (or 64-row)
//     tile is walked in two halves of 32 to bound the registers.
//   * f32, and bf16 at any other D: the CUDA cores in f32 (bf16 widened as
//     it is staged).  Every operand tile is staged once in shared memory as
//     f32 in rows of D + 4 floats (so the 16-byte loads of 8 neighbouring
//     rows fall in distinct banks), and each thread computes a 4 x 4 tile
//     of a product from 16-byte loads, so a loaded value feeds four
//     multiply-adds.

#include "attention_common.cuh"
#include "mma_ptx.cuh"

#include <type_traits>

namespace {

using namespace mma_ptx;

using attn::load16;
using attn::zero16;

constexpr int kRowsB = 64;   // query rows of a tile
constexpr int kKeysB = 64;   // keys of a tile
constexpr int kNT = 256;     // threads: 16 x 16, each a 4 x 4 product tile
constexpr int kPT = kRowsB + 4;  // stride of the P / dS tiles (floats)

template <typename T>
struct Problem {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  const float* lse;   // (B, Hq, Sq)
  float* delta;       // (B, Hq, Sq) scratch: written by pass 1
  T* dq;
  T* dk;
  T* dv;
  const int* kv_len;    // (B,)
  const int* q_offset;  // (B,)
  int sq, skv, hq, hkv, d, causal, window;
  float scale;
};

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float s, const float4 x) {
  acc.x += s * x.x;
  acc.y += s * x.y;
  acc.z += s * x.z;
  acc.w += s * x.w;
}

__device__ __forceinline__ void put4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

__device__ __forceinline__ void put4(__nv_bfloat16* dst, float4 x) {
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dst);
  out[0] = __floats2bfloat162_rn(x.x, x.y);
  out[1] = __floats2bfloat162_rn(x.z, x.w);
}

// Element offset of flattened row `row` of (b, h) in q, o, do and dq
template <typename T>
__device__ __forceinline__ size_t q_row(const Problem<T>& p, int b, int h,
                                        int row) {
  const int g = p.hq / p.hkv;
  return (((size_t)b * p.sq + row / g) * p.hq + h * g + row % g) * p.d;
}

// Index of flattened row `row` of (b, h) in lse and delta
template <typename T>
__device__ __forceinline__ size_t lse_row(const Problem<T>& p, int b, int h,
                                          int row) {
  const int g = p.hq / p.hkv;
  return ((size_t)b * p.hq + h * g + row % g) * p.sq + row / g;
}

// May the query of flattened row `row` see the key at `pos`?
template <typename T>
__device__ __forceinline__ bool visible(const Problem<T>& p, int row,
                                        int n_rows, int pos, int kl,
                                        int qo) {
  const int qpos = qo + row / (p.hq / p.hkv);
  return row < n_rows && pos >= 0 && pos < kl
         && (!p.causal || pos <= qpos)
         && (p.window <= 0 || qpos - pos < p.window);
}

// Stage 64 rows of a (.., D) tensor into shared memory as f32 rows of
// ld = D + 4; off(r) is row r's element offset, or negative for a row
// read as zeros.
template <typename T, typename Off>
__device__ __forceinline__ void stage(float* dst, const T* src, int d,
                                      int ld, int tid, Off off) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = d / kVec;
  for (int idx = tid; idx < 64 * vpr; idx += kNT) {
    const int r = idx / vpr;
    const int c = (idx % vpr) * kVec;
    const long long o = off(r);
    if (o >= 0) {
      load16(src + o + c, dst + r * ld + c);
    } else {
      zero16<T>(dst + r * ld + c);
    }
  }
}

// a[4][4] += rows (4 of A, stride ld, from ra) . rows (4 of B, 16 apart,
// from rb), over d: the 4 x 4 product tile of one thread
__device__ __forceinline__ void tile_dots(float (&acc)[4][4], const float* a,
                                          const float* b, int ld, int d) {
  for (int c = 0; c < d; c += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + i * ld + c);
      bv[i] = *reinterpret_cast<const float4*>(b + 16 * i * ld + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += dot4(av[i], bv[j]);
  }
}

// ---------------------------------------------------------------------------
// Pass 1: delta and dq.  Thread (tr, tc) = (tid / 16, tid % 16) owns rows
// 4 tr .. 4 tr + 3 of the block and, of each 64-key tile, keys tc + 16 j;
// for dq it owns the same rows and the float4 columns tc + 16 jj.
// ---------------------------------------------------------------------------

template <typename T, int kJ>
__global__ void __launch_bounds__(kNT)
flash_bwd_dq_kernel(const Problem<T> p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int d = p.d;
  const int ld = d + 4;
  float* q_s = sm;                       // (64, ld)
  float* do_s = q_s + kRowsB * ld;       // (64, ld)
  float* k_s = do_s + kRowsB * ld;       // (64, ld); o while delta forms
  float* v_s = k_s + kKeysB * ld;        // (64, ld)
  float* ds_s = v_s + kKeysB * ld;       // (64 rows, kPT)
  float* lse_s = ds_s + kRowsB * kPT;    // (64)
  float* dl_s = lse_s + kRowsB;          // (64)

  const int g = p.hq / p.hkv;
  const int b = blockIdx.x / p.hkv;
  const int h = blockIdx.x % p.hkv;
  const int n_rows = p.sq * g;
  const int row0 = blockIdx.y * kRowsB;
  if (row0 >= n_rows) return;
  const int row_end = min(row0 + kRowsB, n_rows);
  const int kl = min(max(p.kv_len[b], 0), p.skv);
  const int qo = p.q_offset[b];
  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;

  auto row_off = [&](int r) -> long long {
    return row0 + r < row_end ? (long long)q_row(p, b, h, row0 + r) : -1;
  };
  stage(q_s, p.q, d, ld, tid, row_off);
  stage(do_s, p.dout, d, ld, tid, row_off);
  stage(k_s, p.o, d, ld, tid, row_off);
  for (int r = tid; r < kRowsB; r += kNT) {
    lse_s[r] = row0 + r < row_end ? p.lse[lse_row(p, b, h, row0 + r)] : 0.f;
  }
  __syncthreads();
  {  // delta = rowsum(o do): 4 threads a row
    const int r = tid / 4;
    float s = 0.f;
    for (int c = tid % 4; c < d; c += 4) {
      s += k_s[r * ld + c] * do_s[r * ld + c];
    }
    s += __shfl_xor_sync(attn::kFull, s, 1);
    s += __shfl_xor_sync(attn::kFull, s, 2);
    if (tid % 4 == 0) {
      dl_s[r] = s;
      if (row0 + r < row_end) p.delta[lse_row(p, b, h, row0 + r)] = s;
    }
  }

  // keys any row of the block can see: [lo, hi)
  const int first_q = row0 / g;
  const int last_q = (row_end - 1) / g;
  int hi = kl;
  if (p.causal) hi = min(hi, qo + last_q + 1);
  int lo = 0;
  if (p.window > 0) lo = max(0, qo + first_q - p.window + 1);

  float4 acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      acc[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  for (int base = lo; base < hi; base += kKeysB) {
    __syncthreads();  // every thread is done with the last tile (and o)
    auto key_off = [&](int t) -> long long {
      const int pos = base + t;
      return pos < hi
                 ? (((long long)b * p.skv + pos) * p.hkv + h) * d
                 : -1;
    };
    stage(k_s, p.k, d, ld, tid, key_off);
    stage(v_s, p.v, d, ld, tid, key_off);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dots(s, q_s + 4 * tr * ld, k_s + tc * ld, ld, d);
    tile_dots(dp, do_s + 4 * tr * ld, v_s + tc * ld, ld, d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * tr + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = tc + 16 * j;
        const bool ok = visible(p, row0 + r, row_end, base + t, hi, qo);
        const float pv = ok ? expf(s[i][j] * p.scale - lse_s[r]) : 0.f;
        ds_s[r * kPT + t] = pv * (dp[i][j] - dl_s[r]) * p.scale;
      }
    }
    __syncthreads();
    for (int t = 0; t < kKeysB; ++t) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds_s[(4 * tr + i) * kPT + t];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int c = 4 * (tc + 16 * jj);
        if (c < d) {
          const float4 kv =
              *reinterpret_cast<const float4*>(k_s + t * ld + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) fma4(acc[i][jj], dsv[i], kv);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * tr + i;
    if (row >= row_end) continue;
    T* dst = p.dq + q_row(p, b, h, row);
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int c = 4 * (tc + 16 * jj);
      if (c < d) put4(dst + c, acc[i][jj]);
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 2: dk and dv.  Thread (tr, tc) owns keys 4 tr .. 4 tr + 3 of the
// block and, of each 64-row tile, rows tc + 16 j; for dk and dv the same
// keys and the float4 columns tc + 16 jj.
// ---------------------------------------------------------------------------

template <typename T, int kJ>
__global__ void __launch_bounds__(kNT)
flash_bwd_dkv_kernel(const Problem<T> p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int d = p.d;
  const int ld = d + 4;
  float* k_s = sm;                       // (64 keys, ld)
  float* v_s = k_s + kKeysB * ld;        // (64 keys, ld)
  float* q_s = v_s + kKeysB * ld;        // (64 rows, ld)
  float* do_s = q_s + kRowsB * ld;       // (64 rows, ld)
  float* p_s = do_s + kRowsB * ld;       // (64 keys, kPT)
  float* ds_s = p_s + kKeysB * kPT;      // (64 keys, kPT)
  float* lse_s = ds_s + kKeysB * kPT;    // (64 rows)
  float* dl_s = lse_s + kRowsB;          // (64 rows)

  const int g = p.hq / p.hkv;
  const int b = blockIdx.x / p.hkv;
  const int h = blockIdx.x % p.hkv;
  const int k0 = blockIdx.y * kKeysB;
  const int kl = min(max(p.kv_len[b], 0), p.skv);
  const int qo = p.q_offset[b];
  const int n_rows = p.sq * g;
  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;

  auto key_off = [&](int t) -> long long {
    const int pos = k0 + t;
    return pos < kl ? (((long long)b * p.skv + pos) * p.hkv + h) * d : -1;
  };
  stage(k_s, p.k, d, ld, tid, key_off);
  stage(v_s, p.v, d, ld, tid, key_off);

  // the rows that can see a key of the block: [r_lo, r_hi)
  const int k_last = min(k0 + kKeysB, kl) - 1;
  int r_lo = 0, r_hi = 0;
  if (k_last >= k0) {
    const int i_lo = p.causal ? max(0, k0 - qo) : 0;
    int i_hi = p.sq;
    if (p.window > 0) i_hi = min(i_hi, max(0, k_last - qo + p.window));
    r_lo = min(i_lo, p.sq) * g;
    r_hi = max(r_lo, i_hi * g);
  }

  float4 adk[4][kJ], adv[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      adk[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);
      adv[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  for (int rb = r_lo; rb < r_hi; rb += kRowsB) {
    __syncthreads();  // every thread is done with the last row tile
    auto row_off = [&](int r) -> long long {
      return rb + r < r_hi ? (long long)q_row(p, b, h, rb + r) : -1;
    };
    stage(q_s, p.q, d, ld, tid, row_off);
    stage(do_s, p.dout, d, ld, tid, row_off);
    for (int r = tid; r < kRowsB; r += kNT) {
      const bool live = rb + r < r_hi;
      lse_s[r] = live ? p.lse[lse_row(p, b, h, rb + r)] : 0.f;
      dl_s[r] = live ? p.delta[lse_row(p, b, h, rb + r)] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dots(s, k_s + 4 * tr * ld, q_s + tc * ld, ld, d);
    tile_dots(dp, v_s + 4 * tr * ld, do_s + tc * ld, ld, d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = 4 * tr + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tc + 16 * j;
        const bool ok = visible(p, rb + r, min(r_hi, n_rows), k0 + key, kl,
                                qo);
        const float pv = ok ? expf(s[i][j] * p.scale - lse_s[r]) : 0.f;
        p_s[key * kPT + r] = pv;
        ds_s[key * kPT + r] = pv * (dp[i][j] - dl_s[r]) * p.scale;
      }
    }
    __syncthreads();
    for (int r = 0; r < kRowsB; ++r) {
      float pk[4], dsk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = p_s[(4 * tr + i) * kPT + r];
        dsk[i] = ds_s[(4 * tr + i) * kPT + r];
      }
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int c = 4 * (tc + 16 * jj);
        if (c < d) {
          const float4 dov =
              *reinterpret_cast<const float4*>(do_s + r * ld + c);
          const float4 qv =
              *reinterpret_cast<const float4*>(q_s + r * ld + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            fma4(adv[i][jj], pk[i], dov);
            fma4(adk[i][jj], dsk[i], qv);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = k0 + 4 * tr + i;
    if (pos >= p.skv) continue;
    const size_t off = (((size_t)b * p.skv + pos) * p.hkv + h) * d;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int c = 4 * (tc + 16 * jj);
      if (c < d) {
        put4(p.dk + off + c, adk[i][jj]);
        put4(p.dv + off + c, adv[i][jj]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core route (bf16, D % 16 == 0, D <= 128): 4 warps a block.
// m16n8k16 fragments: a thread (g, t) = (lane / 4, lane % 4) holds of each
// 16 x 8 accumulator tile rows g and g + 8, columns 2 t and 2 t + 1.
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int kTcThreads = 128;
constexpr int kTcTile = 64;  // rows of a dq block, keys of a dk/dv block
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr size_t tc_smem(int d) {
  // four staged (64, D + 8) bf16 tiles, then lse (log2 units) and delta
  return sizeof(bf16) * 4 * (size_t)kTcTile * (d + 8)
         + sizeof(float) * 2 * kTcTile;
}

// The A fragments (high and low bf16 parts) of a 16 x 16 operand held as
// two 16 x 8 accumulator tiles c0 (columns 0-7) and c1 (columns 8-15)
__device__ __forceinline__ void split_a(const float* c0, const float* c1,
                                        uint32_t* hi, uint32_t* lo) {
  const float src[4][2] = {{c0[0], c0[1]}, {c0[2], c0[3]},
                           {c1[0], c1[1]}, {c1[2], c1[3]}};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(src[i][0], src[i][1]);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(
        src[i][0] - __low2float(h), src[i][1] - __high2float(h));
    lo[i] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// acc (16 x D) += A (16 x 16, high + low parts) . B, B the 16 staged rows
// from `rows` of a (.., D + 8) bf16 tile read as (k = row, n = column):
// ldmatrix.trans
template <int D>
__device__ __forceinline__ void mma_rows(float (*acc)[4], const uint32_t* hi,
                                         const uint32_t* lo, const bf16* rows,
                                         int lane) {
  constexpr int kStride = D + 8;
#pragma unroll
  for (int dn = 0; dn < D / 16; ++dn) {
    uint32_t r[4];
    ldsm_x4_trans(r, rows + (lane % 8 + ((lane / 8) % 2) * 8) * kStride
                         + dn * 16 + (lane / 16) * 8);
    mma_bf16(acc[2 * dn], hi, r);
    mma_bf16(acc[2 * dn], lo, r);
    mma_bf16(acc[2 * dn + 1], hi, r + 2);
    mma_bf16(acc[2 * dn + 1], lo, r + 2);
  }
}

// c (16 x 32) += A . B^T: A the 16 staged rows from a_rows, B the 32 from
// b_rows, both (.., D + 8) bf16 tiles, over D
template <int D>
__device__ __forceinline__ void mma_nt32(float (*c)[4], const bf16* a_rows,
                                         const bf16* b_rows, int lane) {
  constexpr int kStride = D + 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    ldsm_x4(a, a_rows + (lane % 16) * kStride + kc * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      ldsm_x4(r, b_rows + (np * 16 + (lane / 16) * 8 + lane % 8) * kStride
                     + kc * 16 + ((lane / 8) % 2) * 8);
      mma_bf16(c[2 * np], a, r);
      mma_bf16(c[2 * np + 1], a, r + 2);
    }
  }
}

// Stage 64 rows of D bf16 with cp.async (zero-filled where off(r) < 0)
template <int D, typename Off>
__device__ __forceinline__ void stage_tc(bf16* dst, const bf16* src, int tid,
                                         Off off) {
  constexpr int kChunks = D / 8;
  for (int idx = tid; idx < kTcTile * kChunks; idx += kTcThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const long long o = off(r);
    cp_async16(dst + r * (D + 8) + c, o >= 0 ? src + o + c : src, o >= 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc_kernel(const Problem<bf16> p) {
  constexpr int kStride = D + 8;
  constexpr int kDN = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // (64 rows, kStride)
  bf16* do_s = q_s + kTcTile * kStride;
  bf16* k_s = do_s + kTcTile * kStride;  // (64 keys); o while delta forms
  bf16* v_s = k_s + kTcTile * kStride;
  float* lse_s = reinterpret_cast<float*>(v_s + kTcTile * kStride);
  float* dl_s = lse_s + kTcTile;

  const int g = p.hq / p.hkv;
  const int b = blockIdx.x / p.hkv;
  const int h = blockIdx.x % p.hkv;
  const int n_rows = p.sq * g;
  const int row0 = blockIdx.y * kTcTile;
  if (row0 >= n_rows) return;
  const int row_end = min(row0 + kTcTile, n_rows);
  const int kl = min(max(p.kv_len[b], 0), p.skv);
  const int qo = p.q_offset[b];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  auto row_off = [&](int r) -> long long {
    return row0 + r < row_end ? (long long)q_row(p, b, h, row0 + r) : -1;
  };
  stage_tc<D>(q_s, p.q, tid, row_off);
  stage_tc<D>(do_s, p.dout, tid, row_off);
  stage_tc<D>(k_s, p.o, tid, row_off);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  {  // delta = rowsum(o do), 2 threads a row; lse in log2 units
    const int r = tid / 2;
    float s = 0.f;
    for (int c = (tid % 2) * (D / 2); c < (tid % 2 + 1) * (D / 2); c += 2) {
      const float2 o2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(k_s + r * kStride + c));
      const float2 d2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(do_s + r * kStride + c));
      s += o2.x * d2.x + o2.y * d2.y;
    }
    s += __shfl_xor_sync(attn::kFull, s, 1);
    if (tid % 2 == 0) {
      const bool live = row0 + r < row_end;
      const size_t li = live ? lse_row(p, b, h, row0 + r) : 0;
      dl_s[r] = s;
      lse_s[r] = live ? p.lse[li] * kLog2e : 0.f;
      if (live) p.delta[li] = s;
    }
  }
  __syncthreads();

  const int wrow = warp * 16;
  const int fr = lane / 4;
  const int t = lane % 4;
  float lse2[2], dl[2];
  int qpos[2];
  bool live[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wrow + fr + 8 * hh;
    lse2[hh] = lse_s[r];
    dl[hh] = dl_s[r];
    live[hh] = row0 + r < row_end;
    qpos[hh] = qo + (row0 + r) / g;
  }
  const float scale_log2 = p.scale * kLog2e;

  const int first_q = row0 / g;
  const int last_q = (row_end - 1) / g;
  int hi = kl;
  if (p.causal) hi = min(hi, qo + last_q + 1);
  int lo = 0;
  if (p.window > 0) lo = max(0, qo + first_q - p.window + 1);

  float acc[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int base = lo; base < hi; base += kTcTile) {
    __syncthreads();  // every warp is done with the last tile (and o)
    auto key_off = [&](int k) -> long long {
      const int pos = base + k;
      return pos < hi ? (((long long)b * p.skv + pos) * p.hkv + h) * D : -1;
    };
    stage_tc<D>(k_s, p.k, tid, key_off);
    stage_tc<D>(v_s, p.v, tid, key_off);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kb = half * 32;
      if (base + kb >= hi) break;
      float s[4][4] = {}, dp[4][4] = {};
      mma_nt32<D>(s, q_s + wrow * kStride, k_s + kb * kStride, lane);
      mma_nt32<D>(dp, do_s + wrow * kStride, v_s + kb * kStride, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int hh = c >> 1;
          const int key = base + kb + 8 * j + 2 * t + (c & 1);
          const bool ok = live[hh] && key < hi
                          && (!p.causal || key <= qpos[hh])
                          && (p.window <= 0 || qpos[hh] - key < p.window);
          const float pv =
              ok ? exp2f(s[j][c] * scale_log2 - lse2[hh]) : 0.f;
          s[j][c] = pv * (dp[j][c] - dl[hh]) * p.scale;  // dS
        }
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        uint32_t ah[4], al[4];
        split_a(s[2 * kc], s[2 * kc + 1], ah, al);
        mma_rows<D>(acc, ah, al, k_s + (kb + 16 * kc) * kStride, lane);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!live[hh]) continue;
    bf16* dst = p.dq + q_row(p, b, h, row0 + wrow + fr + 8 * hh);
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * hh], acc[n][2 * hh + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_tc_kernel(const Problem<bf16> p) {
  constexpr int kStride = D + 8;
  constexpr int kDN = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // (64 keys, kStride)
  bf16* v_s = k_s + kTcTile * kStride;
  bf16* q_s = v_s + kTcTile * kStride;  // (64 rows, kStride)
  bf16* do_s = q_s + kTcTile * kStride;
  float* lse_s = reinterpret_cast<float*>(do_s + kTcTile * kStride);
  float* dl_s = lse_s + kTcTile;

  const int g = p.hq / p.hkv;
  const int b = blockIdx.x / p.hkv;
  const int h = blockIdx.x % p.hkv;
  const int k0 = blockIdx.y * kTcTile;
  const int kl = min(max(p.kv_len[b], 0), p.skv);
  const int qo = p.q_offset[b];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  auto key_off = [&](int k) -> long long {
    const int pos = k0 + k;
    return pos < kl ? (((long long)b * p.skv + pos) * p.hkv + h) * D : -1;
  };
  stage_tc<D>(k_s, p.k, tid, key_off);
  stage_tc<D>(v_s, p.v, tid, key_off);
  cp_async_commit();

  // the rows that can see a key of the block: [r_lo, r_hi)
  const int k_last = min(k0 + kTcTile, kl) - 1;
  int r_lo = 0, r_hi = 0;
  if (k_last >= k0) {
    const int i_lo = p.causal ? max(0, k0 - qo) : 0;
    int i_hi = p.sq;
    if (p.window > 0) i_hi = min(i_hi, max(0, k_last - qo + p.window));
    r_lo = min(i_lo, p.sq) * g;
    r_hi = max(r_lo, i_hi * g);
  }

  const int wkey = warp * 16;
  const int fr = lane / 4;
  const int t = lane % 4;
  const int kpos[2] = {k0 + wkey + fr, k0 + wkey + fr + 8};
  const float scale_log2 = p.scale * kLog2e;
  float dk[kDN][4], dv[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;

  for (int rb = r_lo; rb < r_hi; rb += kTcTile) {
    __syncthreads();  // every warp is done with the last row tile
    auto row_off = [&](int r) -> long long {
      return rb + r < r_hi ? (long long)q_row(p, b, h, rb + r) : -1;
    };
    stage_tc<D>(q_s, p.q, tid, row_off);
    stage_tc<D>(do_s, p.dout, tid, row_off);
    cp_async_commit();
    if (tid < kTcTile) {
      const bool live = rb + tid < r_hi;
      const size_t li = live ? lse_row(p, b, h, rb + tid) : 0;
      lse_s[tid] = live ? p.lse[li] * kLog2e : 0.f;
      dl_s[tid] = live ? p.delta[li] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rh = half * 32;
      if (rb + rh >= r_hi) break;
      float s[4][4] = {}, dp[4][4] = {};
      mma_nt32<D>(s, k_s + wkey * kStride, q_s + rh * kStride, lane);
      mma_nt32<D>(dp, v_s + wkey * kStride, do_s + rh * kStride, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int rl = rh + 8 * j + 2 * t + (c & 1);
          const int row = rb + rl;
          const int key = kpos[c >> 1];
          const int qp = qo + row / g;
          const bool ok = row < r_hi && key < kl
                          && (!p.causal || key <= qp)
                          && (p.window <= 0 || qp - key < p.window);
          s[j][c] = ok ? exp2f(s[j][c] * scale_log2 - lse_s[rl]) : 0.f;
        }
      // dV += P^T dO, then dS^T = P^T (dP^T - delta) scale, dK += dS^T Q
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        uint32_t ah[4], al[4];
        split_a(s[2 * kc], s[2 * kc + 1], ah, al);
        mma_rows<D>(dv, ah, al, do_s + (rh + 16 * kc) * kStride, lane);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int rl = rh + 8 * j + 2 * t + (c & 1);
          s[j][c] *= (dp[j][c] - dl_s[rl]) * p.scale;
        }
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        uint32_t ah[4], al[4];
        split_a(s[2 * kc], s[2 * kc + 1], ah, al);
        mma_rows<D>(dk, ah, al, q_s + (rh + 16 * kc) * kStride, lane);
      }
    }
  }
  cp_async_wait<0>();  // a block with no row tile still has its K/V copies

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (kpos[hh] >= p.skv) continue;
    const size_t off = (((size_t)b * p.skv + kpos[hh]) * p.hkv + h) * D;
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(p.dk + off + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dk[n][2 * hh], dk[n][2 * hh + 1]);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + off + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dv[n][2 * hh], dv[n][2 * hh + 1]);
    }
  }
}

template <int D>
cudaError_t launch_tc(const Problem<bf16>& p, int b, cudaStream_t stream) {
  const size_t smem = tc_smem(D);
  auto k1 = flash_bwd_dq_tc_kernel<D>;
  auto k2 = flash_bwd_dkv_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = p.sq * (p.hq / p.hkv);
  if (rows > 0) {
    const dim3 grid(b * p.hkv, (rows + kTcTile - 1) / kTcTile);
    k1<<<grid, kTcThreads, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.skv > 0) {
    const dim3 grid(b * p.hkv, (p.skv + kTcTile - 1) / kTcTile);
    k2<<<grid, kTcThreads, smem, stream>>>(p);
    err = cudaGetLastError();
  }
  return err;
}

// Does (dtype, d) take the tensor-core route?  bf16 (dtype 1) with d a
// multiple of 16 up to 128, the forward's rule (kernels/attention_tc.py)
inline bool takes_tc(int dtype, int d) {
  return dtype == 1 && d % 16 == 0 && d >= 16 && d <= 128;
}

__host__ constexpr size_t smem_dq(int d) {
  return sizeof(float) * ((size_t)(2 * kRowsB + 2 * kKeysB) * (d + 4)
                          + (size_t)kRowsB * kPT + 2 * kRowsB);
}

__host__ constexpr size_t smem_dkv(int d) {
  return sizeof(float) * ((size_t)(2 * kRowsB + 2 * kKeysB) * (d + 4)
                          + 2 * (size_t)kKeysB * kPT + 2 * kRowsB);
}

template <typename T, int kJ>
cudaError_t launch(const Problem<T>& p, int b, cudaStream_t stream) {
  const size_t s1 = smem_dq(p.d), s2 = smem_dkv(p.d);
  auto k1 = flash_bwd_dq_kernel<T, kJ>;
  auto k2 = flash_bwd_dkv_kernel<T, kJ>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return err;
  const int rows = p.sq * (p.hq / p.hkv);
  if (rows > 0) {
    const dim3 grid(b * p.hkv, (rows + kRowsB - 1) / kRowsB);
    k1<<<grid, kNT, s1, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.skv > 0) {
    const dim3 grid(b * p.hkv, (p.skv + kKeysB - 1) / kKeysB);
    k2<<<grid, kNT, s2, stream>>>(p);
    err = cudaGetLastError();
  }
  return err;
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     void* delta, void* dq, void* dk, void* dv,
                     const void* kv_len, const void* q_offset, int b, int sq,
                     int skv, int hq, int hkv, int d, int causal, int window,
                     float sm_scale, cudaStream_t stream) {
  Problem<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<const T*>(o);
  p.dout = static_cast<const T*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<T*>(dq);
  p.dk = static_cast<T*>(dk);
  p.dv = static_cast<T*>(dv);
  p.kv_len = static_cast<const int*>(kv_len);
  p.q_offset = static_cast<const int*>(q_offset);
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.hkv = hkv;
  p.d = d;
  p.causal = causal;
  p.window = window;
  p.scale = sm_scale;
  if constexpr (std::is_same<T, bf16>::value) {
    switch (takes_tc(1, d) ? d : 0) {
      case 16: return launch_tc<16>(p, b, stream);
      case 32: return launch_tc<32>(p, b, stream);
      case 48: return launch_tc<48>(p, b, stream);
      case 64: return launch_tc<64>(p, b, stream);
      case 80: return launch_tc<80>(p, b, stream);
      case 96: return launch_tc<96>(p, b, stream);
      case 112: return launch_tc<112>(p, b, stream);
      case 128: return launch_tc<128>(p, b, stream);
      default: break;
    }
  }
  if (d <= 64) return launch<T, 1>(p, b, stream);
  return launch<T, 2>(p, b, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16; q, o, do, dq (B, Sq, Hq, D), k, v, dk, dv (B, Skv, Hkv, D)
// in that dtype; lse and delta (B, Hq, Sq) float32 (delta is scratch the
// call fills); kv_len and q_offset (B,) int32; window <= 0 means no sliding
// window.  Every pointer is a device pointer of a contiguous tensor, 16-byte
// aligned; D is a multiple of 8 up to 128.  bf16 at D % 16 == 0 takes the
// tensor-core route, everything else the CUDA-core one (the wrapper's
// route names the same rule).  The two passes go on `stream` in order and
// nothing is synchronised.  Returns the cudaError_t of the
// launches (0 = cudaSuccess).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const void* kv_len, const void* q_offset, int b, int sq,
    int skv, int hq, int hkv, int d, int causal, int window, int dtype,
    float sm_scale, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || d <= 0 || d > 128 || d % 8 != 0
      || sq < 0 || skv < 0 || b < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_t<float>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                kv_len, q_offset, b, sq, skv, hq, hkv, d,
                                causal, window, sm_scale, st);
  }
  if (dtype == 1) {
    return (int)launch_t<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq,
                                        dk, dv, kv_len, q_offset, b, sq, skv,
                                        hq, hkv, d, causal, window, sm_scale,
                                        st);
  }
  return (int)cudaErrorInvalidValue;
}
