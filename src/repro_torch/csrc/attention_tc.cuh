// The bf16 tensor-core tile walk of four kernels for Hopper (sm_90a): the
// flash forward (flash_attention.cu) and the dense decode
// (decode_attention.cu) over dense K/V, the ragged paged attention
// (ragged_paged_attention.cu) and the paged decode
// (paged_decode_attention.cu) over the paged pools.
//
// Every one computes attention of flattened (query i, head-in-group) rows:
// row r of a (batch row b, KV head h) is query r / G, head h * G + r % G,
// so the G query heads of a KV head share every staged tile.  Query i sits
// at q_offset[b] + i; a key at p is visible when p < kv_len[b] (clamped to
// Skv), p <= q_offset[b] + i if causal, and q_offset[b] + i - p < window if
// window > 0.  The dense decode is the case Sq = 1, q_offset = lengths - 1,
// not causal, no window.  One template parameter says how keys and rows
// are addressed:
//
//   * DenseKV: K/V (B, Skv, Hkv, D), rows b * Sq + i of q and out.
//   * PagedKV: K/V in the pools (n_pool, Hkv, ps, D); key p of row b is row
//     p % ps of page page_table[b, p / ps], so its head h lies at pool row
//     (page Hkv + h) ps + p % ps.  A block reads the ids of the pages its
//     keys span into shared memory once.  Beside each ring slot it keeps a
//     table of the slot's 64 pool rows, which 64 threads fill (one division
//     by ps a key) one step before the tile's copies are issued; the copies
//     then run as the dense layout's do, one table read per 16-byte chunk.
//     Nothing assumes that ps divides the 64-key tile or the reverse.  (Per
//     chunk address arithmetic in the copy loop put a serial page lookup
//     on every tile's critical path: 1.7x the prefill time on the H100,
//     PERF.md.)  An id outside [0, n_pool) and any key at or past the
//     walk's bound are zero-filled, never read.  With q_start / q_len the
//     rows are packed (the ragged kernel): segment b owns rows
//     q_start[b] + i for i below its clamped q_len, query i at
//     kv_len[b] - q_len[b] + i, causal; a block past those rows returns at
//     once and no row past them is written, since the next segment's rows
//     follow.  Without them (the paged decode) the rows are b * Sq + i as
//     in the dense layout.
//
// What bounds it on the H100: at decode (a few rows per KV head) the bytes
// of K and V; at a prefill chunk (64+ rows per KV head) the 4 D operations
// per visible query-key pair, which the tensor cores run at 989 TFLOP/s.
// What the design does about it:
//
//   * Staging.  K/V tiles of kTileN = 64 keys stay bf16 in shared memory,
//     rows padded by 8 bf16 (16 bytes), so the 8 row addresses of every
//     ldmatrix phase fall in distinct banks.  cp.async.cg 16-byte copies
//     fill a ring of kStages tiles (2 at D > 64, 3 at D <= 64): tiles n+1
//     (and n+2) are in flight while tile n computes.  Keys at or past the
//     walk's upper bound are zero-filled (src-size 0), never read: a stale
//     NaN there cannot reach P V through 0 * NaN.
//   * Products.  S = Q K^T and O += P V with mma.sync m16n8k16 (bf16 in,
//     f32 accumulators).  Q's fragments are loaded once per block with
//     ldmatrix, K's with ldmatrix, V's with ldmatrix.trans.  P comes from
//     the S accumulators in registers (the m16n8 C layout is the m16k16 A
//     layout).  P is split into a bf16 high and a bf16 low part and both go
//     through the tensor cores, so P keeps about 16 bits: bf16 P alone
//     would add 2^-9 |p v| / l per element, over the bf16 check's 1e-4
//     floor for outputs near 0.
//   * Masks and softmax.  The mask is applied per S element (each thread's
//     two fragment rows have their own query position), and skipped for a
//     tile that every row of the warp sees whole.  The online softmax stays
//     in f32 registers, in base-2 units (scores times scale * log2 e), with
//     row max and row sum reduced over the quad that shares a row.  A
//     masked element gets p = 0 even when its row's running max is still
//     the finite kNegInf; a row with no visible key ends with l = 0 and
//     writes zeros.
//   * Two warp layouts.  Wide (prefill chunks): 64 rows a block, each of
//     the 4 warps owns 16 rows and walks every key of the block's range.
//     Narrow (decode): one 16-row tile a block (G <= 16 rows, padded); the
//     4 warps form key groups, each taking its own 16 keys of every staged
//     tile, and their partials merge through shared memory at the end.
//   * Key split.  Grid (B * Hkv, row blocks, n_split).  With n_split > 1
//     each block walks its share of the keys and writes unnormalised
//     (m, l, acc) partials to f32 scratch; attn_tc_combine_kernel rescales
//     them and writes the rows.  Each block's visible key range [lo, hi),
//     read on the device, is cut into n_split tile-aligned shares, for the
//     four kernels alike; n_split and the scratch size come from the shapes
//     alone (the shared plan, kernels/attention_tc.py), and a split whose
//     share is empty returns at once.

#pragma once

#include "mma_ptx.cuh"

namespace attn_tc {

using namespace mma_ptx;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileN = 64;   // keys per staged tile
constexpr int kPad = 8;      // bf16 of padding per staged row
constexpr int kMaxSplit = 32;
constexpr int kMaxRows = 64;  // rows of the wide layout
constexpr float kNegInf = -0.7f * 3.402823466e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// The problem and its key ranges
// ---------------------------------------------------------------------------

struct Params {
  const bf16* q;    // (B, Sq, Hq, D), or packed (T, Hq, D)
  const bf16* k;    // (B, Skv, Hkv, D), or the pool (n_pool, Hkv, ps, D)
  const bf16* v;
  bf16* out;        // as q
  float* m_part;    // (B * Hkv, row blocks, n_split, block rows)
  float* l_part;
  float* acc_part;  // the same, times D
  const int* kv_len;    // (B,)
  const int* q_offset;  // (B,), or null: the query sits at kv_len - 1
  int sq, skv, hq, hkv;
  int causal, window;  // window <= 0: none
  int n_split;       // 1..kMaxSplit shares of each block's visible keys
  float scale_log2;  // sm_scale * log2(e)
};

// The paged policy's problem: k and v are the pools (n_pool, Hkv, ps, D)
struct PagedParams : Params {
  // key p of row b is row p % ps of page page_table[b * max_pages + p / ps]
  // (skv = max_pages * ps); a page id outside [0, n_pool) reads as zeros
  const int* page_table;
  int ps, max_pages, n_pool;
  // packed rows, or null: row b owns packed rows q_start[b] + i for
  // i < min(q_len[b], sq, n_tokens - q_start[b]), query i sitting at
  // kv_len[b] - q_len[b] + i.  Null: rows b * sq + i, as in the dense
  // layout.
  const int* q_start;
  const int* q_len;
  int n_tokens;
};

// How keys and rows are addressed, and the kernels' parameter type.  The
// dense policy (flash, the dense decode) reads K/V as (B, Skv, Hkv, D);
// the paged one (the ragged kernel, the paged decode) reads them from the
// pools through the page table, and may pack its rows.  A kernel source
// passes its own type derived from one of them, so that its name tells a
// profile which caller ran.  (The dense kernels keep Params as it was:
// ptxas allocates their registers differently when the struct grows.)
struct DenseKV {
  static constexpr bool kPaged = false;
  using P = Params;
};
struct PagedKV {
  static constexpr bool kPaged = true;
  using P = PagedParams;
};

// Flattened rows of batch row (segment) b: Sq G, or G per packed query
template <class A>
__device__ __forceinline__ int row_count(const typename A::P& p, int b) {
  const int g = p.hq / p.hkv;
  if constexpr (A::kPaged) {
    if (p.q_len) {
      const int ql = min(min(p.q_len[b], p.sq), p.n_tokens - p.q_start[b]);
      return max(ql, 0) * g;
    }
  }
  return p.sq * g;
}

// The first query row of batch row (segment) b in q and out
template <class A>
__device__ __forceinline__ size_t first_row(const typename A::P& p, int b) {
  if constexpr (A::kPaged) {
    if (p.q_start) return (size_t)p.q_start[b];
  }
  return (size_t)b * p.sq;
}

// Keys [s0, s1) that split `split` of row block [row0, row_end) of batch
// row b walks (s0 on a tile boundary; empty when s0 >= s1), and the
// block's kv_len and query offset.  The combine kernel calls it too, so
// both passes agree on which splits hold a partial.
struct Range {
  int s0, s1, kl, qo;
};

template <class A>
__device__ __forceinline__ Range split_range(const typename A::P& p, int b,
                                             int row0, int row_end,
                                             int split) {
  const int g = p.hq / p.hkv;
  Range r;
  r.kl = min(max(p.kv_len[b], 0), p.skv);
  r.qo = p.q_offset ? p.q_offset[b] : r.kl - 1;
  if constexpr (A::kPaged) {
    if (p.q_len) r.qo = p.kv_len[b] - p.q_len[b];
  }
  // keys any row of the block can see: [lo, hi), lo on a tile boundary
  int hi = r.kl;
  if (p.causal) hi = min(hi, r.qo + (row_end - 1) / g + 1);
  int lo = 0;
  if (p.window > 0) lo = max(0, r.qo + row0 / g - p.window + 1);
  lo = lo / kTileN * kTileN;
  const int tiles = hi > lo ? (hi - lo + kTileN - 1) / kTileN : 0;
  const int share = (tiles + p.n_split - 1) / p.n_split * kTileN;
  r.s0 = lo + split * share;
  r.s1 = min(hi, r.s0 + share);
  return r;
}

__device__ __forceinline__ size_t part_index(const Params& p, int bh, int rb,
                                             int split, int block_rows,
                                             int r) {
  return (((size_t)bh * gridDim.y + rb) * p.n_split + split) * block_rows + r;
}

// ---------------------------------------------------------------------------
// One warp's online-softmax state over 16 rows, and its update by kKeys
// staged keys
// ---------------------------------------------------------------------------

template <int D, int kKeys>
struct Walk {
  static constexpr int kKC = D / 16;  // k16 steps of Q K^T
  static constexpr int kDN = D / 8;   // n8 tiles of O
  static constexpr int kSN = kKeys / 8;
  static constexpr int kStride = D + kPad;  // staged row, in bf16

  uint32_t qf[kKC][4];
  float o[kDN][4];  // fragment rows g ([0], [1]) and g + 8 ([2], [3])
  float m[2], l[2];  // l: this thread's share until `finish`

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < kDN; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // q_s: this warp's 16 staged query rows
  __device__ __forceinline__ void load_q(const bf16* q_s, int lane) {
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      ldsm_x4(qf[kc], q_s + (lane % 16) * kStride + kc * 16 + (lane / 16) * 8);
    }
  }

  // k_s/v_s: the first of this warp's kKeys staged rows, at key position
  // pos0; [lo0, hi0) and [lo1, hi1): the keys fragment rows g and g + 8
  // may see; full: every row of the warp sees every key here
  __device__ __forceinline__ void step(const bf16* k_s, const bf16* v_s,
                                       int lane, int pos0, int lo0, int hi0,
                                       int lo1, int hi1, bool full,
                                       float scale_log2) {
    float s[kSN][4];
#pragma unroll
    for (int j = 0; j < kSN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
#pragma unroll
      for (int np = 0; np < kKeys / 16; ++np) {
        // matrices: keys +0 / +8 of the pair of n8 tiles, depth +0 / +8
        uint32_t r[4];
        ldsm_x4(r, k_s + (np * 16 + (lane / 16) * 8 + lane % 8) * kStride
                       + kc * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kc], r);
        mma_bf16(s[2 * np + 1], qf[kc], r + 2);
      }
    }

    const int t = lane % 4;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kSN; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c / 2;
        float x = s[j][c] * scale_log2;
        if (!full) {
          const int pos = pos0 + 8 * j + 2 * t + (c & 1);
          const int lo = h ? lo1 : lo0;
          const int hi = h ? hi1 : hi0;
          if (pos < lo || pos >= hi) x = kNegInf;
        }
        s[j][c] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < kSN; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c / 2;
        // a masked element is exactly kNegInf: p = 0 even when the row's
        // max is still kNegInf
        const float pv = s[j][c] == kNegInf ? 0.f : exp2f(s[j][c] - m[h]);
        s[j][c] = pv;
        l[h] += pv;
      }
    }
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      // A fragments of P (keys 16 kc .. 16 kc + 15): high and low bf16
      uint32_t ph[4], pl[4];
      const float* s0 = s[2 * kc];
      const float* s1 = s[2 * kc + 1];
      const float src[4][2] = {{s0[0], s0[1]}, {s0[2], s0[3]},
                               {s1[0], s1[1]}, {s1[2], s1[3]}};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 hh =
            __floats2bfloat162_rn(src[i][0], src[i][1]);
        ph[i] = *reinterpret_cast<const uint32_t*>(&hh);
        pl[i] = pack_bf16(src[i][0] - __low2float(hh),
                          src[i][1] - __high2float(hh));
      }
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        // matrices: keys +0 / +8 of the k16 step, dims +0 / +8
        uint32_t r[4];
        ldsm_x4_trans(r, v_s + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8)
                               * kStride + dn * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * dn], ph, r);
        mma_bf16(o[2 * dn], pl, r);
        mma_bf16(o[2 * dn + 1], ph, r + 2);
        mma_bf16(o[2 * dn + 1], pl, r + 2);
      }
    }
  }

  // reduce l over the quad that shares each row
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(kFull, l[h], 1);
      l[h] += __shfl_xor_sync(kFull, l[h], 2);
    }
  }
};

// Shared memory of one block: block_rows staged query rows and the ring of
// kStages K and V tiles, all bf16 rows of D + kPad, then (paged policy)
// the page ids of the block's keys; after the walk the same bytes hold the
// key groups' partials while they merge.
__host__ __device__ constexpr size_t ring_bytes(int d, int block_rows,
                                                int stages) {
  return sizeof(bf16) * (size_t)(d + kPad)
         * ((size_t)block_rows + 2 * (size_t)stages * kTileN);
}

__host__ __device__ constexpr size_t merge_bytes(int d, int block_rows,
                                                 int groups) {
  // o (groups, rows, d); m, l, weights (groups, rows); 1/l, m, l (rows)
  return sizeof(float) * ((size_t)groups * block_rows * (d + 3)
                          + 3 * (size_t)block_rows);
}

// tables: ints after the ring (the paged policy's page ids and row tables)
__host__ __device__ constexpr size_t smem_bytes(int d, int block_rows,
                                                int stages, int groups,
                                                int tables = 0) {
  return groups > 1 && merge_bytes(d, block_rows, groups)
                           > ring_bytes(d, block_rows, stages)
                               + sizeof(int) * (size_t)tables
             ? merge_bytes(d, block_rows, groups)
             : ring_bytes(d, block_rows, stages)
                   + sizeof(int) * (size_t)tables;
}

// Page ids one block of the paged policy stages: its keys are a
// tile-aligned share of at most ceil(ceil(skv / kTileN) / n_split) tiles,
// which spans at most ceil(share / ps) + 1 pages
__host__ __device__ inline int block_pages(const PagedParams& p) {
  const int tiles = (p.skv + kTileN - 1) / kTileN;
  const int share = (tiles + p.n_split - 1) / p.n_split * kTileN;
  const int pages = (share + p.ps - 1) / p.ps + 1;
  return pages < p.max_pages ? pages : p.max_pages;
}

// Paged: thread tid < kTileN writes the pool row of key base + tid of a
// tile into its ring slot's table `rows`, ((page Hkv + h) ps + key % ps),
// or -1 for a key at or past s1 or on a page outside the pool; ids: the
// block's page ids from page0 on.  One division by ps a key.
__device__ __forceinline__ void stage_rows(const PagedParams& p, int* rows,
                                           const int* ids, int page0, int h,
                                           int s1, int base, int tid) {
  if (tid < kTileN) {
    const int pos = base + tid;
    const int id = pos < s1 ? ids[pos / p.ps - page0] : -1;
    rows[tid] = id < 0 ? -1 : (id * p.hkv + h) * p.ps + pos % p.ps;
  }
}

// Where a block row's output goes: row r of (b, h) is query r / g, head
// h g + r % g
__device__ __forceinline__ size_t out_offset(const Params& p, int b, int h,
                                             int row, int d) {
  const int g = p.hq / p.hkv;
  return (((size_t)b * p.sq + row / g) * p.hq + h * g + row % g) * d;
}

// The same for either policy: q0 is b's first row (first_row), which
// packed rows need
template <class A>
__device__ __forceinline__ size_t row_offset(const typename A::P& p, int b,
                                             size_t q0, int h, int row,
                                             int d) {
  if constexpr (A::kPaged) {
    const int g = p.hq / p.hkv;
    return ((q0 + row / g) * p.hq + h * g + row % g) * d;
  }
  return out_offset(p, b, h, row, d);
}

// Writes row `row` (block-local `r`) of a block: the normalised output
// when the block is the only split, else its unnormalised partial.
template <int D, class A>
__device__ __forceinline__ void put_pair(const typename A::P& p, int b,
                                         size_t q0,
                                         int h, int bh, int rb, int split,
                                         int block_rows, int row, int r,
                                         int dd, float x0, float x1,
                                         float inv_l) {
  if (p.n_split == 1) {
    *reinterpret_cast<__nv_bfloat162*>(
        p.out + row_offset<A>(p, b, q0, h, row, D) + dd) =
        __floats2bfloat162_rn(x0 * inv_l, x1 * inv_l);
  } else {
    *reinterpret_cast<float2*>(
        p.acc_part + part_index(p, bh, rb, split, block_rows, r) * D + dd) =
        make_float2(x0, x1);
  }
}

// ---------------------------------------------------------------------------
// The split pass: grid (B * Hkv, row blocks, n_split).  kRowWarps warps own
// 16 rows each (16 kRowWarps rows a block); kGroups groups of them each
// take 64 / kGroups keys of every staged tile and merge at the end.
// ---------------------------------------------------------------------------

template <int D, int kStages, int kRowWarps, int kGroups, class A>
__global__ void __launch_bounds__(32 * kRowWarps * kGroups)
attn_tc_split_kernel(const typename A::P p) {
  constexpr int kNThreads = 32 * kRowWarps * kGroups;
  constexpr int kStride = D + kPad;
  constexpr int kBlockRows = 16 * kRowWarps;
  constexpr int kWarpKeys = kTileN / kGroups;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kTileCopies = kTileN * kChunks;
  using W = Walk<D, kWarpKeys>;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // (kBlockRows, kStride)
  bf16* k_s = q_s + kBlockRows * kStride;  // (kStages, kTileN, kStride)
  bf16* v_s = k_s + kStages * kTileN * kStride;

  const int g = p.hq / p.hkv;
  const int bh = blockIdx.x;
  const int b = bh / p.hkv;
  const int h = bh % p.hkv;
  const int rb = blockIdx.y;
  const int split = blockIdx.z;
  const int row0 = rb * kBlockRows;
  const int row_end = min(row0 + kBlockRows, row_count<A>(p, b));
  if constexpr (A::kPaged) {
    // past a packed segment's rows: the rows that follow are another
    // segment's, so the block writes nothing (the combine skips it too)
    if (row0 >= row_end) return;
  }
  const Range rg = split_range<A>(p, b, row0, row_end, split);
  // an empty share holds no partial (the combine skips it); a lone split
  // still writes its rows (zeros)
  if (p.n_split > 1 && rg.s0 >= rg.s1) return;
  const int s0 = rg.s0;
  const int s1 = max(rg.s0, rg.s1);
  const size_t q0 = first_row<A>(p, b);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = warp / kRowWarps;
  const size_t kv_row = (size_t)p.hkv * D;  // elements between key rows
  // dense: row b's keys of head h; paged: the pools (rows from the tables)
  const bf16* kb =
      A::kPaged ? p.k : p.k + ((size_t)b * p.skv * p.hkv + h) * D;
  const bf16* vb =
      A::kPaged ? p.v : p.v + ((size_t)b * p.skv * p.hkv + h) * D;

  // the block's query rows (zeros past row_end)
  for (int idx = tid; idx < kBlockRows * kChunks; idx += kNThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int row = row0 + r;
    const bool ok = row < row_end;
    cp_async16(q_s + r * kStride + c,
               ok ? p.q + row_offset<A>(p, b, q0, h, row, D) + c : p.q,
               ok);
  }
  // paged: the ids of the pages that hold keys [s0, s1), once per block
  // (-1 for an id outside the pool: its keys are zero-filled), then a
  // table per ring slot of each staged key's head row in the pool,
  // ((page Hkv + h) ps + key % ps), or -1 for a key that is not read
  int* pt_s = reinterpret_cast<int*>(v_s + kStages * kTileN * kStride);
  int* row_s = pt_s;  // (kStages, kTileN), after the page ids
  int page0 = 0;  // the page of key s0
  if constexpr (A::kPaged) {
    row_s += block_pages(p);
    page0 = s0 / p.ps;
    const int n_pages = s1 > s0 ? (s1 - 1) / p.ps - page0 + 1 : 0;
    const int* ids = p.page_table + (size_t)b * p.max_pages + page0;
    for (int i = tid; i < n_pages; i += kNThreads) {
      const int id = ids[i];
      pt_s[i] = id < 0 || id >= p.n_pool ? -1 : id;
    }
    __syncthreads();
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      if (s0 + st * kTileN < s1) {
        stage_rows(p, row_s + st * kTileN, pt_s, page0, h, s1,
                   s0 + st * kTileN, tid);
      }
    }
    __syncthreads();
  }
  // stage the tile at key `base` into ring slot `slot`; keys >= s1 zero
  auto fetch = [&](int slot, int base) {
    bf16* kd = k_s + slot * kTileN * kStride;
    bf16* vd = v_s + slot * kTileN * kStride;
    const int* rows = row_s + slot * kTileN;  // paged: the slot's table
#pragma unroll
    for (int it = 0; it < (kTileCopies + kNThreads - 1) / kNThreads; ++it) {
      const int idx = tid + it * kNThreads;
      if (kTileCopies % kNThreads != 0 && idx >= kTileCopies) break;
      const int t = idx / kChunks;
      const int c = (idx % kChunks) * 8;
      bool ok;
      size_t off;
      if constexpr (A::kPaged) {  // the key's pool row (stage_rows)
        const int row = rows[t];
        ok = row >= 0;
        off = ok ? (size_t)row * D + c : 0;
      } else {
        const int pos = base + t;
        ok = pos < s1;
        off = ok ? (size_t)pos * kv_row + c : 0;
      }
      cp_async16(kd + t * kStride + c, kb + off, ok);
      cp_async16(vd + t * kStride + c, vb + off, ok);
    }
  };

  const int n_tiles = (s1 - s0 + kTileN - 1) / kTileN;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) fetch(st, s0 + st * kTileN);
    cp_async_commit();  // the first group carries the query rows too
  }

  // this thread's two fragment rows and the keys each may see
  const int wrow = (warp % kRowWarps) * 16;  // warp's first block row
  const int frow = wrow + lane / 4;          // fragment row g
  int lo[2], hi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + frow + 8 * hh;
    const int qpos = rg.qo + row / g;
    lo[hh] = s0;
    hi[hh] = s1;
    if (p.causal) hi[hh] = min(hi[hh], qpos + 1);
    if (p.window > 0) lo[hh] = max(lo[hh], qpos - p.window + 1);
    if (row >= row_end) hi[hh] = lo[hh];  // padding: sees nothing
  }
  const bool warp_live = row0 + wrow < row_end;
  const int key0 = group * kWarpKeys;  // this warp's keys of each tile

  W w;
  w.init();
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` has landed; every warp is done with the
                      // slot the next fetch overwrites
    if (it == 0) w.load_q(q_s + wrow * kStride, lane);
    if (it + kStages - 1 < n_tiles) {
      fetch((it + kStages - 1) % kStages, s0 + (it + kStages - 1) * kTileN);
    }
    cp_async_commit();
    if constexpr (A::kPaged) {
      // tile it's slot is free again: its rows were read by its fetch, and
      // the barrier at the top of the next step publishes them
      if (it + kStages < n_tiles) {
        stage_rows(p, row_s + (it % kStages) * kTileN, pt_s, page0, h, s1,
                   s0 + (it + kStages) * kTileN, tid);
      }
    }
    const int pos0 = s0 + it * kTileN + key0;
    if (!warp_live || pos0 >= s1) continue;
    const bool full = __all_sync(
        kFull, pos0 >= lo[0] && pos0 >= lo[1] && pos0 + kWarpKeys <= hi[0]
                   && pos0 + kWarpKeys <= hi[1]);
    const int slot = it % kStages;
    w.step(k_s + (slot * kTileN + key0) * kStride,
           v_s + (slot * kTileN + key0) * kStride, lane, pos0, lo[0], hi[0],
           lo[1], hi[1], full, p.scale_log2);
  }
  w.finish();
  cp_async_wait<0>();

  const int t = lane % 4;
  if constexpr (kGroups == 1) {  // each warp writes its own 16 rows
    if (!warp_live) return;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = frow + 8 * hh;
      const int row = row0 + r;
      if (row >= row_end) continue;
      const float inv = w.l[hh] == 0.f ? 0.f : 1.f / w.l[hh];
      if (p.n_split > 1 && t == 0) {
        const size_t i = part_index(p, bh, rb, split, kBlockRows, r);
        p.m_part[i] = w.m[hh];
        p.l_part[i] = w.l[hh];
      }
#pragma unroll
      for (int n = 0; n < W::kDN; ++n) {
        put_pair<D, A>(p, b, q0, h, bh, rb, split, kBlockRows, row, r,
                       8 * n + 2 * t, w.o[n][2 * hh], w.o[n][2 * hh + 1],
                       inv);
      }
    }
    return;
  }
  // merge the key groups' partials of the same rows through shared memory
  // (the ring is free: every copy has landed and every warp is past it)
  constexpr int kR = kBlockRows;
  __syncthreads();
  float* o_s = reinterpret_cast<float*>(smem_raw);  // (kGroups, kR, D)
  float* m_s = o_s + kGroups * kR * D;              // (kGroups, kR)
  float* l_s = m_s + kGroups * kR;                  // (kGroups, kR)
  float* w_s = l_s + kGroups * kR;                  // (kGroups, kR)
  float* inv_s = w_s + kGroups * kR;                // (kR)
  float* mm_s = inv_s + kR;                         // (kR)
  float* ll_s = mm_s + kR;                          // (kR)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = frow + 8 * hh;
    if (t == 0) {
      m_s[group * kR + r] = w.m[hh];
      l_s[group * kR + r] = w.l[hh];
    }
#pragma unroll
    for (int n = 0; n < W::kDN; ++n) {
      *reinterpret_cast<float2*>(o_s + (group * kR + r) * D + 8 * n
                                 + 2 * t) =
          make_float2(w.o[n][2 * hh], w.o[n][2 * hh + 1]);
    }
  }
  __syncthreads();
  if (tid < kR) {
    float mx = kNegInf;
    for (int k = 0; k < kGroups; ++k) mx = fmaxf(mx, m_s[k * kR + tid]);
    float ls = 0.f;
    for (int k = 0; k < kGroups; ++k) {
      const float wk = exp2f(m_s[k * kR + tid] - mx);
      w_s[k * kR + tid] = wk;
      ls += wk * l_s[k * kR + tid];
    }
    mm_s[tid] = mx;
    ll_s[tid] = ls;
    inv_s[tid] = ls == 0.f ? 0.f : 1.f / ls;
  }
  __syncthreads();
  const int n_rows = row_end - row0;
  for (int e = tid; e < n_rows * (D / 2); e += kNThreads) {
    const int r = e / (D / 2);
    const int dd = (e % (D / 2)) * 2;
    float x0 = 0.f, x1 = 0.f;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const float wk = w_s[k * kR + r];
      const float2 ov =
          *reinterpret_cast<const float2*>(o_s + (k * kR + r) * D + dd);
      x0 += wk * ov.x;
      x1 += wk * ov.y;
    }
    put_pair<D, A>(p, b, q0, h, bh, rb, split, kR, row0 + r, r, dd, x0, x1,
                   inv_s[r]);
  }
  if (p.n_split > 1 && tid < n_rows) {
    const size_t i = part_index(p, bh, rb, split, kR, tid);
    p.m_part[i] = mm_s[tid];
    p.l_part[i] = ll_s[tid];
  }
}

// ---------------------------------------------------------------------------
// The combine pass: grid (B * Hkv, row blocks, block rows / kWarps), one
// warp per row.  Lane s reads split s's (m, l) when that split holds a
// partial (kMaxSplit == 32: one split a lane), the warp reduces the common
// max and the rescaled sum, and each lane then sums its D / 32 columns over
// the used splits, four splits' loads in flight at a time.  A row no split
// saw a key of writes zeros.
// ---------------------------------------------------------------------------

template <int D, class A>
__global__ void __launch_bounds__(kThreads)
attn_tc_combine_kernel(const typename A::P p, int block_rows) {
  constexpr int kVecs = D / 4;  // float4 columns of a row
  const int g = p.hq / p.hkv;
  const int bh = blockIdx.x;
  const int b = bh / p.hkv;
  const int h = bh % p.hkv;
  const int rb = blockIdx.y;
  const int row0 = rb * block_rows;
  const int row_end =
      min(row0 + block_rows, A::kPaged ? row_count<A>(p, b) : p.sq * g);
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.z * kWarps + (threadIdx.x >> 5);  // block row
  if (row0 + r >= row_end) return;

  bool mine = false;  // split `lane` holds a partial of this row
  if (lane < p.n_split) {
    const Range rg = split_range<A>(p, b, row0, row_end, lane);
    mine = rg.s0 < rg.s1;
  }
  const unsigned used = __ballot_sync(kFull, mine);
  float m = kNegInf, l = 0.f;
  if (mine) {
    const size_t i = part_index(p, bh, rb, lane, block_rows, r);
    m = p.m_part[i];
    l = p.l_part[i];
  }
  float mx = m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  }
  float wk = mine ? exp2f(m - mx) : 0.f;
  float ls = wk * l;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ls += __shfl_xor_sync(kFull, ls, o);
  wk *= ls == 0.f ? 0.f : 1.f / ls;

  bf16* dst =
      p.out + row_offset<A>(p, b, first_row<A>(p, b), h, row0 + r, D);
  // every lane runs every pass (the shuffles need the whole warp); lanes
  // past the row's columns load and store nothing
  for (int c0 = 0; c0 < kVecs; c0 += 32) {
    const int c = c0 + lane;
    const bool live = c < kVecs;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    unsigned left = used;
    while (left) {
      int sp[4];
      float4 x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // up to four used splits at a time
        sp[j] = left ? __ffs(left) - 1 : -1;
        if (left) left &= left - 1;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (sp[j] >= 0 && live) {
          const size_t i = part_index(p, bh, rb, sp[j], block_rows, r);
          x[j] = reinterpret_cast<const float4*>(p.acc_part + i * D)[c];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float w = __shfl_sync(kFull, wk, sp[j] < 0 ? 0 : sp[j]);
        const float ws = sp[j] < 0 ? 0.f : w;
        acc.x += ws * x[j].x;
        acc.y += ws * x[j].y;
        acc.z += ws * x[j].z;
        acc.w += ws * x[j].w;
      }
    }
    if (!live) continue;
    *reinterpret_cast<__nv_bfloat162*>(dst + 4 * c) =
        __floats2bfloat162_rn(acc.x, acc.y);
    *reinterpret_cast<__nv_bfloat162*>(dst + 4 * c + 2) =
        __floats2bfloat162_rn(acc.z, acc.w);
  }
}

// ---------------------------------------------------------------------------
// Host side: one launch of the walk (and of the combine when split)
// ---------------------------------------------------------------------------

// The two layouts: wide, 64 rows a block (4 row warps, one key group);
// narrow, 16 rows a block (1 row warp x 4 key groups of 16 keys).  A ring
// of 2 tiles at D > 64 and 3 at D <= 64: deeper rings and two key groups
// in the wide layout (8 warps) measured no faster on the H100 (PERF.md).
template <int D, bool kNarrow, class A>
cudaError_t launch_walk(const typename A::P& p, int b, cudaStream_t stream) {
  constexpr int kRowWarps = kNarrow ? 1 : 4;
  constexpr int kGroups = kNarrow ? 4 : 1;
  constexpr int kStages = D <= 64 ? 3 : 2;
  constexpr int kBlockRows = 16 * kRowWarps;
  // paged: the page ids and the kStages row tables after the ring
  int tables = 0;
  if constexpr (A::kPaged) tables = block_pages(p) + kStages * kTileN;
  const size_t smem = smem_bytes(D, kBlockRows, kStages, kGroups, tables);
  auto kernel = attn_tc_split_kernel<D, kStages, kRowWarps, kGroups, A>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int rows = p.sq * (p.hq / p.hkv);
  const dim3 grid(b * p.hkv, (rows + kBlockRows - 1) / kBlockRows, p.n_split);
  kernel<<<grid, 32 * kRowWarps * kGroups, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  attn_tc_combine_kernel<D, A>
      <<<dim3(grid.x, grid.y, kBlockRows / kWarps), kThreads, 0, stream>>>(
          p, kBlockRows);
  return cudaGetLastError();
}

template <bool kNarrow, class A>
cudaError_t launch_walk_d(int d, const typename A::P& p, int b,
                          cudaStream_t stream) {
  switch (d) {
    case 16: return launch_walk<16, kNarrow, A>(p, b, stream);
    case 32: return launch_walk<32, kNarrow, A>(p, b, stream);
    case 48: return launch_walk<48, kNarrow, A>(p, b, stream);
    case 64: return launch_walk<64, kNarrow, A>(p, b, stream);
    case 80: return launch_walk<80, kNarrow, A>(p, b, stream);
    case 96: return launch_walk<96, kNarrow, A>(p, b, stream);
    case 112: return launch_walk<112, kNarrow, A>(p, b, stream);
    case 128: return launch_walk<128, kNarrow, A>(p, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Does (dtype, d) take this walk?  bf16 (dtype 1) with d a multiple of 16
// up to 128; the wrappers' plan (kernels/attention_tc.py) states the same
// rule.
inline bool takes_walk(int dtype, int d) {
  return dtype == 1 && d % 16 == 0 && d >= 16 && d <= 128;
}

// A: the addressing (DenseKV, or a type derived from PagedKV, which takes
// a PagedParams); block_rows: 16 (narrow) or 64 (wide),
// the layouts of launch_walk; scratch as Params says when n_split > 1.
template <class A>
cudaError_t launch(const typename A::P& p, int b, int d, int block_rows,
                   cudaStream_t stream) {
  if (p.n_split < 1 || p.n_split > kMaxSplit
      || (p.n_split > 1 && (!p.m_part || !p.l_part || !p.acc_part))) {
    return cudaErrorInvalidValue;
  }
  if constexpr (A::kPaged) {
    // a pool row index ((page Hkv + h) ps + row) must fit an int
    if (!p.page_table || p.ps <= 0 || p.max_pages <= 0
        || (p.q_len && !p.q_start)
        || (long long)p.n_pool * p.hkv * p.ps >= (1ll << 31)) {
      return cudaErrorInvalidValue;
    }
  }
  if (block_rows == 16) return launch_walk_d<true, A>(d, p, b, stream);
  if (block_rows == kMaxRows) return launch_walk_d<false, A>(d, p, b, stream);
  return cudaErrorInvalidValue;
}

}  // namespace attn_tc
