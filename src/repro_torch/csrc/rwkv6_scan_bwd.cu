// The backward of the RWKV-6 WKV recurrence for Hopper (sm_90a): one call
// per RWKV layer and micro-batch of training.
//
// Replaces no Pallas kernel: the reference differentiates its chunked jnp
// scan (src/repro/kernels/ops.py, rwkv6_scan), each chunk checkpointed
// and recomputed in its backward.  Training reaches this kernel through
// kernels.ops's RWKV6Scan autograd function, after the forward kernel
// (rwkv6_scan.cu) has written the state before every chunk of `chunk`
// steps (`bounds`).
// With S the state before step t and G the gradient of the state after it,
// walked from the last step to the first:
//
//   dr_t[i] = sum_j dout_t[j] (S[i,j] + u_i k_t[i] v_t[j])
//   dk_t[i] = r_t[i] u_i (dout_t . v_t) + sum_j G[i,j] v_t[j]
//   dv_t[j] = dout_t[j] sum_i r_t[i] u_i k_t[i] + sum_i G[i,j] k_t[i]
//   dw_t[i] = sum_j G[i,j] S[i,j]
//   du[i]  += r_t[i] k_t[i] (dout_t . v_t)
//   G       <- r_t^T dout_t + diag(w_t) G
//
// and the final G is the initial state's gradient.  It computes the same
// function as the plain version, repro_torch.kernels.ref.rwkv6_bwd_reference.
//
//   * r, k, v, dout (B, T, H, N) in the compute dtype (f32 or bf16), w
//     (B, T, H, N) f32, u (H, N) f32, bounds (B, C, H, N, N) f32 (C =
//     ceil(T / chunk)), dstate (B, H, N, N) f32 or null (zero);
//   * dr, dk, dv (B, T, H, N) in the compute dtype, dw (B, T, H, N), du
//     (H, N) and dstate0 (B, H, N, N) f32.
//
// What bounds it on the H100: the f32 work, about 14 N^2 operations a
// step, row and head (the states re-run, the four gradient sums and G's
// update), on the CUDA cores, and the shared memory and shuffles that
// feed it; the bytes are small (the inputs once, the gradients once).
// Only G's recurrence is serial over the whole sequence, and across a
// chunk of L steps it is affine: G_in(c) = L_c + P_c (.) G_out(c), with
// L_c = sum_t (prod_{s < t} w_s) r_t^T dout_t over the chunk's steps (the
// walk from a zero gradient; s runs over the chunk's steps before t) and
// P_c[i] = prod_t w_t[i] scaling row i.
// So the call runs in three stages, each filling the card:
//
//   1. `local`, a block per (row, head, chunk): the chunk's L_c as one
//      product of its prefix-scaled r and dout (the prefix products of the
//      decays walked once per row), P_c, and the chunk's share of du;
//   2. `carry`, a thread per 4 adjacent elements of (row, head, i, :),
//      serial over the C chunks only: G_out(C - 1) = dstate, G_out(c - 1)
//      = L_c + P_c G_out(c), dstate0 = G_in(0), each G_out(c) written
//      over L_c; its last blocks add du's per-chunk shares in order;
//   3. `walk`, a block per (row, head, chunk) over the whole N x N state,
//      thread (q, l) holding rows q RT .. of its CT = N / 16 adjacent
//      columns of S and G in registers (Walk<N>): it re-runs the chunk's
//      states forward from the boundary state the forward wrote, keeping
//      the state every SEG steps in registers; then, sub-chunk by
//      sub-chunk of SUB steps from the last, it re-runs the sub-chunk's
//      states into shared memory (each thread's own slots) from its
//      segment's state and walks them back from the carried G_out(c).
//      A row's sums of dr, dk and dw over all N columns lie on the 16
//      lanes of one half warp: a shuffle tree halves the rows between
//      lane pairs, then three lanes write dr, dk and dw with their bonus
//      terms (u k (dout . v), r u (dout . v)).  dv's column sums go
//      through the warps' partials in shared memory, added once per
//      sub-chunk with dout sum r u k.
//
// The three launches are chained by programmatic dependent launch: the
// carry starts as the local stage's blocks do and waits only before
// reading L_c, and the walk loads its rows and re-runs its segment states
// while the carry runs, waiting only before loading G_out(c).
//
// At rwkv6-3b's training micro-batch (1 x 1,024 steps, 40 heads of 64)
// the local and walk stages run 1,280 blocks each (4.8 waves of the
// walk's 2 blocks on each of 132 SMs); the walk's block is 256 threads
// of 4 x 4 elements, 4-step sub-chunks (112.5 KB of shared memory, so
// two blocks, 16 warps, an SM) and a state kept every 8 steps; the carry
// is 32 dependent multiply-adds on 164 k elements.
//
// Never divides by a decay: w = exp(-exp(x)) reaches 0 in f32, so S is
// never recovered by inverting the recurrence (each chunk is re-run
// forward from its stored boundary) and dw is the sum of G S, not the
// identity that forms it from cumulative sums of r dr - k dk over w.  No
// chunked tensor-core form either: it would need differences of log
// decays, which are -inf where w underflows.  Every sum is taken in a
// fixed order (shuffle trees, partials added in warp order, du's shares
// in (row, chunk) order) with no atomics: two launches on the same inputs
// give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;      // threads across a row of the state
constexpr int kLocalThreads = 256;  // a block of the local stage
constexpr int kMaxChunk = 32;   // steps per chunk, at most (rwkv6_scan.CHUNK)
constexpr int kCarryThreads = 256;
constexpr int kCarryBatch = 16;  // chunks whose loads the carry issues at once
constexpr int kCarryVec = 4;    // adjacent state elements a carry thread
constexpr int kSmemLimit = 232448;  // the H100's shared memory a block

// The local stage's thread holds RT x RT elements of the N x N state
// (256 threads, RT = N / 16).
template <int N>
struct Tile {
  static constexpr int RT = N / kLanes;
  static_assert(kLanes * (N / RT) == kLocalThreads, "threads");
};

// The walk's block of each head size (rwkv6_scan_bwd.WALK repeats it):
// each thread holds RT rows x CT = N / kLanes adjacent columns of S and G
// (kLanes threads a row group, so THREADS = kLanes N / RT); SUB steps of
// states in shared memory at a time; the states at every SEG-th step of
// the chunk (a multiple of SUB) kept in registers; MIN_BLOCKS blocks an
// SM asked of the register allocation.
template <int N> struct Walk;
template <>
struct Walk<16> {
  static constexpr int RT = 1, THREADS = 256, SUB = 8, SEG = 8, MIN_BLOCKS = 1;
};
template <>
struct Walk<32> {
  static constexpr int RT = 2, THREADS = 256, SUB = 8, SEG = 8, MIN_BLOCKS = 1;
};
template <>
struct Walk<64> {
  static constexpr int RT = 4, THREADS = 256, SUB = 4, SEG = 8, MIN_BLOCKS = 2;
};

// The dynamic shared memory of each stage, in bytes (rwkv6_scan_bwd._plan
// repeats them): the chunk's r, k, w, v and dout [kMaxChunk][N] in f32,
// then for the local stage dout . v a step, and for the walk the
// sub-chunk's states [SUB][RT][THREADS][CT], the warps' dv partials
// [SUB][THREADS / 32][N], u [N], and dout . v and sum r u k a step.
__host__ __device__ constexpr int local_smem(int n) {
  return 4 * (5 * kMaxChunk * n + kMaxChunk);
}
template <int N>
__host__ __device__ constexpr int walk_smem() {
  return 4 * (5 * kMaxChunk * N + Walk<N>::SUB * N * N
              + Walk<N>::SUB * (Walk<N>::THREADS / 32) * N + N
              + 2 * kMaxChunk);
}
static_assert(walk_smem<64>() <= kSmemLimit, "the walk's shared memory");

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int W>
__device__ __forceinline__ void load_f32(float* dst, const float* src) {
  if constexpr (W == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x, dst[1] = x.y, dst[2] = x.z, dst[3] = x.w;
  } else if constexpr (W == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x, dst[1] = x.y;
  } else {
    dst[0] = *src;
  }
}

template <int W>
__device__ __forceinline__ void store_f32(float* dst, const float* x) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
  } else {
    *dst = x[0];
  }
}

// 16 bytes of a row from device memory, widened to f32 in shared memory
__device__ __forceinline__ void stage16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void stage16(float* dst, const __nv_bfloat16* src) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
  const float2 c = __bfloat1622float2(p[2]), d = __bfloat1622float2(p[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// nt steps of one (row, head)'s N-wide rows (`stride` elements apart in
// device memory) into dst[nt][N]
template <int N, int THREADS, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           size_t stride, int nt) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kPer = N / kVec;
  for (int x = threadIdx.x; x < nt * kPer; x += THREADS) {
    const int tt = x / kPer, e = (x % kPer) * kVec;
    stage16(dst + tt * N + e, src + (size_t)tt * stride + e);
  }
}

// dot[t] = dout_t . v_t and, when `bu` is given, bu[t] = sum_i r_t[i] u_i
// k_t[i]: a warp a step, lanes over the row, a shuffle tree
template <int N, int THREADS>
__device__ __forceinline__ void step_sums(const float* rs, const float* ks,
                                          const float* vs, const float* ds,
                                          const float* us, float* dot,
                                          float* bu, int nt) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int tt = warp; tt < nt; tt += THREADS / 32) {
    float a = 0.f, b = 0.f;
    for (int e = lane; e < N; e += 32) {
      a = fmaf(ds[tt * N + e], vs[tt * N + e], a);
      if (bu != nullptr) b = fmaf(rs[tt * N + e] * us[e], ks[tt * N + e], b);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (lane == 0) {
      dot[tt] = a;
      if (bu != nullptr) bu[tt] = b;
    }
  }
}

// Stage 1: a block per (b, c, h) chunk.  carry[b, c, h] = L_c, decay[b, c,
// h] = P_c, du_part[b, c, h] = sum over the chunk of r k (dout . v).
template <typename T, int N>
__global__ void __launch_bounds__(kLocalThreads)
wkv_bwd_local(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ w,
              const T* __restrict__ dout, float* __restrict__ carry,
              float* __restrict__ decay, float* __restrict__ du_part,
              int t_len, int h, int chunk) {
  constexpr int RT = Tile<N>::RT;
  extern __shared__ __align__(16) float sm[];
  float* rs = sm;
  float* ks = rs + kMaxChunk * N;
  float* ws = ks + kMaxChunk * N;
  float* vs = ws + kMaxChunk * N;
  float* ds = vs + kMaxChunk * N;
  float* dot = ds + kMaxChunk * N;

  // the carry (launched dependent on this grid) may start
  asm volatile("griddepcontrol.launch_dependents;");
  const int n_chunks = (t_len + chunk - 1) / chunk;
  const int c = blockIdx.x % n_chunks;
  const int bh = blockIdx.x / n_chunks;
  const int bb = bh / h, hh = bh % h;
  const int t0 = c * chunk, nt = min(chunk, t_len - t0);
  const size_t stride = (size_t)h * N;
  const size_t base = ((size_t)bb * t_len + t0) * stride + (size_t)hh * N;
  stage_rows<N, kLocalThreads>(rs, r + base, stride, nt);
  stage_rows<N, kLocalThreads>(ks, k + base, stride, nt);
  stage_rows<N, kLocalThreads>(ws, w + base, stride, nt);
  stage_rows<N, kLocalThreads>(vs, v + base, stride, nt);
  stage_rows<N, kLocalThreads>(ds, dout + base, stride, nt);
  __syncthreads();
  step_sums<N, kLocalThreads>(rs, ks, vs, ds, nullptr, dot, nullptr, nt);
  __syncthreads();

  // each row's prefix products of the decays, walked once: rs[t][i]
  // becomes r_t[i] prod_{s < t} w_s[i] (s over the chunk's steps)
  const size_t item = ((size_t)bb * n_chunks + c) * h + hh;
  const int tid = threadIdx.x;
  if (tid < N) {
    float prod = 1.f, du = 0.f;
#pragma unroll 4
    for (int tt = 0; tt < nt; ++tt) {
      const float ri = rs[tt * N + tid];
      du = fmaf(ri * ks[tt * N + tid], dot[tt], du);
      rs[tt * N + tid] = ri * prod;
      prod *= ws[tt * N + tid];
    }
    decay[item * N + tid] = prod;
    du_part[item * N + tid] = du;
  }
  __syncthreads();

  // L_c = (prefix-scaled r)^T dout over the chunk's steps
  const int i0 = (tid / kLanes) * RT, j0 = (tid % kLanes) * RT;
  float acc[RT][RT];
#pragma unroll
  for (int a = 0; a < RT; ++a) {
#pragma unroll
    for (int m = 0; m < RT; ++m) acc[a][m] = 0.f;
  }
#pragma unroll 4
  for (int tt = 0; tt < nt; ++tt) {
    float ra[RT], dd[RT];
    load_f32<RT>(ra, rs + tt * N + i0);
    load_f32<RT>(dd, ds + tt * N + j0);
#pragma unroll
    for (int a = 0; a < RT; ++a) {
#pragma unroll
      for (int m = 0; m < RT; ++m) acc[a][m] = fmaf(ra[a], dd[m], acc[a][m]);
    }
  }
  float* out = carry + item * N * N + (size_t)i0 * N + j0;
#pragma unroll
  for (int a = 0; a < RT; ++a) store_f32<RT>(out + (size_t)a * N, acc[a]);
}

// Stage 2: a thread per kCarryVec adjacent elements of (b, h, i, :),
// serial over the chunks from the last: carry[b, c, h, i, j] holds L_c on
// entry and G_out(c) on exit; dstate0 = G_in(0).  The last `du_blocks`
// blocks add du_part over (b, c) in order.  Launched dependent on the
// local stage: only the reads of its outputs wait for it.
template <int N>
__global__ void __launch_bounds__(kCarryThreads)
wkv_bwd_carry(float* __restrict__ carry, const float* __restrict__ decay,
              const float* __restrict__ dstate, float* __restrict__ dstate0,
              const float* __restrict__ du_part, float* __restrict__ du,
              int b_len, int h, int n_chunks, int carry_blocks) {
  // the walk (launched dependent on this grid) may start its prologue
  asm volatile("griddepcontrol.launch_dependents;");
  if ((int)blockIdx.x >= carry_blocks) {
    const int x = (blockIdx.x - carry_blocks) * kCarryThreads + threadIdx.x;
    asm volatile("griddepcontrol.wait;" ::: "memory");
    if (x >= h * N) return;
    const int parts = b_len * n_chunks;
    float sum = 0.f;
    for (int p = 0; p < parts; ++p) sum += du_part[(size_t)p * h * N + x];
    du[x] = sum;
    return;
  }
  const size_t e =
      ((size_t)blockIdx.x * kCarryThreads + threadIdx.x) * kCarryVec;
  const size_t per_b = (size_t)h * N * N;
  const bool live = e < (size_t)b_len * per_b;
  const size_t bb = e / per_b, hh = e % per_b / (N * N);
  const int ij = (int)(e % (N * N)), i = ij / N;
  float g[kCarryVec] = {};
  if (live && dstate != nullptr) load_f32<kCarryVec>(g, dstate + e);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (!live) return;
  for (int c1 = n_chunks; c1 > 0; c1 -= kCarryBatch) {
    const int nb = min(kCarryBatch, c1);
    float lc[kCarryBatch][kCarryVec], pc[kCarryBatch];
#pragma unroll
    for (int x = 0; x < kCarryBatch; ++x) {
      if (x < nb) {
        const size_t item = (bb * n_chunks + (c1 - 1 - x)) * h + hh;
        load_f32<kCarryVec>(lc[x], carry + item * N * N + ij);
        pc[x] = decay[item * N + i];
      }
    }
#pragma unroll
    for (int x = 0; x < kCarryBatch; ++x) {
      if (x < nb) {
        const size_t item = (bb * n_chunks + (c1 - 1 - x)) * h + hh;
        store_f32<kCarryVec>(carry + item * N * N + ij, g);
#pragma unroll
        for (int m = 0; m < kCarryVec; ++m) g[m] = fmaf(pc[x], g[m], lc[x][m]);
      }
    }
  }
  store_f32<kCarryVec>(dstate0 + e, g);
}

// S <- diag(w_t) S + k_t^T v_t on a thread's RT x CT piece
template <int N, int RT, int CT>
__device__ __forceinline__ void advance(float (&s)[RT][CT], const float* ks,
                                        const float* ws, const float* vs,
                                        int tt, int i0, int j0) {
  float kk[RT], ww[RT], vv[CT];
  load_f32<RT>(kk, ks + tt * N + i0);
  load_f32<RT>(ww, ws + tt * N + i0);
  load_f32<CT>(vv, vs + tt * N + j0);
#pragma unroll
  for (int a = 0; a < RT; ++a) {
#pragma unroll
    for (int m = 0; m < CT; ++m) s[a][m] = fmaf(ww[a], s[a][m], kk[a] * vv[m]);
  }
}

// Stage 3: a block per (b, c, h) chunk over the whole state.  Writes dr,
// dk, dv and dw of the chunk's steps.
template <typename T, int N>
__global__ void __launch_bounds__(Walk<N>::THREADS, Walk<N>::MIN_BLOCKS)
wkv_bwd_walk(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ bounds,
             const T* __restrict__ dout, const float* __restrict__ carry,
             T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
             float* __restrict__ dw, int t_len, int h, int chunk) {
  constexpr int RT = Walk<N>::RT, CT = N / kLanes;
  constexpr int kThreads = Walk<N>::THREADS, kWarps = kThreads / 32;
  constexpr int kSub = Walk<N>::SUB, kSeg = Walk<N>::SEG;
  constexpr int kBnd = kMaxChunk / kSeg - 1;  // states kept in registers
  constexpr int kGroup = kLanes / RT;  // lanes that end with one row's sums
  constexpr int kHalvings = RT == 4 ? 2 : RT == 2 ? 1 : 0;
  static_assert(kLanes * (N / RT) == kThreads && kThreads % 32 == 0,
                "threads");
  static_assert(kGroup >= 3, "a row's three sums need three lanes");
  static_assert(kSeg % kSub == 0 && kMaxChunk % kSeg == 0, "sub-chunks");
  extern __shared__ __align__(16) float sm[];
  float* rs = sm;
  float* ks = rs + kMaxChunk * N;
  float* ws = ks + kMaxChunk * N;
  float* vs = ws + kMaxChunk * N;
  float* ds = vs + kMaxChunk * N;
  float* hist = ds + kMaxChunk * N;  // [kSub][RT][kThreads][CT]
  float* dvp = hist + kSub * N * N;  // [kSub][kWarps][N]
  float* us = dvp + kSub * kWarps * N;
  float* dot = us + N;
  float* bu = dot + kMaxChunk;

  const int n_chunks = (t_len + chunk - 1) / chunk;
  const int c = blockIdx.x % n_chunks;
  const int bh = blockIdx.x / n_chunks;
  const int bb = bh / h, hh = bh % h;
  const int t0 = c * chunk, nt = min(chunk, t_len - t0);
  const int n_sub = (nt + kSub - 1) / kSub;
  const int n_seg = (nt + kSeg - 1) / kSeg;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int l = tid % kLanes;
  const int i0 = (tid / kLanes) * RT, j0 = l * CT;
  const size_t stride = (size_t)h * N;
  const size_t base = ((size_t)bb * t_len + t0) * stride + (size_t)hh * N;
  const size_t item = ((size_t)bb * n_chunks + c) * h + hh;
  const float* s0 = bounds + item * N * N + (size_t)i0 * N + j0;

  float s[RT][CT];
#pragma unroll
  for (int a = 0; a < RT; ++a) load_f32<CT>(s[a], s0 + (size_t)a * N);
  stage_rows<N, kThreads>(rs, r + base, stride, nt);
  stage_rows<N, kThreads>(ks, k + base, stride, nt);
  stage_rows<N, kThreads>(ws, w + base, stride, nt);
  stage_rows<N, kThreads>(vs, v + base, stride, nt);
  stage_rows<N, kThreads>(ds, dout + base, stride, nt);
  for (int e = tid; e < N; e += kThreads) us[e] = u[hh * N + e];
  __syncthreads();
  step_sums<N, kThreads>(rs, ks, vs, ds, us, dot, bu, nt);
  __syncthreads();  // dot and bu are read from the first reverse step on

  // the states at the starts of segments 1 .. n_seg - 1
  float bnd[kBnd > 0 ? kBnd : 1][RT][CT];
#pragma unroll
  for (int sg = 0; sg < kBnd; ++sg) {
    if (sg + 1 < n_seg) {
#pragma unroll 1
      for (int tt = sg * kSeg; tt < (sg + 1) * kSeg; ++tt) {
        advance<N, RT, CT>(s, ks, ws, vs, tt, i0, j0);
      }
#pragma unroll
      for (int a = 0; a < RT; ++a) {
#pragma unroll
        for (int m = 0; m < CT; ++m) bnd[sg][a][m] = s[a][m];
      }
    }
  }

  // G_out(c), which the carry stage wrote
  asm volatile("griddepcontrol.wait;" ::: "memory");
  float g[RT][CT];
  const float* g0 = carry + item * N * N + (size_t)i0 * N + j0;
#pragma unroll
  for (int a = 0; a < RT; ++a) load_f32<CT>(g[a], g0 + (size_t)a * N);

  for (int sc = n_sub - 1; sc >= 0; --sc) {
    const int st = sc * kSub, ns = min(kSub, nt - st);
    // the sub-chunk's first state, from its segment's
    const int sg = st / kSeg;
    if (sg == 0) {
#pragma unroll
      for (int a = 0; a < RT; ++a) load_f32<CT>(s[a], s0 + (size_t)a * N);
    }
#pragma unroll
    for (int x = 0; x < kBnd; ++x) {
      if (x == sg - 1) {
#pragma unroll
        for (int a = 0; a < RT; ++a) {
#pragma unroll
          for (int m = 0; m < CT; ++m) s[a][m] = bnd[x][a][m];
        }
      }
    }
#pragma unroll 1
    for (int tt = sg * kSeg; tt < st; ++tt) {
      advance<N, RT, CT>(s, ks, ws, vs, tt, i0, j0);
    }
    // the sub-chunk's states, each in this thread's own slots
#pragma unroll
    for (int tt = 0; tt < kSub; ++tt) {
      if (tt < ns) {
#pragma unroll
        for (int a = 0; a < RT; ++a) {
          store_f32<CT>(hist + ((tt * RT + a) * kThreads + tid) * CT, s[a]);
        }
        if (tt + 1 < ns) advance<N, RT, CT>(s, ks, ws, vs, st + tt, i0, j0);
      }
    }

    // the previous sub-chunk's dv partials have been read
    if (sc != n_sub - 1) __syncthreads();

    // the reverse walk
#pragma unroll
    for (int tt = kSub - 1; tt >= 0; --tt) {
      if (tt >= ns) continue;
      const int t = st + tt;
      float rr[RT], kk[RT], ww[RT], vv[CT], dd[CT];
      load_f32<RT>(rr, rs + t * N + i0);
      load_f32<RT>(kk, ks + t * N + i0);
      load_f32<RT>(ww, ws + t * N + i0);
      load_f32<CT>(vv, vs + t * N + j0);
      load_f32<CT>(dd, ds + t * N + j0);
      float xr[RT][3], xv[CT];
#pragma unroll
      for (int m = 0; m < CT; ++m) xv[m] = 0.f;
#pragma unroll
      for (int a = 0; a < RT; ++a) {
        float sv[CT];
        load_f32<CT>(sv, hist + ((tt * RT + a) * kThreads + tid) * CT);
        float ar = 0.f, ak = 0.f, aw = 0.f;
#pragma unroll
        for (int m = 0; m < CT; ++m) {
          ar = fmaf(dd[m], sv[m], ar);
          ak = fmaf(g[a][m], vv[m], ak);
          aw = fmaf(g[a][m], sv[m], aw);
          xv[m] = fmaf(g[a][m], kk[a], xv[m]);
          g[a][m] = fmaf(ww[a], g[a][m], rr[a] * dd[m]);
        }
        xr[a][0] = ar, xr[a][1] = ak, xr[a][2] = aw;
      }
      // the rows' sums over the kLanes column threads: halve the rows
      // between lane pairs, then a butterfly over the last kGroup lanes;
      // three lanes of each group write dr, dk and dw of their row
      int roff = 0;
#pragma unroll
      for (int st2 = 0; st2 < kHalvings; ++st2) {
        const int half = RT >> (st2 + 1), mask = kLanes >> (st2 + 1);
        const bool hi = (l & mask) != 0;
#pragma unroll
        for (int a = 0; a < half; ++a) {
#pragma unroll
          for (int x = 0; x < 3; ++x) {
            const float send = hi ? xr[a][x] : xr[a + half][x];
            const float keep = hi ? xr[a + half][x] : xr[a][x];
            xr[a][x] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
          }
        }
        roff += hi ? half : 0;
      }
#pragma unroll
      for (int mask = kGroup / 2; mask >= 1; mask /= 2) {
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          xr[0][x] += __shfl_xor_sync(0xffffffffu, xr[0][x], mask);
        }
      }
      const int which = l % kGroup, row = i0 + roff;
      const size_t at = base + (size_t)t * stride + row;
      if (which == 2) {
        dw[at] = xr[0][2];
      } else if (which < 2) {
        const float x = which == 0 ? ks[t * N + row] : rs[t * N + row];
        const float sum = which == 0 ? xr[0][0] : xr[0][1];
        (which == 0 ? dr : dk)[at] = from_f32<T>(fmaf(us[row] * x, dot[t],
                                                      sum));
      }
      // the columns' sums over the warp's two row groups (lanes l, l + 16),
      // then into the warp's partials
      const bool hi = (lane & 16) != 0;
      float* dvw = dvp + (tt * kWarps + warp) * N + j0;
      if constexpr (CT >= 2) {
        constexpr int kH = CT / 2;
#pragma unroll
        for (int m = 0; m < kH; ++m) {
          const float send = hi ? xv[m] : xv[m + kH];
          const float keep = hi ? xv[m + kH] : xv[m];
          xv[m] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
        }
        store_f32<kH>(dvw + (hi ? kH : 0), xv);
      } else {
        xv[0] += __shfl_xor_sync(0xffffffffu, xv[0], 16);
        if (!hi) dvw[0] = xv[0];
      }
    }
    __syncthreads();  // the sub-chunk's dv partials are in place

    for (int x = tid; x < ns * N; x += kThreads) {
      const int tt = x / N, e = x % N, t = st + tt;
      float sum = ds[t * N + e] * bu[t];
#pragma unroll
      for (int wq = 0; wq < kWarps; ++wq) sum += dvp[(tt * kWarps + wq) * N + e];
      dv[base + (size_t)t * stride + e] = from_f32<T>(sum);
    }
  }
}

struct Args {
  const void *r, *k, *v, *w, *u, *bounds, *dout, *dstate;
  void *carry, *decay, *du_part, *dr, *dk, *dv, *dw, *du, *dstate0;
};

template <typename T, int N>
cudaError_t launch(const Args& a, int b, int t, int h, int chunk,
                   int smem_local, int smem_walk, cudaStream_t stream) {
  if (smem_local != local_smem(N) || smem_walk != walk_smem<N>()) {
    return cudaErrorInvalidValue;
  }
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        wkv_bwd_local<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        local_smem(N));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(wkv_bwd_walk<T, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 walk_smem<N>());
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(wkv_bwd_walk<T, N>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int n_chunks = (t + chunk - 1) / chunk;
  const long long items = (long long)b * h * n_chunks;
  const long long cells = (long long)b * h * N * N;
  const long long carry_blocks =
      (cells / kCarryVec + kCarryThreads - 1) / kCarryThreads;
  const int du_blocks = (h * N + kCarryThreads - 1) / kCarryThreads;
  if (items > 0x7fffffff || carry_blocks + du_blocks > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  if (items > 0) {
    wkv_bwd_local<T, N><<<(unsigned)items, kLocalThreads, local_smem(N),
                          stream>>>(
        static_cast<const T*>(a.r), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const float*>(a.w),
        static_cast<const T*>(a.dout), static_cast<float*>(a.carry),
        static_cast<float*>(a.decay), static_cast<float*>(a.du_part), t, h,
        chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t carry_cfg = {};
  carry_cfg.gridDim = dim3((unsigned)(carry_blocks + du_blocks));
  carry_cfg.blockDim = dim3(kCarryThreads);
  carry_cfg.stream = stream;
  carry_cfg.attrs = attr;
  carry_cfg.numAttrs = items > 0 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(
      &carry_cfg, wkv_bwd_carry<N>, static_cast<float*>(a.carry),
      static_cast<const float*>(a.decay), static_cast<const float*>(a.dstate),
      static_cast<float*>(a.dstate0), static_cast<const float*>(a.du_part),
      static_cast<float*>(a.du), b, h, n_chunks, (int)carry_blocks);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || items == 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)items);
  cfg.blockDim = dim3(Walk<N>::THREADS);
  cfg.dynamicSmemBytes = walk_smem<N>();
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, wkv_bwd_walk<T, N>, static_cast<const T*>(a.r),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.w), static_cast<const float*>(a.u),
      static_cast<const float*>(a.bounds), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.carry), static_cast<T*>(a.dr),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), static_cast<float*>(a.dw),
      t, h, chunk);
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}

template <typename T>
cudaError_t launch_n(const Args& a, int b, int t, int h, int n, int chunk,
                     int smem_local, int smem_walk, cudaStream_t stream) {
  switch (n) {
    case 16:
      return launch<T, 16>(a, b, t, h, chunk, smem_local, smem_walk, stream);
    case 32:
      return launch<T, 32>(a, b, t, h, chunk, smem_local, smem_walk, stream);
    case 64:
      return launch<T, 64>(a, b, t, h, chunk, smem_local, smem_walk, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 = float32, 1 =
// bfloat16 (of r, k, v, dout, dr, dk and dv; everything else is float32).
// Every pointer is a device pointer of a contiguous tensor, 16-byte
// aligned; dstate may be null (a zero gradient of the final state).  The
// scratch: carry (B, C, H, N, N), decay and du_part (B, C, H, N), f32, C =
// ceil(T / chunk).  chunk is the forward's (rwkv6_scan.bound_chunk), at
// most 32; smem_local and smem_walk the two stages' dynamic shared memory
// (rwkv6_scan_bwd._plan).  Three launches on `stream` (the walk dependent
// on the carry), nothing synchronised.  Returns the first failing
// launch's cudaError_t (0 = cudaSuccess); cudaErrorInvalidValue for a plan
// it does not build.
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* bounds, const void* dout, const void* dstate,
    void* carry, void* decay, void* du_part, void* dr, void* dk, void* dv,
    void* dw, void* du, void* dstate0, int b, int t, int h, int n, int dtype,
    int chunk, int smem_local, int smem_walk, void* stream) {
  if (b < 0 || t < 0 || h <= 0 || chunk <= 0 || chunk > kMaxChunk) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{r,     k,       v,  w,  u,  bounds, dout, dstate, carry,
               decay, du_part, dr, dk, dv, dw,     du,   dstate0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_n<float>(a, b, t, h, n, chunk, smem_local, smem_walk,
                                st);
  }
  if (dtype == 1) {
    return (int)launch_n<__nv_bfloat16>(a, b, t, h, n, chunk, smem_local,
                                        smem_walk, st);
  }
  return (int)cudaErrorInvalidValue;
}
