// RWKV-6 WKV recurrence for Hopper (sm_90a): the time mix of every RWKV-6
// layer, one launch per layer and forward.
//
// Replaces the Pallas TPU kernel `_wkv_kernel` behind `pallas_rwkv6_scan`
// (src/repro/kernels/ssm_scan.py).  It computes the same function as the
// plain version (repro_torch.kernels.ref.rwkv6_reference), sequentially
// over time for each (batch row b, head h), with an N x N f32 state:
//
//   out_t  = r_t . (S + diag(u) k_t^T v_t)
//   S     <- diag(w_t) S + k_t^T v_t
//
//   * r, k, v (B, T, H, N) in the compute dtype (f32 or bf16), w (B, T, H,
//     N) f32 decays, u (H, N) f32 bonus, state0 (B, H, N, N) f32;
//   * out (B, T, H, N) in r's dtype, final state (B, H, N, N) f32.
//
// The TPU kernel starts from a zero state and its wrapper folds a non-zero
// state0 in afterwards, analytically (a cumulative product of the decays).
// Here each thread loads its part of state0 into registers at t = 0, so
// the recurrence itself carries it: the same function, with no second
// pass.
//
// What bounds it on the H100: at prefill (2 rows x 128 steps of 40 heads of
// 64) the shared memory's bandwidth first and the f32 issue rate second.
// Every state element takes 3 f32 instructions a step (k_i v_j, the
// output's r_i S_ij and the update w_i S_ij + k_i v_j), and every thread
// reads its rows' r_i, k_i, w_i and its columns' v_j from shared memory
// each step; a warp's broadcast read costs the shared memory about one
// cycle a value, as much as 32 distinct ones.  At decode (T = 1) the bytes
// bound it, the state read and written once.  Only the update's one
// multiply-add per element and step is serial; the output sums feed
// nothing later.  The design:
//
//   * columns over blocks: the columns of S are independent (out_t[j] =
//     sum_i r_i S_ij + v_j sum_i r_i u_i k_i; S_ij <- w_i S_ij + k_i v_j),
//     so a block takes COLS columns of one (b, h), N / COLS blocks a head,
//     with no combine across blocks; Shape<64> takes 32 columns, two
//     blocks a head: 160 blocks for a prefill call of 2 rows and 640
//     for a decode step of 8, where one block a head (each stages the
//     head's whole r, k and w rows) would leave 52 of 132 SMs idle at
//     prefill;
//   * rows over row groups, columns on lanes: thread (q, l) keeps rows q
//     N/R .. (q + 1) N/R - 1 of its CPT adjacent columns in registers for
//     the whole sequence.  CPT = 4 lets one read of r_i, k_i and w_i serve
//     4 columns, which cuts the shared-memory reads per state element by
//     4; the state's load and store are coalesced row pieces;
//   * the output sums off the recurrence's chain: each step a thread adds
//     its rows' r_i S_ij into one partial per column and stores them in
//     shared memory, with no shuffle and no barrier; once per chunk, after
//     one barrier, the block sums the R partials of each (step, column),
//     adds the bonus and stores out;
//   * an asynchronous chunk ring: the block stages chunk c + 1 of r, k, w
//     (whole rows) and v (its own columns) with 16-byte cp.async copies,
//     in the compute dtype, into the other of two slots while chunk c
//     computes; steps past T are zero-filled and never run, so no padded
//     step touches the state.  Each step's r, k, w and v are read into
//     registers a step ahead and widened there.  The bonus sum_i r_i u_i
//     k_i of each step is reduced once for the block, not in every thread;
//   * decode (T = 1) is the same kernel with a one-step chunk and one slot:
//     every block issues its state loads at once, so the whole state of
//     the call is in flight together.
//
// N (16, 32, 64) is a template parameter and Shape<N> fixes COLS, CPT
// and R for it: 32 x 4 x 8 at N = 64 and 32, 16 x 2 x 4 at N = 16.  The
// launch plan names the chunk, the ring and the shared memory; the C entry
// point refuses shared memory that does not match them.
//
// state0 and the final state may be the same buffer (the serving path
// updates its cache in place): each thread reads exactly the state entries
// it later writes, before it writes them, and no other thread, in its
// block or another, reads or writes those entries.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_ptx.cuh"

namespace {

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// The block of each head size, as rwkv6_scan.SHAPES lists it: COLS state
// columns, CPT of them a thread, R row groups.  At N = 64 these were the
// fastest of the shapes timed on the H100 (PERF.md).
template <int N> struct Shape;
template <>
struct Shape<16> {
  static constexpr int COLS = 16, CPT = 2, R = 4;
};
template <>
struct Shape<32> {
  static constexpr int COLS = 32, CPT = 4, R = 8;
};
template <>
struct Shape<64> {
  static constexpr int COLS = 32, CPT = 4, R = 8;
};

// The dynamic shared memory of one call, in bytes, as
// rwkv6_scan._plan computes it: `ring` slots of a chunk's r and k
// [chunk][N] and v [chunk][COLS] in the compute dtype and w [chunk][N]
// f32, as copied; the bonus of each step [chunk]; the output partials
// [chunk][R][COLS]; then 2 rows of slack, which the recurrence's reads one
// and two steps past a chunk's end may touch (never used).
struct Layout {
  int k, w, v, slot;  // offsets within a slot, and its size
  int bonus, part, total;
};

__host__ __device__ inline Layout layout(int n, int cols, int rows,
                                         int chunk, int ring, int itemsize) {
  Layout s;
  s.k = chunk * n * itemsize;
  s.w = 2 * s.k;
  s.v = s.w + chunk * n * 4;
  s.slot = round16(s.v + chunk * cols * itemsize);
  s.bonus = ring * s.slot;
  s.part = s.bonus + round16(chunk * 4);
  s.total = s.part + chunk * rows * cols * 4 + 2 * n * 4;
  return s;
}

// CPT consecutive values: loaded from f32 or bf16 and widened to f32,
// stored to f32, or stored rounded to the output dtype
template <int CPT>
__device__ __forceinline__ void load_f32(float* dst, const float* src) {
  if constexpr (CPT == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x, dst[1] = x.y, dst[2] = x.z, dst[3] = x.w;
  } else if constexpr (CPT == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x, dst[1] = x.y;
  } else {
    dst[0] = *src;
  }
}

template <int CPT>
__device__ __forceinline__ void store_f32(float* dst, const float* x) {
  if constexpr (CPT == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (CPT == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
  } else {
    *dst = x[0];
  }
}

template <int CPT>
__device__ __forceinline__ void load_f32(float* dst,
                                         const __nv_bfloat16* src) {
  if constexpr (CPT == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(src);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    dst[0] = a.x, dst[1] = a.y, dst[2] = b.x, dst[3] = b.y;
  } else if constexpr (CPT == 2) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(src));
    dst[0] = a.x, dst[1] = a.y;
  } else {
    dst[0] = __bfloat162float(*src);
  }
}

// 16 bytes of the compute dtype widened to f32 (4 or 8 values)
__device__ __forceinline__ void widen16(float* dst, const float* src) {
  load_f32<4>(dst, src);
}

__device__ __forceinline__ void widen16(float* dst,
                                        const __nv_bfloat16* src) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    dst[2 * j] = f.x, dst[2 * j + 1] = f.y;
  }
}

template <int CPT>
__device__ __forceinline__ void store_out(float* dst, const float* x) {
  store_f32<CPT>(dst, x);
}

template <int CPT>
__device__ __forceinline__ void store_out(__nv_bfloat16* dst,
                                          const float* x) {
  if constexpr (CPT == 1) {
    *dst = __float2bfloat16(x[0]);
  } else {
    __nv_bfloat162 y[CPT / 2];
#pragma unroll
    for (int m = 0; m < CPT / 2; ++m) {
      y[m] = __floats2bfloat162_rn(x[2 * m], x[2 * m + 1]);
    }
    if constexpr (CPT == 4) {
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(y);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(dst) = y[0];
    }
  }
}

// One block per COLS columns of one (b, h).  Its threads form R row groups
// of COLS / CPT threads: thread (q, l) = threadIdx.x (q COLS / CPT + l)
// keeps rows q N/R .. (q + 1) N/R - 1 of the CPT columns c0 + l CPT .. in
// registers.  `chunk` steps per ring slot, `ring` slots (2 whenever T >
// chunk).
template <typename T, int N, int COLS, int CPT, int R>
__global__ void __launch_bounds__(R * COLS / CPT)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* state0,
                  T* __restrict__ out, float* state_out, int t_len, int h,
                  int chunk, int ring) {
  constexpr int kGroup = COLS / CPT;  // threads of a row group
  constexpr int kThreads = R * kGroup;
  constexpr int kRows = N / R;        // state rows of each thread
  constexpr int kSplit = N / COLS;    // blocks of one (b, h)
  constexpr int kPer = 16 / (int)sizeof(T);  // elements a 16-byte piece
  constexpr int kPieces = N / kPer;   // 16-byte pieces of a row of r or k
  constexpr int kWPieces = N / 4;
  constexpr int kVPieces = COLS / kPer;
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "threads");
  static_assert(N % R == 0 && kRows % 4 == 0, "rows of a thread");
  static_assert(N % COLS == 0 && COLS % CPT == 0 && kVPieces >= 1 &&
                (CPT == 1 || CPT == 2 || CPT == 4), "columns");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem = smem_raw;
  const Layout lay = layout(N, COLS, R, chunk, ring, sizeof(T));
  float* bonus = reinterpret_cast<float*>(smem + lay.bonus);
  float* part = reinterpret_cast<float*>(smem + lay.part);

  const int bh = blockIdx.x / kSplit;
  const int c0 = (blockIdx.x % kSplit) * COLS;
  const int b = bh / h;
  const int hh = bh % h;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int lc = (tid % kGroup) * CPT;  // first column of this thread
  const int q = tid / kGroup;
  const int i0 = q * kRows;
  // element offset of (b, t = 0, hh, 0); step t adds t * step
  const size_t step = (size_t)h * N;
  const size_t base = (size_t)b * t_len * step + (size_t)hh * N;
  const int n_chunks = (t_len + chunk - 1) / chunk;

  // chunk ci of r, k, w (whole rows) and v (this block's columns) into
  // slot ci % ring, 16 bytes a copy: a thread copies the same piece of
  // every (kThreads / pieces)-th step; steps past T are zero-filled (never
  // read from memory)
  auto stage = [&](int ci) {
    const int t0 = ci * chunk;
    unsigned char* slot = smem + (ci % ring) * lay.slot;
    for (int tt = tid / kPieces; tt < chunk; tt += kThreads / kPieces) {
      const bool valid = t0 + tt < t_len;
      const int e = (tid % kPieces) * kPer;
      const size_t at = base + (valid ? (size_t)(t0 + tt) * step : 0) + e;
      const int dst = (tt * N + e) * (int)sizeof(T);
      mma_ptx::cp_async16(slot + dst, r + at, valid);
      mma_ptx::cp_async16(slot + lay.k + dst, k + at, valid);
    }
    for (int tt = tid / kWPieces; tt < chunk; tt += kThreads / kWPieces) {
      const bool valid = t0 + tt < t_len;
      const int e = (tid % kWPieces) * 4;
      const size_t at = base + (valid ? (size_t)(t0 + tt) * step : 0) + e;
      mma_ptx::cp_async16(slot + lay.w + (tt * N + e) * 4, w + at, valid);
    }
    for (int tt = tid / kVPieces; tt < chunk; tt += kThreads / kVPieces) {
      const bool valid = t0 + tt < t_len;
      const int e = (tid % kVPieces) * kPer;
      const size_t at =
          base + (valid ? (size_t)(t0 + tt) * step : 0) + c0 + e;
      mma_ptx::cp_async16(slot + lay.v + (tt * COLS + e) * (int)sizeof(T),
                          v + at, valid);
    }
    mma_ptx::cp_async_commit();
  };

  if (n_chunks > 0) stage(0);

  // this thread's rows of its columns: each row group reads COLS
  // consecutive floats of a row, so the loads of a warp are coalesced
  float s[kRows][CPT];
  const float* s0 = state0 + ((size_t)bh * N + i0) * N + c0 + lc;
#pragma unroll
  for (int i = 0; i < kRows; ++i) load_f32<CPT>(s[i], s0 + (size_t)i * N);
  float up[kPer];  // u of the rows of this lane's pieces in the bonus
#pragma unroll
  for (int j = 0; j < kPer; j += 4) {
    load_f32<4>(up + j, u + hh * N + (lane % kPieces) * kPer + j);
  }

  struct Step {  // one step's r, k, w of this thread's rows, v of its columns
    float r[kRows], k[kRows], w[kRows], v[CPT];
  };
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * chunk;
    const int nt = min(chunk, t_len - t0);
    mma_ptx::cp_async_wait<0>();
    __syncthreads();  // chunk ci landed; every thread is done with ci - 1
    const unsigned char* slot = smem + (ci % ring) * lay.slot;
    const T* rs = reinterpret_cast<const T*>(slot);
    const T* ks = reinterpret_cast<const T*>(slot + lay.k);
    const float* ws = reinterpret_cast<const float*>(slot + lay.w);
    const T* vs = reinterpret_cast<const T*>(slot + lay.v);

    // each step's bonus sum_i r_i u_i k_i: a thread takes 16 bytes of r
    // and of k, and the kPieces consecutive lanes that hold a step's
    // pieces reduce their sums
    for (int p0 = tid - lane; p0 < nt * kPieces; p0 += kThreads) {
      const int p = p0 + lane;
      const int at = (p < nt * kPieces ? p / kPieces : 0) * N +
                     (p % kPieces) * kPer;
      float rp[kPer], kp[kPer];
      widen16(rp, rs + at);
      widen16(kp, ks + at);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) sum = fmaf(rp[j] * up[j], kp[j], sum);
#pragma unroll
      for (int off = kPieces / 2; off > 0; off /= 2) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      if (p < nt * kPieces && p % kPieces == 0) bonus[p / kPieces] = sum;
    }
    __syncthreads();  // the chunk's bonuses are in place
    // the next chunk into the other slot while this one computes (the
    // last reads of that slot, chunk ci - 1's, ended before the barrier)
    if (ci + 1 < n_chunks) stage(ci + 1);

    // the recurrence: per step, row and column one multiply-add into the
    // column's partial (the old S) and one into the state; nothing shared
    // but the partials.  Each step's r, k, w and v are read into
    // registers one step ahead, and r, k and v widened there, so the
    // reads' latency hides behind the current step's arithmetic (the
    // reads past the chunk's last step land in later buffers or the
    // slack, and are never used).
    auto fetch = [&](Step& x, int tt) {
#pragma unroll
      for (int i = 0; i < kRows; i += 4) {
        load_f32<4>(x.r + i, rs + tt * N + i0 + i);
        load_f32<4>(x.k + i, ks + tt * N + i0 + i);
        load_f32<4>(x.w + i, ws + tt * N + i0 + i);
      }
      load_f32<CPT>(x.v, vs + tt * COLS + lc);
    };
    auto advance = [&](const Step& x, int tt) {
      float acc[CPT];
#pragma unroll
      for (int m = 0; m < CPT; ++m) acc[m] = 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          acc[m] = fmaf(x.r[i], s[i][m], acc[m]);
          s[i][m] = fmaf(x.w[i], s[i][m], x.k[i] * x.v[m]);
        }
      }
      store_f32<CPT>(part + (tt * R + q) * COLS + lc, acc);
    };
    Step cur, nxt;
    fetch(cur, 0);
    for (int tt = 0; tt < nt; tt += 2) {
      fetch(nxt, tt + 1);
      advance(cur, tt);
      if (tt + 1 < nt) {
        fetch(cur, tt + 2);
        advance(nxt, tt + 1);
      }
    }
    __syncthreads();  // every partial of the chunk is in place

    // out: the R partials of each (step, column) and the bonus term
    for (int tt = q; tt < nt; tt += R) {
      float o[CPT], vj[CPT];
      load_f32<CPT>(vj, vs + tt * COLS + lc);
#pragma unroll
      for (int m = 0; m < CPT; ++m) o[m] = bonus[tt] * vj[m];
#pragma unroll
      for (int g = 0; g < R; ++g) {
        float x[CPT];
        load_f32<CPT>(x, part + (tt * R + g) * COLS + lc);
#pragma unroll
        for (int m = 0; m < CPT; ++m) o[m] += x[m];
      }
      store_out<CPT>(out + base + (size_t)(t0 + tt) * step + c0 + lc, o);
    }
  }

  float* sf = state_out + ((size_t)bh * N + i0) * N + c0 + lc;
#pragma unroll
  for (int i = 0; i < kRows; ++i) store_f32<CPT>(sf + (size_t)i * N, s[i]);
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* state0,
                   void* out, void* state_out, int b, int t, int h,
                   int chunk, int ring, int smem, cudaStream_t stream) {
  constexpr int COLS = Shape<N>::COLS, CPT = Shape<N>::CPT, R = Shape<N>::R;
  const Layout lay = layout(N, COLS, R, chunk, ring, sizeof(T));
  if (smem != lay.total) return cudaErrorInvalidValue;
  auto kernel = rwkv6_scan_kernel<T, N, COLS, CPT, R>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<b * h * (N / COLS), R * COLS / CPT, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(state0),
      static_cast<T*>(out), static_cast<float*>(state_out), t, h, chunk,
      ring);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* state0,
                     void* out, void* state_out, int b, int t, int h, int n,
                     int chunk, int ring, int smem, cudaStream_t stream) {
  switch (n) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, state0, out, state_out, b, t, h,
                           chunk, ring, smem, stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, state0, out, state_out, b, t, h,
                           chunk, ring, smem, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, state0, out, state_out, b, t, h,
                           chunk, ring, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 = float32, 1 =
// bfloat16 (of r, k, v and out; w, u and both states are always float32).
// Every pointer is a device pointer of a contiguous tensor, r, k, v and w
// 16-byte aligned; n (the head size) is 16, 32 or 64.  The launch plan
// (rwkv6_scan._plan) follows: steps per chunk, ring slots and the dynamic
// shared memory in bytes.  One launch on `stream`, nothing synchronised.
// Returns the launch's cudaError_t (0 = cudaSuccess); cudaErrorInvalidValue
// for a plan it does not build.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u,
                                 const void* state0, void* out,
                                 void* state_out, int b, int t, int h, int n,
                                 int dtype, int chunk, int ring, int smem,
                                 void* stream) {
  if (b < 0 || t < 0 || h <= 0 || chunk <= 0 || ring <= 0 || ring > 2 ||
      (t > chunk && ring < 2)) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_n<float>(r, k, v, w, u, state0, out, state_out, b, t,
                                h, n, chunk, ring, smem, st);
  }
  if (dtype == 1) {
    return (int)launch_n<__nv_bfloat16>(r, k, v, w, u, state0, out,
                                        state_out, b, t, h, n, chunk, ring,
                                        smem, st);
  }
  return (int)cudaErrorInvalidValue;
}
