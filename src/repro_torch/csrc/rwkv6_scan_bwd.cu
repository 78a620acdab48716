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
// What bounds it on the H100: like the forward, the f32 issue rate and the
// shared memory's bandwidth of a walk that is serial over time, here with
// about 7 f32 instructions per state element and step (the recompute's
// update, the four gradient sums and G's update) and the row sums of dr,
// dk and dw across a row group's lanes.  The bytes are small: the inputs
// once, the gradients once.  The design:
//
//   * S is never recovered by inverting the recurrence (w_t = exp(-exp(.))
//     can be ~0): each chunk, from the last to the first, is re-run forward
//     from its boundary state, and every step's S is kept in a scratch
//     buffer (`hist`) that only the thread that wrote it reads back, laid
//     out so a warp's stores and loads are coalesced; the chunk's states
//     of one block (chunk x N x COLS f32, 256 KB at N = 64) do not fit in
//     its shared memory, and its L2 footprint (21 MB for rwkv6-3b's 40
//     heads) does;
//   * the forward's column split: a block takes COLS columns of one
//     (b, h), with the forward's Shape<N> (thread (q, l) keeps rows q N/R
//     .. of CPT adjacent columns of S and of G in registers).  G's columns
//     are independent, and dv sums over rows inside the block (partials in
//     shared memory, reduced once per chunk as the forward reduces out);
//   * dr, dk and dw sum over all N columns, across the N / COLS blocks of a
//     head, and du over B and T: each block writes its row sums as
//     partials, and a second pass (`combine`, a warp per step) adds the
//     blocks' partials and the terms that need whole rows (dout_t . v_t),
//     then a third (`du_sum`) adds the combine's per-tile du partials, in a
//     fixed order: no atomics, the same sums every run.
//
// A simple first kernel: the chunk's rows are staged with plain loads
// (no cp.async ring), and the walk is serial over the chunk's steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// The forward's block of each head size (rwkv6_scan.cu's Shape<N>).
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

constexpr int kMaxChunk = 32;    // steps per chunk, at most (rwkv6_scan.CHUNK)
constexpr int kTile = 32;        // steps per block of the combine pass
constexpr int kCombineWarps = 8;

// The dynamic shared memory of the walk, in floats, whatever the chunk:
// r, k, w [chunk][N], v, dout [chunk][COLS], the bonus [chunk] and the dv
// partials [chunk][R][COLS] (rwkv6_scan_bwd._plan repeats it).
__host__ __device__ constexpr int smem_floats(int n, int cols, int rows) {
  return kMaxChunk * (3 * n + 2 * cols + 1 + rows * cols);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// The walk: one block per COLS columns of one (b, h), chunks from the last
// to the first.  Writes dv, dstate0 and the row-sum partials `part`
// (3, N / COLS, B, T, H, N): dr's (sum_j dout_j S_ij), dk's (sum_j G_ij
// v_j) and dw's (sum_j G_ij S_ij) over this block's columns.
template <typename T, int N, int COLS, int CPT, int R>
__global__ void __launch_bounds__(R * COLS / CPT)
wkv_bwd_walk(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ bounds,
             const T* __restrict__ dout, const float* __restrict__ dstate,
             float* __restrict__ hist, float* __restrict__ part,
             T* __restrict__ dv, float* __restrict__ dstate0, int b_len,
             int t_len, int h, int chunk) {
  constexpr int kGroup = COLS / CPT;  // threads of a row group
  constexpr int kThreads = R * kGroup;
  constexpr int kRows = N / R;        // state rows of each thread
  constexpr int kSplit = N / COLS;    // blocks of one (b, h)
  static_assert(kThreads % 32 == 0 && 32 % kGroup == 0, "threads");
  static_assert(N % R == 0 && N % COLS == 0 && COLS % CPT == 0, "shape");

  extern __shared__ __align__(16) float sm[];
  float* rs = sm;
  float* ks = rs + kMaxChunk * N;
  float* ws = ks + kMaxChunk * N;
  float* vs = ws + kMaxChunk * N;
  float* ds = vs + kMaxChunk * COLS;
  float* bonus = ds + kMaxChunk * COLS;
  float* dvp = bonus + kMaxChunk;  // [chunk][R][COLS]

  const int bh = blockIdx.x / kSplit;
  const int cb = blockIdx.x % kSplit;
  const int c0 = cb * COLS;
  const int bb = bh / h;
  const int hh = bh % h;
  const int tid = threadIdx.x;
  const int lc = (tid % kGroup) * CPT;  // first column of this thread
  const int q = tid / kGroup;
  const int i0 = q * kRows;
  const size_t step = (size_t)h * N;
  const size_t base = (size_t)bb * t_len * step + (size_t)hh * N;
  const int n_chunks = (t_len + chunk - 1) / chunk;
  const size_t plane = (size_t)b_len * t_len * h * N;
  float* pr = part + (size_t)cb * plane;
  float* pk = part + (size_t)(kSplit + cb) * plane;
  float* pw = part + (size_t)(2 * kSplit + cb) * plane;
  // this block's slice of the scratch: [step][row][thread][CPT]
  float* hb = hist + (size_t)blockIdx.x * kMaxChunk * N * COLS;
  auto hist_at = [&](int tt, int i) {
    return hb + ((size_t)(tt * kRows + i) * kThreads + tid) * CPT;
  };

  float g[kRows][CPT];
  const size_t so = ((size_t)bh * N + i0) * N + c0 + lc;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      g[i][m] = dstate != nullptr ? dstate[so + (size_t)i * N + m] : 0.f;
    }
  }

  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const int t0 = ci * chunk;
    const int nt = min(chunk, t_len - t0);
    __syncthreads();  // every read of the last chunk's rows is done
    for (int x = tid; x < nt * N; x += kThreads) {
      const size_t at = base + (size_t)(t0 + x / N) * step + x % N;
      rs[x] = to_f32(r[at]);
      ks[x] = to_f32(k[at]);
      ws[x] = w[at];
    }
    for (int x = tid; x < nt * COLS; x += kThreads) {
      const size_t at = base + (size_t)(t0 + x / COLS) * step + c0 + x % COLS;
      vs[x] = to_f32(v[at]);
      ds[x] = to_f32(dout[at]);
    }
    __syncthreads();  // the chunk's rows are in place
    for (int tt = tid; tt < nt; tt += kThreads) {
      float sum = 0.f;
      for (int e = 0; e < N; ++e) {
        sum = fmaf(rs[tt * N + e] * u[hh * N + e], ks[tt * N + e], sum);
      }
      bonus[tt] = sum;  // read after the walk's closing barrier
    }

    // the chunk's states, re-run forward from its boundary (the forward
    // kernel's arithmetic), each step's kept in the scratch
    float s[kRows][CPT];
    const float* sb = bounds + (((size_t)bb * n_chunks + ci) * h + hh) * N * N +
                      (size_t)i0 * N + c0 + lc;
#pragma unroll
    for (int i = 0; i < kRows; ++i) load_f32<CPT>(s[i], sb + (size_t)i * N);
    for (int tt = 0; tt < nt; ++tt) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        store_f32<CPT>(hist_at(tt, i), s[i]);
        const float wi = ws[tt * N + i0 + i], ki = ks[tt * N + i0 + i];
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          s[i][m] = fmaf(wi, s[i][m], ki * vs[tt * COLS + lc + m]);
        }
      }
    }

    // the reverse walk
    for (int tt = nt - 1; tt >= 0; --tt) {
      float vj[CPT], dj[CPT], a_v[CPT];
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        vj[m] = vs[tt * COLS + lc + m];
        dj[m] = ds[tt * COLS + lc + m];
        a_v[m] = 0.f;
      }
      float a_r[kRows], a_k[kRows], a_w[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float si[CPT];
        load_f32<CPT>(si, hist_at(tt, i));
        const float ri = rs[tt * N + i0 + i], ki = ks[tt * N + i0 + i];
        const float wi = ws[tt * N + i0 + i];
        a_r[i] = a_k[i] = a_w[i] = 0.f;
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          a_r[i] = fmaf(dj[m], si[m], a_r[i]);
          a_k[i] = fmaf(g[i][m], vj[m], a_k[i]);
          a_w[i] = fmaf(g[i][m], si[m], a_w[i]);
          a_v[m] = fmaf(g[i][m], ki, a_v[m]);
          g[i][m] = fmaf(wi, g[i][m], ri * dj[m]);
        }
      }
      store_f32<CPT>(dvp + (tt * R + q) * COLS + lc, a_v);
      // the row sums over this block's columns: the kGroup lanes of the
      // row group, then one lane writes them
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int off = kGroup / 2; off > 0; off /= 2) {
          a_r[i] += __shfl_xor_sync(0xffffffffu, a_r[i], off);
          a_k[i] += __shfl_xor_sync(0xffffffffu, a_k[i], off);
          a_w[i] += __shfl_xor_sync(0xffffffffu, a_w[i], off);
        }
      }
      if (tid % kGroup == 0) {
        const size_t at = ((size_t)(bb * t_len + t0 + tt) * h + hh) * N + i0;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          pr[at + i] = a_r[i];
          pk[at + i] = a_k[i];
          pw[at + i] = a_w[i];
        }
      }
    }
    __syncthreads();  // every dv partial and bonus of the chunk is in place

    // dv: the R partials of each (step, column) and the bonus term
    for (int tt = q; tt < nt; tt += R) {
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        float o = ds[tt * COLS + lc + m] * bonus[tt];
#pragma unroll
        for (int gq = 0; gq < R; ++gq) o += dvp[(tt * R + gq) * COLS + lc + m];
        dv[base + (size_t)(t0 + tt) * step + c0 + lc + m] = from_f32<T>(o);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    store_f32<CPT>(dstate0 + so + (size_t)i * N, g[i]);
  }
}

// The second pass: a block per kTile steps of one (b, h), a warp per step.
// dr = the blocks' dr partials + u k (dout . v), dk = theirs + r u (dout .
// v), dw = theirs; the tile's du partial sum_t r k (dout . v) goes to
// du_part (B * tiles, H, N).
template <typename T, int N, int KSPLIT>
__global__ void __launch_bounds__(kCombineWarps * 32)
wkv_bwd_combine(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ u,
                const T* __restrict__ dout, const float* __restrict__ part,
                T* __restrict__ dr, T* __restrict__ dk,
                float* __restrict__ dw, float* __restrict__ du_part,
                int b_len, int t_len, int h) {
  constexpr int kE = (N + 31) / 32;  // elements of a row per lane
  __shared__ float red[kCombineWarps][N];
  const int tiles = (t_len + kTile - 1) / kTile;
  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int bb = bh / h;
  const int hh = bh % h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t plane = (size_t)b_len * t_len * h * N;

  float uu[kE], du_acc[kE];
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const int e = lane + 32 * j;
    uu[j] = e < N ? u[hh * N + e] : 0.f;
    du_acc[j] = 0.f;
  }
  for (int tt = warp; tt < kTile; tt += kCombineWarps) {
    const int t = tile * kTile + tt;
    if (t >= t_len) break;  // the same for every lane of the warp
    const size_t row = ((size_t)(bb * t_len + t) * h + hh) * N;
    float rr[kE], kk[kE], dot = 0.f;
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int e = lane + 32 * j;
      rr[j] = e < N ? to_f32(r[row + e]) : 0.f;
      kk[j] = e < N ? to_f32(k[row + e]) : 0.f;
      if (e < N) dot = fmaf(to_f32(dout[row + e]), to_f32(v[row + e]), dot);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int e = lane + 32 * j;
      if (e >= N) continue;
      float sr = 0.f, sk = 0.f, sw = 0.f;
#pragma unroll
      for (int c = 0; c < KSPLIT; ++c) {
        sr += part[(size_t)c * plane + row + e];
        sk += part[(size_t)(KSPLIT + c) * plane + row + e];
        sw += part[(size_t)(2 * KSPLIT + c) * plane + row + e];
      }
      dr[row + e] = from_f32<T>(fmaf(uu[j] * kk[j], dot, sr));
      dk[row + e] = from_f32<T>(fmaf(rr[j] * uu[j], dot, sk));
      dw[row + e] = sw;
      du_acc[j] = fmaf(rr[j] * kk[j], dot, du_acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const int e = lane + 32 * j;
    if (e < N) red[warp][e] = du_acc[j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < N; e += blockDim.x) {
    float sum = 0.f;
#pragma unroll
    for (int wq = 0; wq < kCombineWarps; ++wq) sum += red[wq][e];
    du_part[((size_t)(bb * tiles + tile) * h + hh) * N + e] = sum;
  }
}

// The third pass: du[h, e] = the sum of the `parts` tile partials, in order.
__global__ void wkv_bwd_du_sum(const float* __restrict__ du_part,
                               float* __restrict__ du, int parts, int hn) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= hn) return;
  float sum = 0.f;
  for (int p = 0; p < parts; ++p) sum += du_part[(size_t)p * hn + x];
  du[x] = sum;
}

struct Args {
  const void *r, *k, *v, *w, *u, *bounds, *dout, *dstate;
  void *hist, *part, *du_part, *dr, *dk, *dv, *dw, *du, *dstate0;
};

template <typename T, int N>
cudaError_t launch(const Args& a, int b, int t, int h, int chunk, int smem,
                   cudaStream_t stream) {
  constexpr int COLS = Shape<N>::COLS, CPT = Shape<N>::CPT, R = Shape<N>::R;
  if (smem != smem_floats(N, COLS, R) * (int)sizeof(float)) {
    return cudaErrorInvalidValue;
  }
  if (b > 0) {
    auto walk = wkv_bwd_walk<T, N, COLS, CPT, R>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          walk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    walk<<<b * h * (N / COLS), R * COLS / CPT, smem, stream>>>(
        static_cast<const T*>(a.r), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const float*>(a.w),
        static_cast<const float*>(a.u), static_cast<const float*>(a.bounds),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.dstate),
        static_cast<float*>(a.hist), static_cast<float*>(a.part),
        static_cast<T*>(a.dv), static_cast<float*>(a.dstate0), b, t, h,
        chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int tiles = (t + kTile - 1) / kTile;
  if (b > 0 && t > 0) {
    wkv_bwd_combine<T, N, N / COLS>
        <<<b * h * tiles, kCombineWarps * 32, 0, stream>>>(
            static_cast<const T*>(a.r), static_cast<const T*>(a.k),
            static_cast<const T*>(a.v), static_cast<const float*>(a.u),
            static_cast<const T*>(a.dout), static_cast<const float*>(a.part),
            static_cast<T*>(a.dr), static_cast<T*>(a.dk),
            static_cast<float*>(a.dw), static_cast<float*>(a.du_part), b, t,
            h);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  wkv_bwd_du_sum<<<(h * N + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(a.du_part), static_cast<float*>(a.du),
      b * tiles, h * N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const Args& a, int b, int t, int h, int n, int chunk,
                     int smem, cudaStream_t stream) {
  switch (n) {
    case 16:
      return launch<T, 16>(a, b, t, h, chunk, smem, stream);
    case 32:
      return launch<T, 32>(a, b, t, h, chunk, smem, stream);
    case 64:
      return launch<T, 64>(a, b, t, h, chunk, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 = float32, 1 =
// bfloat16 (of r, k, v, dout, dr, dk and dv; everything else is float32).
// Every pointer is a device pointer of a contiguous tensor, 16-byte
// aligned; dstate may be null (a zero gradient of the final state).  The
// scratch: hist (B H N/COLS blocks x 32 x N x COLS f32), part (3 x N/COLS
// x B T H N f32), du_part (B ceil(T/32) H N f32).  chunk is the forward's
// (rwkv6_scan.bound_chunk), at most 32; smem the walk's dynamic shared
// memory (rwkv6_scan_bwd._plan).  Three launches on `stream`, nothing
// synchronised.  Returns the first failing launch's cudaError_t (0 =
// cudaSuccess); cudaErrorInvalidValue for a plan it does not build.
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* bounds, const void* dout, const void* dstate,
    void* hist, void* part, void* du_part, void* dr, void* dk, void* dv,
    void* dw, void* du, void* dstate0, int b, int t, int h, int n, int dtype,
    int chunk, int smem, void* stream) {
  if (b < 0 || t < 0 || h <= 0 || chunk <= 0 || chunk > kMaxChunk) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{r,    k,       v,  w,  u,  bounds, dout, dstate, hist,
               part, du_part, dr, dk, dv, dw,     du,   dstate0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_n<float>(a, b, t, h, n, chunk, smem, st);
  if (dtype == 1) {
    return (int)launch_n<__nv_bfloat16>(a, b, t, h, n, chunk, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}
