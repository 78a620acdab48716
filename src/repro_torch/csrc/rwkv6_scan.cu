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
// Here the block loads state0 into registers at t = 0, so the recurrence
// itself carries it: the same function, with no second pass.
//
// What bounds it on the H100: neither rate.  A decode step (T = 1) moves
// about 10.5 MB for 8 rows x 40 heads, mostly the state read and written
// once, and a prefill chunk (2 rows x 128 steps) does 5 N^2 + 5 N f32
// operations per (b, t, h) on the CUDA cores, a few microseconds either
// way.  What limits it is the serial chain over T.  The design:
//
//   * the columns of S are independent (out_t[j] = sum_i r_i S_ij +
//     v_j sum_i r_i u_i k_i; S_ij <- w_i S_ij + k_i v_j), so one block of
//     N threads runs each (b, h) and thread j keeps column j of S, N f32
//     values, in registers for the whole sequence, as the TPU kernel keeps
//     S in VMEM;
//   * the block stages kChunk time steps of r, k, w and v at a time in
//     shared memory (one coalesced row of N values per step and tensor);
//     every thread then reads the same row, a broadcast, in 16-byte
//     pieces;
//   * the bonus sum_i r_i u_i k_i, the same for every column, is reduced
//     once per step while the chunk is staged (one thread per step), not
//     in every thread;
//   * each step's dot product over i runs on four partial sums, so the
//     dependent chain is N / 4 fused multiply-adds long.
//
// N is a template parameter: 64 (rwkv6-3b), 32 and 16 (reduced configs).
//
// Later work: split the columns of a head over more blocks so the 80
// blocks of a prefill call fill 132 SMs, and load the next chunk while the
// current one computes.
//
// state0 and the final state may be the same buffer (the serving path
// updates its cache in place): thread j reads column j of its (b, h)
// before any thread writes it, and writes only column j.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;  // time steps staged in shared memory per pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

// One block per (b, h), N threads; thread j owns column j of the state.
template <typename T, int N>
__global__ void __launch_bounds__(N)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* state0,
                  T* __restrict__ out, float* state_out, int t_len, int h) {
  __shared__ __align__(16) float r_s[kChunk][N];
  __shared__ __align__(16) float k_s[kChunk][N];
  __shared__ __align__(16) float w_s[kChunk][N];
  __shared__ float v_s[kChunk][N];
  // r_i u_i k_i, transposed and padded so that both the staging writes
  // (thread i) and the reduction's reads (thread tt) avoid bank conflicts
  __shared__ float ruk_s[N][kChunk + 1];
  __shared__ float bonus_s[kChunk];  // sum_i r_i u_i k_i per step

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh % h;
  const int j = threadIdx.x;
  const float uj = u[hh * N + j];

  float s[N];
  const float* s0 = state0 + (size_t)bh * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = s0[i * N + j];

  for (int t0 = 0; t0 < t_len; t0 += kChunk) {
    const int n = min(kChunk, t_len - t0);
    __syncthreads();  // every thread is done with the previous chunk
#pragma unroll 8
    for (int tt = 0; tt < n; ++tt) {
      const size_t off = (((size_t)b * t_len + t0 + tt) * h + hh) * N + j;
      const float rj = to_f32(r[off]);
      const float kj = to_f32(k[off]);
      r_s[tt][j] = rj;
      k_s[tt][j] = kj;
      ruk_s[j][tt] = rj * uj * kj;
      w_s[tt][j] = w[off];
      v_s[tt][j] = to_f32(v[off]);
    }
    __syncthreads();  // the chunk is in shared memory
    for (int tt = j; tt < n; tt += N) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < N; i += 4) {
#pragma unroll
        for (int c = 0; c < 4; ++c) part[c] += ruk_s[i + c][tt];
      }
      bonus_s[tt] = (part[0] + part[1]) + (part[2] + part[3]);
    }
    __syncthreads();  // the chunk's bonuses are in shared memory
    for (int tt = 0; tt < n; ++tt) {
      const float vj = v_s[tt][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&r_s[tt][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&k_s[tt][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&w_s[tt][i]);
        const float ri[4] = {r4.x, r4.y, r4.z, r4.w};
        const float ki[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wi[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[c] = fmaf(ri[c], s[i + c], acc[c]);
          s[i + c] = fmaf(wi[c], s[i + c], ki[c] * vj);
        }
      }
      const float o = (acc[0] + acc[1]) + (acc[2] + acc[3])
                      + vj * bonus_s[tt];
      store(out + (((size_t)b * t_len + t0 + tt) * h + hh) * N + j, o);
    }
  }

  float* sf = state_out + (size_t)bh * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) sf[i * N + j] = s[i];
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* state0,
                   void* out, void* state_out, int b, int t, int h,
                   cudaStream_t stream) {
  rwkv6_scan_kernel<T, N><<<b * h, N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(state0),
      static_cast<T*>(out), static_cast<float*>(state_out), t, h);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* state0,
                     void* out, void* state_out, int b, int t, int h, int n,
                     cudaStream_t stream) {
  switch (n) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, state0, out, state_out, b, t, h,
                           stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, state0, out, state_out, b, t, h,
                           stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, state0, out, state_out, b, t, h,
                           stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 = float32, 1 =
// bfloat16 (of r, k, v and out; w, u and both states are always float32).
// Every pointer is a device pointer of a contiguous tensor; n (the head
// size) must be 16, 32 or 64.  One launch on `stream`, nothing
// synchronised.  Returns the launch's cudaError_t (0 = cudaSuccess).
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u,
                                 const void* state0, void* out,
                                 void* state_out, int b, int t, int h, int n,
                                 int dtype, void* stream) {
  if (b < 0 || t < 0 || h <= 0) return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_n<float>(r, k, v, w, u, state0, out, state_out, b, t,
                                h, n, st);
  }
  if (dtype == 1) {
    return (int)launch_n<__nv_bfloat16>(r, k, v, w, u, state0, out,
                                        state_out, b, t, h, n, st);
  }
  return (int)cudaErrorInvalidValue;
}
