// Batched per-expert GEMM on Hopper: out[e] = x[e] @ w[e], the MoE FFN's
// hot loop, for bfloat16 or float32 inputs with f32 accumulation and the
// output in x's dtype, rounded once.
//
// Replaces the Pallas TPU kernel `_gemm_kernel` behind `pallas_expert_gemm`
// (src/repro/kernels/moe_gemm.py:27 and :35).  That kernel holds a whole
// (128, D) x tile and a (D, 128) w tile in VMEM and contracts them in one
// MXU step per grid point; at D = 2048 in f32 one such tile is 1 MB, where a
// Hopper block has 227 KB of shared memory.  Here the depth is a loop.
//
// What bounds it on the H100: bytes.  At the serving shapes (deepseek-moe-16b:
// E = 64 experts, D = 2048 <-> F = 1408, C = 264 packed tokens in a mixed
// step, 8 in a decode-only one) every launch streams all E expert matrices,
// 369 MB in bf16, against 2 E C D F operations: 0.110 ms of bytes and at
// most 0.098 ms of tensor-core operations.  What the design does about it:
// each expert's weights are read from device memory once per 64-row tile of
// C (once in all at decode, where C = 8 fits one tile; the row tiles of one
// column tile run side by side and share it through L2), in 16-byte loads,
// with the next depth slab's loads started before the current slab's
// products, so a block keeps its loads in flight while it computes.  The
// broadcast x of the single-device MoE (every expert sees every token) is
// passed with an expert stride of 0 and read from its one copy.
//
// Design (correct first; wgmma, TMA and a deeper pipeline are later work).
// Both kernels: grid (ceil(F / 128), ceil(C / 64), E), one block of 256
// threads per 64 x 128 tile of out[e], a walk over D in slabs staged in
// shared memory, and the ragged C and F edges and a D that is not a multiple
// of the slab masked inside the kernel (zeros staged, stores skipped): no
// padding copy.  D and F must be multiples of 8, so a 16-byte load never
// straddles an edge.
//   * bfloat16 (the serving path): tensor cores through mma.sync
//     m16n8k16 with f32 accumulators.  64-deep slabs are staged as bf16, x
//     row-major and w as it lies (rows of F), rows padded so that the
//     ldmatrix reads of a warp hit distinct banks; w's fragments come from
//     ldmatrix.trans.  Each of the 8 warps owns a 32 x 32 piece of the tile.
//   * float32 (the parity checks): CUDA cores.  32-deep slabs, x stored
//     transposed; each thread accumulates a 4 x 8 register tile with fmaf
//     (rows ty + 16 i, columns tx + 16 j, so a warp's shared-memory reads are
//     broadcasts or consecutive words), summing its D products in order.

#include "mma_ptx.cuh"

namespace {

using namespace mma_ptx;

constexpr int kBM = 64;   // rows of C per block
constexpr int kBN = 128;  // columns of F per block
constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kHK = 64;        // depth of one staged slab
constexpr int kXP = kHK + 8;   // padded x row (bf16): 144 B, 36 words
constexpr int kWP = kBN + 8;   // padded w row (bf16): 272 B, 68 words

__global__ void __launch_bounds__(kThreads)
    expert_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w,
                            __nv_bfloat16* __restrict__ out, int c, int d,
                            int f, long long x_estride) {
  constexpr int kXC = kHK / 8;   // 16-byte chunks per x slab row
  constexpr int kWC = kBN / 8;   // 16-byte chunks per w slab row
  constexpr int kXLoads = kBM * kXC / kThreads;  // 2
  constexpr int kWLoads = kHK * kWC / kThreads;  // 4
  __shared__ __align__(16) __nv_bfloat16 xs[kBM][kXP];
  __shared__ __align__(16) __nv_bfloat16 ws[kHK][kWP];

  const int e = blockIdx.z;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wm = (tid / 32) / 4;  // warp's 32 rows: wm * 32
  const int wn = (tid / 32) % 4;  // warp's 32 columns: wn * 32
  const __nv_bfloat16* xe = x + (long long)e * x_estride;
  const __nv_bfloat16* we = w + (long long)e * d * f;

  uint4 xr[kXLoads];
  uint4 wr[kWLoads];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // start every 16-byte load of the slab at depth k0 (zeros off the edges)
  auto fetch = [&](int k0) {
#pragma unroll
    for (int p = 0; p < kXLoads; ++p) {
      const int idx = tid + p * kThreads;
      const int row = row0 + idx / kXC;
      const int k = k0 + (idx % kXC) * 8;
      xr[p] = (row < c && k < d)
                  ? *reinterpret_cast<const uint4*>(xe + (long long)row * d + k)
                  : zero;
    }
#pragma unroll
    for (int p = 0; p < kWLoads; ++p) {
      const int idx = tid + p * kThreads;
      const int k = k0 + idx / kWC;
      const int col = col0 + (idx % kWC) * 8;
      wr[p] = (k < d && col < f)
                  ? *reinterpret_cast<const uint4*>(we + (long long)k * f + col)
                  : zero;
    }
  };

  auto stash = [&]() {
#pragma unroll
    for (int p = 0; p < kXLoads; ++p) {
      const int idx = tid + p * kThreads;
      *reinterpret_cast<uint4*>(&xs[idx / kXC][(idx % kXC) * 8]) = xr[p];
    }
#pragma unroll
    for (int p = 0; p < kWLoads; ++p) {
      const int idx = tid + p * kThreads;
      *reinterpret_cast<uint4*>(&ws[idx / kWC][(idx % kWC) * 8]) = wr[p];
    }
  };

  float acc[2][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < d; k0 += kHK) {
    __syncthreads();  // every warp is done reading the previous slab
    stash();
    __syncthreads();
    if (k0 + kHK < d) fetch(k0 + kHK);  // in flight during the products
#pragma unroll
    for (int ks = 0; ks < kHK; ks += 16) {
      uint32_t a[2][4];
      uint32_t b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // matrices: rows +0 / +8 of the m16 tile, depth +0 / +8
        ldsm_x4(a[mt], &xs[wm * 32 + mt * 16 + lane % 16][ks + (lane / 16) * 8]);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        // matrices: depth +0 / +8 of the k16 step, columns +0 / +8
        uint32_t r[4];
        ldsm_x4_trans(r, &ws[ks + lane % 8 + ((lane / 8) % 2) * 8]
                            [wn * 32 + np * 16 + (lane / 16) * 8]);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
  }

  // accumulator fragment: (row g, columns 2t, 2t+1) and (row g + 8, same)
  const int g = lane / 4;
  const int t = lane % 4;
  __nv_bfloat16* oe = out + (long long)e * c * f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wm * 32 + mt * 16 + g + 8 * h;
      if (row >= c) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = col0 + wn * 32 + nt * 8 + 2 * t;
        if (col < f) {  // f is even, so col + 1 < f too
          *reinterpret_cast<__nv_bfloat162*>(oe + (long long)row * f + col) =
              __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFK = 32;        // depth of one staged slab
constexpr int kTY = 16;        // thread rows
constexpr int kTX = 16;        // thread columns
constexpr int kRM = kBM / kTY;  // output rows per thread
constexpr int kRN = kBN / kTX;  // output columns per thread
constexpr int kXS = kBM + 1;    // padded row of the transposed x slab

__global__ void __launch_bounds__(kThreads)
    expert_gemm_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           float* __restrict__ out, int c, int d, int f,
                           long long x_estride) {
  constexpr int kXC = kFK / 4;  // 16-byte chunks per x slab row
  constexpr int kWC = kBN / 4;  // 16-byte chunks per w slab row
  constexpr int kXLoads = kBM * kXC / kThreads;  // 2
  constexpr int kWLoads = kFK * kWC / kThreads;  // 4
  __shared__ float xs[kFK][kXS];  // xs[k][row]
  __shared__ __align__(16) float ws[kFK][kBN];

  const int e = blockIdx.z;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int ty = tid / kTX;
  const int tx = tid % kTX;
  const float* xe = x + (long long)e * x_estride;
  const float* we = w + (long long)e * d * f;

  float4 xr[kXLoads];
  float4 wr[kWLoads];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  auto fetch = [&](int k0) {
#pragma unroll
    for (int p = 0; p < kXLoads; ++p) {
      const int idx = tid + p * kThreads;
      const int row = row0 + idx / kXC;
      const int k = k0 + (idx % kXC) * 4;
      xr[p] = (row < c && k < d)
                  ? *reinterpret_cast<const float4*>(xe + (long long)row * d + k)
                  : zero;
    }
#pragma unroll
    for (int p = 0; p < kWLoads; ++p) {
      const int idx = tid + p * kThreads;
      const int k = k0 + idx / kWC;
      const int col = col0 + (idx % kWC) * 4;
      wr[p] = (k < d && col < f)
                  ? *reinterpret_cast<const float4*>(we + (long long)k * f + col)
                  : zero;
    }
  };

  auto stash = [&]() {
#pragma unroll
    for (int p = 0; p < kXLoads; ++p) {
      const int idx = tid + p * kThreads;
      const int r = idx / kXC;
      const int k = (idx % kXC) * 4;
      xs[k][r] = xr[p].x;
      xs[k + 1][r] = xr[p].y;
      xs[k + 2][r] = xr[p].z;
      xs[k + 3][r] = xr[p].w;
    }
#pragma unroll
    for (int p = 0; p < kWLoads; ++p) {
      const int idx = tid + p * kThreads;
      *reinterpret_cast<float4*>(&ws[idx / kWC][(idx % kWC) * 4]) = wr[p];
    }
  };

  float acc[kRM][kRN];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < d; k0 += kFK) {
    __syncthreads();
    stash();
    __syncthreads();
    if (k0 + kFK < d) fetch(k0 + kFK);
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[kRM];
      float b[kRN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) a[i] = xs[kk][ty + kTY * i];
#pragma unroll
      for (int j = 0; j < kRN; ++j) b[j] = ws[kk][tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  float* oe = out + (long long)e * c * f;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int row = row0 + ty + kTY * i;
    if (row >= c) continue;
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int col = col0 + tx + kTX * j;
      if (col < f) oe[(long long)row * f + col] = acc[i][j];
    }
  }
}

}  // namespace

// x: (E, C, D) with rows of D contiguous and expert stride x_estride
// elements (C * D, or 0 for one (C, D) matrix broadcast over the experts);
// w: (E, D, F) contiguous; out: (E, C, F) contiguous, x's dtype.
// dtype 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int expert_gemm_launch(const void* x, const void* w, void* out,
                                  int e, int c, int d, int f,
                                  long long x_estride, int dtype,
                                  void* stream) {
  if (e < 0 || c < 0 || d < 0 || f < 0 || d % 8 != 0 || f % 8 != 0
      || e > 65535 || (c + kBM - 1) / kBM > 65535 || x_estride < 0
      || x_estride % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (e == 0 || c == 0 || f == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((f + kBN - 1) / kBN, (c + kBM - 1) / kBM, e);
  if (dtype == 0) {
    expert_gemm_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), c, d, f, x_estride);
  } else if (dtype == 1) {
    expert_gemm_bf16_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), c, d, f, x_estride);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
