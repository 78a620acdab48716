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
// most 0.098 ms of tensor-core operations, so the two must overlap.  A
// design that reads each expert's weights into the SMs once per tile of C
// moves several times the bound's bytes out of L2; this one reads them once
// per launch (and x once per tile of F).  The broadcast x of the
// single-device MoE (every expert sees every token) is passed with an
// expert stride of 0 and read from its one copy.
//
// bfloat16 (the serving path): wgmma on a TMA-fed ring.  The product is
// taken transposed, out[e]^T = w[e]^T x[e]^T, so that F is wgmma's 64-row M
// and C its N (a multiple of 8): the decode-only step runs at N = 8 with no
// idle rows, a mixed step at N = 264.  One block owns an (expert, F tile of
// `block_f` = 64 or 128) pair for a whole tile of C (all of C up to kCCap
// rows; wider C takes more tiles along grid x, still one launch), so each
// expert's weights cross from L2 into the SMs once per launch.
//   * Ring: `stages` slots of a 64-deep slab of w (block_f x 64, F
//     contiguous: A in MN-major form) and of x (tile rows x 64, D
//     contiguous: B in K-major form), each loaded by TMA with the 128-byte
//     swizzle and counted on the slot's full mbarrier; TMA's zero fill past
//     the tensors' ends covers the C, D and F edges, so there is no padding
//     copy.  A slot is refilled when every consumer has arrived on its
//     empty mbarrier.
//   * Warpgroups: one producer (one thread issues the loads; setmaxnreg
//     gives its registers away) and block_f / 64 consumers, each owning 64
//     rows of F and all N columns: per 16-deep step, wgmma m64nWk16 for
//     each power-of-two width W in N's binary split (N past 256: N - 128
//     and 128, so 264 = 136 + 128), f32 accumulators in registers (N / 2 a
//     thread), each slot's group waited for before its slot is freed.
//   * Epilogue: the accumulators, rounded once to bf16, are transposed
//     through shared memory (the drained ring) into rows of F and written
//     with 16-byte stores, masked at the C and F edges.
// The launch plan (block_f, the C tile, the stage count and the dynamic
// shared memory) comes from the shapes alone, in kernels/expert_gemm.py.
//
// float32 (the parity checks): CUDA cores.  Grid (ceil(F / 128),
// ceil(C / 64), E), one block of 256 threads per 64 x 128 tile of out[e],
// 32-deep slabs staged in shared memory with x stored transposed, the
// ragged C and F edges and a D that is not a multiple of the slab masked
// inside the kernel (zeros staged, stores skipped): no padding copy.  D and
// F must be multiples of 8, so a 16-byte load never straddles an edge.
// Each thread accumulates a 4 x 8 register tile with fmaf (rows ty + 16 i,
// columns tx + 16 j, so a warp's shared-memory reads are broadcasts or
// consecutive words), summing its D products in order.

#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is looked up
                   // through the runtime at first use: no -lcuda

#include <array>
#include <utility>

#include "mma_ptx.cuh"

namespace {

using namespace mma_ptx;

constexpr int kBM = 64;   // rows of C per block (float32)
constexpr int kBN = 128;  // columns of F per block (float32)
constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// bfloat16: wgmma on a TMA-fed shared-memory ring
// ---------------------------------------------------------------------------

constexpr int kSlab = 64;                 // depth of one ring slot
constexpr int kRowBytes = kSlab * 2;      // one 128-byte swizzle row
constexpr int kWHalf = 64 * kRowBytes;    // a 64-wide F slab of w: 8 KB
constexpr int kCCap = 272;                // widest C tile
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;        // a block's shared memory
constexpr int kAlign = 1024;              // a 128-byte-swizzled TMA tile
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// x's tile in a ring slot: one TMA box of all NT rows, or two boxes of a
// multiple of 8 rows each (so the second starts on a 1024-byte swizzle
// atom) past the box's 256-row limit
__host__ __device__ constexpr int x_loads(int nt) { return nt > 256 ? 2 : 1; }

__host__ __device__ constexpr int x_box_rows(int nt) {
  return x_loads(nt) == 2 ? (nt / 2 + 7) / 8 * 8 : nt;
}

// one 16-deep step of an NT-wide tile: a wgmma for each power-of-two width
// W in NT's binary split, widest first, on x rows [N0, N0 + W) and the
// accumulators from N0 / 2; past 256, NT - 128 and 128 (264 = 136 + 128:
// two products of like size ran faster on the H100 than 256 + 8)
template <int NT, int W = 256, int N0 = 0>
__device__ __forceinline__ void wgmma_step(float* acc, uint64_t desc_a,
                                           uint64_t desc_b) {
  if constexpr (NT > 256) {
    wgmma_bf16_tn<NT - 128>(acc, desc_a, desc_b);
    wgmma_bf16_tn<128>(acc + (NT - 128) / 2, desc_a,
                       desc_b + (((NT - 128) * kRowBytes) >> 4));
  } else if constexpr (W >= 8) {
    constexpr bool take = ((NT / 8) & (W / 8)) != 0;
    if constexpr (take) {
      wgmma_bf16_tn<W>(acc + N0 / 2, desc_a,
                       desc_b + ((N0 * kRowBytes) >> 4));
    }
    wgmma_step<NT, W / 2, take ? N0 + W : N0>(acc, desc_a, desc_b);
  }
}

template <int NT>
__global__ void __launch_bounds__(384, 1)
    expert_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                             const __grid_constant__ CUtensorMap x_map,
                             __nv_bfloat16* __restrict__ out, int c, int d,
                             int f, int block_f, int stages, int x_shared) {
  constexpr int kXBox = x_box_rows(NT);
  constexpr int kXBytes = x_loads(NT) * kXBox * kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1)
      & ~static_cast<uintptr_t>(kAlign - 1));
  const int n_cons = block_f / 64;  // consumer warpgroups
  const int w_bytes = n_cons * kWHalf;
  const int stage_bytes = w_bytes + kXBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * stage_bytes);
  uint64_t* empty = full + stages;
  const int c0 = blockIdx.x * NT;
  const int f0 = blockIdx.y * block_f;
  const int e = blockIdx.z;
  const int n_k = (d + kSlab - 1) / kSlab;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], n_cons);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == n_cons) {  // the producer: the last warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 == 0) {
      const int xe = x_shared ? 0 : e;
      for (int kb = 0; kb < n_k; ++kb) {
        const int s = kb % stages;
        mbar_wait(&empty[s], ((kb / stages) & 1) ^ 1);  // round 0 passes
        uint8_t* slot = smem + s * stage_bytes;
        mbar_expect_tx(&full[s], stage_bytes);
        for (int h = 0; h < n_cons; ++h) {
          tma_load_3d(slot + h * kWHalf, &w_map, &full[s], f0 + 64 * h,
                      kb * kSlab, e);
        }
        for (int l = 0; l < x_loads(NT); ++l) {
          tma_load_3d(slot + w_bytes + l * kXBox * kRowBytes, &x_map,
                      &full[s], kb * kSlab, c0 + l * kXBox, xe);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < n_k; ++kb) {
    const int s = kb % stages;
    mbar_wait(&full[s], (kb / stages) & 1);
    const uint8_t* slot = smem + s * stage_bytes;
    // A: this warpgroup's 64 rows of F, one 128-byte row per depth;
    // B: x's rows, one 128-byte row of depth per C row
    const uint64_t a = wgmma_desc_sw128(slot + wg * kWHalf, kWHalf,
                                        8 * kRowBytes);
    const uint64_t b = wgmma_desc_sw128(slot + w_bytes, 16, 8 * kRowBytes);
    fence_regs<NT / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSlab / 16; ++ks) {
      // 16 depths: 16 rows of A (2048 bytes), 32 bytes along B's rows
      wgmma_step<NT>(acc, a + ((ks * 16 * kRowBytes) >> 4),
                     b + ((ks * 32) >> 4));
    }
    wgmma_commit();
    // Wait for this slot's products before the next slot's issue.  Keeping
    // a group in flight across the loop (wait_group 1) gave wrong sums at
    // N >= 128 on the H100 (the last depth step missing from some columns),
    // and was no faster: the ring keeps the loads ahead either way, and the
    // other consumer warpgroup fills the tensor cores meanwhile.
    wgmma_wait<0>();
    fence_regs<NT / 2>(acc);
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);  // free the slot
  }

  // epilogue: every consumer is done with the ring, which now stages the
  // bf16 tile as rows of C, each block_f values of F (padded by 8: the
  // scalar writes of a warp hit distinct banks)
  named_barrier(1, 128 * n_cons);
  const int ld = block_f + 8;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  const int lane = threadIdx.x % 32;
  // accumulator fragment: value 4 j + 2 h + b is row g + 8 h of the
  // warp's 16 (F), column 8 j + 2 t + b (C), g = lane / 4, t = lane % 4
  const int m0 = wg * 64 + ((threadIdx.x % 128) / 32) * 16 + lane / 4;
  const int n0 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        tile[(8 * j + n0 + b) * ld + m0 + 8 * h] =
            __float2bfloat16_rn(acc[4 * j + 2 * h + b]);
      }
    }
  }
  named_barrier(1, 128 * n_cons);
  const int chunks = block_f / 8;  // 16-byte pieces of a staged row
  __nv_bfloat16* oe = out + static_cast<long long>(e) * c * f;
  for (int i = threadIdx.x; i < NT * chunks; i += 128 * n_cons) {
    const int n = i / chunks;
    const int q = i % chunks;
    const int row = c0 + n;
    const int col = f0 + 8 * q;
    if (row < c && col < f) {  // f % 8 == 0: a piece is in or out whole
      *reinterpret_cast<uint4*>(oe + static_cast<long long>(row) * f + col) =
          *reinterpret_cast<const uint4*>(tile + n * ld + 8 * q);
    }
  }
}

using WgmmaKernel = void (*)(CUtensorMap, CUtensorMap, __nv_bfloat16*, int,
                             int, int, int, int, int);

template <int... I>
std::array<WgmmaKernel, sizeof...(I)> wgmma_kernels(
    std::integer_sequence<int, I...>) {
  return {{&expert_gemm_wgmma_kernel<8 * (I + 1)>...}};
}

// one instance per C tile width 8, 16, ..., kCCap
const std::array<WgmmaKernel, kCCap / 8> kWgmmaKernels =
    wgmma_kernels(std::make_integer_sequence<int, kCCap / 8>{});

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once; null if missing
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a bf16 tensor (n2, n1, n0), n0 contiguous, read in boxes of (1, box1,
// box0) with the 128-byte swizzle (box0 = 64: one 128-byte row); reads
// past its end give zeros
bool tile_map(CUtensorMap* map, const void* base, unsigned long long n0,
              unsigned long long n1, unsigned long long n2, unsigned box0,
              unsigned box1) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {n0 * 2, n0 * n1 * 2};  // bytes
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the dynamic shared memory of a plan: alignment slack, the ring, and a
// full and an empty mbarrier per slot
int wgmma_smem(int block_f, int c_tile, int stages) {
  const int slot = block_f / 64 * kWHalf
                   + x_loads(c_tile) * x_box_rows(c_tile) * kRowBytes;
  return kAlign + stages * slot + 16 * stages;
}

int launch_wgmma(const void* x, const void* w, void* out, int e, int c,
                 int d, int f, long long x_estride, int block_f, int c_tile,
                 int c_tiles, int stages, int smem, cudaStream_t st) {
  const int f_tiles = (f + block_f - 1) / block_f;
  if ((block_f != 64 && block_f != 128) || c_tile < 8 || c_tile > kCCap
      || c_tile % 8 != 0 || c_tiles < 1
      || static_cast<long long>(c_tiles) * c_tile < c || stages < 2
      || stages > kMaxStages || smem != wgmma_smem(block_f, c_tile, stages)
      || smem > kSmemLimit || f_tiles > 65535
      || (x_estride != 0 && x_estride != static_cast<long long>(c) * d)) {
    return (int)cudaErrorInvalidValue;
  }
  if (d == 0) {  // no depth: zeros, as the sum of no products
    return (int)cudaMemsetAsync(out, 0, 2ull * e * c * f, st);
  }
  static bool configured = false;  // every instance's shared-memory cap
  if (!configured) {
    for (WgmmaKernel k : kWgmmaKernels) {
      const cudaError_t err = cudaFuncSetAttribute(
          reinterpret_cast<const void*>(k),
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (err != cudaSuccess) return (int)err;
    }
    configured = true;
  }
  CUtensorMap w_map, x_map;
  if (!tile_map(&w_map, w, f, d, e, 64, kSlab)
      || !tile_map(&x_map, x, d, c, x_estride == 0 ? 1 : e, kSlab,
                   x_box_rows(c_tile))) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(c_tiles, f_tiles, e);
  kWgmmaKernels[c_tile / 8 - 1]<<<grid, 128 * (block_f / 64 + 1), smem,
                                   st>>>(
      w_map, x_map, static_cast<__nv_bfloat16*>(out), c, d, f, block_f,
      stages, x_estride == 0 ? 1 : 0);
  return (int)cudaGetLastError();
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
// dtype 0 = float32 (CUDA cores; the plan's ints are not read), 1 =
// bfloat16 (wgmma): block_f, c_tile, c_tiles, stages and smem are the
// launch plan of kernels/expert_gemm.py.  Returns a cudaError_t.
extern "C" int expert_gemm_launch(const void* x, const void* w, void* out,
                                  int e, int c, int d, int f,
                                  long long x_estride, int dtype,
                                  int block_f, int c_tile, int c_tiles,
                                  int stages, int smem, void* stream) {
  if (e < 0 || c < 0 || d < 0 || f < 0 || d % 8 != 0 || f % 8 != 0
      || e > 65535 || x_estride < 0 || x_estride % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (e == 0 || c == 0 || f == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if ((c + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((f + kBN - 1) / kBN, (c + kBM - 1) / kBM, e);
    expert_gemm_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), c, d, f, x_estride);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    return launch_wgmma(x, w, out, e, c, d, f, x_estride, block_f, c_tile,
                        c_tiles, stages, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}
