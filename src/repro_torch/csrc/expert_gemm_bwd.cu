// The expert GEMM's backward on Hopper, for bfloat16: the three products
// of training's MoE gradient, each accumulated in f32 and rounded once to
// bf16, with every operand read where it lies.
//
//   dX_e = dY_e W_e^T    (C, F) @ (F, D), per expert
//   dW_e = X_e^T dY_e    (D, C) @ (C, F), per expert; X may be one (C, D)
//                        matrix shared by every expert
//   dX   = sum_e dY_e W_e^T   (x broadcast over the experts): one (C, D)
//
// The reference differentiates its jnp einsum (src/repro/kernels/ops.py:102,
// `expert_gemm`), so no Pallas backward is replaced; this kernel is the
// gradient of the one that replaces `_gemm_kernel`
// (src/repro/kernels/moe_gemm.py:27).
//
// What bounds it on the H100: both.  At granite-moe-3b-a800m's training
// shapes (E 40, D 1,536 <-> F 512, 1,024 tokens) each product is 64.4 GFLOP
// (0.0651 ms at 989 TFLOP/s) against 108-231 MB (0.032-0.069 ms at 3.35
// TB/s): 277 FLOP a byte at the down products, near the card's ridge.  So
// the tensor cores must stay fed and the launch must fill the card.
//
// Every product is taken transposed, out^T (M x N) = A (M x K) B (K x N),
// so that the output's contiguous axis is wgmma's M, as in the forward:
//   dX:  M = D, N = C, K = F.  A is W_e (D, F) as stored, F contiguous:
//        K-major; B is dY_e (C, F) as stored: K-major.
//   dW:  M = F, N = D, K = C.  A is dY_e (C, F) as stored, F contiguous:
//        MN-major; B is X_e (C, D) as stored, D contiguous: MN-major.
// wgmma's transpose immediates (wgmma_bf16_tn<N, kTA, kTB>) and the TMA
// maps take each operand in the layout it has, so the wrapper makes no
// transposed, permuted or padded copy.  TMA's zero fill past a map's end
// covers every edge: C off a multiple of 8 or of the tile (the depth of dW
// stops at each expert's last token, since the map is 3-D), F off a
// multiple of 64 (a slab of the summed dX stops at its expert's end), and
// the M and N edges of the tile, which the epilogue masks.
//
// The depth walk.  A tile is 128 rows of M (two consumer warpgroups of
// 64) by BN columns of N (64, 128 or 256: wgmma's N) over a range of
// (expert, 64-deep slab) pairs: one expert's slabs for the per-expert
// products, or a share of all E K / 64 pairs for the summed dX, so that a
// product of few tiles still covers the SMs.  Shares write f32 partials
// that a second kernel adds in share order (no atomics: two launches are
// bit for bit equal).  The plan (kernels/expert_gemm.py:bwd_plan) picks BN
// and the shares from the shapes and the SM count alone.
//
// The block: one producer warpgroup (one thread issues the TMA loads into
// a ring of `stages` slots, each an A slab of 128 x 64 and a B slab of BN x
// 64 with the 128-byte swizzle) and two consumer warpgroups.  A consumer
// keeps one wgmma group in flight: it issues a slot's four 16-deep
// products, commits them, waits until at most that group runs
// (wait_group 1), and then frees the slot of the group before, which has
// finished; after the walk it waits for the last group before the
// epilogue reads the accumulators.  (Freeing the slot just issued, or
// reading the accumulators with the last group still running, lets the
// next load or the epilogue race the products: the last depth step goes
// missing from some columns.)  The epilogue stores straight from the
// accumulators, bf16 pairs (one shuffle a pair) or f32 partials, each
// warp's store four full 32-byte sectors, so it needs no shared memory and
// the ring stays the producer's: with fewer blocks than tiles (the plan's
// persistent grid) a block walks tile after tile and the producer loads
// the next tile's slabs while the consumers store the last one's.

#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is looked up
                   // through the runtime at first use: no -lcuda

#include <array>

#include "mma_ptx.cuh"

namespace {

using namespace mma_ptx;

constexpr int kSlab = 64;               // depth of one ring slot
constexpr int kRowBytes = kSlab * 2;    // one 128-byte swizzle row
constexpr int kBox = 64 * kRowBytes;    // a 64 x 64 box: 8 KB
constexpr int kTileM = 128;             // rows of M a block
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;      // a block's shared memory
constexpr int kAlign = 1024;            // a 128-byte-swizzled TMA tile
constexpr int kThreads = 384;           // two consumers and the producer
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

__host__ __device__ constexpr int stage_bytes(int bn) {
  return (kTileM + bn) * kRowBytes;
}

// the dynamic shared memory of a plan: alignment slack, the ring, and a
// full and an empty mbarrier per slot
__host__ __device__ constexpr int bwd_smem(int bn, int stages) {
  return kAlign + stages * (stage_bytes(bn) + 16);
}

static_assert(bwd_smem(256, 4) <= kSmemLimit,
              "a 256-wide tile keeps four slots");

// kMn: the dW product (A and B MN-major); else dX (both K-major).  Block
// b takes the tiles b, b + gridDim.x, ... of n_tiles x m_tiles x shares
// (N fastest, then M, then the expert or share), so a grid of fewer
// blocks than tiles is persistent: the producer loads the next tile's
// slabs while the consumers store the last one's.
template <int BN, bool kMn>
__global__ void __launch_bounds__(kThreads, 1)
    expert_gemm_bwd_kernel(const __grid_constant__ CUtensorMap a_map,
                           const __grid_constant__ CUtensorMap b_map,
                           void* __restrict__ out, int m, int n,
                           int k_slabs, int pairs, int shares, int n_tiles,
                           int m_tiles, int b_shared, int f32_out,
                           int stages) {
  constexpr int kABytes = kTileM * kRowBytes;  // 16 KB
  constexpr int kStage = stage_bytes(BN);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1)
      & ~static_cast<uintptr_t>(kAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * kStage);
  uint64_t* empty = full + stages;
  const int tiles = n_tiles * m_tiles * shares;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 == 0) {
      int s = 0, phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int n0 = (t % n_tiles) * BN;
        const int m0 = (t / n_tiles % m_tiles) * kTileM;
        const int z = t / (n_tiles * m_tiles);
        // the tile's pairs [j0, j1): pair j is slab j % k_slabs of expert
        // j / k_slabs (shares == experts: exactly one expert's slabs)
        const int j0 = static_cast<int>(static_cast<long long>(z) * pairs
                                        / shares);
        const int j1 = static_cast<int>(static_cast<long long>(z + 1)
                                        * pairs / shares);
        for (int j = j0; j < j1; ++j) {
          mbar_wait(&empty[s], phase ^ 1);  // round 0 passes
          const int e = j / k_slabs;
          const int k0 = (j - e * k_slabs) * kSlab;
          uint8_t* slot = smem + s * kStage;
          mbar_expect_tx(&full[s], kStage);
          if constexpr (kMn) {
            // A: dY_e's tokens [k0, k0 + 64) by F [m0, m0 + 128), two
            // boxes; B: X's tokens [k0, k0 + 64) by D [n0, n0 + BN), BN /
            // 64 boxes
            tma_load_3d(slot, &a_map, &full[s], m0, k0, e);
            tma_load_3d(slot + kBox, &a_map, &full[s], m0 + 64, k0, e);
#pragma unroll
            for (int q = 0; q < BN / 64; ++q) {
              tma_load_3d(slot + kABytes + q * kBox, &b_map, &full[s],
                          n0 + 64 * q, k0, b_shared ? 0 : e);
            }
          } else {
            // A: W_e's rows [m0, m0 + 128) of D by F [k0, k0 + 64);
            // B: dY_e's tokens [n0, n0 + BN) by F [k0, k0 + 64)
            tma_load_3d(slot, &a_map, &full[s], k0, m0, e);
            tma_load_3d(slot + kABytes, &b_map, &full[s], k0, n0, e);
          }
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  // slot 0's descriptors: A this warpgroup's 64 rows of M (one 8 KB box
  // either way), B all BN columns.  K-major: rows of 64 depths, 8-row
  // groups 1024 bytes apart, a 16-deep step 32 bytes along the row.
  // MN-major: rows of 64 M (N) values, one per depth, 8-deep groups 1024
  // bytes apart and 64-wide blocks a box (8 KB) apart, a 16-deep step 16
  // rows (2048 bytes).
  const uint64_t a0 = wgmma_desc_sw128(smem + wg * kBox, kBox, 8 * kRowBytes);
  const uint64_t b0 = wgmma_desc_sw128(smem + kABytes, kMn ? kBox : 16,
                                       8 * kRowBytes);
  constexpr int kStep = kMn ? (16 * kRowBytes) >> 4 : 32 >> 4;
  // accumulator fragment: value 4 j + 2 h + b is row g + 8 h of the
  // warp's 16 (M), column 8 j + 2 t + b (N), g = lane / 4, t = lane % 4
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int ml = wg * 64 + ((threadIdx.x % 128) / 32) * 16 + g;
  const int nl = 2 * (lane % 4);
  int s = 0, phase = 0;
  float acc[BN / 2];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n0 = (t % n_tiles) * BN;
    const int m0 = (t / n_tiles % m_tiles) * kTileM;
    const int z = t / (n_tiles * m_tiles);
    const int n_k =
        static_cast<int>(static_cast<long long>(z + 1) * pairs / shares)
        - static_cast<int>(static_cast<long long>(z) * pairs / shares);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int i = 0; i < n_k; ++i) {
      mbar_wait(&full[s], phase);
      const uint64_t off = static_cast<uint64_t>((s * kStage) >> 4);
      fence_regs<BN / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSlab / 16; ++ks) {
        wgmma_bf16_tn<BN, kMn ? 1 : 0, kMn ? 1 : 0>(
            acc, a0 + off + ks * kStep, b0 + off + ks * kStep);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the group before this one has finished
      fence_regs<BN / 2>(acc);
      if (i > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs<BN / 2>(acc);
    if (n_k > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);

    // epilogue, straight from the accumulators into rows of N (M
    // contiguous), while the producer fills the ring for the next tile
    const long long slice = static_cast<long long>(z) * n * m;
    const int col = m0 + ml;
    if (f32_out) {  // a share's partial, laid out as the output: a warp's
                    // store is four rows of 8 consecutive floats
      float* o = static_cast<float*>(out) + slice;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int row = n0 + 8 * j + nl + b;
            if (row < n && col + 8 * h < m) {
              o[static_cast<long long>(row) * m + col + 8 * h] =
                  acc[4 * j + 2 * h + b];
            }
          }
        }
      }
    } else {  // bf16 pairs: a lane of even g keeps its rows g, g + 1 of M
              // (the second from lane ^ 4), one of odd g its rows g + 7,
              // g + 8; a warp's store is four rows of 16 consecutive values
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + slice;
      const bool odd = g & 1;
      const int pc = odd ? col + 7 : col;  // even: m % 8 == 0 keeps it in
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const float v0 = acc[4 * j + b], v1 = acc[4 * j + 2 + b];
          const float got = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
          const int row = n0 + 8 * j + nl + b;
          if (row < n && pc < m) {
            *reinterpret_cast<__nv_bfloat162*>(
                o + static_cast<long long>(row) * m + pc) =
                odd ? __floats2bfloat162_rn(got, v1)
                    : __floats2bfloat162_rn(v0, got);
          }
        }
      }
    }
  }
}

// out = bf16(sum of the shares' f32 partials, in share order); four
// values a thread
__global__ void __launch_bounds__(256)
    sum_shares_kernel(const float4* __restrict__ part,
                      uint2* __restrict__ out, long long n4, int shares) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * 256) {
    float4 a = part[i];
    for (int s = 1; s < shares; ++s) {
      const float4 b = part[s * n4 + i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a.x, a.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a.z, a.w);
    out[i] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                        *reinterpret_cast<const uint32_t*>(&hi));
  }
}

using BwdKernel = void (*)(CUtensorMap, CUtensorMap, void*, int, int, int,
                           int, int, int, int, int, int, int);

// [dW?][64, 128, 256]
const std::array<std::array<BwdKernel, 3>, 2> kKernels = {{
    {{&expert_gemm_bwd_kernel<64, false>, &expert_gemm_bwd_kernel<128, false>,
      &expert_gemm_bwd_kernel<256, false>}},
    {{&expert_gemm_bwd_kernel<64, true>, &expert_gemm_bwd_kernel<128, true>,
      &expert_gemm_bwd_kernel<256, true>}},
}};

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

// a bf16 tensor of dims (d0, d1, d2), d0 contiguous, d1 and d2 `s1` and
// `s2` elements apart, read in boxes of (64, rows, 1) with the 128-byte
// swizzle; reads past its end give zeros
bool tile_map(CUtensorMap* map, const void* base, const long long* dims,
              const long long* strides, unsigned rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t gdims[3] = {static_cast<cuuint64_t>(dims[0]),
                               static_cast<cuuint64_t>(dims[1]),
                               static_cast<cuuint64_t>(dims[2])};
  const cuuint64_t gstrides[2] = {static_cast<cuuint64_t>(strides[0]) * 2,
                                  static_cast<cuuint64_t>(strides[1]) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kSlab), rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), gdims, gstrides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool map_ok(const void* p, const long long* dims, const long long* strides) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && dims[0] > 0
         && dims[1] > 0 && dims[2] > 0 && strides[0] % 8 == 0
         && strides[1] % 8 == 0 && strides[0] >= 0 && strides[1] >= 0;
}

}  // namespace

// One product of the backward, bf16.  a and b: the operands as the caller
// holds them, each a 3-D view (d0, d1, d2) with d0 contiguous and the
// element strides s1, s2 of d1 and d2:
//   dW (mn_major 1): a = dY (F, C, E), b = X (D, C, E or 1); m = F,
//                    n = D, k = C; out (E, D, F)
//   dX (mn_major 0): a = W (F, D, E), b = dY (F, C, E); m = D, n = C,
//                    k = F; out (E, C, D), or (C, D) summed over the
//                    experts
// The plan of kernels/expert_gemm.py:bwd_plan: bn (64, 128 or 256),
// m_tiles, n_tiles, shares (`experts` for the per-expert products, else
// the shares of the summed depth), blocks (of the n_tiles x m_tiles x
// shares tiles: all of them, or fewer for a persistent grid), stages and
// smem.  part:
// null, or (shares > 1, summed) f32 scratch of shares x n x m for the
// partials.  Returns a cudaError_t.
extern "C" int expert_gemm_bwd_launch(
    const void* a, long long a0, long long a1, long long a2, long long as1,
    long long as2, const void* b, long long b0, long long b1, long long b2,
    long long bs1, long long bs2, void* out, void* part, int m, int n, int k,
    int experts, int mn_major, int bn, int m_tiles, int n_tiles, int shares,
    int blocks, int stages, int smem, void* stream) {
  const long long ad[3] = {a0, a1, a2}, as[2] = {as1, as2};
  const long long bd[3] = {b0, b1, b2}, bs[2] = {bs1, bs2};
  const int wi = bn == 64 ? 0 : bn == 128 ? 1 : bn == 256 ? 2 : -1;
  const int k_slabs = (k + kSlab - 1) / kSlab;
  const long long pairs = static_cast<long long>(experts) * k_slabs;
  const long long tiles = static_cast<long long>(n_tiles) * m_tiles * shares;
  if (m < 0 || n < 0 || k < 0 || experts < 1 || experts > 65535
      || m % 8 != 0 || wi < 0 || m_tiles != (m + kTileM - 1) / kTileM
      || n_tiles != (n + bn - 1) / bn || stages < 2
      || stages > kMaxStages || smem != bwd_smem(bn, stages)
      || smem > kSmemLimit || shares < 1 || tiles >= (1ll << 31)
      || blocks < 1 || blocks > tiles || pairs > (1ll << 30)
      || (pairs > 0 && shares > pairs)
      || (part != nullptr && shares < 2)) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0 || n == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long out_elems =
      static_cast<long long>(part == nullptr ? shares : 1) * n * m;
  if (pairs == 0) {  // no depth: zeros, as the sum of no products
    return (int)cudaMemsetAsync(out, 0, 2ull * out_elems, st);
  }
  if (!map_ok(a, ad, as) || !map_ok(b, bd, bs)) {
    return (int)cudaErrorInvalidValue;
  }
  static bool configured = false;  // every instance's shared-memory cap
  if (!configured) {
    for (const auto& row : kKernels) {
      for (BwdKernel kern : row) {
        const cudaError_t err = cudaFuncSetAttribute(
            reinterpret_cast<const void*>(kern),
            cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
        if (err != cudaSuccess) return (int)err;
      }
    }
    configured = true;
  }
  // box rows: a K-major A is one 128-row box, a K-major B one bn-row box;
  // an MN-major operand is 64-deep boxes of 64 values
  CUtensorMap a_map, b_map;
  if (!tile_map(&a_map, a, ad, as, mn_major ? 64 : kTileM)
      || !tile_map(&b_map, b, bd, bs, mn_major ? 64 : bn)) {
    return (int)cudaErrorInvalidValue;
  }
  kKernels[mn_major ? 1 : 0][wi]<<<blocks, kThreads, smem, st>>>(
      a_map, b_map, part != nullptr ? part : out, m, n, k_slabs,
      static_cast<int>(pairs), shares, n_tiles, m_tiles, b2 == 1 ? 1 : 0,
      part != nullptr ? 1 : 0, stages);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return (int)err;
  const long long n4 = static_cast<long long>(n) * m / 4;
  const long long sum_blocks = (n4 + 255) / 256;
  sum_shares_kernel<<<static_cast<unsigned>(
                          sum_blocks < 4096 ? sum_blocks : 4096),
                      256, 0, st>>>(static_cast<const float4*>(part),
                                    static_cast<uint2*>(out), n4, shares);
  return (int)cudaGetLastError();
}
