// sma_gemm for Hopper: C = epilogue(A @ B + bias).
//
// Replaces the Pallas kernel repro/kernels/sma_gemm.py:83 (`sma_gemm`,
// body `_sma_gemm_kernel`).  A (M, K) and B (K, N) are row-major (B keeps
// JAX's (K, N) layout), C is (M, N) in A's dtype; bias is f32.  The TPU
// kernel's sequential K grid axis, with its VMEM-resident accumulator,
// becomes a K loop with the f32 accumulator on chip, and bias and the
// epilogue are applied to the f32 sums before C is stored once.
//
// What bounds it on an H100: the tensor-core operations (2 M N K) at
// prefill and training sizes, the weight read (K N elements) at decode.
// The wrapper picks one of three routes from shape, dtype and alignment:
//
// * wgmma (bf16/f16, M > 16, K and N multiples of 8, 16-byte-aligned
//   bases, so TMA can take both operands).  A block owns a 128 x 128 tile
//   of C.  One producer thread keeps a ring of 4 stages of A (128 x 64) and
//   B (64 x 128, two 64-column boxes) in flight with TMA (128-byte swizzle,
//   an mbarrier with expect-tx per stage; the hardware zero-fills past the
//   ragged M, N and K edges, so nothing is padded by copy).  Two consumer
//   warpgroups each run wgmma.mma_async m64n128k16 on 64 rows, the f32
//   accumulator in registers for the whole K loop; B is MN-major in shared
//   memory (the transpose-B form).  Each consumer releases a stage once the
//   wgmma group that read it has retired (one group kept in flight).
// * split-K (bf16/f16, M <= 16, N a multiple of 8, aligned bases): the
//   decode and serving ticks.  A block owns 64 columns of one K slice and
//   streams that slice of B once with 16-byte loads, 8 column groups x 32
//   K rows of threads with the M <= 16 rows of A in f32 registers; it
//   writes f32 partials to a scratch tensor (the wrapper's), and a second
//   launch sums the slices in fixed order, adds bias, applies the epilogue
//   and casts.  Deterministic: no atomics.  The wrapper picks the slices
//   so that column blocks x slices >= 264 (two blocks per SM).
// * otherwise gemm_tile.cuh: the WMMA kernel for bf16/f16 operands TMA
//   cannot take, the CUDA-core kernel (no TF32) for f32.
//
// The TMA descriptors are encoded on the host for every call
// (hopper.cuh's encode) and passed as __grid_constant__ parameters.
#include "gemm_tile.cuh"
#include "hopper.cuh"

namespace repro {
namespace wg {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4;
constexpr int A_BYTES = BM * BK * 2;  // one TMA box: 128 rows of 128 bytes
constexpr int B_BOX = BK * 64 * 2;    // one TMA box: 64 K rows x 64 columns
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BOX;
constexpr int THREADS = 384;  // a producer warpgroup, two consumer ones
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// Tiles are numbered along M first (m_fast) or along N first, whichever
// has fewer, so the blocks resident together share the operand that is
// re-read from L2 (the head's dW walks 784 column tiles of 16 row tiles).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_wgmma_kernel(__grid_constant__ const CUtensorMap tmA,
                      __grid_constant__ const CUtensorMap tmB,
                      const float* __restrict__ bias, T* __restrict__ C,
                      int M, int N, int K, int ep, int mtiles, int ntiles,
                      int m_fast) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the stages to it.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  // bars[s]: stage s is full (producer's expect-tx + TMA bytes);
  // bars[STAGES + s]: stage s is free again (one arrival per consumer).
  const int tile = blockIdx.x;
  const int mt = m_fast ? tile % mtiles : tile / ntiles;
  const int nt = m_fast ? tile / mtiles : tile % ntiles;
  const int m0 = mt * BM, n0 = nt * BN;
  const int nk = (K + BK - 1) / BK;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);
      mbar_init(smem_u32(&bars[STAGES + s]), 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wgi == 0) {
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES)
          mbar_wait(smem_u32(&bars[STAGES + s]), (kt / STAGES - 1) & 1);
        const uint32_t full = smem_u32(&bars[s]);
        // The full boxes' bytes, also where TMA zero-fills past an edge.
        mbar_expect_tx(full, STAGE_BYTES);
        const uint32_t sa = smem_u32(smem + s * STAGE_BYTES);
        const uint32_t sb = sa + A_BYTES;
        tma_load(sa, &tmA, kt * BK, m0, full);
        tma_load(sb, &tmB, n0, kt * BK, full);
        tma_load(sb + B_BOX, &tmB, n0 + 64, kt * BK, full);
      }
    }
    return;
  }

  const int c = wgi - 1;  // this consumer's 64 rows of the tile
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(smem_u32(&bars[s]), (kt / STAGES) & 1);
    const uint32_t sa = smem_u32(smem + s * STAGE_BYTES) + c * 64 * 128;
    const uint32_t sb = smem_u32(smem + s * STAGE_BYTES) + A_BYTES;
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A, K-major: 8-row groups 1024 bytes apart, 16 K values = 32 bytes
      // further along the swizzled row.  B, MN-major: 8 K rows (1024 bytes)
      // to the next K group, the second 64-column box B_BOX bytes on, 16 K
      // rows = 2048 bytes per step.
      wgmma_ss<0, 1, T>(d, smem_desc(sa + kk * 32, 16, 1024),
                        smem_desc(sb + kk * 2048, B_BOX, 1024), 1);
    }
    wgmma_commit();
    fence_acc(d);
    // The group of the previous k tile has retired: free its stage.
    wgmma_wait<1>();
    fence_acc(d);
    if (kt > 0 && threadIdx.x % 128 == 0)
      mbar_arrive(smem_u32(&bars[STAGES + (kt - 1) % STAGES]));
  }
  wgmma_wait<0>();
  fence_acc(d);

  // Accumulator layout of m64nNk16: warp w of the warpgroup holds rows
  // 16 w + lane / 4 and + 8; register 4 j + 2 h + e is column 8 j +
  // 2 (lane % 4) + e of row + 8 h.
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = m0 + c * 64 + (t / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * (lane % 4);
    if (col < N) {  // N is even on this route, so col + 1 < N too
      const float b0 = bias != nullptr ? bias[col] : 0.f;
      const float b1 = bias != nullptr ? bias[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row < M)
          store2(C + static_cast<size_t>(row) * N + col,
                 apply_epilogue(d[4 * j + 2 * h] + b0, ep),
                 apply_epilogue(d[4 * j + 2 * h + 1] + b1, ep));
      }
    }
  }
}

// A row-major (outer, inner) 16-bit matrix, boxes of (box_outer,
// box_inner).
bool encode2d(EncodeTiled fn, CUtensorMap* map, const void* ptr, bool f16,
              uint64_t inner, uint64_t outer, uint32_t box_inner,
              uint32_t box_outer) {
  const uint64_t dims[2] = {inner, outer};
  const uint32_t box[2] = {box_inner, box_outer};
  return encode(fn, map, ptr, f16, 2, dims, box);
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* bias, void* c,
                   int M, int N, int K, int ep, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  constexpr bool f16 = std::is_same<T, __half>::value;
  CUtensorMap ta, tb;
  if (!encode2d(fn, &ta, a, f16, K, M, BK, BM) ||
      !encode2d(fn, &tb, b, f16, N, K, 64, BK))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return err;
  const int mtiles = (M + BM - 1) / BM, ntiles = (N + BN - 1) / BN;
  gemm_wgmma_kernel<T><<<mtiles * ntiles, THREADS, SMEM, stream>>>(
      ta, tb, bias, static_cast<T*>(c), M, N, K, ep, mtiles, ntiles,
      mtiles < ntiles);
  return cudaGetLastError();
}

}  // namespace wg

namespace splitk {

constexpr int BN = 64, THREADS = 256, ROWS = THREADS / (BN / 8);  // 32

// acc[m][:] += A[m][k] * B[k][n .. n + 8) for the M <= MT rows of A.
template <typename T, int MT>
__device__ __forceinline__ void fma_row(float (&acc)[MT][8], const uint4& raw,
                                        const T* __restrict__ A, int K, int M,
                                        int k) {
  const T* e = reinterpret_cast<const T*>(&raw);
  float bv[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) bv[v] = to_f(e[v]);
  // Rows past M repeat row M - 1 (never stored): no branch per row.
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float av = to_f(A[static_cast<size_t>(min(m, M - 1)) * K + k]);
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[m][v] = fmaf(av, bv[v], acc[m][v]);
  }
}

// Block (column block, K slice): thread (k row kr, column group cg) walks
// rows k0 + kr, k0 + kr + 32, ... of its slice, U 16-byte loads in
// flight; the 32 row partial sums are folded by shuffles and shared memory
// in fixed order and the block writes part[slice][m][n].
template <typename T, int MT>
__global__ void __launch_bounds__(THREADS) splitk_partial_kernel(
    const T* __restrict__ A, const T* __restrict__ B,
    float* __restrict__ part, int M, int N, int K, int kslice) {
  constexpr int U = MT <= 8 ? 8 : 4;  // 16-byte loads in flight a thread
  __shared__ float red[THREADS / 32][MT][BN];
  const int cg = threadIdx.x % 8, kr = threadIdx.x / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * BN, n = n0 + cg * 8, s = blockIdx.y;
  const int k0 = s * kslice, k1 = min(K, k0 + kslice);
  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[m][v] = 0.f;
  if (n < N) {  // N is a multiple of 8: a column group is all in or out
    const T* bp = B + n;
    int k = k0 + kr;
    for (; k + ROWS * (U - 1) < k1; k += ROWS * U) {
      uint4 raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(
            bp + static_cast<size_t>(k + ROWS * u) * N));
#pragma unroll
      for (int u = 0; u < U; ++u)
        fma_row<T, MT>(acc, raw[u], A, K, M, k + ROWS * u);
    }
    for (; k < k1; k += ROWS) {
      const uint4 raw = __ldg(
          reinterpret_cast<const uint4*>(bp + static_cast<size_t>(k) * N));
      fma_row<T, MT>(acc, raw, A, K, M, k);
    }
  }
  // A warp holds k rows 4 warp .. 4 warp + 3 (lane / 8) of all 8 groups.
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      float x = acc[m][v];
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      acc[m][v] = x;
    }
  if (lane < 8) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int v = 0; v < 8; ++v) red[warp][m][cg * 8 + v] = acc[m][v];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MT * BN; i += THREADS) {
    const int m = i / BN, col = n0 + i % BN;
    if (m < M && col < N) {
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) x += red[w][m][i % BN];
      part[(static_cast<size_t>(s) * M + m) * N + col] = x;
    }
  }
}

// C = epilogue(sum over slices, in order, + bias), in T.
template <typename T>
__global__ void __launch_bounds__(256) splitk_reduce_kernel(
    const float* __restrict__ part, const float* __restrict__ bias,
    T* __restrict__ C, int M, int N, int slices, int ep) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t mn = static_cast<size_t>(M) * N;
  if (i >= mn) return;
  float x = 0.f;
  for (int s = 0; s < slices; ++s) x += part[s * mn + i];
  if (bias != nullptr) x += bias[i % N];
  C[i] = from_f<T>(apply_epilogue(x, ep));
}

template <typename T, int MT>
cudaError_t launch_mt(const void* a, const void* b, const float* bias,
                      float* part, void* c, int M, int N, int K, int slices,
                      int kslice, int ep, cudaStream_t stream) {
  splitk_partial_kernel<T, MT>
      <<<dim3((N + BN - 1) / BN, slices), THREADS, 0, stream>>>(
          static_cast<const T*>(a), static_cast<const T*>(b), part, M, N, K,
          kslice);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t mn = static_cast<size_t>(M) * N;
  splitk_reduce_kernel<T><<<static_cast<unsigned>((mn + 255) / 256), 256, 0,
                            stream>>>(part, bias, static_cast<T*>(c), M, N,
                                      slices, ep);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* bias,
                   float* part, void* c, int M, int N, int K, int slices,
                   int kslice, int ep, cudaStream_t stream) {
  if (M <= 1)
    return launch_mt<T, 1>(a, b, bias, part, c, M, N, K, slices, kslice, ep,
                           stream);
  if (M <= 2)
    return launch_mt<T, 2>(a, b, bias, part, c, M, N, K, slices, kslice, ep,
                           stream);
  if (M <= 4)
    return launch_mt<T, 4>(a, b, bias, part, c, M, N, K, slices, kslice, ep,
                           stream);
  if (M <= 8)
    return launch_mt<T, 8>(a, b, bias, part, c, M, N, K, slices, kslice, ep,
                           stream);
  if (M <= 16)
    return launch_mt<T, 16>(a, b, bias, part, c, M, N, K, slices, kslice, ep,
                            stream);
  return cudaErrorInvalidValue;
}

}  // namespace splitk
}  // namespace repro

// Route codes: must match _ROUTE_CODES in repro_torch/kernels/sma_gemm.py.
enum { kRouteTile = 0, kRouteWgmma = 1, kRouteSplitK = 2 };

// part: the split-K route's f32 scratch (slices * M * N), else unused.
extern "C" int sma_gemm_launch(const void* a, const void* b,
                               const void* bias, void* out, void* part,
                               int M, int N, int K, int dtype, int epilogue,
                               int route, int slices, int kslice,
                               void* stream) {
  const float* bs = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  if (route == kRouteTile)
    return repro::launch_gemm<false>(a, b, bs, nullptr, nullptr, out, M, N,
                                     K, dtype, epilogue, st);
  cudaError_t err = cudaErrorInvalidValue;
  if (route == kRouteWgmma && dtype == repro::kBF16)
    err = repro::wg::launch<__nv_bfloat16>(a, b, bs, out, M, N, K, epilogue,
                                           st);
  else if (route == kRouteWgmma && dtype == repro::kF16)
    err = repro::wg::launch<__half>(a, b, bs, out, M, N, K, epilogue, st);
  else if (route == kRouteSplitK && dtype == repro::kBF16)
    err = repro::splitk::launch<__nv_bfloat16>(a, b, bs, pt, out, M, N, K,
                                               slices, kslice, epilogue, st);
  else if (route == kRouteSplitK && dtype == repro::kF16)
    err = repro::splitk::launch<__half>(a, b, bs, pt, out, M, N, K, slices,
                                        kslice, epilogue, st);
  return static_cast<int>(err);
}
