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
//   bases, so TMA can take both operands): the warp-specialised TMA +
//   wgmma kernel of gemm_wgmma.cuh, which norm_gemm.cu shares.
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
#include "gemm_wgmma.cuh"

namespace repro {

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
    err = repro::wg::launch<__nv_bfloat16, false>(a, b, bs, nullptr, nullptr,
                                                  out, M, N, K, epilogue, st);
  else if (route == kRouteWgmma && dtype == repro::kF16)
    err = repro::wg::launch<__half, false>(a, b, bs, nullptr, nullptr, out, M,
                                           N, K, epilogue, st);
  else if (route == kRouteSplitK && dtype == repro::kBF16)
    err = repro::splitk::launch<__nv_bfloat16>(a, b, bs, pt, out, M, N, K,
                                               slices, kslice, epilogue, st);
  else if (route == kRouteSplitK && dtype == repro::kF16)
    err = repro::splitk::launch<__half>(a, b, bs, pt, out, M, N, K, slices,
                                        kslice, epilogue, st);
  return static_cast<int>(err);
}
