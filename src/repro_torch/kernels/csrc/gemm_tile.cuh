// The tiled GEMM skeleton shared by sma_gemm.cu and norm_gemm.cu.
//
//   C = epilogue(prologue(A) @ B + bias)
//
// A (M, K) and B (K, N) are row-major (B keeps JAX's (K, N) layout), C is
// (M, N) in A's dtype.  One block owns a (BM, BN) tile of C and loops over
// K inside the block: the loop takes the place of the TPU kernel's
// sequential K grid axis, and the f32 accumulators stay in registers for
// the whole loop (the "revolving accumulator").  Bias and the epilogue are
// applied to the f32 sums once, after the last K step, and C is written
// once.  Ragged M/N/K are masked in the kernel: out-of-range elements load
// as 0 and out-of-range outputs are not stored; nothing is padded by copy.
//
// bf16/f16 operands run on the tensor cores through WMMA (16x16x16, f32
// accumulate), with a two-stage cp.async pipeline: tile k+1 streams into
// shared memory while tile k is multiplied.  f32 operands run on the CUDA
// cores in full f32 (no TF32).
//
// With NORM the A tile gets the rmsnorm prologue of norm_gemm: once it is
// resident in shared memory each element becomes round(x * r[row] *
// scale[k]) in A's dtype, as repro.kernels.ref.rmsnorm_gemm_ref rounds the
// normalized rows before the product.  r (f32, per row) comes from the
// wrapper.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace repro {

// Copy a (ROWS, COLS) tile of a row-major (R, C) matrix with leading
// dimension ld, starting at (r0, c0), into shared memory with row stride
// sld.  Whole in-range 16-byte chunks go by cp.async; a chunk that crosses
// the ragged edge (or any chunk of an unaligned matrix) is copied element by
// element with zeros outside the matrix.
template <typename T, int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(T* s, int sld, const T* g, int ld,
                                          int R, int C, int r0, int c0,
                                          bool vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = COLS / VEC;
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    const int gr = r0 + r, gc = c0 + c;
    T* dst = s + r * sld + c;
    if (vec_ok && gr < R && gc + VEC <= C) {
      cp_async16(dst, g + static_cast<size_t>(gr) * ld + gc);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        dst[e] = (gr < R && gc + e < C)
                     ? g[static_cast<size_t>(gr) * ld + gc + e]
                     : from_f<T>(0.f);
    }
  }
}

template <typename T, int BM, int BN, int BK, int WM, int WN, bool NORM>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
    gemm_tc_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   const float* __restrict__ bias,
                   const float* __restrict__ rrow,
                   const float* __restrict__ scale, T* __restrict__ C, int M,
                   int N, int K, int ep) {
  using namespace nvcuda;
  constexpr int WARPS_N = BN / WN;
  constexpr int THREADS = (BM / WM) * WARPS_N * 32;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int SA = BK + 8;  // padded row strides against bank conflicts
  constexpr int SB = BN + 8;
  constexpr int A_ELEMS = BM * SA, B_ELEMS = BK * SB;
  constexpr int PIPE_BYTES = 2 * (A_ELEMS + B_ELEMS) * sizeof(T);
  constexpr int EPI_BYTES = (THREADS / 32) * 256 * sizeof(float);
  constexpr int SMEM = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;
  constexpr int VEC = 16 / sizeof(T);
  __shared__ __align__(128) unsigned char smem[SMEM];
  T* As = reinterpret_cast<T*>(smem);  // [2][BM][SA]
  T* Bs = As + 2 * A_ELEMS;            // [2][BK][SB]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool a_vec =
      K % VEC == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const bool b_vec =
      N % VEC == 0 && (reinterpret_cast<uintptr_t>(B) & 15) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (K + BK - 1) / BK;
  load_tile<T, BM, BK, THREADS>(As, SA, A, K, M, K, m0, 0, a_vec);
  load_tile<T, BK, BN, THREADS>(Bs, SB, B, N, K, N, 0, n0, b_vec);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_tile<T, BM, BK, THREADS>(As + (cur ^ 1) * A_ELEMS, SA, A, K, M, K,
                                    m0, (kt + 1) * BK, a_vec);
      load_tile<T, BK, BN, THREADS>(Bs + (cur ^ 1) * B_ELEMS, SB, B, N, K, N,
                                    (kt + 1) * BK, n0, b_vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    T* as = As + cur * A_ELEMS;
    const T* bs = Bs + cur * B_ELEMS;
    if (NORM) {
      for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
        const int r = i / BK, c = i % BK;
        const int gr = m0 + r, gc = kt * BK + c;
        float v = 0.f;
        if (gr < M && gc < K) v = to_f(as[r * SA + c]) * rrow[gr] * scale[gc];
        as[r * SA + c] = from_f<T>(v);
      }
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], as + (wm * WM + i * 16) * SA + kk, SA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], bs + kk * SB + wn * WN + j * 16, SB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: a WMMA accumulator's element-to-thread map is opaque, so each
  // warp stages one 16x16 f32 fragment at a time in shared memory (reusing
  // the pipeline buffers), adds bias, applies the epilogue and stores.
  float* stage = reinterpret_cast<float*>(smem) + warp * 256;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int rb = m0 + wm * WM + i * 16, cb = n0 + wn * WN + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int gr = rb + e / 16, gc = cb + e % 16;
        if (gr < M && gc < N) {
          float v = stage[e];
          if (bias != nullptr) v += bias[gc];
          C[static_cast<size_t>(gr) * N + gc] =
              from_f<T>(apply_epilogue(v, ep));
        }
      }
      __syncwarp();
    }
  }
}

// f32 operands: 64x64 tile, 256 threads, 4x4 outputs per thread, fmaf in
// K order on the CUDA cores.
template <bool NORM>
__global__ void __launch_bounds__(256)
    gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ bias,
                    const float* __restrict__ rrow,
                    const float* __restrict__ scale, float* __restrict__ C,
                    int M, int N, int K, int ep) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float As[BK][BM + 4];  // transposed: As[k][m]
  __shared__ float Bs[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += 256) {
      const int r = i / BK, c = i % BK, gr = m0 + r, gc = k0 + c;
      float v = 0.f;
      if (gr < M && gc < K) {
        v = A[static_cast<size_t>(gr) * K + gc];
        if (NORM) v = v * rrow[gr] * scale[gc];
      }
      As[c][r] = v;
    }
    for (int i = threadIdx.x; i < BK * BN; i += 256) {
      const int r = i / BN, c = i % BN, gr = k0 + r, gc = n0 + c;
      Bs[r][c] = (gr < K && gc < N) ? B[static_cast<size_t>(gr) * N + gc]
                                    : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = m0 + ty + 16 * i, gc = n0 + tx + 16 * j;
      if (gr < M && gc < N) {
        float v = acc[i][j];
        if (bias != nullptr) v += bias[gc];
        C[static_cast<size_t>(gr) * N + gc] = apply_epilogue(v, ep);
      }
    }
}

template <typename T, bool NORM>
void launch_tc(const T* a, const T* b, const float* bias, const float* rrow,
               const float* scale, T* c, int M, int N, int K, int ep,
               cudaStream_t stream) {
  if (M <= 16) {
    // Decode-sized M: one 16-row tile, narrow N tiles for more blocks.
    constexpr int BM = 16, BN = 64, BK = 64, WM = 16, WN = 16;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_tc_kernel<T, BM, BN, BK, WM, WN, NORM>
        <<<grid, (BM / WM) * (BN / WN) * 32, 0, stream>>>(
            a, b, bias, rrow, scale, c, M, N, K, ep);
  } else {
    constexpr int BM = 128, BN = 128, BK = 32, WM = 64, WN = 32;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_tc_kernel<T, BM, BN, BK, WM, WN, NORM>
        <<<grid, (BM / WM) * (BN / WN) * 32, 0, stream>>>(
            a, b, bias, rrow, scale, c, M, N, K, ep);
  }
}

template <bool NORM>
int launch_gemm(const void* a, const void* b, const float* bias,
                const float* rrow, const float* scale, void* c, int M, int N,
                int K, int dtype, int ep, cudaStream_t stream) {
  switch (dtype) {
    case kF32: {
      dim3 grid((N + 63) / 64, (M + 63) / 64);
      gemm_f32_kernel<NORM><<<grid, 256, 0, stream>>>(
          static_cast<const float*>(a), static_cast<const float*>(b), bias,
          rrow, scale, static_cast<float*>(c), M, N, K, ep);
      break;
    }
    case kBF16:
      launch_tc<__nv_bfloat16, NORM>(
          static_cast<const __nv_bfloat16*>(a),
          static_cast<const __nv_bfloat16*>(b), bias, rrow, scale,
          static_cast<__nv_bfloat16*>(c), M, N, K, ep, stream);
      break;
    case kF16:
      launch_tc<__half, NORM>(static_cast<const __half*>(a),
                              static_cast<const __half*>(b), bias, rrow,
                              scale, static_cast<__half*>(c), M, N, K, ep,
                              stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro
