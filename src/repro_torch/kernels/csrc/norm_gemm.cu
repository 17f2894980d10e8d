// rmsnorm_gemm for Hopper: C = epilogue((x * r * scale) @ W).
//
// Replaces the Pallas kernel repro/kernels/norm_gemm.py:62 (`rmsnorm_gemm`,
// body `_norm_gemm_kernel`).  The A tile is normalized once it is resident
// in shared memory, in f32, and rounded to x's dtype before the
// tensor-core product, so the normalized matrix never exists in device
// memory.  r = rsqrt(mean(x^2) + eps) is an f32 per-row vector from the
// wrapper, as the JAX wrapper computes it outside its pallas_call.
//
// What bounds it on an H100: on the serving path it is final_norm -> head,
// (B, 2048) @ (2048, 100352) with B <= 8, so the 411 MB bf16 weight read
// sets the time (bytes); in training, M = 8192 tokens, the 3.37 TFLOP of
// the product (operations).  The wrapper picks the route from shape, dtype
// and alignment:
//
// * wgmma (bf16/f16, M > 16, K and N multiples of 8, 16-byte-aligned
//   bases): gemm_wgmma.cuh's TMA + wgmma kernel with its NORM prologue,
//   the consumers rewriting their rows of each A stage in place;
// * tile: gemm_tile.cuh's WMMA kernel with its NORM prologue, for M <= 16
//   (1568 column blocks of 64 keep every SM streaming the weight) and what
//   TMA cannot take;
// * f32: gemm_tile.cuh's CUDA-core kernel.
#include "gemm_tile.cuh"
#include "gemm_wgmma.cuh"

// Route codes: must match _ROUTE_CODES in repro_torch/kernels/norm_gemm.py.
enum { kNormTile = 0, kNormWgmma = 1 };

extern "C" int norm_gemm_launch(const void* x, const void* r,
                                const void* scale, const void* w, void* out,
                                int M, int N, int K, int dtype, int epilogue,
                                int route, void* stream) {
  const float* rr = static_cast<const float*>(r);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kNormTile)
    return repro::launch_gemm<true>(x, w, nullptr, rr, sc, out, M, N, K,
                                    dtype, epilogue, st);
  cudaError_t err = cudaErrorInvalidValue;
  if (route == kNormWgmma && dtype == repro::kBF16)
    err = repro::wg::launch<__nv_bfloat16, true>(x, w, nullptr, rr, sc, out,
                                                 M, N, K, epilogue, st);
  else if (route == kNormWgmma && dtype == repro::kF16)
    err = repro::wg::launch<__half, true>(x, w, nullptr, rr, sc, out, M, N, K,
                                          epilogue, st);
  return static_cast<int>(err);
}

// Dynamic shared memory of the wgmma route's kernel, in bytes.
extern "C" int norm_gemm_wgmma_smem() { return repro::wg::Ring<true>::SMEM; }
