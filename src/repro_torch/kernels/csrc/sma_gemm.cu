// sma_gemm for Hopper: C = epilogue(A @ B + bias).
//
// Replaces the Pallas kernel repro/kernels/sma_gemm.py:83 (`sma_gemm`,
// body `_sma_gemm_kernel`).  The tile skeleton is in gemm_tile.cuh.
//
// What bounds it on an H100: at decode (M <= 16) the weight read, K*N
// elements, sets the time (bytes); at prefill (M ~ 2048) the 2*M*N*K
// tensor-core operations do.  The design streams B once per 16-row block
// at decode and keeps the accumulator and epilogue on chip, so neither C
// before the epilogue nor a padded copy of A or B ever reaches memory.
#include "gemm_tile.cuh"

extern "C" int sma_gemm_launch(const void* a, const void* b,
                               const void* bias, void* out, int M, int N,
                               int K, int dtype, int epilogue, void* stream) {
  return repro::launch_gemm<false>(a, b, static_cast<const float*>(bias),
                                   nullptr, nullptr, out, M, N, K, dtype,
                                   epilogue,
                                   static_cast<cudaStream_t>(stream));
}
