// rmsnorm_gemm for Hopper: C = epilogue((x * r * scale) @ W).
//
// Replaces the Pallas kernel repro/kernels/norm_gemm.py:62 (`rmsnorm_gemm`,
// body `_norm_gemm_kernel`).  It is the gemm_tile.cuh skeleton with the
// NORM prologue: the A tile is normalized in shared memory, in f32, and
// rounded to x's dtype before the tensor-core product, so the normalized
// matrix never exists in device memory.  r = rsqrt(mean(x^2) + eps) is an
// f32 per-row vector from the wrapper, as the JAX wrapper computes it
// outside its pallas_call.
//
// What bounds it on an H100: on the serving path it is final_norm -> head,
// (B, 2048) @ (2048, 100352) with B <= 8, so the 411 MB bf16 weight read
// sets the time (bytes).  1568 column blocks of 64 keep every SM streaming.
#include "gemm_tile.cuh"

extern "C" int norm_gemm_launch(const void* x, const void* r,
                                const void* scale, const void* w, void* out,
                                int M, int N, int K, int dtype, int epilogue,
                                void* stream) {
  return repro::launch_gemm<true>(x, w, nullptr, static_cast<const float*>(r),
                                  static_cast<const float*>(scale), out, M, N,
                                  K, dtype, epilogue,
                                  static_cast<cudaStream_t>(stream));
}
