// Shared helpers of the port's CUDA kernels: dtype codes, scalar
// conversions, epilogues and cp.async.  Every kernel library includes this
// header once, so each exports its own `repro_error_string`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Must match the dtype codes in repro_torch/kernels/*.py.
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };
// Must match repro_torch.core.sma.EPILOGUE_CODES.
enum Epilogue { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3, kTanh = 4 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype() does
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// The SMA epilogues (repro_torch.core.sma.EPILOGUES) on an f32 value.
__device__ __forceinline__ float apply_epilogue(float x, int ep) {
  switch (ep) {
    case kRelu:
      return fmaxf(x, 0.f);
    case kGelu:  // tanh approximation
      return 0.5f * x *
             (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
    case kSilu:
      return x / (1.f + expf(-x));
    case kTanh:
      return tanhf(x);
    default:
      return x;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace repro

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
