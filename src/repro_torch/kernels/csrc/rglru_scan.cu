// RG-LRU scan for Hopper: the diagonal linear recurrence
// h_t = a_t * h_{t-1} + u_t over (B, S, D) with a float32 carry.
//
// Replaces the Pallas kernel repro/kernels/rglru.py:55 (`rglru_scan`, body
// `_rglru_kernel`).  The TPU kernel walks a (B, D/bd, S/bs) grid with time
// innermost and carries h in a VMEM scratch across the sequential time
// axis; it pads S and D to its blocks (a = 1, u = 0 past S).  Here blocks
// run in no order, so one thread owns one (b, d) channel for the whole
// sequence and keeps the carry in a register: the time loop is the
// sequential axis.  Channels past D are masked by index, nothing is
// padded.  Neighbouring threads own neighbouring channels, so every load of
// a[b, t, :] and u[b, t, :] and every store of h_seq[b, t, :] is coalesced
// across the warp.
//
// Semantics (those of the TPU kernel): a, u and h0 are read as f32; the
// carry starts at h0 (zeros without one); each step is a product and a sum,
// each rounded to f32 (no fused multiply-add, so the result is the plain
// PyTorch version's bit for bit); h_seq is stored in a's dtype and h_last
// is the final f32 carry rounded once to a's dtype.
//
// What bounds it on an H100: bytes, in principle (3 * B * S * D elements
// move, 2 flops each); in this first version, latency.  At the prefill's
// shape (B 4, S 4096, D 2560, bf16) only 10,240 threads run, each a chain of
// 4,096 dependent steps.  To keep memory requests in flight, each thread
// loads the next CHUNK steps of a and u into registers before it runs them.
// A time-chunked scan (local scans, a carry pass, a fix-up) that spreads
// each channel over many threads is the redesign.
#include "common.cuh"

namespace repro {

constexpr int kScanThreads = 128;
constexpr int kChunk = 32;  // steps of a and u loaded ahead of their use

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
    rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ u,
                      const T* __restrict__ h0, T* __restrict__ h_seq,
                      T* __restrict__ h_last, int S, int D) {
  const int d = blockIdx.x * kScanThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t row = static_cast<size_t>(b) * D + d;  // (b, d) of h0/h_last
  const T* ab = a + static_cast<size_t>(b) * S * D + d;
  const T* ub = u + static_cast<size_t>(b) * S * D + d;
  T* hb = h_seq + static_cast<size_t>(b) * S * D + d;
  float h = h0 != nullptr ? to_f(h0[row]) : 0.f;

  int t = 0;
  for (; t + kChunk <= S; t += kChunk) {
    float av[kChunk], uv[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const size_t off = static_cast<size_t>(t + i) * D;
      av[i] = to_f(ab[off]);
      uv[i] = to_f(ub[off]);
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      h = __fadd_rn(__fmul_rn(av[i], h), uv[i]);
      hb[static_cast<size_t>(t + i) * D] = from_f<T>(h);
    }
  }
  for (; t < S; ++t) {  // the ragged tail, one step at a time
    const size_t off = static_cast<size_t>(t) * D;
    h = __fadd_rn(__fmul_rn(to_f(ab[off]), h), to_f(ub[off]));
    hb[off] = from_f<T>(h);
  }
  h_last[row] = from_f<T>(h);
}

template <typename T>
void launch_scan(const void* a, const void* u, const void* h0, void* h_seq,
                 void* h_last, int B, int S, int D, cudaStream_t stream) {
  dim3 grid((D + kScanThreads - 1) / kScanThreads, B);
  rglru_scan_kernel<T><<<grid, kScanThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(u),
      static_cast<const T*>(h0), static_cast<T*>(h_seq),
      static_cast<T*>(h_last), S, D);
}

}  // namespace repro

// h0 may be null (a zero carry).  Returns cudaGetLastError() after the
// launch.
extern "C" int rglru_scan_launch(const void* a, const void* u, const void* h0,
                                 void* h_seq, void* h_last, int B, int S,
                                 int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      repro::launch_scan<float>(a, u, h0, h_seq, h_last, B, S, D, s);
      break;
    case repro::kBF16:
      repro::launch_scan<__nv_bfloat16>(a, u, h0, h_seq, h_last, B, S, D, s);
      break;
    case repro::kF16:
      repro::launch_scan<__half>(a, u, h0, h_seq, h_last, B, S, D, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
