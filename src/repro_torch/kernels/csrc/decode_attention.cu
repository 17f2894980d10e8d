// Paged decode attention for Hopper: one new token per request against a
// KV pool read in place through the block table.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py:78
// (`decode_attention`, body `_decode_kernel`) together with the page gather
// that repro/backends/pallas_backend.py:82 (`paged_decode_attention`) puts
// in front of it.  Here nothing is gathered: the kernel follows the table.
//
// One block per (request, KV head) serves the g = Hq / Hkv query rows of
// that head.  It walks only positions < kv_len, so the pages it touches are
// p < ceil(kv_len / BS) and sentinel table entries past them are never read.
// An entry outside [0, NB) below kv_len, or kv_len past the table's
// MB * BS, is the caller's bug: the kernel reads nothing there and writes
// NaN for that (request, head), so the fault shows as non-finite logits
// instead of another request's page read in silence.  Each step brings
// TILE tokens of
// K and V into shared memory (16-byte loads along the contiguous head_dim),
// scores them against the scaled queries, and folds them into an f32 online
// softmax (running max m, sum l, accumulator).  The mask value is -1e30 as
// in the Pallas kernel, and a row with kv_len == 0 (a batch-padding row)
// ends with l == 0 and writes 0, not NaN.
//
// What bounds it on an H100: bytes.  Every valid K/V row is read once
// (2 * kv_len * Hkv * D elements per request) and the arithmetic is 4 flops
// per element read; the design reads each row exactly once and keeps the
// scores and the accumulator on chip.
//
// The contiguous `decode_attention` entry is the same kernel with BS = Smax
// and the table arange(B)[:, None], built by the wrapper.
//
// Shared memory is f32 throughout: 2 * TILE * (D + 1) of K and V, g * TILE
// scores, 2 * g * D of queries and accumulators.  Where that passes 48 KB
// (g = 10, D = 256: 54 KB at TILE 16) the launch opts in to more, up to the
// 227 KB a block may have; the wrapper picks TILE.
#include "common.cuh"

namespace repro {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(128) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ kv_len, T* __restrict__ out, int Hq, int Hkv,
    int D, int NB, int BS, int MB, int TILE, float scale) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int bad;  // an entry or a length outside the table was hit
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = Hq / Hkv, DP = D + 1;  // +1: conflict-free column reads
  float* Ks = sm;                       // [TILE][DP]
  float* Vs = Ks + TILE * DP;           // [TILE][DP]
  float* S = Vs + TILE * DP;            // [g][TILE] scores, then p
  float* Qs = S + g * TILE;             // [g][D] scaled queries
  float* Acc = Qs + g * D;              // [g][D]
  float* Ml = Acc + g * D;              // [g][3]: m, l, alpha
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarp = nthr / 32;

  const int len = min(max(kv_len[b], 0), MB * BS);
  if (tid == 0) bad = kv_len[b] > MB * BS;
  const T* qb = q + (static_cast<size_t>(b) * Hq + static_cast<size_t>(h) * g) * D;
  for (int i = tid; i < g * D; i += nthr) {
    Qs[i] = to_f(qb[i]) * scale;
    Acc[i] = 0.f;
  }
  for (int r = tid; r < g; r += nthr) {
    Ml[3 * r] = kNegInf;
    Ml[3 * r + 1] = 0.f;
    Ml[3 * r + 2] = 0.f;
  }
  __syncthreads();

  constexpr int VEC = 16 / sizeof(T);
  const int cpr = D / VEC;  // 16-byte chunks per token row
  const int* tb = table + static_cast<size_t>(b) * MB;
  for (int t0 = 0; t0 < len; t0 += TILE) {
    const int n = min(TILE, len - t0);
    for (int i = tid; i < n * cpr; i += nthr) {
      const int t = i / cpr, c = (i % cpr) * VEC, pos = t0 + t;
      const int blk = tb[pos / BS];
      uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;
      if (blk >= 0 && blk < NB) {
        const size_t off =
            ((static_cast<size_t>(blk) * Hkv + h) * BS + pos % BS) * D + c;
        kr = *reinterpret_cast<const uint4*>(kp + off);
        vr = *reinterpret_cast<const uint4*>(vp + off);
      } else {
        bad = 1;
      }
      const T* ke = reinterpret_cast<const T*>(&kr);
      const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[t * DP + c + e] = to_f(ke[e]);
        Vs[t * DP + c + e] = to_f(ve[e]);
      }
    }
    __syncthreads();
    for (int i = tid; i < g * n; i += nthr) {
      const int r = i / n, t = i % n;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(Qs[r * D + d], Ks[t * DP + d], s);
      S[r * TILE + t] = s;
    }
    __syncthreads();
    for (int r = warp; r < g; r += nwarp) {
      float mt = kNegInf;
      for (int t = lane; t < n; t += 32) mt = fmaxf(mt, S[r * TILE + t]);
      mt = warp_max(mt);
      const float m_old = Ml[3 * r], m_new = fmaxf(m_old, mt);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(S[r * TILE + t] - m_new);
        S[r * TILE + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Ml[3 * r] = m_new;
        Ml[3 * r + 1] = Ml[3 * r + 1] * alpha + sum;
        Ml[3 * r + 2] = alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < g * D; i += nthr) {
      const int r = i / D, d = i % D;
      float a = Acc[i] * Ml[3 * r + 2];
      for (int t = 0; t < n; ++t) a = fmaf(S[r * TILE + t], Vs[t * DP + d], a);
      Acc[i] = a;
    }
    __syncthreads();
  }

  T* ob = out + (static_cast<size_t>(b) * Hq + static_cast<size_t>(h) * g) * D;
  const float nan = __int_as_float(0x7fc00000);
  for (int i = tid; i < g * D; i += nthr) {
    const float l = Ml[3 * (i / D) + 1];
    ob[i] = from_f<T>(bad ? nan : (l == 0.f ? 0.f : Acc[i] / l));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* table, const int* kv_len, void* out, int B,
                   int Hq, int Hkv, int D, int NB, int BS, int MB, int tile,
                   float scale, size_t smem, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  paged_decode_kernel<T><<<grid, 128, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, kv_len, static_cast<T*>(out), Hq, Hkv,
      D, NB, BS, MB, tile, scale);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* kv_len, void* out, int B, int Hq, int Hkv, int D, int NB,
    int BS, int MB, int tile, float scale, int dtype, void* stream) {
  const int g = Hq / Hkv;
  const size_t smem =
      sizeof(float) * (2 * tile * (D + 1) + g * tile + 2 * g * D + 3 * g);
  const int* tb = static_cast<const int*>(table);
  const int* kl = static_cast<const int*>(kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return static_cast<int>(repro::launch<float>(
          q, k_pool, v_pool, tb, kl, out, B, Hq, Hkv, D, NB, BS, MB, tile,
          scale, smem, s));
    case repro::kBF16:
      return static_cast<int>(repro::launch<__nv_bfloat16>(
          q, k_pool, v_pool, tb, kl, out, B, Hq, Hkv, D, NB, BS, MB, tile,
          scale, smem, s));
    case repro::kF16:
      return static_cast<int>(repro::launch<__half>(
          q, k_pool, v_pool, tb, kl, out, B, Hq, Hkv, D, NB, BS, MB, tile,
          scale, smem, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
