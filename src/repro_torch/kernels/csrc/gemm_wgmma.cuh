// The TMA + wgmma GEMM shared by sma_gemm.cu and norm_gemm.cu:
//
//   C = epilogue(prologue(A) @ B + bias)
//
// A (M, K) and B (K, N) are row-major 16-bit (B keeps JAX's (K, N) layout),
// C is (M, N) in A's dtype; bias is f32.  The TPU kernels' sequential K grid
// axis, with its VMEM-resident accumulator, becomes a K loop with the f32
// accumulator in registers, and bias and the epilogue are applied to the
// f32 sums before C is stored once.  The caller checks what TMA needs: K
// and N multiples of 8 and 16-byte-aligned bases (A, B and C).
//
// A block works on a 128 x 128 tile of C at a time; one block per SM walks
// the tiles (persistent), so the pipeline is filled once and a tile's
// epilogue overlaps the next tile's loads.  One producer thread keeps a
// ring of stages of A (128 x 64) and B (64 x 128, two 64-column boxes) in
// flight with TMA (128-byte swizzle, an mbarrier with expect-tx per stage;
// the hardware zero-fills past the ragged M, N and K edges, so nothing is
// padded by copy).  Two consumer warpgroups each run wgmma.mma_async
// m64n128k16 on 64 rows, the f32 accumulator in registers for the whole K
// loop; B is MN-major in shared memory (the transpose-B form).  Each
// consumer releases a stage once the wgmma group that read it has retired
// (one group kept in flight).  The epilogue rounds each consumer's 64 x 128
// outputs into two swizzled 64 x 64 boxes of shared memory and stores them
// with TMA (which clips the ragged edges): whole 128-byte rows, where
// storing from the accumulator layout writes 4 bytes a thread scattered
// over 8 rows (slow at the head's 1.6 GB output).
//
// NORM (norm_gemm's rmsnorm prologue, the SIMD-mode half of the TPU
// kernel): a fourth warpgroup, the normalizer, rewrites each A stage in
// place once it has landed, in the swizzled layout, two elements at a
// time, as round(x * r[row] * scale[k]) in A's dtype -- the order and
// rounding of repro.kernels.norm_gemm's `a.astype(x_ref.dtype)` and of
// repro_torch.kernels.ref.rmsnorm_gemm_ref -- fences its generic writes
// against the async proxy (fence.proxy.async) and arrives on the stage's
// "normalized" mbarrier, which the consumers wait on instead of "full".
// r (f32, per row, from the wrapper) is loaded once a tile; the scale
// values a thread needs are loaded a stage ahead.  So the normalized
// matrix never exists in device memory, and the rewrite runs beside the
// consumers' products instead of between them.  The normalizer holds
// stages between the producer and the consumers, so NORM's ring is 6
// stages deep (4 without).  What the prologue costs is the normalizer's
// arithmetic, one warp an SM sub-partition; its extra shared-memory
// traffic cost nothing measurable (H100).  Slower designs, measured on an
// H100 at the training head's shape: the consumers rewriting their own
// rows before each stage's wgmma; the consumers building A as register
// fragments (ldmatrix, normalize, wgmma with a register A operand, two
// stages' fragments in turns); the normalizer reading x from global
// memory instead of a TMA'd stage; seven normalizing warps (the
// producer warpgroup's idle three added).
#pragma once

#include "hopper.cuh"

namespace repro {
namespace wg {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int A_BYTES = BM * BK * 2;  // one TMA box: 128 rows of 128 bytes
constexpr int B_BOX = BK * 64 * 2;    // one TMA box: 64 K rows x 64 columns
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BOX;
constexpr int C_BOX = 64 * 64 * 2;    // one output box: 64 rows x 64 columns
// The ring's depth: NORM's normalizer holds stages between the producer
// and the consumers, so it gets a deeper ring.
template <bool NORM>
struct Ring {
  static constexpr int STAGES = NORM ? 6 : 4;
  static constexpr int SMEM =
      STAGES * STAGE_BYTES + 4 * C_BOX + 1024 + 3 * STAGES * 8;
};

// A producer warpgroup, (with NORM) the normalizer, two consumers.
template <bool NORM>
struct Threads {
  static constexpr int value = NORM ? 512 : 384;
};

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16*, float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(__half*, float a, float b) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A packed pair of T (the lower column in the low half), each element x
// turned into round((x * r) * s) with its column's s: unpacked and rounded
// two at a time (the normalizer's arithmetic is what the prologue costs).
__device__ __forceinline__ uint32_t norm2(__nv_bfloat16*, uint32_t v,
                                          float r, float s0, float s1) {
  const float lo = __uint_as_float(v << 16) * r * s0;
  const float hi = __uint_as_float(v & 0xffff0000u) * r * s1;
  return pack2(static_cast<__nv_bfloat16*>(nullptr), lo, hi);
}
__device__ __forceinline__ uint32_t norm2(__half*, uint32_t v, float r,
                                          float s0, float s1) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&v));
  return pack2(static_cast<__half*>(nullptr), f.x * r * s0, f.y * r * s1);
}

// Persistent: a block per SM walks the tiles blockIdx.x, + gridDim.x, ...,
// with one ring of stages across them, so the producer loads the next
// tile while the consumers finish and store the last.  Tiles are numbered
// along M first (m_fast) or along N first, whichever has fewer, so the
// blocks working together share the operand that is re-read from L2 (the
// head's dW walks 784 column tiles of 16 row tiles).
template <typename T, bool NORM>
__global__ void __launch_bounds__(Threads<NORM>::value, 1)
    gemm_wgmma_kernel(__grid_constant__ const CUtensorMap tmA,
                      __grid_constant__ const CUtensorMap tmB,
                      __grid_constant__ const CUtensorMap tmC,
                      const float* __restrict__ bias,
                      const float* __restrict__ rrow,
                      const float* __restrict__ scale, int M, int N, int K,
                      int ep, int mtiles, int ntiles, int m_fast) {
  constexpr int STAGES = Ring<NORM>::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the stages to it.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* cbuf = smem + STAGES * STAGE_BYTES;  // [consumer][2] boxes
  uint64_t* bars = reinterpret_cast<uint64_t*>(cbuf + 4 * C_BOX);
  // bars[s]: stage s is full (producer's expect-tx + TMA bytes);
  // bars[STAGES + s]: stage s is free again (one arrival per consumer);
  // bars[2 STAGES + s]: stage s is normalized (NORM: every normalizer
  // thread).  A use of the ring is counted across tiles (`it`).
  const int tiles = mtiles * ntiles;
  const int nk = (K + BK - 1) / BK;
  const int wgi = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  auto origin = [&](int tile, int& m0, int& n0) {
    m0 = (m_fast ? tile % mtiles : tile / ntiles) * BM;
    n0 = (m_fast ? tile / mtiles : tile % ntiles) * BN;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);
      mbar_init(smem_u32(&bars[STAGES + s]), 2);
      mbar_init(smem_u32(&bars[2 * STAGES + s]), 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wgi == 0) {
    if (t == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        origin(tile, m0, n0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES)
            mbar_wait(smem_u32(&bars[STAGES + s]), (it / STAGES - 1) & 1);
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
    }
    return;
  }

  if (NORM && wgi == 1) {
    // The normalizer: thread t rewrites rows t / 8 + 16 i (i < 8) of every
    // A stage, the 16-byte chunk t % 8 of each.  Under the 128-byte swizzle
    // that chunk holds K columns 8 lc .. 8 lc + 7 of all eight rows (their
    // row index is the same mod 8).
    const int lc = (t % 8) ^ ((t / 8) % 8);
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      origin(tile, m0, n0);
      float rr[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = m0 + t / 8 + 16 * i;
        rr[i] = row < M ? rrow[row] : 0.f;
      }
      float sc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sc[e] = 8 * lc + e < K ? scale[8 * lc + e] : 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        float next[8];
        const int k1 = (kt + 1) * BK + 8 * lc;
#pragma unroll
        for (int e = 0; e < 8; ++e) next[e] = k1 + e < K ? scale[k1 + e] : 0.f;
        mbar_wait(smem_u32(&bars[s]), (it / STAGES) & 1);
        unsigned char* a = smem + s * STAGE_BYTES;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          uint4* p = reinterpret_cast<uint4*>(a + (t / 8 + 16 * i) * 128 +
                                              (t % 8) * 16);
          uint4 raw = *p;
          T* tag = nullptr;
          raw.x = norm2(tag, raw.x, rr[i], sc[0], sc[1]);
          raw.y = norm2(tag, raw.y, rr[i], sc[2], sc[3]);
          raw.z = norm2(tag, raw.z, rr[i], sc[4], sc[5]);
          raw.w = norm2(tag, raw.w, rr[i], sc[6], sc[7]);
          *p = raw;
        }
        fence_proxy_async();
        mbar_arrive(smem_u32(&bars[2 * STAGES + s]));
#pragma unroll
        for (int e = 0; e < 8; ++e) sc[e] = next[e];
      }
    }
    return;
  }

  const int c = wgi - (NORM ? 2 : 1);  // this consumer's 64 rows of a tile
  const int lane = t % 32, g = lane / 4, tq = lane % 4;
  // The consumers read a stage once it is full, or with NORM normalized.
  const int ready = NORM ? 2 * STAGES : 0;
  unsigned char* cb = cbuf + c * 2 * C_BOX;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    origin(tile, m0, n0);
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(smem_u32(&bars[ready + s]), (it / STAGES) & 1);
      const uint32_t sa = smem_u32(smem + s * STAGE_BYTES) + c * 64 * 128;
      const uint32_t sb = smem_u32(smem + s * STAGE_BYTES) + A_BYTES;
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A, K-major: 8-row groups 1024 bytes apart, 16 K values = 32
        // bytes further along the swizzled row.  B, MN-major: 8 K rows
        // (1024 bytes) to the next K group, the second 64-column box B_BOX
        // bytes on, 16 K rows = 2048 bytes per step.
        wgmma_ss<0, 1, T>(d, smem_desc(sa + kk * 32, 16, 1024),
                          smem_desc(sb + kk * 2048, B_BOX, 1024), 1);
      }
      wgmma_commit();
      fence_acc(d);
      // The group of the previous k tile has retired: free its stage.
      wgmma_wait<1>();
      fence_acc(d);
      if (kt > 0 && t == 0)
        mbar_arrive(smem_u32(&bars[STAGES + (it - 1) % STAGES]));
    }
    wgmma_wait<0>();
    fence_acc(d);
    if (t == 0) {
      mbar_arrive(smem_u32(&bars[STAGES + (it - 1) % STAGES]));
      bulk_wait_read();  // the last tile's stores have read cb
    }
    named_sync(1 + c, 128);

    // Accumulator layout of m64nNk16: warp w of the warpgroup holds rows
    // 16 w + lane / 4 and + 8; register 4 j + 2 h + e is column 8 j +
    // 2 (lane % 4) + e of row + 8 h.  Column 8 j + 2 (lane % 4) of a row r
    // goes to box j / 8, at 16-byte chunk (j % 8) ^ (r % 8) of the row.
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * tq;
      // N is a multiple of 8 on this route: col and col + 1 are in or out.
      const float b0 = bias != nullptr && col < N ? bias[col] : 0.f;
      const float b1 = bias != nullptr && col < N ? bias[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (t / 32) * 16 + g + 8 * h;
        *reinterpret_cast<uint32_t*>(
            cb + (j / 8) * C_BOX + r * 128 + ((j % 8) ^ (r % 8)) * 16 +
            4 * tq) =
            pack2(static_cast<T*>(nullptr),
                  apply_epilogue(d[4 * j + 2 * h] + b0, ep),
                  apply_epilogue(d[4 * j + 2 * h + 1] + b1, ep));
      }
    }
    fence_proxy_async();
    named_sync(1 + c, 128);
    if (t == 0) {
      tma_store(&tmC, smem_u32(cb), n0, m0 + c * 64);
      tma_store(&tmC, smem_u32(cb + C_BOX), n0 + 64, m0 + c * 64);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait();  // every store of this consumer has landed
}

// A row-major (outer, inner) 16-bit matrix, boxes of (box_outer,
// box_inner).
inline bool encode2d(EncodeTiled fn, CUtensorMap* map, const void* ptr,
                     bool f16, uint64_t inner, uint64_t outer,
                     uint32_t box_inner, uint32_t box_outer) {
  const uint64_t dims[2] = {inner, outer};
  const uint32_t box[2] = {box_inner, box_outer};
  return encode(fn, map, ptr, f16, 2, dims, box);
}

// rrow and scale: NORM's per-row r and per-column scale (f32), else unused.
template <typename T, bool NORM>
cudaError_t launch(const void* a, const void* b, const float* bias,
                   const float* rrow, const float* scale, void* c, int M,
                   int N, int K, int ep, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  constexpr bool f16 = std::is_same<T, __half>::value;
  CUtensorMap ta, tb, tc;
  if (!encode2d(fn, &ta, a, f16, K, M, BK, BM) ||
      !encode2d(fn, &tb, b, f16, N, K, 64, BK) ||
      !encode2d(fn, &tc, c, f16, N, M, 64, 64))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_wgmma_kernel<T, NORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Ring<NORM>::SMEM);
  if (err != cudaSuccess) return err;
  const int mtiles = (M + BM - 1) / BM, ntiles = (N + BN - 1) / BN;
  // One block per SM (the shared memory allows no second one).
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int grid = mtiles * ntiles < sms ? mtiles * ntiles : sms;
  gemm_wgmma_kernel<T, NORM>
      <<<grid, Threads<NORM>::value, Ring<NORM>::SMEM, stream>>>(
          ta, tb, tc, bias, rrow, scale, M, N, K, ep, mtiles, ntiles,
          mtiles < ntiles);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace repro
