// Flash attention for Hopper: causal / windowed GQA online-softmax
// attention, forward and backward, on wgmma + TMA.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:101
// (`flash_attention`, body `_flash_kernel`).  That kernel has no gradient
// (a pallas_call has no transpose rule); the backward here follows
// FlashAttention-2 and is held against jax.grad of the JAX package's XLA
// attention (repro.backends.xla_backend.chunked_mha) in the tests.
//
// Semantics (those of the TPU kernel): q (B, Hq, Sq, D), k/v (B, Hkv, Skv,
// D), query head h reads KV head h / (Hq / Hkv) (K and V are never
// replicated); queries are end-aligned, so row i sits at position
// i + Skv - Sq; key j is valid for it when j < Skv, and, with `causal`,
// j <= pos, and, with a window W, j > pos - W.  Scores are scaled after
// the product (for D = 64 the scale 1/8 is exact, so this equals the TPU
// kernel's scaling of q first).  Inner arithmetic is f32.  A masked score
// contributes exactly 0 and a row that sees no key (only possible when
// Sq > Skv) gives 0, lse = +inf and zero gradients, never NaN.
//
// Grid.  The Pallas kernel carries (m, l, acc) in VMEM across a sequential
// KV grid axis.  Here a block loops over the KV tiles itself.  The loop
// bounds are the TPU kernel's `run` predicate: KV tiles wholly in the
// future (causal) or wholly before the window are never loaded.  Keys past
// Skv and query rows past Sq are zero-filled by TMA (3-D tensor maps over
// (D, S, B * H), so a box never reads the next head's rows) and masked.
//
// Forward (head_dim 64, 128, 256).  A block of three warpgroups owns 128
// query rows of one (batch, query head).  The producer warpgroup gives its
// registers to the consumers (setmaxnreg 24 / 240); one of its threads
// TMA-loads the Q tile once and keeps a ring of K/V stages in flight (a
// full mbarrier with expect-tx per stage, an empty one every consumer
// thread arrives on).  Each consumer warpgroup owns 64 rows:
//   S = Q K^T      wgmma m64nTKk16, Q and K both K-major in shared memory;
//   softmax        on the f32 accumulator in registers: row max and sum by
//                  quad shuffles, exp2 with scale * log2(e) folded into one
//                  FMA; only a tile that can hold a masked (row, key) pair
//                  (the diagonal, the window's start, the ragged end of
//                  Skv) is masked element by element;
//   O += P V       P rounded to q's dtype as the register A operand, V the
//                  MN-major B (the transpose-B form), O in registers.
// The epilogue stores O / l for rows < Sq and lse = m * scale + log l.
// Tiles, checked against 227 KB of shared memory (Fwd<D>::SMEM):
//   D 64:  128-key tiles; Q 16 KB + 3 x (K + V) 32 KB = 112 KB;
//   D 128: 128-key tiles; Q 32 KB + 3 x (K + V) 64 KB = 224 KB;
//   D 256:  64-key tiles; Q 64 KB + 2 x (K + V) 64 KB = 192 KB; O is
//          64 x 256 f32, 128 registers a consumer thread.
//
// Backward (FlashAttention-2).  A first pass computes delta = rowsum(dO *
// O) per query row.  At head_dim 256 two passes follow, with no unordered
// add (see "backward, D 256" below).  At head_dim 64 and 128 a block owns
// 128 keys of one (batch, KV head), 64 per consumer warpgroup, with K and
// V loaded once.  The producer walks every query head of the group and
// every 64-row query tile that can see those keys (the same `run` bounds,
// transposed), TMA-loading Q and dO into a ring of stages and copying lse
// and delta beside them.  Per tile each consumer computes
//   S^T = K Q^T and dP^T = V dO^T   (wgmma, everything from shared memory),
//   P^T = exp(S^T * scale - lse),  dS^T = P^T * (dP^T - delta),
//   dV += P^T dO and dK += dS^T Q   (P^T, dS^T as register A operands;
//                                    dO, Q MN-major B),
// and writes dS^T to the stage's shared memory (128-byte swizzle), then
// arrives on the stage's dS mbarrier.  One of the two consumers, in turns,
// waits on it and computes dQ = dS K over all 128 keys (A = dS^T read
// MN-major, B = K MN-major), stages dQ in shared memory and adds it to the
// zeroed f32 dQ with one TMA reduce-add a 32-column box (the adds happen
// in the L2, in no fixed order: at head_dim 64 and 128 dQ's low bits vary
// from run to run, as the tolerance says).  dK and dV are summed over the
// group inside the block and written once.  Shared memory: K + V 32 / 64
// KB, a ring of 3 / 2 stages of Q, dO (8 / 16 KB each) and dS^T (16 KB),
// two dQ tiles (16 / 32 KB) and lse / delta: 162 KB at D 64, 225 KB at D
// 128.
//
// What bounds it on an H100: operations.  At B 4, H 32, S 2048, D 64,
// causal, the forward does 4 * D flops on each of B*H*S(S+1)/2 visible
// (query, key) pairs, 68.7 GFLOP, 0.069 ms at 989 TFLOP/s, against 0.040 ms
// of bytes; the backward 2.5x the operations.  The design answers with
// wgmma at full width, TMA with no address arithmetic in the consumers,
// warp specialisation and skipped tiles; not yet with overlapping one
// tile's softmax with the next tile's products inside a warpgroup (issuing
// S of tile i ahead of P V of tile i - 1 was slower: ptxas then injects
// warpgroup waits, C7519, and spills at D 256).
#include <math.h>

#include "hopper.cuh"

namespace repro {
namespace flash {

constexpr int THREADS = 384;       // a producer warpgroup, two consumers
constexpr int PRODUCER_REGS = 24;  // setmaxnreg: 24 + 2 x 240 <= 512
constexpr int CONSUMER_REGS = 240;
constexpr float kNegInf = -1e30f;  // floor of the running max
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- helpers
// Two f32 values rounded into one 32-bit register, `lo` in the low half
// (the lower column of an mma fragment).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Is every key of [k0, k1] visible to every query position of [p0, p1]?
// Then the tile needs no mask.
__device__ __forceinline__ bool all_visible(int k0, int k1, int p0, int p1,
                                            int Skv, int causal, int window) {
  return k1 < Skv && (!causal || k1 <= p0) && (window <= 0 || k0 > p1 - window);
}

// Is key kp visible to the query at position qp?
__device__ __forceinline__ bool visible(int qp, int kp, int Skv, int causal,
                                        int window) {
  return kp < Skv && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// The A fragments of a 64 x (8 NK) accumulator, rounded to T: k16 step kk
// takes accumulator columns 16 kk .. 16 kk + 15.
template <typename T, int NK>
__device__ __forceinline__ void to_a_frags(const float (&s)[4 * NK],
                                           uint32_t (&a)[NK / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < NK / 2; ++kk) {
    a[kk][0] = pack2<T>(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// x, which the compiler may not assume is the same from one loop trip to
// the next: a shared-memory base made opaque keeps the compiler from
// hoisting a loop's wgmma descriptors into registers.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---------------------------------------------------------------- forward
template <int D>
struct Fwd {
  static constexpr int BQ = 128;             // query rows a block
  static constexpr int TK = D > 128 ? 64 : 128;  // keys a KV tile
  static constexpr int BOXES = D / 64;       // 64-column TMA boxes a row
  static constexpr int Q_BOX = BQ * 128;     // bytes of one Q box
  static constexpr int KV_BOX = TK * 128;    // bytes of one K or V box
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int KV_BYTES = BOXES * KV_BOX;  // one of K, V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int STAGES = D > 128 ? 2 : 3;  // depth of the K/V ring
  static constexpr int BARS = 1 + 2 * STAGES;
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE_BYTES + 1024 + 8 * BARS;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(__grid_constant__ const CUtensorMap tmQ,
                     __grid_constant__ const CUtensorMap tmK,
                     __grid_constant__ const CUtensorMap tmV,
                     T* __restrict__ out, float* __restrict__ lse, int Hq,
                     int Hkv, int Sq, int Skv, float scale, int causal,
                     int window) {
  using F = Fwd<D>;
  constexpr int BQ = F::BQ, TK = F::TK, STAGES = F::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + F::Q_BYTES + STAGES * F::STAGE_BYTES);
  // bars[0]: Q has arrived; bars[1 + s]: stage s is full (expect-tx + TMA
  // bytes); bars[1 + STAGES + s]: stage s is free (every consumer thread).
  const uint32_t q_bar = smem_u32(&bars[0]);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sKV = sQ + F::Q_BYTES;

  const int iq = gridDim.x - 1 - blockIdx.x;  // latest (longest) rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = Skv - Sq;
  const int q0 = iq * BQ;
  // KV tiles this block can see (the TPU kernel's `run` predicate).
  const int first = q0 + off, last = min(q0 + BQ, Sq) - 1 + off;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, last + 1);
  if (window > 0) kv_lo = max(kv_lo, first - window + 1);
  const int kt0 = kv_lo / TK;
  const int kt1 = kv_hi > kv_lo ? (kv_hi + TK - 1) / TK : kt0;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bars[1 + s]), 1);
      mbar_init(smem_u32(&bars[1 + STAGES + s]), 2 * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && kt0 < kt1) {
      mbar_expect_tx(q_bar, F::Q_BYTES);
#pragma unroll
      for (int x = 0; x < F::BOXES; ++x)
        tma_load(sQ + x * F::Q_BOX, &tmQ, x * 64, q0, b * Hq + h, q_bar);
      for (int kt = kt0; kt < kt1; ++kt) {
        const int i = kt - kt0, s = i % STAGES;
        if (i >= STAGES)
          mbar_wait(smem_u32(&bars[1 + STAGES + s]), (i / STAGES - 1) & 1);
        const uint32_t full = smem_u32(&bars[1 + s]);
        // The full boxes' bytes, also where TMA zero-fills past an edge.
        mbar_expect_tx(full, F::STAGE_BYTES);
        const uint32_t sk = sKV + s * F::STAGE_BYTES, sv = sk + F::KV_BYTES;
#pragma unroll
        for (int x = 0; x < F::BOXES; ++x) {
          tma_load(sk + x * F::KV_BOX, &tmK, x * 64, kt * TK, b * Hkv + hk,
                   full);
          tma_load(sv + x * F::KV_BOX, &tmV, x * 64, kt * TK, b * Hkv + hk,
                   full);
        }
      }
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  const int c = threadIdx.x / 128 - 1;  // this consumer's 64 rows
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r0 = q0 + c * 64 + w * 16 + g, r1 = r0 + 8;  // this thread's rows
  const int p0 = r0 + off, p1 = r1 + off;               // their positions
  const int cp0 = q0 + c * 64 + off, cp1 = cp0 + 63;    // the consumer's
  // Keys the row at position p sees: [p - window + 1, p] (from 0 without a
  // window, to Skv - 1 without causal), never past Skv - 1.
  const int big = 1 << 30;
  const int klo0 = window > 0 ? p0 - window + 1 : -big;
  const int klo1 = window > 0 ? p1 - window + 1 : -big;
  const int khi0 = causal ? min(p0, Skv - 1) : Skv - 1;
  const int khi1 = causal ? min(p1, Skv - 1) : Skv - 1;
  const float sl2 = scale * kLog2e;
  const uint32_t sq = sQ + c * 64 * 128;  // its rows in every Q box

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  uint32_t pa[TK / 16][4];  // P, the A operand of P V

  if (kt0 < kt1) mbar_wait(q_bar, 0);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0, s = i % STAGES;
    mbar_wait(smem_u32(&bars[1 + s]), (i / STAGES) & 1);
    const uint32_t sk = sKV + s * F::STAGE_BYTES, sv = sk + F::KV_BYTES;
    const uint32_t sqi = opaque(sq);  // not hoisted: no descriptor array

    // S = Q K^T: k16 step kk reads 32 bytes into box kk / 4 of both; the
    // first step overwrites the accumulator (scale-d 0).
    float sc[TK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, 0, T>(
          sc, smem_desc(sqi + (kk / 4) * F::Q_BOX + (kk % 4) * 32, 16, 1024),
          smem_desc(sk + (kk / 4) * F::KV_BOX + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);

    // Mask (only where the tile can hold a hidden pair), online softmax.
    // Masked scores become -inf; the running max never drops below -1e30,
    // so they give exactly 0.
    const int k0 = kt * TK;
    if (!all_visible(k0, k0 + TK - 1, cp0, cp1, Skv, causal, window)) {
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + 2 * tq + e;
          if (kp < klo0 || kp > khi0) sc[4 * j + e] = -INFINITY;
          if (kp < klo1 || kp > khi1) sc[4 * j + 2 + e] = -INFINITY;
        }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = exp2_approx((m0 - mn0) * sl2);
    const float a1 = exp2_approx((m1 - mn1) * sl2);
    const float ms0 = mn0 * sl2, ms1 = mn1 * sl2;
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2_approx(fmaf(sc[4 * j + e], sl2, -ms0));
        sc[4 * j + 2 + e] = exp2_approx(fmaf(sc[4 * j + 2 + e], sl2, -ms1));
        ls0 += sc[4 * j + e];
        ls1 += sc[4 * j + 2 + e];
      }
    l0 = l0 * a0 + ls0;  // per-lane partial sums, reduced at the end
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }

    // O += P V: P rounded to q's dtype, from registers; V MN-major, 16 keys
    // = 2048 bytes a step, its 64-column boxes KV_BOX bytes apart.
    to_a_frags<T, TK / 8>(sc, pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_rs<1, T>(o, pa[kk], smem_desc(sv + kk * 2048, F::KV_BOX, 1024),
                     1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    fence_regs(pa);
    mbar_arrive(smem_u32(&bars[1 + STAGES + s]));
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float i1 = l1 > 0.f ? 1.f / l1 : 0.f;
  T* ob = out + (static_cast<size_t>(b) * Hq + h) * Sq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * D + col) =
          pack2<T>(o[4 * j] * i0, o[4 * j + 1] * i0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r1) * D + col) =
          pack2<T>(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
  }
  if (tq == 0) {
    float* lb = lse + (static_cast<size_t>(b) * Hq + h) * Sq;
    if (r0 < Sq) lb[r0] = l0 > 0.f ? m0 * scale + __logf(l0) : INFINITY;
    if (r1 < Sq) lb[r1] = l1 > 0.f ? m1 * scale + __logf(l1) : INFINITY;
  }
}

// --------------------------------------------------------------- backward
// delta = rowsum(dO * O) in f32, one warp per query row.
template <typename T, int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dot_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                         float* __restrict__ delta, size_t rows) {
  const size_t row = static_cast<size_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + row * D;
  const T* d = dout + row * D;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f(o[c]), to_f(d[c]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[row] = acc;
}

template <int D>
struct Bwd {
  static constexpr int BK = 128;           // keys a block, 64 a consumer
  static constexpr int BQ = 64;            // query rows a tile
  static constexpr int BOXES = D / 64;
  static constexpr int KV_BOX = BK * 128;  // bytes of one K or V box
  static constexpr int KV_BYTES = BOXES * KV_BOX;
  static constexpr int Q_BOX = BQ * 128;   // bytes of one Q or dO box
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int STAGES = D > 64 ? 2 : 3;  // depth of the Q/dO ring
  static constexpr int DS_BYTES = BK * BQ * 2;  // dS^T, 128 keys x 64 rows
  static constexpr int STAGE_BYTES = 2 * Q_BYTES + DS_BYTES;  // Q, dO, dS^T
  static constexpr int DQ_BOX = BQ * 32 * 4;  // 64 rows x 32 f32 columns
  static constexpr int DQ_BYTES = (D / 32) * DQ_BOX;  // one consumer's dQ
  static constexpr int LD_BYTES = 2 * BQ * 4;  // lse * log2(e), delta
  static constexpr int BARS = 1 + 3 * STAGES;
  static constexpr int SMEM = 2 * KV_BYTES + STAGES * STAGE_BYTES +
                              2 * DQ_BYTES + STAGES * LD_BYTES + 1024 +
                              8 * BARS;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_kernel(__grid_constant__ const CUtensorMap tmQ,
                     __grid_constant__ const CUtensorMap tmK,
                     __grid_constant__ const CUtensorMap tmV,
                     __grid_constant__ const CUtensorMap tmdO,
                     __grid_constant__ const CUtensorMap tmdQ,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv,
                     int Sq, int Skv, float scale, int causal, int window) {
  using F = Bwd<D>;
  constexpr int BK = F::BK, BQ = F::BQ, STAGES = F::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* stages = smem + 2 * F::KV_BYTES;
  unsigned char* dqbuf = stages + STAGES * F::STAGE_BYTES;  // [2][DQ_BYTES]
  float* lds = reinterpret_cast<float*>(dqbuf + 2 * F::DQ_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(lds + STAGES * 2 * BQ);
  // bars[0]: K and V have arrived; bars[1 + s]: stage s is full (the TMA
  // bytes, and the producer warp's lse / delta copy); bars[1 + STAGES + s]:
  // stage s is free (every consumer thread); bars[1 + 2 STAGES + s]: dS^T
  // of stage s is written (every consumer thread).
  const uint32_t kv_bar = smem_u32(&bars[0]);
  const uint32_t sK = smem_u32(smem), sV = sK + F::KV_BYTES;

  const int jt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int off = Skv - Sq;
  const int k0 = jt * BK;
  // Query rows that can see some key of this block.
  const int klast = min(k0 + BK, Skv) - 1;
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(q_lo, k0 - off);
  if (window > 0) q_hi = min(q_hi, klast + window - off);
  const int it0 = q_lo / BQ;
  const int nq = q_hi > q_lo ? (q_hi + BQ - 1) / BQ - it0 : 0;
  const int tiles = group * nq;  // (query head, query tile) pairs

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bars[1 + s]), 2);
      mbar_init(smem_u32(&bars[1 + STAGES + s]), 2 * 128);
      mbar_init(smem_u32(&bars[1 + 2 * STAGES + s]), 2 * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    regs_dec<PRODUCER_REGS>();
    const int lane = threadIdx.x;
    if (lane < 32 && tiles > 0) {
      if (lane == 0) {
        mbar_expect_tx(kv_bar, 2 * F::KV_BYTES);
#pragma unroll
        for (int x = 0; x < F::BOXES; ++x) {
          tma_load(sK + x * F::KV_BOX, &tmK, x * 64, k0, b * Hkv + hk,
                   kv_bar);
          tma_load(sV + x * F::KV_BOX, &tmV, x * 64, k0, b * Hkv + hk,
                   kv_bar);
        }
      }
      for (int i = 0; i < tiles; ++i) {
        const int s = i % STAGES;
        const int hh = hk * group + i / nq, q0 = (it0 + i % nq) * BQ;
        // lse and delta of the tile, read before the wait for a free stage
        // so their latency hides behind it.
        const size_t row0 = (static_cast<size_t>(b) * Hq + hh) * Sq + q0;
        float lv[BQ / 32], dl[BQ / 32];
#pragma unroll
        for (int u = 0; u < BQ / 32; ++u) {
          const int r = lane + 32 * u;
          const bool in = q0 + r < Sq;
          lv[u] = in ? lse[row0 + r] * kLog2e : INFINITY;
          dl[u] = in ? delta[row0 + r] : 0.f;
        }
        if (i >= STAGES)
          mbar_wait(smem_u32(&bars[1 + STAGES + s]), (i / STAGES - 1) & 1);
        unsigned char* st = stages + s * F::STAGE_BYTES;
        const uint32_t full = smem_u32(&bars[1 + s]);
        if (lane == 0) {
          mbar_expect_tx(full, 2 * F::Q_BYTES);
          const uint32_t sq = smem_u32(st), sdo = sq + F::Q_BYTES;
#pragma unroll
          for (int x = 0; x < F::BOXES; ++x) {
            tma_load(sq + x * F::Q_BOX, &tmQ, x * 64, q0, b * Hq + hh, full);
            tma_load(sdo + x * F::Q_BOX, &tmdO, x * 64, q0, b * Hq + hh,
                     full);
          }
        }
        float* sl = lds + s * 2 * BQ;
#pragma unroll
        for (int u = 0; u < BQ / 32; ++u) {
          sl[lane + 32 * u] = lv[u];
          sl[BQ + lane + 32 * u] = dl[u];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(full);
      }
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  const int c = threadIdx.x / 128 - 1;  // this consumer's 64 keys
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int kr = c * 64 + w * 16 + g;       // this thread's key rows in the
  const int kp0 = k0 + kr, kp1 = kp0 + 8;   // block: kr and kr + 8
  const int ck0 = k0 + c * 64, ck1 = ck0 + 63;  // the consumer's keys
  // Query positions that see key kp: [kp, kp + window) (or from 0, to any,
  // without causal / window); none for a key past Skv.
  const int big = 1 << 30;
  const int qlo0 = kp0 >= Skv ? big : causal ? kp0 : -big;
  const int qlo1 = kp1 >= Skv ? big : causal ? kp1 : -big;
  const int qhi0 = window > 0 ? kp0 + window : big;
  const int qhi1 = window > 0 ? kp1 + window : big;
  const float sl2 = scale * kLog2e;
  const uint32_t dq_buf = smem_u32(dqbuf + c * F::DQ_BYTES);
  const uint32_t sk = sK + c * 64 * 128, sv = sV + c * 64 * 128;

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  if (tiles > 0) mbar_wait(kv_bar, 0);
  for (int i = 0; i < tiles; ++i) {
    const int s = i % STAGES;
    const int hh = hk * group + i / nq, q0 = (it0 + i % nq) * BQ;
    mbar_wait(smem_u32(&bars[1 + s]), (i / STAGES) & 1);
    unsigned char* stg = stages + s * F::STAGE_BYTES;
    const uint32_t sq = smem_u32(stg), sdo = sq + F::Q_BYTES;
    const uint32_t sds = sdo + F::Q_BYTES;
    const uint32_t ski = opaque(sk), svi = opaque(sv);  // not hoisted
    const float* sl = lds + s * 2 * BQ;

    // S^T = K Q^T and dP^T = V dO^T, all K-major; the first k16 step
    // overwrites the accumulators (scale-d 0).
    float st[BQ / 2], dpt[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t ko = (kk / 4) * F::KV_BOX + (kk % 4) * 32;
      const uint32_t qo = (kk / 4) * F::Q_BOX + (kk % 4) * 32;
      wgmma_ss<0, 0, T>(st, smem_desc(ski + ko, 16, 1024),
                        smem_desc(sq + qo, 16, 1024), kk > 0);
      wgmma_ss<0, 0, T>(dpt, smem_desc(svi + ko, 16, 1024),
                        smem_desc(sdo + qo, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(st);
    fence_acc(dpt);

    // P^T and dS^T in f32; masked pairs (only where the tile can hold one)
    // and rows past Sq (lse = +inf) give exactly 0.
    const bool need_mask = !all_visible(ck0, ck1, q0 + off, q0 + BQ - 1 + off,
                                        Skv, causal, window);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 8 * j + 2 * tq + e;  // query row in the tile
        const int qp = q0 + qi + off;
        const float l2 = sl[qi], dd = sl[BQ + qi];
        float p0 = exp2_approx(fmaf(st[4 * j + e], sl2, -l2));
        float p1 = exp2_approx(fmaf(st[4 * j + 2 + e], sl2, -l2));
        if (need_mask) {
          if (qp < qlo0 || qp >= qhi0) p0 = 0.f;
          if (qp < qlo1 || qp >= qhi1) p1 = 0.f;
        }
        st[4 * j + e] = p0;
        st[4 * j + 2 + e] = p1;
        dpt[4 * j + e] = p0 * (dpt[4 * j + e] - dd);
        dpt[4 * j + 2 + e] = p1 * (dpt[4 * j + 2 + e] - dd);
      }
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
    to_a_frags<T, BQ / 8>(st, pa);
    to_a_frags<T, BQ / 8>(dpt, sa);

    // dS^T into the stage, [key][query] with the 128-byte swizzle: the
    // 16-byte chunk j of row r sits at chunk j ^ (r % 8).
    unsigned char* dsrow = stg + 2 * F::Q_BYTES;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int sw = (j ^ (kr % 8)) * 16 + 4 * tq;
      *reinterpret_cast<uint32_t*>(dsrow + kr * 128 + sw) =
          sa[j / 2][j % 2 ? 2 : 0];
      *reinterpret_cast<uint32_t*>(dsrow + (kr + 8) * 128 + sw) =
          sa[j / 2][j % 2 ? 3 : 1];
    }
    fence_proxy_async();
    mbar_arrive(smem_u32(&bars[1 + 2 * STAGES + s]));

    // dV += P^T dO and dK += dS^T Q: 16 query rows = 2048 bytes a step,
    // the 64-column boxes Q_BOX bytes apart.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs<1, T>(dva, pa[kk], smem_desc(sdo + kk * 2048, F::Q_BOX, 1024),
                     1);
      wgmma_rs<1, T>(dka, sa[kk], smem_desc(sq + kk * 2048, F::Q_BOX, 1024),
                     1);
    }
    wgmma_commit();

    if (c == (i & 1)) {
      // dQ = dS K over the block's 128 keys: A = dS^T read MN-major
      // (queries contiguous), B = K MN-major; 16 keys = 2048 bytes a step.
      if constexpr (D > 64) {
        wgmma_wait<0>();  // frees P^T / dS^T's registers first
        fence_acc(dva);
        fence_acc(dka);
        fence_regs(pa);
        fence_regs(sa);
      }
      mbar_wait(smem_u32(&bars[1 + 2 * STAGES + s]), (i / STAGES) & 1);
      float dqa[D / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<1, 1, T>(dqa, smem_desc(sds + kk * 2048, F::DS_BYTES, 1024),
                          smem_desc(opaque(sK) + kk * 2048, F::KV_BOX, 1024),
                          kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dqa);
      fence_acc(dva);
      fence_acc(dka);
      fence_regs(pa);
      fence_regs(sa);
      // dQ * scale into this consumer's buffer, boxes of 32 f32 columns
      // with the 128-byte swizzle (16-byte chunk j of row r at j ^ (r % 8)),
      // then one TMA reduce-add a box into the f32 dQ: rows past Sq are
      // skipped by the tensor map.
      if (t == 0) bulk_wait_read();  // the last reduce has read the buffer
      named_sync(2 + c, 128);
      unsigned char* buf = dqbuf + c * F::DQ_BYTES;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * tq, cb = col % 32;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = w * 16 + g + 8 * half;
          float2* dst = reinterpret_cast<float2*>(
              buf + (col / 32) * F::DQ_BOX + r * 128 +
              (((cb / 4) ^ (r % 8)) * 16) + (cb % 4) * 4);
          *dst = make_float2(dqa[4 * j + 2 * half] * scale,
                             dqa[4 * j + 2 * half + 1] * scale);
        }
      }
      fence_proxy_async();
      named_sync(2 + c, 128);
      if (t == 0) {
#pragma unroll
        for (int x = 0; x < D / 32; ++x)
          tma_reduce_add(&tmdQ, dq_buf + x * F::DQ_BOX, x * 32, q0,
                         b * Hq + hh);
        bulk_commit();
      }
    } else {
      wgmma_wait<0>();
      fence_acc(dva);
      fence_acc(dka);
      fence_regs(pa);
      fence_regs(sa);
    }
    mbar_arrive(smem_u32(&bars[1 + STAGES + s]));
  }
  if (t == 0) bulk_wait();  // this consumer's dQ reduces have landed

  const size_t kvoff = (static_cast<size_t>(b) * Hkv + hk) * Skv * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    if (kp0 < Skv) {
      const size_t o = kvoff + static_cast<size_t>(kp0) * D + col;
      *reinterpret_cast<uint32_t*>(dk + o) =
          pack2<T>(dka[4 * j] * scale, dka[4 * j + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) =
          pack2<T>(dva[4 * j], dva[4 * j + 1]);
    }
    if (kp1 < Skv) {
      const size_t o = kvoff + static_cast<size_t>(kp1) * D + col;
      *reinterpret_cast<uint32_t*>(dk + o) =
          pack2<T>(dka[4 * j + 2] * scale, dka[4 * j + 3] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) =
          pack2<T>(dva[4 * j + 2], dva[4 * j + 3]);
    }
  }
}

// ------------------------------------------------------- backward, D 256
// At head_dim 256 the tiling above does not fit (128 keys a block give
// 428,088 bytes of shared memory), so the backward runs in two passes
// after the delta pass, with no unordered add anywhere: the gradients are
// the same bits from run to run.
//
// Pass 1 (flash_bwd256_dkv_kernel): dK, dV and dS.  A block owns 64 keys
// of one (batch, KV head), K and V loaded once, and walks every query
// head of the group and every 64-row query tile that can see those keys
// (the tiles whose key_band holds them).  Three warpgroups, as the
// forward: the producer (setmaxnreg 24) keeps a ring of two stages of Q
// and dO in flight with TMA and copies beside each stage lse * log2(e),
// delta, the tile's first row, whether it needs the mask and its dS slot.
// The two consumers split the work by role, so each score product runs once:
//   consumer 0   S^T = K Q^T, P^T = exp2(S^T scale log2(e) - lse), masked;
//                hands P^T in f32 to consumer 1 through shared memory;
//                dV += P^T dO (P^T rounded to q's dtype, register A);
//   consumer 1   dP^T = V dO^T; dS^T = P^T (dP^T - delta) in f32, rounded
//                once to q's dtype: the A operand of dK += dS^T Q, and
//                stored (TMA, from a swizzled staging tile) to its slot of
//                the dS scratch for pass 2.
// Four products a tile.  dV or dK (64 x 256 f32) takes 128 of a consumer
// thread's registers, so a consumer takes a tile in four 16-row parts, an
// 8-register score accumulator each, and leaves each part's dV or dK
// product in flight over the next part's score product.  ptxas does
// allocate past the 168 registers a thread has at launch after
// setmaxnreg.inc (ptxas_probe.py: its probe kernel touches R233 and does
// not spill), but not enough here: with 32-row parts this kernel touches
// R174, spills 416 bytes and serializes the wgmmas (C7512), with 64-row
// parts R199 and 1008 bytes; with 16-row parts R165 and 44 bytes.
// Shared memory: K + V 64 KB, 2 x (Q + dO) 128 KB, two 4 KB hand-off
// buffers (P^T of a part, f32), the 8 KB dS^T staging tile, 2 x (lse,
// delta, the tile's metadata): 215,144 bytes.  dK and dV are written once.
//
// Pass 2 (flash_bwd256_dq_kernel): dQ = scale * sum over key tiles of dS K.
// A block owns two 64-row query tiles of one (batch, query head), one a
// consumer warpgroup (dQ 64 x 256 f32), and walks the union of their
// bands in ascending order, so each K tile is read once for both (the
// pass is bound by those reads, from the L2); each consumer sums the key
// tiles of its own band, in ascending order, on wgmma (A = dS^T read
// MN-major, B = K MN-major).  A producer warp keeps a ring of four stages
// (K 32 KB and each consumer's dS 8 KB) in flight; dQ is written once in
// q's dtype.  288 threads: 197,696 bytes of shared memory.
//
// The dS scratch is banded: for each (batch, query head, query tile) only
// the key tiles the tile sees (key_band), in ascending order, one 64 x 64
// [key][query] tile a slot; `slots` per (batch, query head), which the
// wrapper reads from flash_attention_bwd256_slots.
//
// Planted faults (chip_smoke.py; plant = 0 on every real call):
// PLANT_KEY_TILE, pass 1's block of the middle key tile skips its tiles (its
// dK, dV zeros, its dS slots the zeros the wrapper then fills the scratch
// with); PLANT_DQ_TILE, pass 2 leaves the last key tile of every query
// tile out of its sum.
constexpr int PLANT_KEY_TILE = 1, PLANT_DQ_TILE = 2;

struct Bwd256 {
  static constexpr int D = 256;
  static constexpr int TILE = 64;   // keys a block, rows a query tile, a slot
  static constexpr int QS = 16;     // query rows a part of a tile
  static constexpr int BOX = TILE * 128;             // a 64-column box
  static constexpr int TILE_BYTES = (D / 64) * BOX;  // K, V, Q or dO
  static constexpr int STAGES = 2;  // depth of the Q/dO ring
  static constexpr int HB_BYTES = TILE * QS * 4;     // P^T of a part, f32
  static constexpr int DS_BYTES = TILE * TILE * 2;   // a dS^T tile
  // lse * log2(e) and delta of a tile's rows, then its first query row,
  // whether it needs the mask, and its dS slot
  static constexpr int LD_WORDS = 2 * TILE + 4;
  static constexpr int LD_BYTES = LD_WORDS * 4;
  static constexpr int BARS = 1 + 2 * STAGES + 4;
  static constexpr int SMEM = 2 * TILE_BYTES + STAGES * 2 * TILE_BYTES +
                              2 * HB_BYTES + DS_BYTES + STAGES * LD_BYTES +
                              1024 + 8 * BARS;
  // pass 2
  static constexpr int DQ_THREADS = 288;  // two consumer warpgroups + a warp
  static constexpr int DQ_STAGES = 4;
  static constexpr int DQ_STAGE_BYTES = TILE_BYTES + 2 * DS_BYTES;  // K, dS
  static constexpr int DQ_SMEM =
      DQ_STAGES * DQ_STAGE_BYTES + 1024 + 8 * 2 * DQ_STAGES;
};

// Key tiles [kt0, kt1) of Bwd256::TILE keys that query tile `it` sees: the
// forward's `run` bounds at 64-row tiles.  The one rule of the dS scratch's
// layout: pass 1's query tiles, both passes' slots and the slot count the
// wrapper sizes the scratch with (flash_attention_bwd256_slots) all come
// from it.  kt0 and kt1 never fall as `it` grows.
struct Band {
  int kt0, kt1;
};
__host__ __device__ __forceinline__ Band key_band(int it, int Sq, int Skv,
                                                  int causal, int window) {
  constexpr int T = Bwd256::TILE;
  const int off = Skv - Sq;
  const int end = it * T + T < Sq ? it * T + T : Sq;
  const int first = it * T + off, last = end - 1 + off;
  int lo = 0, hi = Skv;
  if (causal && last + 1 < hi) hi = last + 1;
  if (window > 0 && first - window + 1 > lo) lo = first - window + 1;
  const int kt0 = lo / T;
  return {kt0, hi > lo ? (hi + T - 1) / T : kt0};
}

// The first dS slot of query tile `it` within its (batch, query head); at
// `it` = the number of query tiles, the slots of a (batch, query head).
__host__ __device__ __forceinline__ int slot_base(int it, int Sq, int Skv,
                                                  int causal, int window) {
  int base = 0;
  for (int i = 0; i < it; ++i) {
    const Band bd = key_band(i, Sq, Skv, causal, window);
    base += bd.kt1 - bd.kt0;
  }
  return base;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd256_dkv_kernel(__grid_constant__ const CUtensorMap tmQ,
                            __grid_constant__ const CUtensorMap tmK,
                            __grid_constant__ const CUtensorMap tmV,
                            __grid_constant__ const CUtensorMap tmdO,
                            __grid_constant__ const CUtensorMap tmS,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv, int Hq,
                            int Hkv, int Sq, int Skv, float scale, int causal,
                            int window, int slots, int plant) {
  using F = Bwd256;
  constexpr int D = F::D, BQ = F::TILE, STAGES = F::STAGES, QS = F::QS;
  constexpr int PARTS = BQ / QS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* stages = smem + 2 * F::TILE_BYTES;  // [STAGES][Q, dO]
  float* hb = reinterpret_cast<float*>(stages + STAGES * 2 * F::TILE_BYTES);
  unsigned char* sds = reinterpret_cast<unsigned char*>(hb) + 2 * F::HB_BYTES;
  float* lds = reinterpret_cast<float*>(sds + F::DS_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(lds + STAGES * F::LD_WORDS);
  // bars[0]: K and V have arrived; bars[1 + s]: stage s is full (the TMA
  // bytes, and the producer warp's lse / delta copy); bars[1 + STAGES + s]:
  // stage s is free (every consumer thread); bars[1 + 2 STAGES + u]:
  // hand-off buffer u holds a P^T (consumer 0's threads);
  // bars[3 + 2 STAGES + u]: consumer 1 has read it.
  const uint32_t kv_bar = smem_u32(&bars[0]);
  const uint32_t sK = smem_u32(smem), sV = sK + F::TILE_BYTES;
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };
  auto hb_full = [&](int u) { return smem_u32(&bars[1 + 2 * STAGES + u]); };
  auto hb_free = [&](int u) { return smem_u32(&bars[3 + 2 * STAGES + u]); };

  const int jt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int off = Skv - Sq;
  const int k0 = jt * BQ;
  // The query tiles whose band holds this key tile: a run [it0, it0 + nq),
  // as the bands only move forward.
  int it0 = 0, nq = 0;
  for (int it = 0; it * BQ < Sq; ++it) {
    const Band bd = key_band(it, Sq, Skv, causal, window);
    if (bd.kt0 <= jt && jt < bd.kt1 && nq++ == 0) it0 = it;
  }
  if ((plant & PLANT_KEY_TILE) && jt == static_cast<int>(gridDim.x) / 2)
    nq = 0;
  const int tiles = group * nq;  // (query head, query tile) pairs

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 2);
      mbar_init(empty(s), 2 * 128);
    }
    for (int u = 0; u < 2; ++u) {
      mbar_init(hb_full(u), 128);
      mbar_init(hb_free(u), 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    regs_dec<PRODUCER_REGS>();
    const int lane = threadIdx.x;
    if (lane < 32 && tiles > 0) {
      if (lane == 0) {
        mbar_expect_tx(kv_bar, 2 * F::TILE_BYTES);
#pragma unroll
        for (int x = 0; x < D / 64; ++x) {
          tma_load(sK + x * F::BOX, &tmK, x * 64, k0, b * Hkv + hk, kv_bar);
          tma_load(sV + x * F::BOX, &tmV, x * 64, k0, b * Hkv + hk, kv_bar);
        }
      }
      // The tile's dS slot: base(it) + jt - kt0(it) of its (batch, query
      // head), base(it) the slots of the query tiles before it.
      const int base0 = slot_base(it0, Sq, Skv, causal, window);
      int base = base0;
      for (int i = 0; i < tiles; ++i) {
        const int s = i % STAGES;
        const int hh = hk * group + i / nq, it = it0 + i % nq, q0 = it * BQ;
        const size_t row0 = (static_cast<size_t>(b) * Hq + hh) * Sq + q0;
        float lv[BQ / 32], dl[BQ / 32];
#pragma unroll
        for (int u = 0; u < BQ / 32; ++u) {
          const int r = lane + 32 * u;
          const bool in = q0 + r < Sq;
          lv[u] = in ? lse[row0 + r] * kLog2e : INFINITY;
          dl[u] = in ? delta[row0 + r] : 0.f;
        }
        if (i % nq == 0) {
          base = base0;
        } else {
          const Band prev = key_band(it - 1, Sq, Skv, causal, window);
          base += prev.kt1 - prev.kt0;
        }
        if (i >= STAGES) mbar_wait(empty(s), (i / STAGES - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * F::TILE_BYTES);
          const uint32_t sq = smem_u32(stages + s * 2 * F::TILE_BYTES);
#pragma unroll
          for (int x = 0; x < D / 64; ++x) {
            tma_load(sq + x * F::BOX, &tmQ, x * 64, q0, b * Hq + hh, full(s));
            tma_load(sq + F::TILE_BYTES + x * F::BOX, &tmdO, x * 64, q0,
                     b * Hq + hh, full(s));
          }
        }
        float* sl = lds + s * F::LD_WORDS;
#pragma unroll
        for (int u = 0; u < BQ / 32; ++u) {
          sl[lane + 32 * u] = lv[u];
          sl[BQ + lane + 32 * u] = dl[u];
        }
        if (lane == 0) {
          int* meta = reinterpret_cast<int*>(sl + 2 * BQ);
          meta[0] = q0;
          meta[1] = !all_visible(k0, k0 + BQ - 1, q0 + off, q0 + BQ - 1 + off,
                                 Skv, causal, window);
          meta[2] = (b * Hq + hh) * slots + base + jt -
                    key_band(it, Sq, Skv, causal, window).kt0;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(full(s));
      }
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  const int c = threadIdx.x / 128 - 1;  // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int kr = w * 16 + g;  // this thread's key rows kr and kr + 8
  const int kp0 = k0 + kr;

  float acc[D / 2];  // dV (consumer 0) or dK / scale (consumer 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (tiles > 0) mbar_wait(kv_bar, 0);
  if (c == 0) {
    const float sl2 = scale * kLog2e;
    for (int i = 0; i < tiles; ++i) {
      const int s = i % STAGES;
      mbar_wait(full(s), (i / STAGES) & 1);
      const uint32_t sq = smem_u32(stages + s * 2 * F::TILE_BYTES);
      const uint32_t sdo = sq + F::TILE_BYTES;
      const float* sl = lds + s * F::LD_WORDS;
      const int* meta = reinterpret_cast<const int*>(sl + 2 * BQ);
      const int q0 = meta[0], need_mask = meta[1];
      uint32_t pa[QS / 16][4];  // P^T of a part, the A operand of dV
#pragma unroll 1
      for (int hf = 0; hf < PARTS; ++hf) {
        const int u = i * PARTS + hf;  // the hand-off ring's turn
        const uint32_t ski = opaque(sK), sqh = opaque(sq + hf * QS * 128);
        // S^T = K Q^T over this part's rows, all K-major.
        float st[QS / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<0, 0, T>(
              st, smem_desc(ski + (kk / 4) * F::BOX + (kk % 4) * 32, 16, 1024),
              smem_desc(sqh + (kk / 4) * F::BOX + (kk % 4) * 32, 16, 1024),
              kk > 0);
        wgmma_commit();
        wgmma_wait<0>();  // this S^T, and the last part's dV product
        fence_acc(st);
        fence_acc(acc);
        fence_regs(pa);
        // P^T in f32; masked pairs and rows past Sq (lse = +inf) give 0.
#pragma unroll
        for (int j = 0; j < QS / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = hf * QS + 8 * j + 2 * tq + e;  // row in the tile
            const float l2 = sl[qi];
            float p0 = exp2_approx(fmaf(st[4 * j + e], sl2, -l2));
            float p1 = exp2_approx(fmaf(st[4 * j + 2 + e], sl2, -l2));
            if (need_mask) {  // key kp is visible to query position qp
              const int qp = q0 + qi + off;
              if (!visible(qp, kp0, Skv, causal, window)) p0 = 0.f;
              if (!visible(qp, kp0 + 8, Skv, causal, window)) p1 = 0.f;
            }
            st[4 * j + e] = p0;
            st[4 * j + 2 + e] = p1;
          }
        // Hand P^T over in f32: consumer 1's thread t holds the same
        // (key, query) pairs of dP^T, so each thread's values sit together
        // (float4 f of thread t at 128 f + t).
        const int hbuf = u & 1;
        if (u >= 2) mbar_wait(hb_free(hbuf), ((u >> 1) - 1) & 1);
        float4* dst = reinterpret_cast<float4*>(hb + hbuf * BQ * QS);
#pragma unroll
        for (int f = 0; f < QS / 8; ++f)
          dst[128 * f + t] = make_float4(st[4 * f], st[4 * f + 1],
                                         st[4 * f + 2], st[4 * f + 3]);
        mbar_arrive(hb_full(hbuf));
        // dV += P^T dO: 16 query rows = 2048 bytes a step, the 64-column
        // boxes BOX bytes apart; left in flight over the next part's S^T.
        to_a_frags<T, QS / 8>(st, pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QS / 16; ++kk)
          wgmma_rs<1, T>(acc, pa[kk],
                         smem_desc(sdo + (hf * QS / 16 + kk) * 2048, F::BOX,
                                   1024),
                         1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_acc(acc);
      fence_regs(pa);
      mbar_arrive(empty(s));
    }
  } else {
    for (int i = 0; i < tiles; ++i) {
      const int s = i % STAGES;
      mbar_wait(full(s), (i / STAGES) & 1);
      const uint32_t sq = smem_u32(stages + s * 2 * F::TILE_BYTES);
      const uint32_t sdo = sq + F::TILE_BYTES;
      const float* sl = lds + s * F::LD_WORDS;
      uint32_t sa[QS / 16][4];  // dS^T of a part, the A operand of dK
#pragma unroll 1
      for (int hf = 0; hf < PARTS; ++hf) {
        const int u = i * PARTS + hf;
        const uint32_t svi = opaque(sV), sdoh = opaque(sdo + hf * QS * 128);
        // dP^T = V dO^T over this part's rows.
        float dpt[QS / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<0, 0, T>(
              dpt, smem_desc(svi + (kk / 4) * F::BOX + (kk % 4) * 32, 16, 1024),
              smem_desc(sdoh + (kk / 4) * F::BOX + (kk % 4) * 32, 16, 1024),
              kk > 0);
        wgmma_commit();
        wgmma_wait<0>();  // this dP^T, and the last part's dK product
        fence_acc(dpt);
        fence_acc(acc);
        fence_regs(sa);
        // dS^T = P^T (dP^T - delta) in f32, P^T from consumer 0.
        const int hbuf = u & 1;
        mbar_wait(hb_full(hbuf), (u >> 1) & 1);
        const float4* src =
            reinterpret_cast<const float4*>(hb + hbuf * BQ * QS);
#pragma unroll
        for (int j = 0; j < QS / 8; ++j) {
          const float4 p = src[128 * j + t];
          const int qi = hf * QS + 8 * j + 2 * tq;
          const float d0 = sl[BQ + qi], d1 = sl[BQ + qi + 1];
          dpt[4 * j] = p.x * (dpt[4 * j] - d0);
          dpt[4 * j + 1] = p.y * (dpt[4 * j + 1] - d1);
          dpt[4 * j + 2] = p.z * (dpt[4 * j + 2] - d0);
          dpt[4 * j + 3] = p.w * (dpt[4 * j + 3] - d1);
        }
        mbar_arrive(hb_free(hbuf));
        to_a_frags<T, QS / 8>(dpt, sa);
        // dS^T into the staging tile, [key][query] with the 128-byte
        // swizzle (16-byte chunk j of row r at j ^ (r % 8)); once every
        // part is in, one TMA store to the tile's slot.  The last store
        // must have read the tile first.
        if (hf == 0) {
          if (t == 0) bulk_wait_read();
          named_sync(1, 128);
        }
#pragma unroll
        for (int jj = 0; jj < QS / 8; ++jj) {
          const int j = hf * QS / 8 + jj;
          const int sw = (j ^ (kr % 8)) * 16 + 4 * tq;
          *reinterpret_cast<uint32_t*>(sds + kr * 128 + sw) =
              sa[jj / 2][jj % 2 ? 2 : 0];
          *reinterpret_cast<uint32_t*>(sds + (kr + 8) * 128 + sw) =
              sa[jj / 2][jj % 2 ? 3 : 1];
        }
        if (hf == PARTS - 1) {
          fence_proxy_async();
          named_sync(1, 128);
          if (t == 0) {
            tma_store(&tmS, smem_u32(sds), 0,
                      reinterpret_cast<const int*>(sl + 2 * BQ)[2] * BQ);
            bulk_commit();
          }
        }
        // dK += dS^T Q over this part's rows; left in flight over the next
        // part's dP^T.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QS / 16; ++kk)
          wgmma_rs<1, T>(acc, sa[kk],
                         smem_desc(sq + (hf * QS / 16 + kk) * 2048, F::BOX,
                                   1024),
                         1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_acc(acc);
      fence_regs(sa);
      mbar_arrive(empty(s));
    }
    if (t == 0) bulk_wait();  // the dS stores have landed
  }

  T* out = c == 0 ? dv : dk;
  const float mul = c == 0 ? 1.f : scale;
  const size_t kvoff = (static_cast<size_t>(b) * Hkv + hk) * Skv * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    if (kp0 < Skv)
      *reinterpret_cast<uint32_t*>(out + kvoff + static_cast<size_t>(kp0) * D +
                                   col) =
          pack2<T>(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (kp0 + 8 < Skv)
      *reinterpret_cast<uint32_t*>(out + kvoff +
                                   static_cast<size_t>(kp0 + 8) * D + col) =
          pack2<T>(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

template <typename T>
__global__ void __launch_bounds__(Bwd256::DQ_THREADS, 1)
    flash_bwd256_dq_kernel(__grid_constant__ const CUtensorMap tmS,
                           __grid_constant__ const CUtensorMap tmK,
                           T* __restrict__ dq, int Hq, int Hkv, int Sq,
                           int Skv, float scale, int causal, int window,
                           int slots, int plant) {
  using F = Bwd256;
  constexpr int D = F::D, BQ = F::TILE, STAGES = F::DQ_STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + STAGES * F::DQ_STAGE_BYTES);
  // bars[s]: stage s (K, then each consumer's dS if its band holds the
  // key tile) is full; bars[STAGES + s]: both consumers are past it.
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  // Consumer c owns query tile 2 blockIdx.x + c (none past Sq); the block
  // walks the union of their bands, key tiles in ascending order.
  const int nqt = (Sq + BQ - 1) / BQ, it0 = 2 * blockIdx.x;
  auto band = [&](int it) {
    return it < nqt ? key_band(it, Sq, Skv, causal, window) : Band{0, 0};
  };
  Band b0 = band(it0), b1 = band(it0 + 1);
  const int slot0 =
      (b * Hq + h) * slots + slot_base(it0, Sq, Skv, causal, window);
  const int slot1 = slot0 + b0.kt1 - b0.kt0;
  if (plant & PLANT_DQ_TILE) {
    if (b0.kt1 > b0.kt0) --b0.kt1;
    if (b1.kt1 > b1.kt0) --b1.kt1;
  }
  const int lo = b0.kt1 > b0.kt0 ? b0.kt0 : b1.kt0;
  const int hi = b1.kt1 > b1.kt0 ? max(b0.kt1, b1.kt1) : b0.kt1;
  const int n = hi > lo ? hi - lo : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);
      mbar_init(smem_u32(&bars[STAGES + s]), 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warp
    if (threadIdx.x == 256) {
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES, kt = lo + i;
        if (i >= STAGES)
          mbar_wait(smem_u32(&bars[STAGES + s]), (i / STAGES - 1) & 1);
        const uint32_t full = smem_u32(&bars[s]);
        const uint32_t sk = smem_u32(smem + s * F::DQ_STAGE_BYTES);
        const bool in0 = b0.kt0 <= kt && kt < b0.kt1;
        const bool in1 = b1.kt0 <= kt && kt < b1.kt1;
        mbar_expect_tx(full, F::TILE_BYTES + (in0 + in1) * F::DS_BYTES);
#pragma unroll
        for (int x = 0; x < D / 64; ++x)
          tma_load(sk + x * F::BOX, &tmK, x * 64, kt * BQ, b * Hkv + hk,
                   full);
        if (in0)
          tma_load(sk + F::TILE_BYTES, &tmS, 0, (slot0 + kt - b0.kt0) * BQ,
                   full);
        if (in1)
          tma_load(sk + F::TILE_BYTES + F::DS_BYTES, &tmS, 0,
                   (slot1 + kt - b1.kt0) * BQ, full);
      }
    }
    return;
  }

  const int c = threadIdx.x / 128;
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int kt0 = c ? b1.kt0 : b0.kt0, kt1 = c ? b1.kt1 : b0.kt1;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // dQ += dS K over this consumer's key tiles: A = dS^T read MN-major
  // (queries contiguous), B = K MN-major; 16 keys = 2048 bytes a step.  A
  // key tile outside the band commits an empty group, so that the group
  // before the last has always retired when its stage is freed.
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES, kt = lo + i;
    mbar_wait(smem_u32(&bars[s]), (i / STAGES) & 1);
    const uint32_t sk = smem_u32(smem + s * F::DQ_STAGE_BYTES);
    const uint32_t sds = sk + F::TILE_BYTES + c * F::DS_BYTES;
    fence_acc(acc);
    wgmma_fence();
    if (kt0 <= kt && kt < kt1) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_ss<1, 1, T>(acc, smem_desc(sds + kk * 2048, F::DS_BYTES, 1024),
                          smem_desc(sk + kk * 2048, F::BOX, 1024), 1);
    }
    wgmma_commit();
    fence_acc(acc);
    // The previous key tile's products have retired: free its stage.
    wgmma_wait<1>();
    fence_acc(acc);
    if (i > 0 && t == 0)
      mbar_arrive(smem_u32(&bars[STAGES + (i - 1) % STAGES]));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  T* qb = dq + (static_cast<size_t>(b) * Hq + h) * Sq * D;
  const int r0 = (it0 + c) * BQ + w * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(qb + static_cast<size_t>(r0) * D + col) =
          pack2<T>(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(qb + static_cast<size_t>(r1) * D + col) =
          pack2<T>(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// ---------------------------------------------------------------- launch
// q/k/v-shaped (B, H, S, D) 16-bit tensor as a 3-D map (D, S, B * H), boxes
// of 64 columns x `rows` rows of one head.  S = 0 (no keys) maps one row
// of `fallback` that is never read.
inline bool encode_bhsd(EncodeTiled fn, CUtensorMap* map, const void* ptr,
                        const void* fallback, bool f16, int D, int S, int BH,
                        int rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(S > 0 ? S : 1),
                            static_cast<uint64_t>(S > 0 ? BH : 1)};
  const uint32_t box[3] = {64, static_cast<uint32_t>(rows), 1};
  return encode(fn, map, S > 0 ? ptr : fallback, f16, 3, dims, box);
}

template <typename K>
int allow_smem(K kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
               float scale, int causal, int window, cudaStream_t stream) {
  using F = Fwd<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  constexpr bool f16 = std::is_same<T, __half>::value;
  CUtensorMap tq, tk, tv;
  if (!encode_bhsd(fn, &tq, q, q, f16, D, Sq, B * Hq, F::BQ) ||
      !encode_bhsd(fn, &tk, k, q, f16, D, Skv, B * Hkv, F::TK) ||
      !encode_bhsd(fn, &tv, v, q, f16, D, Skv, B * Hkv, F::TK))
    return static_cast<int>(cudaErrorInvalidValue);
  if (int err = allow_smem(flash_fwd_kernel<T, D>, F::SMEM)) return err;
  dim3 grid((Sq + F::BQ - 1) / F::BQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, F::SMEM, stream>>>(
      tq, tk, tv, static_cast<T*>(out), lse, Hq, Hkv, Sq, Skv, scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

// The D 256 backward's two passes, after the delta pass: the dS scratch
// `ds` as a 2-D map of 64-column rows, B * Hq * slots tiles of 64 rows.
template <typename T>
int launch_bwd256(EncodeTiled fn, const CUtensorMap& tq, const CUtensorMap& tk,
                  const CUtensorMap& tv, const CUtensorMap& tdo,
                  const float* lse, const float* delta, void* ds, void* dq,
                  void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
                  float scale, int causal, int window, int slots, int plant,
                  cudaStream_t stream) {
  using F = Bwd256;
  constexpr bool f16 = std::is_same<T, __half>::value;
  const int nqt = (Sq + F::TILE - 1) / F::TILE;
  if (slots != slot_base(nqt, Sq, Skv, causal, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t rows = static_cast<uint64_t>(B) * Hq * slots * F::TILE;
  const uint64_t dims[2] = {F::TILE, rows > 0 ? rows : F::TILE};
  const uint32_t box[2] = {F::TILE, F::TILE};
  CUtensorMap ts;
  if (!encode(fn, &ts, ds, f16, 2, dims, box))
    return static_cast<int>(cudaErrorInvalidValue);
  if (int err = allow_smem(flash_bwd256_dkv_kernel<T>, F::SMEM)) return err;
  if (int err = allow_smem(flash_bwd256_dq_kernel<T>, F::DQ_SMEM)) return err;
  dim3 grid_kv((Skv + F::TILE - 1) / F::TILE, Hkv, B);
  flash_bwd256_dkv_kernel<T><<<grid_kv, THREADS, F::SMEM, stream>>>(
      tq, tk, tv, tdo, ts, lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), Hq, Hkv, Sq, Skv, scale, causal, window, slots,
      plant);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  dim3 grid_q(((Sq + F::TILE - 1) / F::TILE + 1) / 2, Hq, B);
  flash_bwd256_dq_kernel<T><<<grid_q, F::DQ_THREADS, F::DQ_SMEM, stream>>>(
      ts, tk, static_cast<T*>(dq), Hq, Hkv, Sq, Skv, scale, causal, window,
      slots, plant);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, void* ds, int B, int Hq, int Hkv, int Sq,
               int Skv, float scale, int causal, int window, int slots,
               int plant, cudaStream_t stream) {
  using F = Bwd<D>;  // the D 64 / 128 tiling; D 256 has Bwd256
  constexpr int BQ = D == 256 ? Bwd256::TILE : F::BQ;
  constexpr int BK = D == 256 ? Bwd256::TILE : F::BK;
  const size_t rows = static_cast<size_t>(B) * Hq * Sq;
  flash_bwd_dot_kernel<T, D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                                 stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, rows);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  constexpr bool f16 = std::is_same<T, __half>::value;
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!encode_bhsd(fn, &tq, q, q, f16, D, Sq, B * Hq, BQ) ||
      !encode_bhsd(fn, &tdo, dout, q, f16, D, Sq, B * Hq, BQ) ||
      !encode_bhsd(fn, &tk, k, q, f16, D, Skv, B * Hkv, BK) ||
      !encode_bhsd(fn, &tv, v, q, f16, D, Skv, B * Hkv, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (D == 256) {
    return launch_bwd256<T>(fn, tq, tk, tv, tdo, lse, delta, ds, dq, dk, dv,
                            B, Hq, Hkv, Sq, Skv, scale, causal, window, slots,
                            plant, stream);
  } else {
    const uint64_t dq_dims[3] = {static_cast<uint64_t>(D),
                                 static_cast<uint64_t>(Sq),
                                 static_cast<uint64_t>(B) * Hq};
    const uint32_t dq_box[3] = {32, F::BQ, 1};
    if (!encode(fn, &tdq, dq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 3, dq_dims,
                dq_box))
      return static_cast<int>(cudaErrorInvalidValue);
    if (int err = allow_smem(flash_bwd_kernel<T, D>, F::SMEM)) return err;
    dim3 grid((Skv + F::BK - 1) / F::BK, Hkv, B);
    flash_bwd_kernel<T, D><<<grid, THREADS, F::SMEM, stream>>>(
        tq, tk, tv, tdo, tdq, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), Hq, Hkv, Sq, Skv, scale, causal, window);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace flash
}  // namespace repro

// Both directions take head_dim 64, 128 and 256 (the backward at 256 in
// its own two passes, flash_bwd256_dkv_kernel and flash_bwd256_dq_kernel).
#define REPRO_FLASH_CASES(CALL)                                      \
  case repro::kBF16 * 1000 + 64: return CALL(__nv_bfloat16, 64);    \
  case repro::kBF16 * 1000 + 128: return CALL(__nv_bfloat16, 128);  \
  case repro::kBF16 * 1000 + 256: return CALL(__nv_bfloat16, 256);  \
  case repro::kF16 * 1000 + 64: return CALL(__half, 64);            \
  case repro::kF16 * 1000 + 128: return CALL(__half, 128);          \
  case repro::kF16 * 1000 + 256: return CALL(__half, 256);

extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int Hq, int Hkv, int Sq, int Skv, int D, float scale, int causal,
    int window, int dtype, void* stream) {
#define REPRO_FWD(T, DD)                                                     \
  repro::flash::launch_fwd<T, DD>(q, k, v, out, static_cast<float*>(lse), B, \
                                  Hq, Hkv, Sq, Skv, scale, causal, window,  \
                                  static_cast<cudaStream_t>(stream))
  switch (dtype * 1000 + D) {
    REPRO_FLASH_CASES(REPRO_FWD)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FWD
}

// dq is f32 (zeroed, summed into) at head_dim 64 / 128 and q's dtype at
// 256; ds is the D 256 backward's dS scratch of `slots` tiles a (batch,
// query head), unused below 256.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, void* ds, int B, int Hq, int Hkv, int Sq, int Skv, int D,
    float scale, int causal, int window, int dtype, int slots, int plant,
    void* stream) {
#define REPRO_BWD(T, DD)                                                   \
  repro::flash::launch_bwd<T, DD>(                                        \
      q, k, v, out, dout, static_cast<const float*>(lse),                 \
      static_cast<float*>(delta), dq, dk, dv, ds, B, Hq, Hkv, Sq, Skv,     \
      scale, causal, window, slots, plant,                                \
      static_cast<cudaStream_t>(stream))
  switch (dtype * 1000 + D) {
    REPRO_FLASH_CASES(REPRO_BWD)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_BWD
}

// dS slots a (batch, query head) of the D 256 backward's banded scratch,
// one 64 x 64 tile each: the wrapper sizes the scratch with it.
extern "C" int flash_attention_bwd256_slots(int Sq, int Skv, int causal,
                                            int window) {
  using namespace repro::flash;
  return slot_base((Sq + Bwd256::TILE - 1) / Bwd256::TILE, Sq, Skv, causal,
                   window);
}

// Dynamic shared memory of a kernel for head_dim D, in bytes: `part` 0 the
// forward, 1 the backward (at D 256 its pass 1), 2 the D 256 backward's
// pass 2; 0 for a head_dim or part it does not have.  The wrapper's tests
// hold repro_torch.kernels.flash_attention.smem_bytes to it.
extern "C" int flash_attention_smem(int D, int part) {
  using namespace repro::flash;
  if (part == 2) return D == 256 ? Bwd256::DQ_SMEM : 0;
  if (part == 1)
    return D == 64    ? Bwd<64>::SMEM
           : D == 128 ? Bwd<128>::SMEM
           : D == 256 ? Bwd256::SMEM
                      : 0;
  return D == 64 ? Fwd<64>::SMEM
         : D == 128 ? Fwd<128>::SMEM
         : D == 256 ? Fwd<256>::SMEM : 0;
}
