// Flash attention for Hopper: causal / windowed GQA online-softmax
// attention, forward and backward.
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
// KV grid axis.  Here one block owns 64 query rows (4 warps x 16) of one
// (batch, head) and loops over the KV tiles itself, with m, l and the
// output accumulator in registers.  The loop bounds are the TPU kernel's
// `run` predicate: KV tiles wholly in the future (causal) or wholly before
// the window are never loaded.  Keys past Skv are masked in the kernel; K
// and V tiles past the end are zero-filled in shared memory, not padded by
// copy.  QK^T and PV run on the tensor cores with mma.sync m16n8k16
// (bf16/f16 in, f32 accumulate).  The score fragment of QK^T is, register
// for register, the A fragment of PV, so P never leaves registers; it is
// rounded to the input dtype for the PV product (the TPU kernel keeps it
// f32; the tolerance in chip_smoke.py is set from readings).  K/V tiles are
// double-buffered with cp.async.  The forward stores out (q's dtype) and
// lse = m + log(l) (f32, (B, Hq, Sq)) for the backward.
//
// Backward (FlashAttention-2).  A first pass computes D = rowsum(dO * O)
// per query row.  Then one block per (batch, KV head, 64-key tile) loops
// over the query heads of its group and over the query tiles that can see
// its keys (the same `run` bounds, transposed), recomputes P = exp(S *
// scale - lse), and accumulates dV += P^T dO and dK += dS^T Q in registers,
// with dS = P * (dP - D), dP = dO V^T.  dK and dV are summed over the
// group inside the block and written once.  dQ += dS K is accumulated
// across KV tiles with f32 atomics into a zeroed (B, Hq, Sq, D) buffer, so
// dQ's summation order varies from run to run (the tolerance says so).
//
// Head dims: the forward takes 64, 128 and 256 (recurrentgemma's MQA heads,
// with Q staged in shared memory and 32-key tiles, see FwdTile); the backward
// 64 and 128.
//
// What bounds it on an H100: operations.  At B 4, H 32, S 2048, D 64,
// causal, the forward does 4 * D flops on each of B*H*S(S+1)/2 visible
// (query, key) pairs, 68.7 GFLOP, 0.069 ms at 989 TFLOP/s, against 0.040 ms
// of bytes; the backward 2.5x the operations.  This first version answers
// the bound only with the tensor cores and the skipped tiles: no wgmma, no
// TMA, no warp specialisation, fragments read from shared memory by plain
// loads.
#include <math.h>

#include "common.cuh"

namespace repro {
namespace flash {

constexpr int BQ = 64;       // query rows per block: 4 warps x 16
constexpr int BK = 64;       // keys per tile (backward; forward: FwdTile)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float kNegInf = -1e30f;  // floor of the running max

// ---------------------------------------------------------------- helpers
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4],
                                                 const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

// Two adjacent 16-bit elements as one register.
template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Elements p[0] and p[stride] (one column, two rows) as one register.
template <typename T>
__device__ __forceinline__ uint32_t col2(const T* p, int stride) {
  const uint16_t* u = reinterpret_cast<const uint16_t*>(p);
  return static_cast<uint32_t>(u[0]) |
         (static_cast<uint32_t>(u[stride]) << 16);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Is key `kp` visible to the query at position `qp`?
__device__ __forceinline__ bool visible(int kp, int qp, int Skv, int causal,
                                        int window) {
  return kp < Skv && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// Copy rows [r0, r0 + ROWS) of a row-major (R, D) matrix into shared memory
// with row stride LD by cp.async; rows past R are zero-filled.
template <typename T, int ROWS, int D, int LD>
__device__ __forceinline__ void load_rows(T* s, const T* g, int r0, int R) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    T* dst = s + r * LD + c;
    if (r0 + r < R) {
      cp_async16(dst, g + static_cast<size_t>(r0 + r) * D + c);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
}

// ---------------------------------------------------------------- forward
// Keys per KV tile of the forward, and whether Q is staged in shared memory.
// At D <= 128 a warp keeps its 16 rows of Q as mma A fragments in registers
// (D / 4 registers a thread) beside the 16 x D f32 output accumulator (D / 2
// registers a thread).  At D = 256 those two alone would be 192 registers,
// so Q is read from shared memory at each product instead, and the tile is
// 32 keys: the K/V double buffer is then 66 KB and Q 33 KB.
template <int D>
struct FwdTile {
  static constexpr int kKeys = D > 128 ? 32 : 64;
  static constexpr bool kQInSmem = D > 128;
  template <typename T>
  static constexpr size_t smem() {
    return (2 * 2 * kKeys + (kQInSmem ? BQ : 0)) * (D + 8) * sizeof(T);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int Hq, int Hkv, int Sq,
                     int Skv, float scale, int causal, int window) {
  constexpr int LD = D + 8;  // padded row stride against bank conflicts
  constexpr int TK = FwdTile<D>::kKeys;
  constexpr bool QS = FwdTile<D>::kQInSmem;
  constexpr int NT = TK / 8;  // score n-tiles per warp
  constexpr int OT = D / 8;   // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [2][TK][LD]
  T* Vs = Ks + 2 * TK * LD;                // [2][TK][LD]
  T* Qs = Vs + 2 * TK * LD;                // [BQ][LD] when QS

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int iq = gridDim.x - 1 - blockIdx.x;  // latest (longest) rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = Skv - Sq;
  const T* qb = q + (static_cast<size_t>(b) * Hq + h) * Sq * D;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * Skv * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * Skv * D;
  const int q0 = iq * BQ;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's rows
  const int p0 = r0 + off, p1 = r1 + off;          // their positions

  // Q as the A fragments of QK^T, straight from device memory (D <= 128).
  uint32_t qf[QS ? 1 : D / 16][4];
  if constexpr (!QS) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int c = ks * 16 + t * 2;
      qf[ks][0] = r0 < Sq ? ld32(qb + static_cast<size_t>(r0) * D + c) : 0u;
      qf[ks][1] = r1 < Sq ? ld32(qb + static_cast<size_t>(r1) * D + c) : 0u;
      qf[ks][2] = r0 < Sq ? ld32(qb + static_cast<size_t>(r0) * D + c + 8) : 0u;
      qf[ks][3] = r1 < Sq ? ld32(qb + static_cast<size_t>(r1) * D + c + 8) : 0u;
    }
  }

  // KV tiles this block can see (the TPU kernel's `run` predicate).
  const int first = q0 + off, last = min(q0 + BQ, Sq) - 1 + off;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, last + 1);
  if (window > 0) kv_lo = max(kv_lo, first - window + 1);
  const int kt0 = kv_lo / TK;
  const int kt1 = kv_hi > kv_lo ? (kv_hi + TK - 1) / TK : kt0;

  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const bool live0 = r0 < Sq, live1 = r1 < Sq;

  if (kt0 < kt1) {
    if constexpr (QS) load_rows<T, BQ, D, LD>(Qs, qb, q0, Sq);
    load_rows<T, TK, D, LD>(Ks, kb, kt0 * TK, Skv);
    load_rows<T, TK, D, LD>(Vs, vb, kt0 * TK, Skv);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      load_rows<T, TK, D, LD>(Ks + (st ^ 1) * TK * LD, kb, (kt + 1) * TK, Skv);
      load_rows<T, TK, D, LD>(Vs + (st ^ 1) * TK * LD, vb, (kt + 1) * TK, Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks_ = Ks + st * TK * LD;
    const T* vs_ = Vs + st * TK * LD;

    // S = Q K^T for this warp's 16 rows x TK keys.
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (QS) {
        const T* qr = Qs + (warp * 16 + g) * LD + kk * 16 + t * 2;
        qa[0] = ld32(qr);
        qa[1] = ld32(qr + 8 * LD);
        qa[2] = ld32(qr + 8);
        qa[3] = ld32(qr + 8 * LD + 8);
      } else {
        qa[0] = qf[kk][0];
        qa[1] = qf[kk][1];
        qa[2] = qf[kk][2];
        qa[3] = qf[kk][3];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const T* kr = ks_ + (n * 8 + g) * LD + kk * 16 + t * 2;
        const uint32_t bf[2] = {ld32(kr), ld32(kr + 8)};
        mma16816<T>(s[n], qa, bf);
      }
    }

    // Mask, scale, online softmax in f32.  Masked scores become -inf; the
    // running max never drops below -1e30, so they give exactly 0.
    const int k0 = kt * TK;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + n * 8 + t * 2 + e;
        s[n][e] = live0 && visible(kp, p0, Skv, causal, window)
                      ? s[n][e] * scale : -INFINITY;
        s[n][2 + e] = live1 && visible(kp, p1, Skv, causal, window)
                          ? s[n][2 + e] * scale : -INFINITY;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = __expf(s[n][e] - mn0);
        s[n][2 + e] = __expf(s[n][2 + e] - mn1);
        ls0 += s[n][e];
        ls1 += s[n][2 + e];
      }
    }
    l0 = l0 * a0 + ls0;  // per-lane partial sums, reduced at the end
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // O += P V: the score fragments are the A fragments of this product.
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint32_t pa[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                              pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                              pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < OT; ++n) {
        const T* vr = vs_ + (kk * 16 + t * 2) * LD + n * 8 + g;
        const uint32_t bf[2] = {col2(vr, LD), col2(vr + 8 * LD, LD)};
        mma16816<T>(o[n], pa, bf);
      }
    }
    __syncthreads();  // every warp is done with stage st before it refills
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float i1 = l1 > 0.f ? 1.f / l1 : 0.f;
  T* ob = out + (static_cast<size_t>(b) * Hq + h) * Sq * D;
#pragma unroll
  for (int n = 0; n < OT; ++n) {
    const int c = n * 8 + t * 2;
    if (live0)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * D + c) =
          pack2<T>(o[n][0] * i0, o[n][1] * i0);
    if (live1)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r1) * D + c) =
          pack2<T>(o[n][2] * i1, o[n][3] * i1);
  }
  if (t == 0) {
    float* lb = lse + (static_cast<size_t>(b) * Hq + h) * Sq;
    if (live0) lb[r0] = l0 > 0.f ? m0 + __logf(l0) : INFINITY;
    if (live1) lb[r1] = l1 > 0.f ? m1 + __logf(l1) : INFINITY;
  }
}

// --------------------------------------------------------------- backward
// D = rowsum(dO * O) in f32, one warp per query row.
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv,
                     int Sq, int Skv, float scale, int causal, int window) {
  constexpr int LD = D + 8;
  constexpr int LDS = BK + 8;
  constexpr int QT = BQ / 8;  // query n-tiles of S^T per warp
  constexpr int OT = D / 8;   // head-dim n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [BK][LD]
  T* Vs = Ks + BK * LD;                    // [BK][LD]
  T* Qs = Vs + BK * LD;                    // [BQ][LD]
  T* dOs = Qs + BQ * LD;                   // [BQ][LD]
  T* dSs = dOs + BQ * LD;                  // [BQ][LDS], dS[query][key]
  float* Ls = reinterpret_cast<float*>(dSs + BQ * LDS);  // [BQ]
  float* Ds = Ls + BQ;                                    // [BQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int jt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int off = Skv - Sq;
  const int k0 = jt * BK;
  const int kr = warp * 16 + g;               // this thread's key rows in
  const int kp0 = k0 + kr, kp1 = kp0 + 8;     // the tile: kr and kr + 8
  const size_t kvoff = (static_cast<size_t>(b) * Hkv + hk) * Skv * D;

  load_rows<T, BK, D, LD>(Ks, k + kvoff, k0, Skv);
  load_rows<T, BK, D, LD>(Vs, v + kvoff, k0, Skv);
  cp_async_commit();

  // Query rows that can see some key of this tile.
  const int klast = min(k0 + BK, Skv) - 1;
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(q_lo, k0 - off);
  if (window > 0) q_hi = min(q_hi, klast + window - off);
  const int it0 = q_lo / BQ;
  const int it1 = q_hi > q_lo ? (q_hi + BQ - 1) / BQ : it0;

  float dka[OT][4], dva[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int hh = hk * group; hh < (hk + 1) * group; ++hh) {
    const size_t qoff = (static_cast<size_t>(b) * Hq + hh) * Sq;
    for (int it = it0; it < it1; ++it) {
      const int q0 = it * BQ;
      __syncthreads();  // the previous tile's Qs/dOs/dSs/Ls/Ds are consumed
      load_rows<T, BQ, D, LD>(Qs, q + qoff * D, q0, Sq);
      load_rows<T, BQ, D, LD>(dOs, dout + qoff * D, q0, Sq);
      cp_async_commit();
      for (int i = threadIdx.x; i < BQ; i += THREADS) {
        const bool in = q0 + i < Sq;
        Ls[i] = in ? lse[qoff + q0 + i] : INFINITY;
        Ds[i] = in ? delta[qoff + q0 + i] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // S^T = K Q^T for this warp's 16 keys x 64 queries; then P^T.
      float pt[QT][4], dpt[QT][4];
#pragma unroll
      for (int n = 0; n < QT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const T* ka = Ks + kr * LD + kk * 16 + t * 2;
        const T* va = Vs + kr * LD + kk * 16 + t * 2;
        const uint32_t af[4] = {ld32(ka), ld32(ka + 8 * LD), ld32(ka + 8),
                                ld32(ka + 8 * LD + 8)};
        const uint32_t avf[4] = {ld32(va), ld32(va + 8 * LD), ld32(va + 8),
                                 ld32(va + 8 * LD + 8)};
#pragma unroll
        for (int n = 0; n < QT; ++n) {
          const T* qr = Qs + (n * 8 + g) * LD + kk * 16 + t * 2;
          const uint32_t bq[2] = {ld32(qr), ld32(qr + 8)};
          mma16816<T>(pt[n], af, bq);
          const T* dr = dOs + (n * 8 + g) * LD + kk * 16 + t * 2;
          const uint32_t bd[2] = {ld32(dr), ld32(dr + 8)};
          mma16816<T>(dpt[n], avf, bd);  // dP^T = V dO^T
        }
      }
#pragma unroll
      for (int n = 0; n < QT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = n * 8 + t * 2 + e;  // query row in the tile
          const int qp = q0 + qi + off;
          const bool in = q0 + qi < Sq;
          const float l = Ls[qi], dd = Ds[qi];
          const float p0 = in && visible(kp0, qp, Skv, causal, window)
                               ? __expf(pt[n][e] * scale - l) : 0.f;
          const float p1 = in && visible(kp1, qp, Skv, causal, window)
                               ? __expf(pt[n][2 + e] * scale - l) : 0.f;
          pt[n][e] = p0;
          pt[n][2 + e] = p1;
          dpt[n][e] = p0 * (dpt[n][e] - dd);  // dS^T
          dpt[n][2 + e] = p1 * (dpt[n][2 + e] - dd);
          dSs[qi * LDS + kr] = from_f<T>(dpt[n][e]);
          dSs[qi * LDS + kr + 8] = from_f<T>(dpt[n][2 + e]);
        }
      }

      // dV += P^T dO and dK += dS^T Q; the score fragments are the A
      // fragments, B runs down a column of dO / Q.
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t pa[4] = {pack2<T>(pt[2 * kk][0], pt[2 * kk][1]),
                                pack2<T>(pt[2 * kk][2], pt[2 * kk][3]),
                                pack2<T>(pt[2 * kk + 1][0], pt[2 * kk + 1][1]),
                                pack2<T>(pt[2 * kk + 1][2], pt[2 * kk + 1][3])};
        const uint32_t sa[4] = {
            pack2<T>(dpt[2 * kk][0], dpt[2 * kk][1]),
            pack2<T>(dpt[2 * kk][2], dpt[2 * kk][3]),
            pack2<T>(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
            pack2<T>(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < OT; ++n) {
          const T* dr = dOs + (kk * 16 + t * 2) * LD + n * 8 + g;
          const uint32_t bd[2] = {col2(dr, LD), col2(dr + 8 * LD, LD)};
          mma16816<T>(dva[n], pa, bd);
          const T* qr = Qs + (kk * 16 + t * 2) * LD + n * 8 + g;
          const uint32_t bq[2] = {col2(qr, LD), col2(qr + 8 * LD, LD)};
          mma16816<T>(dka[n], sa, bq);
        }
      }
      __syncthreads();  // dS of every warp is in shared memory

      // dQ += dS K (scaled): warp w takes query rows 16w .. 16w + 15.
      float dqa[OT][4];
#pragma unroll
      for (int n = 0; n < OT; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const T* sr = dSs + (warp * 16 + g) * LDS + kk * 16 + t * 2;
        const uint32_t af[4] = {ld32(sr), ld32(sr + 8 * LDS), ld32(sr + 8),
                                ld32(sr + 8 * LDS + 8)};
#pragma unroll
        for (int n = 0; n < OT; ++n) {
          const T* kc = Ks + (kk * 16 + t * 2) * LD + n * 8 + g;
          const uint32_t bk[2] = {col2(kc, LD), col2(kc + 8 * LD, LD)};
          mma16816<T>(dqa[n], af, bk);
        }
      }
      const int qa = q0 + warp * 16 + g, qb2 = qa + 8;
#pragma unroll
      for (int n = 0; n < OT; ++n) {
        const int c = n * 8 + t * 2;
        if (qa < Sq) {
          float* dst = dq + (qoff + qa) * D + c;
          atomicAdd(dst, dqa[n][0] * scale);
          atomicAdd(dst + 1, dqa[n][1] * scale);
        }
        if (qb2 < Sq) {
          float* dst = dq + (qoff + qb2) * D + c;
          atomicAdd(dst, dqa[n][2] * scale);
          atomicAdd(dst + 1, dqa[n][3] * scale);
        }
      }
    }
  }

  cp_async_wait<0>();  // a tile no query sees still issued its K/V copies
#pragma unroll
  for (int n = 0; n < OT; ++n) {
    const int c = n * 8 + t * 2;
    if (kp0 < Skv) {
      const size_t o = kvoff + static_cast<size_t>(kp0) * D + c;
      *reinterpret_cast<uint32_t*>(dk + o) =
          pack2<T>(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) = pack2<T>(dva[n][0], dva[n][1]);
    }
    if (kp1 < Skv) {
      const size_t o = kvoff + static_cast<size_t>(kp1) * D + c;
      *reinterpret_cast<uint32_t*>(dk + o) =
          pack2<T>(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) = pack2<T>(dva[n][2], dva[n][3]);
    }
  }
}

// ---------------------------------------------------------------- launch
template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
               float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = FwdTile<D>::template smem<T>();
  if (int err = allow_smem(flash_fwd_kernel<T, D>, smem)) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Hq, Hkv, Sq, Skv,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* delta, float* dq,
               void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
               float scale, int causal, int window, cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(B) * Hq * Sq;
  flash_bwd_dot_kernel<T, D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                                 stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, rows);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  const size_t smem = (2 * BK + 2 * BQ) * (D + 8) * sizeof(T) +
                      BQ * (BK + 8) * sizeof(T) + 2 * BQ * sizeof(float);
  if (int err = allow_smem(flash_bwd_kernel<T, D>, smem)) return err;
  dim3 grid((Skv + BK - 1) / BK, Hkv, B);
  flash_bwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, dq,
      static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv, Sq, Skv, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
}  // namespace repro

// The forward takes head_dim 64, 128 and 256; the backward 64 and 128 (at
// 256 its dK and dV accumulators alone would be 256 registers a thread).
#define REPRO_FLASH_CASES(CALL)                                      \
  case repro::kBF16 * 1000 + 64: return CALL(__nv_bfloat16, 64);    \
  case repro::kBF16 * 1000 + 128: return CALL(__nv_bfloat16, 128);  \
  case repro::kF16 * 1000 + 64: return CALL(__half, 64);            \
  case repro::kF16 * 1000 + 128: return CALL(__half, 128);

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
    case repro::kBF16 * 1000 + 256: return REPRO_FWD(__nv_bfloat16, 256);
    case repro::kF16 * 1000 + 256: return REPRO_FWD(__half, 256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FWD
}

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int Sq, int Skv, int D, float scale,
    int causal, int window, int dtype, void* stream) {
#define REPRO_BWD(T, DD)                                                   \
  repro::flash::launch_bwd<T, DD>(                                        \
      q, k, v, out, dout, static_cast<const float*>(lse),                 \
      static_cast<float*>(delta), static_cast<float*>(dq), dk, dv, B, Hq, \
      Hkv, Sq, Skv, scale, causal, window, static_cast<cudaStream_t>(stream))
  switch (dtype * 1000 + D) {
    REPRO_FLASH_CASES(REPRO_BWD)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_BWD
}
