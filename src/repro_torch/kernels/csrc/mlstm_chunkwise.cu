// Chunkwise mLSTM for Hopper: the stabilized chunkwise form of xLSTM's
// matrix-memory recurrence, with its final (C, n, m) state.
//
// Replaces the Pallas kernel repro/kernels/mlstm.py:108 (`mlstm_chunkwise`,
// body `_mlstm_kernel`).  Per chunk of L steps, with the state (C0, n0, m0)
// of the chunk before (zeros and m0 = 0 at the start), b = cumsum(log f),
// a = log i - b, g = max(m0, cummax(a)), m = b + g:
//
//   h_j = [exp(m0 - g_j) q_j C0 + sum_{s<=j} exp(a_s - g_j) (q_j.k_s) v_s]
//         / max(|exp(m0 - g_j) q_j.n0 + sum_{s<=j} exp(a_s - g_j) q_j.k_s|,
//               exp(-m_j))
//   C = exp(m0 - g_L) C0 + sum_s exp(a_s - g_L) k_s v_s^T
//   n = exp(m0 - g_L) n0 + sum_s exp(a_s - g_L) k_s,   m = b_L + g_L
//
// with q scaled by D^-0.5 (here the products q.k, q C0 and q.n0 are
// scaled instead: for D = 1024 the scale 1/32 is exact).  Steps past S in
// the last chunk are read as log f = 0, log i = -1e30 and q = k = v = 0,
// the reference's padding, so they change neither h nor the state: the
// state written is the state after S steps.
//
// Grid.  The TPU kernel keeps C (D x D f32) in VMEM across a sequential
// chunk axis; at xLSTM's head dim D = 1024 that is 4 MB per (batch, head),
// and a block here has at most 227 KB of shared memory.  So C is split by
// value columns: one block owns E = 128 columns of one (batch, head) and
// walks the chunks in order.  h[:, e] needs only C[:, e] and v[:, e], so the
// column tiles are independent.  The block's C tile (D x 128 f32, 512 KB at
// D = 1024) lives in the f32 state tensor the wrapper allocates: the block
// reads it and writes it once a chunk (at B 4, H 4 the whole C is 64 MB,
// near the 50 MB L2).  What every column block of a (batch, head) needs
// over the full D -- S = q k^T, its decayed row sums and q.n0 -- each block
// computes itself: S is recomputed D / E = 8 times, which makes the
// kernel's operations 1.5x the function's (as the bound below counts it) at
// the xLSTM shape (per chunk and block, 2 L^2 D for S against 2 L D E +
// 2 L^2 E + 2 D L E for the rest);
// a state-independent pre-pass could remove it at the cost of writing the
// (L x L) decay-masked S of every chunk to memory.  n (D f32) and m are the
// same in every column block; each keeps its own copy (n in shared memory,
// m in a register of thread 0) and column block 0 writes them out.
//
// Per chunk:
//   1. the gate scan (cumsum, cummax, stabilizer, decays), serially by one
//      thread from shared memory (L <= 128 steps);
//   2. one loop over D in 32-deep slices: S = q k^T (L x L) and q C0 (L x E)
//      accumulated in registers (8 x 8 of each a thread), q.n0 beside them;
//   3. S scaled and decay-masked (causal), stored transposed in shared
//      memory with its row sums; v's column tile (L x E) loaded;
//   4. h = (decay0 * q C0 + (S . D) v) / den, stored in q's dtype;
//   5. C and n updated in 64-row tiles of D: C += (w k)^T v with w = exp(a -
//      g_L), each tile of k scaled by w in shared memory.
// All arithmetic is f32 on the CUDA cores (the TPU kernel's f32 dots),
// register-tiled 8 x 8 a thread from shared memory.
//
// What bounds it on an H100: operations.  At the xLSTM prefill shape (B 4,
// H 4, S 2048, D 1024, chunk 128) the function is 141.8 GFLOP, counting the
// causal (query, key) pairs only and no q C0 on the first chunk (0.143 ms at
// the 989 TFLOP/s of bf16 tensor cores; 2.1 ms at the 67 TFLOP/s of f32 on
// CUDA cores), and moves 333 MB (0.099 ms).  This first version runs on the
// CUDA cores, in f32, with the redundant S above; the tensor cores
// (mma.sync or wgmma, the state kept f32) are the redesign.
#include <math.h>

#include "common.cuh"

namespace repro {
namespace mlstm {

constexpr int THREADS = 256;
constexpr int LMAX = 128;  // longest chunk the block holds
constexpr int E = 128;     // value columns a block owns
constexpr int DK = 32;     // depth of a D slice in the first loop
constexpr int DT = 64;     // rows of C updated at a time
constexpr int LP = LMAX + 4;  // pitch of [d][row] slices (keeps float4 rows)
constexpr int KP = DT + 4;    // pitch of the w-scaled k tile
constexpr float NEG_BIG = -1e30f;

// Shared memory, in floats.  Region A holds the first loop's slices and,
// later in the chunk, the state update's k tile.
struct Smem {
  static constexpr int kQt = 0;                    // [DK][LP]  q slice
  static constexpr int kKt = kQt + DK * LP;        // [DK][LP]  k slice
  static constexpr int kCs = kKt + DK * LP;        // [DK][E]   C0 slice
  static constexpr int kRegionA = kCs + DK * E;
  static constexpr int kKw = 0;                    // [LMAX][KP] w * k tile
  static_assert(LMAX * KP <= kRegionA, "k tile must fit region A");
  static constexpr int kSdt = kRegionA;            // [LMAX][LP] (S.D)^T
  static constexpr int kVs = kSdt + LMAX * LP;     // [LMAX][E]  v tile
  static constexpr int kGates = kVs + LMAX * E;    // 9 arrays of LMAX
  static constexpr int kLf = kGates, kLi = kLf + LMAX, kA = kLi + LMAX,
                       kG = kA + LMAX, kDecay = kG + LMAX,
                       kMinv = kDecay + LMAX, kW = kMinv + LMAX,
                       kQn = kW + LMAX, kRow = kQn + LMAX;
  static constexpr int kScalars = kRow + LMAX;     // scale_c
  static constexpr int kN = kScalars + 4;          // [D] n
  static size_t bytes(int D) { return sizeof(float) * (kN + D); }
};

__device__ __forceinline__ int row_of(int ty, int i) {
  return (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    mlstm_chunkwise_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ log_f,
                           const float* __restrict__ log_i,
                           T* __restrict__ out, float* __restrict__ C,
                           float* __restrict__ n_out,
                           float* __restrict__ m_out, int S, int D, int L,
                           float scale) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* qt = sm + Smem::kQt;
  float* kt = sm + Smem::kKt;
  float* cs = sm + Smem::kCs;
  float* kw = sm + Smem::kKw;
  float* sdt = sm + Smem::kSdt;
  float* vs = sm + Smem::kVs;
  float* s_lf = sm + Smem::kLf;
  float* s_li = sm + Smem::kLi;
  float* s_a = sm + Smem::kA;
  float* s_g = sm + Smem::kG;
  float* s_decay = sm + Smem::kDecay;
  float* s_minv = sm + Smem::kMinv;
  float* s_w = sm + Smem::kW;
  float* s_qn = sm + Smem::kQn;
  float* s_row = sm + Smem::kRow;
  float* s_scalars = sm + Smem::kScalars;
  float* ns = sm + Smem::kN;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int e0 = blockIdx.y * E;
  const size_t seq = static_cast<size_t>(bh) * S * D;  // q/k/v/out (b, h)
  const T* qb = q + seq;
  const T* kb = k + seq;
  const T* vb = v + seq;
  T* ob = out + seq;
  const float* lfb = log_f + static_cast<size_t>(bh) * S;
  const float* lib = log_i + static_cast<size_t>(bh) * S;
  float* Cb = C + static_cast<size_t>(bh) * D * D;

  for (int d = tid; d < D; d += THREADS) ns[d] = 0.f;
  float m0 = 0.f;  // the stabilizer, carried by thread 0

  const int n_chunks = (S + L - 1) / L;
  for (int ic = 0; ic < n_chunks; ++ic) {
    const int t0 = ic * L;
    const bool first = ic == 0;
    // ---- 1. the gate scan ------------------------------------------------
    if (tid < LMAX) {
      const bool ok = tid < L && t0 + tid < S;
      s_lf[tid] = ok ? lfb[t0 + tid] : 0.f;
      s_li[tid] = ok ? lib[t0 + tid] : NEG_BIG;
    }
    __syncthreads();
    if (tid == 0) {
      float bc = 0.f, cm = -INFINITY;
      for (int j = 0; j < L; ++j) {
        bc += s_lf[j];
        const float a = s_li[j] - bc;
        cm = fmaxf(cm, a);
        const float g = fmaxf(m0, cm);
        s_a[j] = a;
        s_g[j] = g;
        s_decay[j] = expf(m0 - g);
        s_minv[j] = expf(-(bc + g));
      }
      const float g_last = s_g[L - 1];
      for (int j = 0; j < LMAX; ++j)
        s_w[j] = j < L ? expf(s_a[j] - g_last) : 0.f;
      s_scalars[0] = expf(m0 - g_last);
      m0 = bc + g_last;
    }

    // ---- 2. S = q k^T and q C0 over D ------------------------------------
    float acc_s[8][8], acc_c[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc_s[i][j] = acc_c[i][j] = 0.f;
    float qn = 0.f;  // q_tid . n0, for tid < LMAX
    for (int d0 = 0; d0 < D; d0 += DK) {
      const int d = d0 + lane;
#pragma unroll 4
      for (int p = 0; p < LMAX / 8; ++p) {
        const int r = warp + 8 * p;
        const bool ok = r < L && t0 + r < S && d < D;
        const size_t off = static_cast<size_t>(t0 + r) * D + d;
        qt[lane * LP + r] = ok ? to_f(qb[off]) : 0.f;
        kt[lane * LP + r] = ok ? to_f(kb[off]) : 0.f;
      }
#pragma unroll 4
      for (int p = 0; p < DK * E / THREADS; ++p) {
        const int idx = tid + THREADS * p;
        const int kr = idx / E, e = idx % E;
        const bool ok = !first && d0 + kr < D && e0 + e < D;
        cs[idx] = ok ? Cb[static_cast<size_t>(d0 + kr) * D + e0 + e] : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < DK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(
            qt + kk * LP + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(
            qt + kk * LP + 64 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(
            kt + kk * LP + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(
            kt + kk * LP + 64 + tx * 4);
        const float4 c0 = *reinterpret_cast<const float4*>(
            cs + kk * E + tx * 4);
        const float4 c1 = *reinterpret_cast<const float4*>(
            cs + kk * E + 64 + tx * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc_s[i][j] += a[i] * b[j];
            acc_c[i][j] += a[i] * c[j];
          }
      }
      if (tid < LMAX) {
        const int kmax = min(DK, D - d0);
        for (int kk = 0; kk < kmax; ++kk)
          qn += qt[kk * LP + tid] * ns[d0 + kk];
      }
      __syncthreads();
    }

    // ---- 3. S . D (causal, decayed) into shared memory; v's tile ---------
    if (tid < LMAX) s_qn[tid] = qn * scale;
    {
      float part[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j = row_of(ty, i);
        const float gj = s_g[j];
        part[i] = 0.f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int s = row_of(tx, jj);
          float val = 0.f;
          if (s <= j && j < L) val = acc_s[i][jj] * scale * expf(s_a[s] - gj);
          sdt[s * LP + j] = val;
          part[i] += val;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float x = part[i];
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        if (tx == 0) s_row[row_of(ty, i)] = x;
      }
    }
#pragma unroll 4
    for (int p = 0; p < LMAX * E / THREADS; ++p) {
      const int idx = tid + THREADS * p;
      const int r = idx / E, e = idx % E;
      const bool ok = r < L && t0 + r < S && e0 + e < D;
      vs[idx] = ok ? to_f(vb[static_cast<size_t>(t0 + r) * D + e0 + e]) : 0.f;
    }
    __syncthreads();

    // ---- 4. h = (decay0 q C0 + (S . D) v) / den --------------------------
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dj = s_decay[row_of(ty, i)] * scale;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc_c[i][j] *= dj;
    }
    for (int s = 0; s < L; ++s) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(sdt + s * LP + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(
          sdt + s * LP + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(vs + s * E + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(
          vs + s * E + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc_c[i][j] += a[i] * b[j];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = row_of(ty, i);
      if (j >= L || t0 + j >= S) continue;
      const float den =
          fmaxf(fabsf(s_decay[j] * s_qn[j] + s_row[j]), s_minv[j]);
      T* orow = ob + static_cast<size_t>(t0 + j) * D + e0;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int e = row_of(tx, jj);
        if (e0 + e < D) orow[e] = from_f<T>(acc_c[i][jj] / den);
      }
    }

    // ---- 5. C = scale_c C0 + (w k)^T v and n, 64 rows of D at a time -----
    const float scale_c = s_scalars[0];
    for (int dt0 = 0; dt0 < D; dt0 += DT) {
#pragma unroll 4
      for (int p = 0; p < LMAX * DT / THREADS; ++p) {
        const int idx = tid + THREADS * p;
        const int r = idx / DT, dd = idx % DT;
        const bool ok = r < L && t0 + r < S && dt0 + dd < D;
        kw[r * KP + dd] =
            ok ? s_w[r] * to_f(kb[static_cast<size_t>(t0 + r) * D + dt0 + dd])
               : 0.f;
      }
      __syncthreads();
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < L; ++s) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(kw + s * KP + ty * 4);
        const float4 b0 =
            *reinterpret_cast<const float4*>(vs + s * E + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(
            vs + s * E + 64 + tx * 4);
        const float a[4] = {a0.x, a0.y, a0.z, a0.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
      }
      if (tid < DT && dt0 + tid < D) {
        float sum = 0.f;
        for (int s = 0; s < L; ++s) sum += kw[s * KP + tid];
        ns[dt0 + tid] = scale_c * ns[dt0 + tid] + sum;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = dt0 + ty * 4 + i;
        if (d >= D) continue;
        float* crow = Cb + static_cast<size_t>(d) * D + e0;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int e = row_of(tx, jj);
          if (e0 + e >= D) continue;
          crow[e] = first ? acc[i][jj] : scale_c * crow[e] + acc[i][jj];
        }
      }
      __syncthreads();
    }
  }
  if (blockIdx.y == 0) {
    for (int d = tid; d < D; d += THREADS)
      n_out[static_cast<size_t>(bh) * D + d] = ns[d];
    if (tid == 0) m_out[bh] = m0;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* log_f,
           const float* log_i, void* out, float* C, float* n, float* m,
           int BH, int S, int D, int L, cudaStream_t stream) {
  const size_t smem = Smem::bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunkwise_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(BH, (D + E - 1) / E);
  mlstm_chunkwise_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), log_f, log_i, static_cast<T*>(out), C, n, m,
      S, D, L, rsqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mlstm
}  // namespace repro

// q, k, v, out (B*H, S, D) in `dtype`; log_f, log_i (B*H, S) f32; C (B*H, D,
// D), n (B*H, D), m (B*H) f32, written with the state after S steps (C
// needs no zeroing).  1 <= L <= 128.  Returns cudaGetLastError() after the
// launch.
extern "C" int mlstm_chunkwise_launch(const void* q, const void* k,
                                      const void* v, const void* log_f,
                                      const void* log_i, void* out, void* C,
                                      void* n, void* m, int BH, int S, int D,
                                      int L, int dtype, void* stream) {
  if (L < 1 || L > repro::mlstm::LMAX || S < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(log_f);
  const float* li = static_cast<const float*>(log_i);
  float* c = static_cast<float*>(C);
  float* nn = static_cast<float*>(n);
  float* mm = static_cast<float*>(m);
  switch (dtype) {
    case repro::kF32:
      return repro::mlstm::launch<float>(q, k, v, lf, li, out, c, nn, mm, BH,
                                         S, D, L, s);
    case repro::kBF16:
      return repro::mlstm::launch<__nv_bfloat16>(q, k, v, lf, li, out, c, nn,
                                                 mm, BH, S, D, L, s);
    case repro::kF16:
      return repro::mlstm::launch<__half>(q, k, v, lf, li, out, c, nn, mm, BH,
                                          S, D, L, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
