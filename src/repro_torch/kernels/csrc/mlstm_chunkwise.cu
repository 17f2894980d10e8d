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
// Two routes (the wrapper picks one, kernels/mlstm.py `_route`):
//
// Route simt (f32, and what route wgmma does not take).  The TPU kernel
// keeps C (D x D f32) in VMEM across a sequential chunk axis; at xLSTM's
// head dim D = 1024 that is 4 MB per (batch, head), and a block here has at
// most 227 KB of shared memory.  So C is split by value columns: one block
// owns E = 128 columns of one (batch, head) and walks the chunks in order.
// h[:, e] needs only C[:, e] and v[:, e], so the column tiles are
// independent.  The block's C tile (D x 128 f32) lives in the f32 state
// tensor the wrapper allocates: the block reads it and writes it once a
// chunk.  What every column block of a (batch, head) needs over the full D
// -- S = q k^T, its decayed row sums and q.n0 -- each block computes
// itself.  n (D f32) and m are the same in every column block; each keeps
// its own copy and column block 0 writes them out.  Per chunk: the gate
// scan by one thread; S = q k^T and q C0 over D in 32-deep slices; S . D
// into shared memory with its row sums; h = (decay0 q C0 + (S . D) v) /
// den; C and n updated 64 rows of D at a time.  All arithmetic is f32 on
// the CUDA cores, register-tiled 8 x 8 a thread.
//
// Route wgmma (bf16/f16 q, k, v, D % 64 == 0, chunks of 128 steps,
// 16-byte-aligned bases): the work split by what depends on the state.
// The stabilizer chain (b, a, g, m and every chunk's m0) depends only on
// the gates, S . D only on q, k and the gates; only C and n carry state.
//   gates_kernel   one block a (batch, head): each chunk's cumsum and
//                  cummax as warp shuffle scans, the m0 chain over the
//                  chunks by one thread, then per step g, decay0, minv and
//                  w = exp(a - g_L), per chunk exp(m0 - g_L); the final m.
//   intra_kernel   one block a (batch * head, chunk): S = q k^T once, on
//                  wgmma from TMA'd q and k; S . D in registers; its f32
//                  row sums and S . D in hi + lo halves to a scratch.
//   state_kernel   one block a (128 x 128 tile of C, batch * head): the
//                  tile is the f32 wgmma accumulator for the whole walk
//                  over the chunks; each chunk it is handed to the output
//                  pass as C_k (hi + lo, TMA stores), scaled by exp(m0 -
//                  g_L), and C += (w k)^T v, A MN-major from k's TMA'd
//                  boxes rewritten as hi / lo of w k; n beside it in f32.
//   output_kernel  one block a (128 value columns, chunk, batch * head):
//                  h = (decay0 q C_k + (S . D) v) / den on wgmma, q . n_k
//                  on the CUDA cores.
// Precision: in every product one side is exact in the 16-bit type (q, k
// or v) and the other (w k, S . D, C_k) is f32; that side is split into
// hi = round(x) and lo = round(x - hi) and the product made as two wgmma
// into one f32 accumulator, which keeps ~16 mantissa bits (the state is
// held to 1e-5 of its largest entry; TF32's 10 bits, or hi alone, miss
// it).  The decay of C is applied to the f32 accumulator itself.  Scratch
// comes from the wrapper; the largest is C_k of every chunk but the first,
// in hi + lo: B*H*(S/128 - 1)*D^2*4 bytes (1.0 GB at the xLSTM prefill
// shape), written once and read once.
//
// What bounds it on an H100: operations.  At the xLSTM prefill shape (B 4,
// H 4, S 2048, D 1024, chunk 128) the function is 141.8 GFLOP, counting the
// causal (query, key) pairs only and no q C0 on the first chunk (0.143 ms at
// the 989 TFLOP/s of bf16 tensor cores; 2.1 ms at the 67 TFLOP/s of f32 on
// CUDA cores), and moves 333 MB (0.099 ms).  Route simt, on the CUDA cores
// with S recomputed by each of the D / 128 column blocks, took 10.3 ms;
// route wgmma does twice the function's products (the hi / lo halves)
// on the tensor cores plus ~2 GB of C_k traffic (~0.6 ms of bytes).
//
// The backward (mlstm_bwd, below) recomputes the forward's chunk states
// with these same kernels: asked for it, route simt also writes its gate
// scratch and every chunk's C_k and n_k (f32), and route wgmma runs its
// gate and state passes alone.
#include <math.h>

#include "hopper.cuh"

namespace repro {

// What both routes hand the backward.  Gate scratch, f32 [BH][SLOTS][Sp],
// Sp = nc * L: per step a = log i - b, g, w = exp(a - g_L), decay0 =
// exp(m0 - g), minv = exp(-(b + g)).  Chunk scratch, f32 [BH][3][nc]:
// scale_c = exp(m0 - g_L), m0, g_L (route simt writes scale_c only).  C_k
// and n_k, the state entering chunk k, of every chunk but the first: slot
// bh * (nc - 1) + k - 1 of [BH * (nc - 1)][D][D] and [BH * (nc - 1)][D]
// (route wgmma: C_k as hi and lo halves in T, two such arrays).
enum { kA = 0, kG = 1, kW = 2, kDecay = 3, kMinv = 4, SLOTS = 5 };
enum { kScale = 0, kM0 = 1, kGL = 2 };

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
                           float* __restrict__ m_out,
                           float* __restrict__ gates,
                           float* __restrict__ chunks,
                           float* __restrict__ ck, float* __restrict__ nk,
                           int S, int D, int L, float scale) {
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
  const size_t Sp = static_cast<size_t>(n_chunks) * L;
  const bool keep = ck != nullptr;  // the backward's recompute
  for (int ic = 0; ic < n_chunks; ++ic) {
    const int t0 = ic * L;
    const bool first = ic == 0;
    // The state entering the chunk is read from Cr and the state after it
    // written to Cw: both C, or (keep) C_ic's slot and C_{ic+1}'s, the
    // last to C.
    const size_t slot = static_cast<size_t>(bh) * (n_chunks - 1);
    const float* Cr =
        keep && !first ? ck + (slot + ic - 1) * D * D : Cb;
    float* Cw = keep && ic + 1 < n_chunks ? ck + (slot + ic) * D * D : Cb;
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
        cs[idx] = ok ? Cr[static_cast<size_t>(d0 + kr) * D + e0 + e] : 0.f;
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
    if (keep && blockIdx.y == 0 && tid < L) {
      float* gb = gates + bh * SLOTS * Sp + t0 + tid;
      gb[kA * Sp] = s_a[tid];
      gb[kG * Sp] = s_g[tid];
      gb[kW * Sp] = s_w[tid];
      gb[kDecay * Sp] = s_decay[tid];
      gb[kMinv * Sp] = s_minv[tid];
      if (tid == 0)
        chunks[static_cast<size_t>(bh) * 3 * n_chunks + kScale * n_chunks +
               ic] = s_scalars[0];
    }
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
        if (keep && blockIdx.y == 0 && ic + 1 < n_chunks)
          nk[(slot + ic) * D + dt0 + tid] = ns[dt0 + tid];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = dt0 + ty * 4 + i;
        if (d >= D) continue;
        const float* rrow = Cr + static_cast<size_t>(d) * D + e0;
        float* wrow = Cw + static_cast<size_t>(d) * D + e0;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int e = row_of(tx, jj);
          if (e0 + e >= D) continue;
          wrow[e] = first ? acc[i][jj] : scale_c * rrow[e] + acc[i][jj];
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
           float* gates, float* chunks, float* ck, float* nk, int BH, int S,
           int D, int L, cudaStream_t stream) {
  const size_t smem = Smem::bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunkwise_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(BH, (D + E - 1) / E);
  mlstm_chunkwise_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), log_f, log_i, static_cast<T*>(out), C, n, m,
      gates, chunks, ck, nk, S, D, L, rsqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mlstm

// ===========================================================================
// Route wgmma: bf16/f16 q, k, v, D a multiple of 64, chunks of 128 steps,
// 16-byte-aligned bases.  Four launches, split by what depends on the
// state (see the header):
//   gates_kernel   the gate scans and the stabilizer chain (CUDA cores);
//   intra_kernel   S . D and its row sums, once per (batch * head, chunk);
//   state_kernel   the C chain, a 128 x 128 tile of C a block;
//   output_kernel  h, a (batch * head, chunk, 128 value columns) a block.
// ===========================================================================
namespace mlstm_wg {

constexpr int L = 128;          // steps a chunk
constexpr int THREADS = 384;    // a producer warpgroup, two consumer ones
constexpr int BOX = 128 * 128;  // bytes of a 128-row box of 64 16-bit columns
constexpr int HALF = 64 * 128;  // bytes of a 64-row one
constexpr int GATE_WARPS = 16;
constexpr float NEG_BIG = -1e30f;
// Planted faults of chip_smoke.py's controls (a bit mask, 0 on every real
// call; must match repro_torch.kernels.ref.PLANT_*): the lo half of the
// state update dropped; the outputs of chunk nc / 2 reading the C of the
// chunk before (when nc / 2 >= 2); that chunk's S . D row sums dropped;
// the outputs reading C_k's hi half only.
enum { kPlantLo = 1, kPlantLate = 2, kPlantRowsum = 4, kPlantCkHi = 8 };

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// x0, x1 rounded to T (hi) and what that rounding lost, rounded to T again
// (lo); each pair packed into 32 bits, x0 in the low half.  hi + lo keeps
// ~16 of f32's 24 mantissa bits (bf16), the f32 side of a product whose
// other side is exact in T.
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo);
template <>
__device__ __forceinline__ void split2<__nv_bfloat16>(float x0, float x1,
                                                      uint32_t& hi,
                                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
template <>
__device__ __forceinline__ void split2<__half>(float x0, float x1,
                                               uint32_t& hi, uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x0, x1);
  const float2 hf = __half22float2(h);
  const __half2 l = __floats2half2_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <>
__device__ __forceinline__ void store2<__half>(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// ---------------------------------------------------------------- gates
// One block a (batch, head).  Warp w takes chunks w, w + 16, ...; lane l
// takes steps 4 l .. 4 l + 3 of a chunk, and the cumsum and cummax across
// lanes are shuffle scans of the lane totals.  Steps past S read log f 0
// and log i -1e30, the reference's padding.
__global__ void __launch_bounds__(32 * GATE_WARPS)
    gates_kernel(const float* __restrict__ log_f,
                 const float* __restrict__ log_i, float* __restrict__ gates,
                 float* __restrict__ chunks, float* __restrict__ m_out, int S,
                 int nc) {
  const int bh = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t Sp = static_cast<size_t>(nc) * L;
  float* gt = gates + bh * SLOTS * Sp;
  float* ch = chunks + static_cast<size_t>(bh) * 3 * nc;
  const float* lf = log_f + static_cast<size_t>(bh) * S;
  const float* li = log_i + static_cast<size_t>(bh) * S;
  // 1. b = cumsum(log f), a = log i - b, cm = cummax(a) within each chunk;
  //    b goes to the minv slot, cm to the g slot until step 3.
  for (int c = warp; c < nc; c += GATE_WARPS) {
    const int t = c * L + 4 * lane;
    float b[4], a[4], cm[4];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      run += t + i < S ? lf[t + i] : 0.f;
      b[i] = run;
    }
    float x = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    float pre = __shfl_up_sync(0xffffffffu, x, 1);
    if (lane == 0) pre = 0.f;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[i] += pre;
      a[i] = (t + i < S ? li[t + i] : NEG_BIG) - b[i];
      mx = fmaxf(mx, a[i]);
      cm[i] = mx;
    }
    float y = mx;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float z = __shfl_up_sync(0xffffffffu, y, o);
      if (lane >= o) y = fmaxf(y, z);
    }
    float pm = __shfl_up_sync(0xffffffffu, y, 1);
    if (lane == 0) pm = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      gt[kA * Sp + t + i] = a[i];
      gt[kG * Sp + t + i] = fmaxf(cm[i], pm);
      gt[kMinv * Sp + t + i] = b[i];
    }
    if (lane == 31) {  // b and cm at the chunk's last step, for the chain
      ch[kScale * nc + c] = b[3];
      ch[kGL * nc + c] = fmaxf(cm[3], pm);
    }
  }
  __syncthreads();
  // 2. The stabilizer chain: g_L = max(m0, cm_L), m0 of the next chunk =
  //    b_L + g_L, from m0 = 0; the last is the state's m.
  if (threadIdx.x == 0) {
    float m = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float gl = fmaxf(m, ch[kGL * nc + c]);
      const float bl = ch[kScale * nc + c];
      ch[kScale * nc + c] = expf(m - gl);
      ch[kM0 * nc + c] = m;
      ch[kGL * nc + c] = gl;
      m = bl + gl;
    }
    m_out[bh] = m;
  }
  __syncthreads();
  // 3. Per step: g = max(m0, cm), decay0, minv and w.
  for (int c = warp; c < nc; c += GATE_WARPS) {
    const float m0 = ch[kM0 * nc + c], gl = ch[kGL * nc + c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t t = static_cast<size_t>(c) * L + 4 * lane + i;
      const float g = fmaxf(m0, gt[kG * Sp + t]);
      const float b = gt[kMinv * Sp + t];
      gt[kG * Sp + t] = g;
      gt[kDecay * Sp + t] = expf(m0 - g);
      gt[kMinv * Sp + t] = expf(-(b + g));
      gt[kW * Sp + t] = expf(gt[kA * Sp + t] - gl);
    }
  }
}

// ---------------------------------------------------------------- S . D
struct Intra {
  static constexpr int STAGES = 4;
  static constexpr int STAGE_BYTES = 2 * BOX;  // q and k: 64 columns x 128
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

// One block a (batch * head, chunk): S = q k^T on wgmma (q and k K-major
// 128-step boxes, 64 columns of D a stage; each consumer 64 query rows),
// then in registers (S . D)[j][s] = S[j][s] * scale * exp(a_s - g_j) for
// s <= j, else 0; its f32 row sums to rowsum [BH * nc][128], and it split
// into hi + lo in T to sd [2][BH * nc][128][128].
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    intra_kernel(__grid_constant__ const CUtensorMap tmQ,
                 __grid_constant__ const CUtensorMap tmK,
                 const float* __restrict__ gates, T* __restrict__ sd,
                 float* __restrict__ rowsum, int D, int nc, int BH,
                 float scale) {
  using F = Intra;
  constexpr int STAGES = F::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + STAGES * F::STAGE_BYTES);
  // bars[s]: stage s is full; bars[STAGES + s]: stage s is free (one
  // arrival per consumer).
  const int blk = blockIdx.x, bh = blk / nc, t0 = (blk % nc) * L;
  const int nk = D / 64;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);
      mbar_init(smem_u32(&bars[STAGES + s]), 2);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 128) {  // the producer
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES)
          mbar_wait(smem_u32(&bars[STAGES + s]), (kt / STAGES - 1) & 1);
        const uint32_t full = smem_u32(&bars[s]);
        mbar_expect_tx(full, F::STAGE_BYTES);
        const uint32_t sq = smem_u32(smem + s * F::STAGE_BYTES);
        tma_load(sq, &tmQ, kt * 64, t0, bh, full);
        tma_load(sq + BOX, &tmK, kt * 64, t0, bh, full);
      }
    }
    return;
  }
  const int c = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(smem_u32(&bars[s]), (kt / STAGES) & 1);
    const uint32_t sq = smem_u32(smem + s * F::STAGE_BYTES), sk = sq + BOX;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0, T>(acc, smem_desc(sq + c * HALF + kk * 32, 16, 1024),
                        smem_desc(sk + kk * 32, 16, 1024), 1);
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();
    fence_acc(acc);
    if (kt > 0 && t == 0)
      mbar_arrive(smem_u32(&bars[STAGES + (kt - 1) % STAGES]));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Accumulator: rows j0 = 64 c + 16 w + lane / 4 and j0 + 8; register
  // 4 jj + 2 h + e is column (step) 8 jj + 2 (lane % 4) + e.
  const size_t Sp = static_cast<size_t>(nc) * L;
  const float* gb = gates + bh * SLOTS * Sp;
  const int j0 = c * 64 + w * 16 + g, j1 = j0 + 8;
  const float g0 = gb[kG * Sp + t0 + j0], g1 = gb[kG * Sp + t0 + j1];
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = 8 * jj + 2 * tq + e;
      const float as = gb[kA * Sp + t0 + s];
      const float v0 = s <= j0 ? acc[4 * jj + e] * scale * expf(as - g0) : 0.f;
      const float v1 =
          s <= j1 ? acc[4 * jj + 2 + e] * scale * expf(as - g1) : 0.f;
      acc[4 * jj + e] = v0;
      acc[4 * jj + 2 + e] = v1;
      rs0 += v0;
      rs1 += v1;
    }
  rs0 = quad_sum(rs0);
  rs1 = quad_sum(rs1);
  if (tq == 0) {
    rowsum[static_cast<size_t>(blk) * L + j0] = rs0;
    rowsum[static_cast<size_t>(blk) * L + j1] = rs1;
  }
  T* hi = sd + static_cast<size_t>(blk) * L * L;
  T* lo = hi + static_cast<size_t>(BH) * nc * L * L;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const int col = 8 * jj + 2 * tq;
    uint32_t h, l;
    split2<T>(acc[4 * jj], acc[4 * jj + 1], h, l);
    *reinterpret_cast<uint32_t*>(hi + j0 * L + col) = h;
    *reinterpret_cast<uint32_t*>(lo + j0 * L + col) = l;
    split2<T>(acc[4 * jj + 2], acc[4 * jj + 3], h, l);
    *reinterpret_cast<uint32_t*>(hi + j1 * L + col) = h;
    *reinterpret_cast<uint32_t*>(lo + j1 * L + col) = l;
  }
}

// ---------------------------------------------------------------- state
struct State {
  // A ring of half-chunk stages (64 steps): k (two 64-column boxes,
  // rewritten in place as hi), lo (two), v (two), 8 KB a box.
  static constexpr int STAGES = 3;
  static constexpr int STAGE_BYTES = 6 * HALF;
  // C_k for the TMA store: [consumer][hi, lo][2 boxes of 64 x 64].
  static constexpr int OUT_BYTES = 2 * 2 * 2 * HALF;
  // n's column partials: [consumer][chunk parity][16 row groups][64] f32.
  static constexpr int RED_BYTES = 2 * 2 * 16 * 64 * 4;
  static constexpr int SMEM = STAGES * STAGE_BYTES + OUT_BYTES + RED_BYTES +
                              1024 + 2 * STAGES * 8;
};

// One block a (128 x 128 tile of C, batch * head), walking the chunks in
// order with the tile as the f32 wgmma accumulator in registers (each
// consumer 64 rows of D), in half-chunk stages of 64 steps (a ring of 3,
// so TMA runs a chunk ahead).  Per half-chunk the consumer rewrites its k
// box (64 steps x 64 rows of D) in place as hi(w_s k_s) and writes
// lo(w_s k_s) beside it (elementwise, so the swizzled layout is kept),
// fence.proxy.async, warpgroup sync, and issues C += (w k)^T v: A MN-major
// from the k boxes (hi, then lo), B = v MN-major (the transpose-B form),
// 8 wgmma m64n128k16.  The rewrite of a half-chunk overlaps the products
// of the one before.  At each chunk boundary it waits for the products,
// rounds the tile into hi + lo boxes of shared memory (swizzled) and hands
// them to the output pass as C_i with TMA stores (ck slot i - 1), then
// scales the tile by exp(m0 - g_L).  The column block at e = 0 also
// carries n (its 64 rows a consumer, f32 on the CUDA cores from the
// unrounded w k) and stores n_i beside C_i.  The final C and n are written
// in f32.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    state_kernel(__grid_constant__ const CUtensorMap tmK,
                 __grid_constant__ const CUtensorMap tmV,
                 __grid_constant__ const CUtensorMap tmC,
                 const float* __restrict__ gates,
                 const float* __restrict__ chunks, float* __restrict__ nk,
                 float* __restrict__ C, float* __restrict__ n_out, int D,
                 int nc, int BH, int plant) {
  using F = State;
  constexpr int STAGES = F::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* obuf = smem + STAGES * F::STAGE_BYTES;
  float* red = reinterpret_cast<float*>(obuf + F::OUT_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      obuf + F::OUT_BYTES + F::RED_BYTES);
  const int tiles = (D + 127) / 128;
  const int bh = blockIdx.y;
  const int d0 = (blockIdx.x / tiles) * 128, e0 = (blockIdx.x % tiles) * 128;
  const int nh = 2 * nc;  // half-chunks
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);
      mbar_init(smem_u32(&bars[STAGES + s]), 2);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 128) {  // the producer
    if (threadIdx.x == 0) {
      for (int hs = 0; hs < nh; ++hs) {
        const int s = hs % STAGES;
        if (hs >= STAGES)
          mbar_wait(smem_u32(&bars[STAGES + s]), (hs / STAGES - 1) & 1);
        const uint32_t full = smem_u32(&bars[s]);
        mbar_expect_tx(full, 4 * HALF);
        const uint32_t sb = smem_u32(smem + s * F::STAGE_BYTES);
        const int row = hs * 64;
        tma_load(sb, &tmK, d0, row, bh, full);
        tma_load(sb + HALF, &tmK, d0 + 64, row, bh, full);
        tma_load(sb + 4 * HALF, &tmV, e0, row, bh, full);
        tma_load(sb + 5 * HALF, &tmV, e0 + 64, row, bh, full);
      }
    }
    return;
  }
  const int c = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const size_t Sp = static_cast<size_t>(nc) * L;
  const float* wv = gates + bh * SLOTS * Sp + kW * Sp;
  const float* sc = chunks + static_cast<size_t>(bh) * 3 * nc + kScale * nc;
  const bool do_n = e0 == 0;
  // Thread t rewrites rows (steps) t / 8 + 16 ii of its consumer's box, the
  // 16-byte chunk t % 8 of each: under the 128-byte swizzle, columns
  // 8 lc .. 8 lc + 7 of the box for all four rows.
  const int lc = (t % 8) ^ ((t / 8) % 8);
  const int nd = d0 + c * 64 + t;  // the row of n thread t < 64 carries
  float nv = 0.f;
  float* nkb = nk + static_cast<size_t>(bh) * (nc - 1) * D;
  unsigned char* ob = obuf + c * 4 * HALF;  // hi boxes, then lo boxes
  const int orow = w * 16 + g;  // this thread's rows of the consumer's 64
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float part[8];
  // w of this thread's four steps, a half-chunk ahead.
  float wnext[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) wnext[ii] = wv[t / 8 + 16 * ii];
  for (int hs = 0; hs < nh; ++hs) {
    const int s = hs % STAGES, i = hs / 2, half = hs % 2;
    float wcur[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      wcur[ii] = wnext[ii];
      if (hs + 1 < nh)
        wnext[ii] = wv[static_cast<size_t>(hs + 1) * 64 + t / 8 + 16 * ii];
    }
    mbar_wait(smem_u32(&bars[s]), (hs / STAGES) & 1);
    unsigned char* kb = smem + s * F::STAGE_BYTES + c * HALF;
    unsigned char* lb = kb + 2 * HALF;
    if (half == 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e) part[e] = 0.f;
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = t / 8 + 16 * ii;
      const float wr = wcur[ii];
      const int off = r * 128 + (t % 8) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(kb + off);
      const T* x = reinterpret_cast<const T*>(&raw);
      uint32_t hv[4], lv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p0 = to_f(x[2 * e]) * wr, p1 = to_f(x[2 * e + 1]) * wr;
        part[2 * e] += p0;
        part[2 * e + 1] += p1;
        split2<T>(p0, p1, hv[e], lv[e]);
        if (plant & kPlantLo) lv[e] = 0u;
      }
      *reinterpret_cast<uint4*>(kb + off) =
          make_uint4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<uint4*>(lb + off) =
          make_uint4(lv[0], lv[1], lv[2], lv[3]);
    }
    float* rb = red + (c * 2 + (i & 1)) * 16 * 64;
    if (do_n && half == 1) {
#pragma unroll
      for (int e = 0; e < 8; ++e) rb[(t / 8) * 64 + lc * 8 + e] = part[e];
    }
    fence_proxy_async();
    named_sync(1 + c, 128);
    if (half == 0 && i > 0) {
      // Chunk i - 1's products are done: free its last stage, hand C_i to
      // the output pass, decay the tile.
      wgmma_wait<0>();
      fence_acc(acc);
      if (t == 0) {
        mbar_arrive(smem_u32(&bars[STAGES + (hs - 1) % STAGES]));
        bulk_wait_read();  // the last chunk's C_k stores have read ob
      }
      named_sync(1 + c, 128);
      // Column 8 jj + 2 tq of row r goes to box jj / 8, 16-byte chunk
      // (jj % 8) ^ (r % 8) of the row.
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = orow + 8 * h;
          const int o = (jj / 8) * HALF + r * 128 + ((jj % 8) ^ (r % 8)) * 16 +
                        4 * tq;
          uint32_t hv, lv;
          split2<T>(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1], hv, lv);
          *reinterpret_cast<uint32_t*>(ob + o) = hv;
          *reinterpret_cast<uint32_t*>(ob + 2 * HALF + o) = lv;
        }
      fence_proxy_async();
      named_sync(1 + c, 128);
      if (t == 0) {
        const int slab = bh * (nc - 1) + i - 1, lo = BH * (nc - 1);
        const uint32_t o0 = smem_u32(ob);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          tma_store(&tmC, o0 + u * HALF, e0 + 64 * u, d0 + c * 64, slab);
          tma_store(&tmC, o0 + (2 + u) * HALF, e0 + 64 * u, d0 + c * 64,
                    slab + lo);
        }
        bulk_commit();
      }
      const float f = sc[i];
#pragma unroll
      for (int x = 0; x < 64; ++x) acc[x] *= f;
      if (do_n && t < 64 && nd < D)
        nkb[static_cast<size_t>(i - 1) * D + nd] = nv;
    }
    if (do_n && half == 1 && t < 64) {
      float colsum = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) colsum += rb[r * 64 + t];
      nv = sc[i] * nv + colsum;
    }
    const uint32_t ka = smem_u32(kb), la = smem_u32(lb);
    const uint32_t vb = smem_u32(smem + s * F::STAGE_BYTES + 4 * HALF);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // A = (w k)^T, MN-major: 16 steps = 2048 bytes a k16 step (one
      // 64-column box, so LBO is unused); B = v, MN-major, its two
      // 64-column boxes HALF bytes apart.
      wgmma_ss<1, 1, T>(acc, smem_desc(ka + kk * 2048, HALF, 1024),
                        smem_desc(vb + kk * 2048, HALF, 1024), 1);
      wgmma_ss<1, 1, T>(acc, smem_desc(la + kk * 2048, HALF, 1024),
                        smem_desc(vb + kk * 2048, HALF, 1024), 1);
    }
    wgmma_commit();
    if (half == 1) {
      // The chunk's first half has retired: free its stage.
      fence_acc(acc);
      wgmma_wait<1>();
      fence_acc(acc);
      if (t == 0) mbar_arrive(smem_u32(&bars[STAGES + (hs - 1) % STAGES]));
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  const int row0 = d0 + c * 64 + orow, col0 = e0 + 2 * tq;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const int col = col0 + 8 * jj;
    if (col >= D) continue;  // D is a multiple of 64: col + 1 < D too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < D)
        *reinterpret_cast<float2*>(
            C + (static_cast<size_t>(bh) * D + row) * D + col) =
            make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
    }
  }
  if (do_n && t < 64 && nd < D) n_out[static_cast<size_t>(bh) * D + nd] = nv;
  if (t == 0) bulk_wait();  // the C_k stores have landed
}

// ---------------------------------------------------------------- output
struct Out {
  static constexpr int STAGES = 4;
  static constexpr int STAGE_BYTES = 3 * BOX;  // three 16 KB operand slots
  static constexpr int SMEM =
      STAGES * STAGE_BYTES + L * 4 + 1024 + 2 * STAGES * 8;
};

// One block a (128 value columns, chunk, batch * head), each consumer 64
// of the chunk's rows:
//   phase 1 (chunk > 0), D / 64 stages of {q (K-major, 64 columns of D),
//     C hi, C lo (MN-major, 64 rows of D x 128 columns)}: acc = q C_k as
//     two wgmma a k16 step, and q . n_k beside it on the CUDA cores (n_k
//     f32 from the state pass);
//   then acc *= decay0_j * scale, row by row;
//   phase 2, 2 stages of {S . D hi (K-major, 64 steps), v (MN-major, 64
//     steps x 128 columns), S . D lo}: acc += (S . D) v;
//   h = acc / max(|decay0_j scale q_j . n_k + rowsum_j|, exp(-m_j)),
//   stored for rows < S.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    output_kernel(__grid_constant__ const CUtensorMap tmQ,
                  __grid_constant__ const CUtensorMap tmC,
                  __grid_constant__ const CUtensorMap tmSD,
                  __grid_constant__ const CUtensorMap tmV,
                  const float* __restrict__ gates,
                  const float* __restrict__ rowsum,
                  const float* __restrict__ nk, T* __restrict__ out, int S,
                  int D, int nc, int BH, float scale, int plant) {
  using F = Out;
  constexpr int STAGES = F::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  float* qn_s = reinterpret_cast<float*>(smem + STAGES * F::STAGE_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(qn_s + L);
  const int ci = blockIdx.y, bh = blockIdx.z;
  const int e0 = blockIdx.x * 128, t0 = ci * L, blk = bh * nc + ci;
  const int cf = nc / 2;
  // The chunk whose C the outputs read: this one, or (planted) the one
  // before.
  const int src =
      (plant & kPlantLate) && ci == cf && cf >= 2 ? ci - 1 : ci;
  const int n1 = ci > 0 ? D / 64 : 0;  // phase 1's stages (C_0 = 0)
  const int steps = n1 + 2;
  const int c_hi = bh * (nc - 1) + src - 1, c_lo = c_hi + BH * (nc - 1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);
      mbar_init(smem_u32(&bars[STAGES + s]), 2);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 128) {  // the producer
    if (threadIdx.x == 0) {
      for (int st = 0; st < steps; ++st) {
        const int s = st % STAGES;
        if (st >= STAGES)
          mbar_wait(smem_u32(&bars[STAGES + s]), (st / STAGES - 1) & 1);
        const uint32_t full = smem_u32(&bars[s]);
        mbar_expect_tx(full, F::STAGE_BYTES);
        const uint32_t sb = smem_u32(smem + s * F::STAGE_BYTES);
        if (st < n1) {
          tma_load(sb, &tmQ, st * 64, t0, bh, full);
          tma_load(sb + BOX, &tmC, e0, st * 64, c_hi, full);
          tma_load(sb + BOX + HALF, &tmC, e0 + 64, st * 64, c_hi, full);
          tma_load(sb + 2 * BOX, &tmC, e0, st * 64, c_lo, full);
          tma_load(sb + 2 * BOX + HALF, &tmC, e0 + 64, st * 64, c_lo, full);
        } else {
          const int u = st - n1;
          tma_load(sb, &tmSD, 64 * u, 0, blk, full);
          tma_load(sb + BOX, &tmV, e0, t0 + 64 * u, bh, full);
          tma_load(sb + BOX + HALF, &tmV, e0 + 64, t0 + 64 * u, bh, full);
          tma_load(sb + 2 * BOX, &tmSD, 64 * u, 0, blk + BH * nc, full);
        }
      }
    }
    return;
  }
  const int c = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const size_t Sp = static_cast<size_t>(nc) * L;
  const float* gb = gates + bh * SLOTS * Sp;
  // q . n_k: thread t takes row qr of the chunk, logical 16-byte chunks
  // 4 (t % 2) .. + 3 of each q box.
  const int qr = c * 64 + t / 2;
  const float* nb =
      ci > 0 ? nk + (static_cast<size_t>(bh) * (nc - 1) + ci - 1) * D : nk;
  float qn = 0.f;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int j0 = c * 64 + w * 16 + g, j1 = j0 + 8;
  // Phase 1: acc = q C_k, q . n_k beside it.
  for (int st = 0; st < n1; ++st) {
    const int s = st % STAGES;
    mbar_wait(smem_u32(&bars[s]), (st / STAGES) & 1);
    const uint32_t sb = smem_u32(smem + s * F::STAGE_BYTES);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // A = q, K-major (32 bytes a k16 step); B = C_k, MN-major (16 rows =
      // 2048 bytes a step, its 64-column boxes HALF bytes apart).
      const uint64_t da = smem_desc(sb + c * HALF + kk * 32, 16, 1024);
      wgmma_ss<0, 1, T>(acc, da, smem_desc(sb + BOX + kk * 2048, HALF, 1024),
                        1);
      if (!(plant & kPlantCkHi))
        wgmma_ss<0, 1, T>(acc, da,
                          smem_desc(sb + 2 * BOX + kk * 2048, HALF, 1024), 1);
    }
    wgmma_commit();
    const unsigned char* qrow = smem + s * F::STAGE_BYTES + qr * 128;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int lq = 4 * (t % 2) + u;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(qrow + (lq ^ (qr % 8)) * 16);
      const T* x = reinterpret_cast<const T*>(&raw);
      const float4 na = *reinterpret_cast<const float4*>(nb + st * 64 + lq * 8);
      const float4 nn =
          *reinterpret_cast<const float4*>(nb + st * 64 + lq * 8 + 4);
      qn += to_f(x[0]) * na.x + to_f(x[1]) * na.y + to_f(x[2]) * na.z +
            to_f(x[3]) * na.w + to_f(x[4]) * nn.x + to_f(x[5]) * nn.y +
            to_f(x[6]) * nn.z + to_f(x[7]) * nn.w;
    }
    fence_acc(acc);
    wgmma_wait<1>();
    fence_acc(acc);
    if (st > 0 && t == 0)
      mbar_arrive(smem_u32(&bars[STAGES + (st - 1) % STAGES]));
  }
  // acc *= decay0_j * scale, row by row, between the phases: no product
  // in flight (ptxas serializes every wgmma of a loop in which other
  // instructions write the accumulator).
  wgmma_wait<0>();
  fence_acc(acc);
  if (n1 > 0) {
    const float f0 = gb[kDecay * Sp + t0 + j0] * scale;
    const float f1 = gb[kDecay * Sp + t0 + j1] * scale;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      acc[4 * jj] *= f0;
      acc[4 * jj + 1] *= f0;
      acc[4 * jj + 2] *= f1;
      acc[4 * jj + 3] *= f1;
    }
  }
  // Phase 2: acc += (S . D) v.
  for (int st = n1; st < steps; ++st) {
    const int s = st % STAGES;
    mbar_wait(smem_u32(&bars[s]), (st / STAGES) & 1);
    const uint32_t sb = smem_u32(smem + s * F::STAGE_BYTES);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // A = S . D hi and lo, K-major; B = v, MN-major.
      const uint64_t db = smem_desc(sb + BOX + kk * 2048, HALF, 1024);
      wgmma_ss<0, 1, T>(acc, smem_desc(sb + c * HALF + kk * 32, 16, 1024), db,
                        1);
      wgmma_ss<0, 1, T>(
          acc, smem_desc(sb + 2 * BOX + c * HALF + kk * 32, 16, 1024), db, 1);
    }
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();
    fence_acc(acc);
    if (st > 0 && t == 0)
      mbar_arrive(smem_u32(&bars[STAGES + (st - 1) % STAGES]));
  }
  wgmma_wait<0>();
  fence_acc(acc);
  qn += __shfl_xor_sync(0xffffffffu, qn, 1);  // t and t ^ 1 share a row
  if (t % 2 == 0) qn_s[qr] = qn;
  named_sync(1 + c, 128);
  const bool drop_rs = (plant & kPlantRowsum) && ci == cf;
  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = h ? j1 : j0;
    const size_t tp = t0 + j;
    const float rs = drop_rs ? 0.f : rowsum[static_cast<size_t>(blk) * L + j];
    den[h] = fmaxf(fabsf(gb[kDecay * Sp + tp] * scale * qn_s[j] + rs),
                   gb[kMinv * Sp + tp]);
  }
  T* ob = out + static_cast<size_t>(bh) * S * D;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const int col = e0 + 8 * jj + 2 * tq;
    if (col >= D) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tp = t0 + (h ? j1 : j0);
      if (tp < S)
        store2<T>(ob + static_cast<size_t>(tp) * D + col,
                  acc[4 * jj + 2 * h] / den[h],
                  acc[4 * jj + 2 * h + 1] / den[h]);
    }
  }
}

// ---------------------------------------------------------------- launch
template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* log_f,
           const float* log_i, void* out, float* C, float* n, float* m,
           float* gates, float* chunks, void* sd, float* rowsum, void* ck,
           float* nk, int BH, int S, int D, int plant, bool state_only,
           cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  constexpr bool f16 = std::is_same<T, __half>::value;
  const int nc = (S + L - 1) / L;
  const uint64_t seq[3] = {static_cast<uint64_t>(D),
                           static_cast<uint64_t>(S),
                           static_cast<uint64_t>(BH)};
  const uint64_t cdims[3] = {static_cast<uint64_t>(D),
                             static_cast<uint64_t>(D),
                             2ull * BH * (nc > 1 ? nc - 1 : 1)};
  const uint64_t sdims[3] = {L, L, 2ull * BH * nc};
  const uint32_t box128[3] = {64, 128, 1}, box64[3] = {64, 64, 1};
  CUtensorMap tq, tk, tk64, tv64, tc, tsd;
  if (!encode(fn, &tk64, k, f16, 3, seq, box64) ||
      !encode(fn, &tv64, v, f16, 3, seq, box64) ||
      !encode(fn, &tc, ck, f16, 3, cdims, box64) ||
      (!state_only && (!encode(fn, &tq, q, f16, 3, seq, box128) ||
                       !encode(fn, &tk, k, f16, 3, seq, box128) ||
                       !encode(fn, &tsd, sd, f16, 3, sdims, box128))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if ((err = allow_smem(intra_kernel<T>, Intra::SMEM)) ||
      (err = allow_smem(state_kernel<T>, State::SMEM)) ||
      (err = allow_smem(output_kernel<T>, Out::SMEM)))
    return static_cast<int>(err);
  const float scale = rsqrtf(static_cast<float>(D));
  T* sdp = static_cast<T*>(sd);
  gates_kernel<<<BH, 32 * GATE_WARPS, 0, stream>>>(log_f, log_i, gates,
                                                   chunks, m, S, nc);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  if (!state_only) {
    intra_kernel<T><<<BH * nc, THREADS, Intra::SMEM, stream>>>(
        tq, tk, gates, sdp, rowsum, D, nc, BH, scale);
    if ((err = cudaGetLastError())) return static_cast<int>(err);
  }
  const int tiles = (D + 127) / 128;
  state_kernel<T><<<dim3(tiles * tiles, BH), THREADS, State::SMEM, stream>>>(
      tk64, tv64, tc, gates, chunks, nk, C, n, D, nc, BH, plant);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  if (state_only) return 0;
  output_kernel<T><<<dim3(tiles, nc, BH), THREADS, Out::SMEM, stream>>>(
      tq, tc, tsd, tv64, gates, rowsum, nk, static_cast<T*>(out), S, D, nc,
      BH, scale, plant);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mlstm_wg
}  // namespace repro

// q, k, v, out (B*H, S, D) in `dtype`; log_f, log_i (B*H, S) f32; C (B*H, D,
// D), n (B*H, D), m (B*H) f32, written with the state after S steps (C
// needs no zeroing).  gates, chunks, ck, nk: null, or the backward's
// recompute, f32, nc = ceil(S / L): gates [B*H][5][nc*L], chunks
// [B*H][3][nc], ck [B*H*max(nc-1, 1)][D][D], nk [B*H*max(nc-1, 1)*D].
// 1 <= L <= 128.  Returns cudaGetLastError() after the launch.
extern "C" int mlstm_chunkwise_launch(const void* q, const void* k,
                                      const void* v, const void* log_f,
                                      const void* log_i, void* out, void* C,
                                      void* n, void* m, void* gates,
                                      void* chunks, void* ck, void* nk,
                                      int BH, int S, int D, int L, int dtype,
                                      void* stream) {
  if (L < 1 || L > repro::mlstm::LMAX || S < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(log_f);
  const float* li = static_cast<const float*>(log_i);
  float* c = static_cast<float*>(C);
  float* nn = static_cast<float*>(n);
  float* mm = static_cast<float*>(m);
  float* g = static_cast<float*>(gates);
  float* ch = static_cast<float*>(chunks);
  float* cks = static_cast<float*>(ck);
  float* nks = static_cast<float*>(nk);
  if ((cks == nullptr) != (nks == nullptr) ||
      (cks == nullptr) != (g == nullptr) || (g == nullptr) != (ch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case repro::kF32:
      return repro::mlstm::launch<float>(q, k, v, lf, li, out, c, nn, mm, g,
                                         ch, cks, nks, BH, S, D, L, s);
    case repro::kBF16:
      return repro::mlstm::launch<__nv_bfloat16>(
          q, k, v, lf, li, out, c, nn, mm, g, ch, cks, nks, BH, S, D, L, s);
    case repro::kF16:
      return repro::mlstm::launch<__half>(q, k, v, lf, li, out, c, nn, mm, g,
                                          ch, cks, nks, BH, S, D, L, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The wgmma route (bf16/f16, D % 64 == 0, chunks of 128, 16-byte-aligned
// q, k, v).  Scratch from the wrapper, nc = ceil(S / 128): gates f32
// [B*H][5][nc*128], chunks f32 [B*H][3][nc], sd (dtype) [2][B*H*nc][128]
// [128], rowsum f32 [B*H*nc*128], ck (dtype) [2][B*H*max(nc-1, 1)][D][D],
// nk f32 [B*H*max(nc-1, 1)*D].  plant: chip_smoke.py's planted faults, 0
// otherwise.  state_only: the gate and state passes alone (the backward's
// recompute; q, out, sd and rowsum are not read).  Returns
// cudaGetLastError() after the last launch.
extern "C" int mlstm_chunkwise_wgmma_launch(
    const void* q, const void* k, const void* v, const void* log_f,
    const void* log_i, void* out, void* C, void* n, void* m, void* gates,
    void* chunks, void* sd, void* rowsum, void* ck, void* nk, int BH, int S,
    int D, int dtype, int plant, int state_only, void* stream) {
  if (S < 1 || D < 64 || D % 64)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_MLSTM_WG(T)                                                   \
  repro::mlstm_wg::launch<T>(                                               \
      q, k, v, static_cast<const float*>(log_f),                            \
      static_cast<const float*>(log_i), out, static_cast<float*>(C),        \
      static_cast<float*>(n), static_cast<float*>(m),                       \
      static_cast<float*>(gates), static_cast<float*>(chunks), sd,          \
      static_cast<float*>(rowsum), ck, static_cast<float*>(nk), BH, S, D,   \
      plant, state_only != 0, static_cast<cudaStream_t>(stream))
  switch (dtype) {
    case repro::kBF16: return REPRO_MLSTM_WG(__nv_bfloat16);
    case repro::kF16: return REPRO_MLSTM_WG(__half);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_MLSTM_WG
}

// Dynamic shared memory of the wgmma route's kernels in bytes: pass 0
// (S . D), 1 (state), 2 (output).
extern "C" int mlstm_chunkwise_wgmma_smem(int pass) {
  using namespace repro::mlstm_wg;
  return pass == 0 ? Intra::SMEM : pass == 1 ? State::SMEM : Out::SMEM;
}

// ===========================================================================
// The backward, mlstm_chunkwise_bwd.  It replaces no TPU kernel (the Pallas
// kernel has no gradient; the reference differentiates its XLA chunkwise
// path, repro/backends/xla_backend.py:116): the port's own kernel, so that
// xLSTM trains on the card.  It takes q, k, v, dh (B*H, S, D) in T, the
// f32 gates, dC (B*H, D, D) and dn (B*H, D) or null (the final state's
// gradients) and the forward's recompute (see the top of the file: the
// gate scratch, C_k, n_k and the final C, n), and writes dq, dk, dv in T
// and dlog_f, dlog_i in f32.
//
// Every product P o dP is formed in the forward's stabilized frame (the
// same chunk chain of m, g and den), where the scales cancel.  Per chunk k
// of L steps, with Sd_ts = scale (q_t.k_s) exp(a_s - g_t) (s <= t), den_t =
// decay0_t scale q_t.n_k + sum_s Sd_ts, Dv_t = max(|den_t|, minv_t):
//   dnum_t = dh_t / Dv_t;  dden_t = -sign(den_t) (dh_t . num_t) / Dv_t^2
//   where |den_t| > minv_t, else 0;  G_ts = exp(a_s - g_t) scale (dnum_t .
//   v_s + dden_t);  u_t = decay0_t scale / Dv_t;  z_t = decay0_t scale dden_t
//   dq = G k + u (C_k dh) + z n_k
//   dk = G^T q + w (G_k v + gn_k),   dv = (Sd / Dv)^T dh + w (G_k^T k)
// with G_k, gn_k the gradients of the state after chunk k, walked from the
// last chunk down: G_{k-1} = sc_k G_k + sum_{t in k} u_t q_t dh_t^T (dC at
// the end), gn_{k-1} = sc_k gn_k + sum_t z_t q_t.  The row and column sums
// of P o dP are q_t.dq_t and k_s.dk_s: dlog_i = k.dk and dlog_f_j =
// sum_{t >= j} (q.dq - k.dk)_t, plus the final state's own terms: <C, dC>
// + <n, dn> up to s*, and its stabilizer m = F_{S-1} + max(0, li_s* - F_s*)
// taking it back from li_s* (ref.mlstm_chunkwise_bwd_ref is this in plain
// PyTorch over the whole (S, S) matrix).
//
// The wrapper first recomputes the forward's chunk states with the
// forward's own route (kernels/mlstm.py `_route`), then runs the backward on
// the same route.
//
// Route wgmma (bf16/f16, D % 64 == 0, chunks of 128 steps, 16-byte-aligned
// bases): the forward's gate and state passes hand over C_k in hi + lo
// halves; then four launches on the tensor cores, each 384 threads (a TMA
// producer warpgroup, two consumer warpgroups of 64 output rows), and
// final_kernel:
//   y_wg_kernel      one block a (128 columns j, chunk >= 1, batch * head):
//                    Y = dh C_k^T over D and its row dots q . Y.  A pass of
//                    its own because dden needs the whole row's q . Y
//                    before any G exists; it hands Y to the grads pass in
//                    f32 (134 MB at the training shape, written and read
//                    once: ~0.08 ms of bytes, where forming it again there
//                    would cost ~0.13 ms of tensor-core time and a C_k
//                    phase more in that kernel).
//   intra_wg_kernel  one block a (batch * head, chunk): S = q k^T and W =
//                    dh v^T (both sides exact), den, Dv, dden, u, z per step
//                    in registers, G and Sd / Dv to the grads pass in hi +
//                    lo (the simt route's intra and rows kernels in one).
//   walk_wg_kernel   one block a (128 x 128 tile of the state's gradient,
//                    batch * head): the forward's state_kernel in reverse,
//                    the tile the f32 accumulator from (dC, dn) down, A =
//                    (u q)^T rewritten from q's TMA'd boxes as hi / lo, each
//                    chunk's G_k handed over in hi + lo by TMA store, gn_k
//                    beside it in f32.
//   grads_wg_kernel  one block a (128 columns, chunk, batch * head): dq = G
//                    k + u Y + z n_k, dk = w (v G_k^T + gn_k) + G^T q, dv =
//                    w (k G_k) + (Sd / Dv)^T dh in one accumulator, in 48 KB
//                    stages of TMA'd boxes; q . dq and k . dk from the f32
//                    accumulator before the rounding to T, per column tile.
// Deterministic: every sum across blocks goes through per-tile partials
// summed in a fixed order (no atomics), so a gradient is the same bits call
// to call.  Scratch comes from the wrapper; the largest are C_k and G_k of
// every chunk in hi + lo (~1.0 GB each) and Y (f32) at the training shape.
//
// Route simt (f32, D not a multiple of 64, chunks under 128, a single
// step): the simt forward kernel writes its gates, C_k and n_k in f32;
// then six launches, all arithmetic f32 on the CUDA cores, 128 x 128 output
// tiles register-tiled 8 x 8 a thread over 32-deep slices in shared memory:
//   intra_kernel  one block a (chunk, batch * head): Sd, W = dh v^T, den
//                 and sum_s Sd W;
//   y_kernel      one block a (128 columns, chunk, batch * head): C_k dh
//                 and its partial q . (C_k dh);
//   rows_kernel   Dv, dden, u, z per step; G and Sd / Dv in place;
//   walk_kernel   one block a (128 x 128 tile of the state, batch * head):
//                 G_k and gn_k from dC, dn down (and the partials of <C,
//                 dC> + <n, dn>);
//   grads_kernel  one block a (128 columns, chunk, batch * head): dq, dk,
//                 dv and the partial row and column sums;
//   final_kernel  one block a (batch, head): s*, dlog_i and the reverse
//                 cumulative sum of dlog_f.
//
// What bounds it on an H100: operations (kernels/mlstm.py bwd_flops: 343.8
// GFLOP at B 4, H 4, S 2048, D 1024, chunk 128, 0.348 ms at 989 TFLOP/s; 5.1
// ms at the 67 TFLOP/s of f32 CUDA cores, route simt's floor).  Route wgmma
// runs them on the tensor cores at about twice the count (every product
// with an f32 side is two wgmma, its hi and lo halves: ~690 GFLOP, ~0.7 ms
// at peak) and moves ~4.4 GB of hand-offs (C_k written and read, G_k
// written and read twice, Y; ~1.3 ms at 3.35 TB/s): 2.99 ms on an H100
// (11.6 % of the bound; 2.46 GB of scratch and outputs); route simt at
// that shape 31.9 ms (PERF.md row 6b).
// ===========================================================================
namespace repro {
namespace mlstm_bwd {

constexpr int THREADS = 256;
constexpr int LMAX = 128;
constexpr int TILE = 128;       // rows and columns of a block's output tile
constexpr int KS = 32;          // depth of a slice
constexpr int LP = TILE + 4;    // pitch of a [KS][TILE] slice
// The backward's own per-step scratch, f32 [BH][RSLOTS][Sp] (the gates
// are the forward's, repro::kA .. kMinv): den, sum_s Sd W, u, z.
enum { kDen = 0, kHn, kU, kZ, RSLOTS };
// Planted faults of chip_smoke.py's controls (a bit mask, 0 on every real
// call; must match repro_torch.kernels.mlstm.BWD_PLANT_*): the reverse
// state gradient reset at chunk nc / 2; dq's inter-chunk terms dropped;
// dlog_f's reverse cumulative sum shifted by one step.
enum { kPlantReset = 1, kPlantDqInter = 2, kPlantShift = 4 };

__device__ __forceinline__ int rc(int t, int i) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

// Sum over the 16 threads of a half warp that share a row (tx).
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// dst[kk][i] (pitch LP) = element (i, k0 + kk) of an operand whose element
// (i, k) is base[i * si + k * sk], times
// kscale[k0 + kk] where given; 0 outside i < imax, k < kmax.  KFAST: k is
// the contiguous index (lane kk of each warp, rows by warp); else i is
// (consecutive threads, consecutive i).
template <typename Tin, bool KFAST>
__device__ __forceinline__ void load_slice(float* dst, const Tin* base,
                                           long si, long sk, int imax,
                                           int kmax, int k0,
                                           const float* kscale) {
  const int tid = threadIdx.x;
  if (KFAST) {
    const int kk = tid & 31, w = tid >> 5, k = k0 + kk;
    const bool kok = k < kmax;
    const float f = (kscale != nullptr && kok) ? kscale[k] : 1.f;
#pragma unroll 4
    for (int p = 0; p < TILE / 8; ++p) {
      const int i = w + 8 * p;
      dst[kk * LP + i] =
          (kok && i < imax) ? f * to_f(base[i * si + k * sk]) : 0.f;
    }
  } else {
#pragma unroll 4
    for (int p = 0; p < KS * TILE / THREADS; ++p) {
      const int idx = tid + THREADS * p;
      const int i = idx % TILE, kk = idx / TILE, k = k0 + kk;
      const bool ok = k < kmax && i < imax;
      float x = ok ? to_f(base[i * si + k * sk]) : 0.f;
      if (ok && kscale != nullptr) x *= kscale[k];
      dst[kk * LP + i] = x;
    }
  }
}

// acc[i][j] += sum_kk As[kk][rc(ty, i)] * Bs[kk][rc(tx, j)].
__device__ __forceinline__ void fma_slice(float (&acc)[8][8],
                                          const float* As, const float* Bs,
                                          int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < KS; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * LP + ty * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + kk * LP + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * LP + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + kk * LP + 64 + tx * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// acc (+)= A B over K, A's element (m, k) a[m * asi + k * ask] (m < am), B's
// element (n, k) b[n * bsi + k * bsk] (n < bn), B's
// k-th row times bscale[k] where given.  AK / BK: the operand's k is its
// contiguous index.
template <typename TA, bool AK, typename TB, bool BK>
__device__ void block_gemm(float (&acc)[8][8], float* As, float* Bs,
                           const TA* a, long asi, long ask, int am,
                           const TB* b, long bsi, long bsk, int bn, int K,
                           const float* bscale) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int k0 = 0; k0 < K; k0 += KS) {
    load_slice<TA, AK>(As, a, asi, ask, am, K, k0, nullptr);
    load_slice<TB, BK>(Bs, b, bsi, bsk, bn, K, k0, bscale);
    __syncthreads();
    fma_slice(acc, As, Bs, ty, tx);
    __syncthreads();
  }
}

// n_k of chunk c (slot bh * (nc - 1) + c - 1), or null for the first.
__device__ __forceinline__ const float* n_at(const float* nk, int bh, int c,
                                             int nc, int D) {
  return c > 0 ? nk + (static_cast<size_t>(bh) * (nc - 1) + c - 1) * D
               : nullptr;
}

// ---------------------------------------------------------------- walk
// One block a (128 x 128 tile of the state's gradient, batch * head), from
// (dC, dn) at the last chunk down to the first with the tile in registers:
// out_c[k] = G_k, the gradient of the state after chunk k, then G <- sc_k
// G + (u q)^T dh over chunk k.  The column block at e = 0 also carries gn
// (f32, 128 rows a block) with z for u.  Where dC or dn is given, first
// the block's share of <C, dC> + <n, dn> (C, n the final state) to ep.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    walk_kernel(const T* __restrict__ q, const T* __restrict__ dh,
                const float* __restrict__ rows,
                const float* __restrict__ chunks,
                const float* __restrict__ dc, const float* __restrict__ dn,
                const float* __restrict__ C, const float* __restrict__ n,
                float* __restrict__ out_c, float* __restrict__ out_n,
                float* __restrict__ ep, int S, int D, int L, int nc,
                int plant) {
  __shared__ __align__(16) float As[KS * LP];
  __shared__ __align__(16) float Bs[KS * LP];
  __shared__ float red[THREADS];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int td = (D + TILE - 1) / TILE, bh = blockIdx.y;
  const int d0 = (blockIdx.x / td) * TILE, e0 = (blockIdx.x % td) * TILE;
  const size_t Sp = static_cast<size_t>(nc) * L;
  const float* fm = rows + (static_cast<size_t>(bh) * RSLOTS + kU) * Sp;
  const float* fn = rows + (static_cast<size_t>(bh) * RSLOTS + kZ) * Sp;
  const float* sc = chunks + static_cast<size_t>(bh) * 3 * nc + kScale * nc;
  const T* qb = q + static_cast<size_t>(bh) * S * D;
  const T* yb = dh + static_cast<size_t>(bh) * S * D;
  const size_t DD = static_cast<size_t>(D) * D;
  const bool do_n = e0 == 0 && tid < TILE && d0 + tid < D;
  float acc[8][8];
  float nv = 0.f, part = 0.f;
  zero(acc);
  if (dc != nullptr) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = d0 + rc(ty, i), col = e0 + rc(tx, j);
        if (r < D && col < D) {
          const size_t at = bh * DD + static_cast<size_t>(r) * D + col;
          acc[i][j] = dc[at];
          part += dc[at] * C[at];
        }
      }
  }
  if (do_n && dn != nullptr) {
    const size_t at = static_cast<size_t>(bh) * D + d0 + tid;
    nv = dn[at];
    part += nv * n[at];
  }
  if (ep != nullptr) {
    red[tid] = part;
    __syncthreads();
    for (int o = THREADS / 2; o > 0; o >>= 1) {
      if (tid < o) red[tid] += red[tid + o];
      __syncthreads();
    }
    if (tid == 0)
      ep[static_cast<size_t>(bh) * gridDim.x + blockIdx.x] = red[0];
  }
  for (int c = nc - 1; c >= 0; --c) {
    if ((plant & kPlantReset) && c == nc / 2) {
      zero(acc);
      nv = 0.f;
    }
    float* oc = out_c + (static_cast<size_t>(bh) * nc + c) * DD;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = d0 + rc(ty, i), col = e0 + rc(tx, j);
        if (r < D && col < D) oc[static_cast<size_t>(r) * D + col] = acc[i][j];
      }
    if (do_n)
      out_n[(static_cast<size_t>(bh) * nc + c) * D + d0 + tid] = nv;
    if (c == 0) break;
    const float f = sc[c];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= f;
    nv *= f;
    const int t0 = c * L, lv = min(L, S - t0);
    for (int k0 = 0; k0 < lv; k0 += KS) {
      // A = q^T (element (d, s) = q[t0 + s][d0 + d]), B = u dh.
      load_slice<T, false>(As, qb + static_cast<size_t>(t0) * D + d0, 1, D,
                           D - d0, lv, k0, nullptr);
      load_slice<T, false>(Bs, yb + static_cast<size_t>(t0) * D + e0, 1, D,
                           D - e0, lv, k0, fm + t0);
      __syncthreads();
      if (do_n) {
        const int kmax = min(KS, lv - k0);
        float x = 0.f;
        for (int kk = 0; kk < kmax; ++kk)
          x += fn[t0 + k0 + kk] * As[kk * LP + tid];
        nv += x;
      }
      fma_slice(acc, As, Bs, ty, tx);
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------- intra
// One block a (chunk, batch * head): S = q k^T over D (with q . n_k beside
// it), Sd = S scale exp(a_s - g_t) for s <= t to sdm [L][L] and its row
// sums; then W = dh v^T to wm [L][L] and sum_s Sd_ts W_ts.  Per step: den
// = decay0 scale q . n_k + rowsum and that sum (kDen, kHn).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    intra_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dh,
                 const float* __restrict__ gates, float* __restrict__ rows,
                 const float* __restrict__ nk, float* __restrict__ sdm,
                 float* __restrict__ wm, int S, int D, int L, int nc,
                 float scale) {
  __shared__ __align__(16) float As[KS * LP];
  __shared__ __align__(16) float Bs[KS * LP];
  __shared__ float s_row[LMAX], s_hn[LMAX];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int c = blockIdx.x, bh = blockIdx.y, t0 = c * L;
  const int lv = min(L, S - t0);
  const size_t Sp = static_cast<size_t>(nc) * L;
  const float* g = gates + static_cast<size_t>(bh) * SLOTS * Sp;
  float* rw = rows + static_cast<size_t>(bh) * RSLOTS * Sp;
  const size_t seq = (static_cast<size_t>(bh) * S + t0) * D;
  const float* nb = n_at(nk, bh, c, nc, D);
  const size_t blk = (static_cast<size_t>(bh) * nc + c) * L * L;
  float acc[8][8];
  float qn = 0.f;
  zero(acc);
  for (int k0 = 0; k0 < D; k0 += KS) {
    load_slice<T, true>(As, q + seq, D, 1, lv, D, k0, nullptr);
    load_slice<T, true>(Bs, k + seq, D, 1, lv, D, k0, nullptr);
    __syncthreads();
    if (tid < LMAX && nb != nullptr) {
      const int kmax = min(KS, D - k0);
      for (int kk = 0; kk < kmax; ++kk) qn += As[kk * LP + tid] * nb[k0 + kk];
    }
    fma_slice(acc, As, Bs, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = rc(ty, i);
    const float gt = t < L ? g[kG * Sp + t0 + t] : 0.f;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = rc(tx, j);
      float val = 0.f;
      if (s <= t && t < L)
        val = acc[i][j] * scale * expf(g[kA * Sp + t0 + s] - gt);
      if (t < L && s < L) sdm[blk + t * L + s] = val;
      part += val;
    }
    part = row_sum16(part);
    if (tx == 0 && t < L) s_row[t] = part;
  }
  zero(acc);
  block_gemm<T, true, T, true>(acc, As, Bs, dh + seq, D, 1, lv, v + seq, D,
                               1, lv, D, nullptr);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = rc(ty, i);
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = rc(tx, j);
      if (t < L && s < L) {
        wm[blk + t * L + s] = acc[i][j];
        part += sdm[blk + t * L + s] * acc[i][j];
      }
    }
    part = row_sum16(part);
    if (tx == 0 && t < L) s_hn[t] = part;
  }
  __syncthreads();
  if (tid < L) {
    const size_t t = t0 + tid;
    rw[kDen * Sp + t] = g[kDecay * Sp + t] * scale * qn + s_row[tid];
    rw[kHn * Sp + t] = s_hn[tid];
  }
}

// ---------------------------------------------------------------- C_k dh
// One block a (128 columns j, chunk, batch * head): Y[t][j] = sum_e dh_t[e]
// C_k[j][e] to y [BH][Sp][D], and sum_j q_t[j] Y[t][j] to qy [tile][BH][Sp]
// (0 for the first chunk, whose C is 0).  C_k in f32.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    y_kernel(const T* __restrict__ q, const T* __restrict__ dh,
             const float* __restrict__ ck, float* __restrict__ y, float* __restrict__ qy, int S, int D,
             int L, int nc, int BH) {
  __shared__ __align__(16) float As[KS * LP];
  __shared__ __align__(16) float Bs[KS * LP];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int j0 = blockIdx.x * TILE, c = blockIdx.y, bh = blockIdx.z;
  const int t0 = c * L, lv = min(L, S - t0);
  const size_t Sp = static_cast<size_t>(nc) * L;
  const size_t seq = (static_cast<size_t>(bh) * S + t0) * D;
  float acc[8][8];
  zero(acc);
  if (c > 0) {
    const size_t at =
        ((static_cast<size_t>(bh) * (nc - 1) + c - 1) * D + j0) * D;
    block_gemm<T, true, float, true>(acc, As, Bs, dh + seq, D, 1, lv,
                                     ck + at, D, 1, D - j0, D, nullptr);
  }
  float* yb = y + (static_cast<size_t>(bh) * Sp + t0) * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = rc(ty, i);
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j0 + rc(tx, j);
      if (t < L && col < D) {
        yb[static_cast<size_t>(t) * D + col] = acc[i][j];
        if (t < lv) part += to_f(q[seq + static_cast<size_t>(t) * D + col]) *
                            acc[i][j];
      }
    }
    part = row_sum16(part);
    if (tx == 0 && t < L)
      qy[(static_cast<size_t>(blockIdx.x) * BH + bh) * Sp + t0 + t] = part;
  }
}

// ---------------------------------------------------------------- rows
// One block a (chunk, batch * head): per step Dv, dden, u = decay0 scale /
// Dv, z = decay0 scale dden (kU, kZ); then in place G (over W in wm) and
// Sd / Dv (over Sd in sdm).
__global__ void rows_kernel(const float* __restrict__ gates,
                            float* __restrict__ rows,
                            const float* __restrict__ qy,
                            float* __restrict__ sdm, float* __restrict__ wm,
                            int L, int nc, int BH, int td, float scale) {
  __shared__ float s_dv[LMAX], s_dd[LMAX];
  const int tid = threadIdx.x, c = blockIdx.x, bh = blockIdx.y, t0 = c * L;
  const size_t Sp = static_cast<size_t>(nc) * L;
  const float* g = gates + static_cast<size_t>(bh) * SLOTS * Sp;
  float* rw = rows + static_cast<size_t>(bh) * RSLOTS * Sp;
  if (tid < L) {
    const size_t t = t0 + tid;
    float qyv = 0.f;
    for (int tile = 0; tile < td; ++tile)
      qyv += qy[(static_cast<size_t>(tile) * BH + bh) * Sp + t];
    const float den = rw[kDen * Sp + t], minv = g[kMinv * Sp + t];
    const float dec = g[kDecay * Sp + t] * scale;
    const float dv = fmaxf(fabsf(den), minv);
    const float hn = dec * qyv + rw[kHn * Sp + t];
    const float dd =
        fabsf(den) > minv ? -copysignf(1.f, den) * hn / (dv * dv) : 0.f;
    s_dv[tid] = dv;
    s_dd[tid] = dd;
    rw[kU * Sp + t] = dec / dv;
    rw[kZ * Sp + t] = dec * dd;
  }
  __syncthreads();
  const size_t blk = (static_cast<size_t>(bh) * nc + c) * L * L;
  for (int idx = tid; idx < L * L; idx += THREADS) {
    const int t = idx / L, s = idx % L;
    float gv = 0.f;
    if (s <= t)
      gv = expf(g[kA * Sp + t0 + s] - g[kG * Sp + t0 + t]) * scale *
           (wm[blk + idx] / s_dv[t] + s_dd[t]);
    wm[blk + idx] = gv;
    sdm[blk + idx] /= s_dv[t];
  }
}

// ---------------------------------------------------------------- grads
// One block a (128 columns j, chunk, batch * head), the three gradients
// one after the other in one accumulator:
//   dq = G k + u Y + z n_k          (and q . dq to rp [tile][BH][Sp])
//   dk = w (v G_k^T + gn_k) + G^T q (and k . dk to cp)
//   dv = w (k G_k) + (Sd / Dv)^T dh
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    grads_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dh,
                 const float* __restrict__ gates,
                 const float* __restrict__ rows,
                 const float* __restrict__ nk, const float* __restrict__ gk,
                 const float* __restrict__ gn, const float* __restrict__ sdm,
                 const float* __restrict__ wm, const float* __restrict__ y,
                 T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                 float* __restrict__ rp, float* __restrict__ cp, int S,
                 int D, int L, int nc, int BH, int plant) {
  __shared__ __align__(16) float As[KS * LP];
  __shared__ __align__(16) float Bs[KS * LP];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int j0 = blockIdx.x * TILE, c = blockIdx.y, bh = blockIdx.z;
  const int t0 = c * L, lv = min(L, S - t0);
  const size_t Sp = static_cast<size_t>(nc) * L;
  const float* g = gates + static_cast<size_t>(bh) * SLOTS * Sp;
  const float* rw = rows + static_cast<size_t>(bh) * RSLOTS * Sp;
  const size_t seq = (static_cast<size_t>(bh) * S + t0) * D;
  const size_t slot = static_cast<size_t>(bh) * nc + c;
  const float* gm = wm + slot * L * L;
  const float* sn = sdm + slot * L * L;
  const float* gkb = gk + slot * D * D;
  const float* gnb = gn + slot * D;
  const float* nkb = n_at(nk, bh, c, nc, D);
  const float* yb = y + (static_cast<size_t>(bh) * Sp + t0) * D;
  const size_t part_at = (static_cast<size_t>(blockIdx.x) * BH + bh) * Sp + t0;
  float acc[8][8];

  // dq = G k + u Y + z n_k.
  zero(acc);
  block_gemm<float, true, T, false>(acc, As, Bs, gm, L, 1, lv, k + seq + j0,
                                    1, D, D - j0, lv, nullptr);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = rc(ty, i);
    const bool ok = t < lv;
    const float u = ok ? rw[kU * Sp + t0 + t] : 0.f;
    const float z = ok ? rw[kZ * Sp + t0 + t] : 0.f;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j0 + rc(tx, j);
      if (ok && col < D) {
        const size_t at = static_cast<size_t>(t) * D + col;
        float val = acc[i][j];
        if (!(plant & kPlantDqInter))
          val += u * yb[at] + (nkb != nullptr ? z * nkb[col] : 0.f);
        part += to_f(q[seq + at]) * val;
        dq[seq + at] = from_f<T>(val);
      }
    }
    part = row_sum16(part);
    if (tx == 0 && ok) rp[part_at + t] = part;
  }

  // dk = w (v G_k^T + gn_k) + G^T q.
  zero(acc);
  block_gemm<T, true, float, true>(acc, As, Bs, v + seq, D, 1, lv,
                                   gkb + static_cast<size_t>(j0) * D, D, 1,
                                   D - j0, D, nullptr);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = rc(ty, i);
    const float w = s < lv ? g[kW * Sp + t0 + s] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j0 + rc(tx, j);
      acc[i][j] = w * (acc[i][j] + (col < D ? gnb[col] : 0.f));
    }
  }
  block_gemm<float, false, T, false>(acc, As, Bs, gm, 1, L, lv,
                                     q + seq + j0, 1, D, D - j0, lv, nullptr);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = rc(ty, i);
    const bool ok = s < lv;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j0 + rc(tx, j);
      if (ok && col < D) {
        const size_t at = static_cast<size_t>(s) * D + col;
        part += to_f(k[seq + at]) * acc[i][j];
        dk[seq + at] = from_f<T>(acc[i][j]);
      }
    }
    part = row_sum16(part);
    if (tx == 0 && ok) cp[part_at + s] = part;
  }

  // dv = w (k G_k) + (Sd / Dv)^T dh.
  zero(acc);
  block_gemm<T, true, float, false>(acc, As, Bs, k + seq, D, 1, lv,
                                    gkb + j0, 1, D, D - j0, D, nullptr);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = rc(ty, i);
    const float w = s < lv ? g[kW * Sp + t0 + s] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] *= w;
  }
  block_gemm<float, false, T, false>(acc, As, Bs, sn, 1, L, lv,
                                     dh + seq + j0, 1, D, D - j0, lv,
                                     nullptr);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = rc(ty, i);
    if (s >= lv) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j0 + rc(tx, j);
      if (col < D)
        dv[seq + static_cast<size_t>(s) * D + col] = from_f<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------- final
// One block a (batch, head): r_t, c_t summed over the column tiles; dlog_i
// = c - E [t = s*]; dlog_f = reverse cumsum of r - c + E [t <= s*], where
// the state has a gradient: E = <C, dC> + <n, dn> (summed from ep), s* the
// first step of the largest li_s - F_s above 0 (F the cumsum of log f over
// the sequence), or none.  Each thread takes a segment of steps; thread 0
// scans the segments' totals.
__global__ void final_kernel(const float* __restrict__ log_f,
                             const float* __restrict__ log_i,
                             const float* __restrict__ rp,
                             const float* __restrict__ cp,
                             const float* __restrict__ ep,
                             float* __restrict__ dlf, float* __restrict__ dli,
                             int S, int nc, int L, int BH, int td, int nep,
                             int plant) {
  __shared__ float seg[THREADS];
  __shared__ float s_best[THREADS];
  __shared__ int s_arg[THREADS];
  const int tid = threadIdx.x, bh = blockIdx.x;
  const size_t Sp = static_cast<size_t>(nc) * L;
  const int per = (S + THREADS - 1) / THREADS;
  const int lo = min(S, tid * per), hi = min(S, lo + per);
  float e = 0.f;
  int st = -1;
  if (nep > 0) {
    for (int i = 0; i < nep; ++i) e += ep[static_cast<size_t>(bh) * nep + i];
    const float* lf = log_f + static_cast<size_t>(bh) * S;
    const float* li = log_i + static_cast<size_t>(bh) * S;
    float f = 0.f;
    for (int t = lo; t < hi; ++t) f += lf[t];
    seg[tid] = f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < THREADS; ++i) {
        const float x = seg[i];
        seg[i] = run;
        run += x;
      }
    }
    __syncthreads();
    float fg = seg[tid], best = 0.f;
    int arg = -1;
    for (int t = lo; t < hi; ++t) {
      fg += lf[t];
      if (li[t] - fg > best) {
        best = li[t] - fg;
        arg = t;
      }
    }
    s_best[tid] = best;
    s_arg[tid] = arg;
    __syncthreads();
    if (tid == 0) {
      float b = 0.f;
      int a = -1;
      for (int i = 0; i < THREADS; ++i)
        if (s_arg[i] >= 0 && s_best[i] > b) {
          b = s_best[i];
          a = s_arg[i];
        }
      s_arg[0] = a;
    }
    __syncthreads();
    st = s_arg[0];
    __syncthreads();  // seg is reused below
  }
  float sum = 0.f;
  for (int t = lo; t < hi; ++t)
    for (int tile = 0; tile < td; ++tile) {
      const size_t at = (static_cast<size_t>(tile) * BH + bh) * Sp + t;
      sum += rp[at] - cp[at];
    }
  seg[tid] = sum;
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int i = THREADS - 1; i >= 0; --i) {
      const float x = seg[i];
      seg[i] = run;
      run += x;
    }
  }
  __syncthreads();
  float run = seg[tid];
  for (int t = hi - 1; t >= lo; --t) {
    float r = 0.f, cc = 0.f;
    for (int tile = 0; tile < td; ++tile) {
      const size_t at = (static_cast<size_t>(tile) * BH + bh) * Sp + t;
      r += rp[at];
      cc += cp[at];
    }
    const float before = run;
    run += r - cc;
    const size_t o = static_cast<size_t>(bh) * S + t;
    dlf[o] = ((plant & kPlantShift) ? before : run) + (t <= st ? e : 0.f);
    dli[o] = cc - (t == st ? e : 0.f);
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const float* lf,
           const float* li, const T* dh, const float* dc, const float* dn,
           const float* C, const float* n, const float* gates,
           const float* chunks, const float* ck, const float* nk, T* dq, T* dk, T* dv, float* dlf, float* dli,
           float* rows, float* gk, float* gn, float* sdm, float* wm,
           float* y, float* qy, float* rp, float* cp, float* ep, int BH,
           int S, int D, int L, int plant, cudaStream_t st) {
  const int nc = (S + L - 1) / L, td = (D + TILE - 1) / TILE;
  const bool has_state = dc != nullptr || dn != nullptr;
  const float scale = rsqrtf(static_cast<float>(D));
  cudaError_t err;
  intra_kernel<T><<<dim3(nc, BH), THREADS, 0, st>>>(q, k, v, dh, gates, rows,
                                                    nk, sdm, wm, S, D, L, nc,
                                                    scale);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  y_kernel<T><<<dim3(td, nc, BH), THREADS, 0, st>>>(q, dh, ck, y, qy, S, D,
                                                    L, nc, BH);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  rows_kernel<<<dim3(nc, BH), THREADS, 0, st>>>(gates, rows, qy, sdm, wm, L,
                                                nc, BH, td, scale);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  walk_kernel<T><<<dim3(td * td, BH), THREADS, 0, st>>>(
      q, dh, rows, chunks, dc, dn, C, n, gk, gn, has_state ? ep : nullptr, S,
      D, L, nc, plant);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  grads_kernel<T><<<dim3(td, nc, BH), THREADS, 0, st>>>(
      q, k, v, dh, gates, rows, nk, gk, gn, sdm, wm, y, dq, dk, dv, rp, cp, S,
      D, L, nc, BH, plant);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  final_kernel<<<BH, THREADS, 0, st>>>(lf, li, rp, cp, ep, dlf, dli, S, nc, L,
                                       BH, td, has_state ? td * td : 0,
                                       plant);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// Route wgmma of the backward (bf16/f16, D % 64 == 0, chunks of 128 steps,
// 16-byte-aligned bases: where the forward takes its wgmma route).  After
// the forward's gate and state passes (C_k in hi + lo), four launches on
// the tensor cores and final_kernel.  Every product has one side exact in
// T (q, k, v or dh) and, where the other is f32, that side split into hi +
// lo halves in T, two wgmma into one f32 accumulator, as in the forward.
// 384 threads a block: a producer warpgroup (one thread issues the TMA
// loads of a ring of stages) and two consumer warpgroups, each 64 rows of
// the block's 128-row output tile.
// ===========================================================================
using mlstm_wg::BOX;
using mlstm_wg::HALF;
constexpr int WG_THREADS = mlstm_wg::THREADS;
constexpr int WL = mlstm_wg::L;  // steps a chunk

// A ring of TMA-fed stages: bars[s] full (the producer's expect_tx),
// bars[STAGES + s] free (one arrival per consumer).
template <int STAGES>
__device__ __forceinline__ void ring_init(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);
      mbar_init(smem_u32(&bars[STAGES + s]), 2);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// The producer: wait until step st's stage is free, arm its barrier for
// `bytes`; returns the barrier the loads complete on.
template <int STAGES>
__device__ __forceinline__ uint32_t ring_fill(uint64_t* bars, int st,
                                              int bytes) {
  const int s = st % STAGES;
  if (st >= STAGES)
    mbar_wait(smem_u32(&bars[STAGES + s]), (st / STAGES - 1) & 1);
  const uint32_t full = smem_u32(&bars[s]);
  mbar_expect_tx(full, bytes);
  return full;
}

// A consumer: wait until step st's stage is full; returns its address.
template <int STAGES>
__device__ __forceinline__ uint32_t ring_wait(uint64_t* bars,
                                              unsigned char* smem, int st,
                                              int stage_bytes) {
  mbar_wait(smem_u32(&bars[st % STAGES]), (st / STAGES) & 1);
  return smem_u32(smem + (st % STAGES) * stage_bytes);
}

// A consumer, after issuing step st's products: wait for those of step st
// - 1 and free its stage.
template <int STAGES>
__device__ __forceinline__ void ring_retire(float (&acc)[64], uint64_t* bars,
                                           int st, int t) {
  wgmma_commit();
  fence_acc(acc);
  wgmma_wait<1>();
  fence_acc(acc);
  if (st > 0 && t == 0)
    mbar_arrive(smem_u32(&bars[STAGES + (st - 1) % STAGES]));
}

// acc (+)= A B over one 64-deep stage, both K-major (A: the consumer's 64
// rows of a 128-row box at a; B: a 128-row box at b), B as hi at b and lo
// at b_lo (0: B exact).
template <typename T>
__device__ __forceinline__ void mma_kk(float (&acc)[64], uint32_t a,
                                       uint32_t b, uint32_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_ss<0, 0, T>(acc, smem_desc(a + kk * 32, 16, 1024),
                      smem_desc(b + kk * 32, 16, 1024), 1);
    if (b_lo)
      wgmma_ss<0, 0, T>(acc, smem_desc(a + kk * 32, 16, 1024),
                        smem_desc(b_lo + kk * 32, 16, 1024), 1);
  }
}

// acc += A B over one 64-deep stage, A K-major (the consumer's 64 rows of
// a 128-row box) as hi at a and lo at a_lo, or exact (a_lo 0); B MN-major,
// two 64-column boxes HALF bytes apart at b.
template <typename T>
__device__ __forceinline__ void mma_kn(float (&acc)[64], uint32_t a,
                                       uint32_t a_lo, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = smem_desc(b + kk * 2048, HALF, 1024);
    wgmma_ss<0, 1, T>(acc, smem_desc(a + kk * 32, 16, 1024), db, 1);
    if (a_lo)
      wgmma_ss<0, 1, T>(acc, smem_desc(a_lo + kk * 32, 16, 1024), db, 1);
  }
}

// acc += A B over one 64-deep stage, A MN-major (a 64-column box, the
// consumer's 64 rows) as hi at a and lo at a_lo; B MN-major, two 64-column
// boxes HALF bytes apart at b.
template <typename T>
__device__ __forceinline__ void mma_nn(float (&acc)[64], uint32_t a,
                                       uint32_t a_lo, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = smem_desc(b + kk * 2048, HALF, 1024);
    wgmma_ss<1, 1, T>(acc, smem_desc(a + kk * 2048, HALF, 1024), db, 1);
    wgmma_ss<1, 1, T>(acc, smem_desc(a_lo + kk * 2048, HALF, 1024), db, 1);
  }
}

// Two T at p as floats.
template <typename T>
__device__ __forceinline__ float2 load2(const T* p) {
  const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
  const T* x = reinterpret_cast<const T*>(&raw);
  return make_float2(to_f(x[0]), to_f(x[1]));
}

// hi and lo of (x0, x1) to hi[at], lo[at].
template <typename T>
__device__ __forceinline__ void put_split(T* hi, T* lo, size_t at, float x0,
                                          float x1) {
  uint32_t h, l;
  mlstm_wg::split2<T>(x0, x1, h, l);
  *reinterpret_cast<uint32_t*>(hi + at) = h;
  *reinterpret_cast<uint32_t*>(lo + at) = l;
}

struct YPass {
  static constexpr int STAGES = 4;
  static constexpr int STAGE_BYTES = 3 * BOX;  // dh, C_k hi, C_k lo
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

// ---------------------------------------------------------------- Y
// One block a (128 columns j, chunk ci >= 1, batch * head): Y = dh C_k^T
// over e (dh K-major, C_k's rows j K-major as hi and lo, D / 64 stages) to
// y [BH][Sp][D] in f32, and sum_j q_t[j] Y[t][j] to qy [tile][BH][Sp].
// Chunk 0 has C_0 = 0: no block, and its readers take Y = 0.
template <typename T>
__global__ void __launch_bounds__(WG_THREADS, 1)
    y_wg_kernel(__grid_constant__ const CUtensorMap tmDh,
                __grid_constant__ const CUtensorMap tmC,
                const T* __restrict__ q, float* __restrict__ y,
                float* __restrict__ qy, int S, int D, int nc, int BH) {
  using F = YPass;
  constexpr int STAGES = F::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = mlstm_wg::align1024(smem_raw);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + STAGES * F::STAGE_BYTES);
  const int j0 = blockIdx.x * 128, ci = blockIdx.y + 1, bh = blockIdx.z;
  const int t0 = ci * WL, nk = D / 64;
  ring_init<STAGES>(bars);
  if (threadIdx.x < 128) {  // the producer
    if (threadIdx.x == 0) {
      const int c_hi = bh * (nc - 1) + ci - 1, c_lo = c_hi + BH * (nc - 1);
      for (int st = 0; st < nk; ++st) {
        const uint32_t full = ring_fill<STAGES>(bars, st, F::STAGE_BYTES);
        const uint32_t sb = smem_u32(smem + (st % STAGES) * F::STAGE_BYTES);
        tma_load(sb, &tmDh, st * 64, t0, bh, full);
        tma_load(sb + BOX, &tmC, st * 64, j0, c_hi, full);
        tma_load(sb + 2 * BOX, &tmC, st * 64, j0, c_lo, full);
      }
    }
    return;
  }
  const int c = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int st = 0; st < nk; ++st) {
    const uint32_t sb = ring_wait<STAGES>(bars, smem, st, F::STAGE_BYTES);
    fence_acc(acc);
    wgmma_fence();
    mma_kk<T>(acc, sb + c * HALF, sb + BOX, sb + 2 * BOX);
    ring_retire<STAGES>(acc, bars, st, t);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  const size_t Sp = static_cast<size_t>(nc) * WL;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tp = t0 + c * 64 + w * 16 + g + 8 * h;
    const T* qr = q + (static_cast<size_t>(bh) * S + tp) * D;
    float* yr = y + (static_cast<size_t>(bh) * Sp + tp) * D;
    float part = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int col = j0 + 8 * jj + 2 * tq;
      if (col >= D) continue;  // D % 64 == 0: col + 1 < D too
      const float a0 = acc[4 * jj + 2 * h], a1 = acc[4 * jj + 2 * h + 1];
      *reinterpret_cast<float2*>(yr + col) = make_float2(a0, a1);
      if (tp < S) {
        const float2 qv = load2(qr + col);
        part += qv.x * a0 + qv.y * a1;
      }
    }
    part = mlstm_wg::quad_sum(part);
    if (tq == 0) qy[(static_cast<size_t>(blockIdx.x) * BH + bh) * Sp + tp] = part;
  }
}

struct IntraB {
  static constexpr int STAGES = 3;
  static constexpr int STAGE_BYTES = 4 * BOX;  // q, k, dh, v
  static constexpr int SMEM =
      STAGES * STAGE_BYTES + WL * 4 + 1024 + 2 * STAGES * 8;
};

// ---------------------------------------------------------------- intra
// One block a (batch * head, chunk): S = q k^T and W = dh v^T over D on
// wgmma (every operand a 128-step K-major box, 64 columns a stage; each
// consumer 64 query rows), q . n_k beside them on the CUDA cores by the
// producer warpgroup's three idle warps (from global memory, so the
// consumers keep their registers for the two accumulators).  Then in
// registers, per row t and key s: Sd = S E (E = scale exp(a_s - g_t), s <=
// t), den = decay0 scale q . n_k + sum_s Sd, Dv = max(|den|, minv), dden
// = -sign(den) (decay0 scale qy + sum_s Sd W) / Dv^2 where |den| > minv
// (qy the Y pass's partials summed over its td tiles, 0 in chunk 0); u =
// decay0 scale / Dv and z = decay0 scale dden to rows (kU, kZ); G = E (W /
// Dv + dden) and P = Sd / Dv in hi + lo halves to gp [4][BH * nc][128]
// [128] (G hi, G lo, P hi, P lo; row t, column s).
template <typename T>
__global__ void __launch_bounds__(WG_THREADS, 1)
    intra_wg_kernel(__grid_constant__ const CUtensorMap tmQ,
                    __grid_constant__ const CUtensorMap tmK,
                    __grid_constant__ const CUtensorMap tmDh,
                    __grid_constant__ const CUtensorMap tmV,
                    const float* __restrict__ gates,
                    const float* __restrict__ nk,
                    const float* __restrict__ qy, const T* __restrict__ q,
                    float* __restrict__ rows, T* __restrict__ gp, int S,
                    int D, int nc, int BH, int td, float scale) {
  using F = IntraB;
  constexpr int STAGES = F::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = mlstm_wg::align1024(smem_raw);
  float* qn_s = reinterpret_cast<float*>(smem + STAGES * F::STAGE_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(qn_s + WL);
  const int blk = blockIdx.x, bh = blk / nc, ci = blk % nc, t0 = ci * WL;
  const int nks = D / 64;
  ring_init<STAGES>(bars);
  if (threadIdx.x < 128) {  // the producer
    if (threadIdx.x == 0) {
      for (int st = 0; st < nks; ++st) {
        const uint32_t full = ring_fill<STAGES>(bars, st, F::STAGE_BYTES);
        const uint32_t sb = smem_u32(smem + (st % STAGES) * F::STAGE_BYTES);
        tma_load(sb, &tmQ, st * 64, t0, bh, full);
        tma_load(sb + BOX, &tmK, st * 64, t0, bh, full);
        tma_load(sb + 2 * BOX, &tmDh, st * 64, t0, bh, full);
        tma_load(sb + 3 * BOX, &tmV, st * 64, t0, bh, full);
      }
    } else if (threadIdx.x >= 32) {
      // q . n_k (0 in chunk 0): warp wp takes rows wp, wp + 3, ..., each
      // lane 8 columns of every 256.
      const int wp = threadIdx.x / 32 - 1, ln = threadIdx.x % 32;
      const float* nb =
          nk + (static_cast<size_t>(bh) * (nc - 1) + ci - 1) * D;
      for (int r = wp; r < WL; r += 3) {
        float x = 0.f;
        if (ci > 0 && t0 + r < S) {
          const T* qrow = q + (static_cast<size_t>(bh) * S + t0 + r) * D;
          for (int d = 8 * ln; d < D; d += 256) {
            const uint4 raw = *reinterpret_cast<const uint4*>(qrow + d);
            const T* xv = reinterpret_cast<const T*>(&raw);
            const float4 na = *reinterpret_cast<const float4*>(nb + d);
            const float4 nn = *reinterpret_cast<const float4*>(nb + d + 4);
            x += to_f(xv[0]) * na.x + to_f(xv[1]) * na.y +
                 to_f(xv[2]) * na.z + to_f(xv[3]) * na.w +
                 to_f(xv[4]) * nn.x + to_f(xv[5]) * nn.y +
                 to_f(xv[6]) * nn.z + to_f(xv[7]) * nn.w;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, o);
        if (ln == 0) qn_s[r] = x;
      }
      named_sync(4, 352);  // qn_s is written: the consumers may read it
    }
    return;
  }
  const int c = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const size_t Sp = static_cast<size_t>(nc) * WL;
  float acc_s[64], acc_w[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_s[i] = acc_w[i] = 0.f;
  for (int st = 0; st < nks; ++st) {
    const int s = st % STAGES;
    mbar_wait(smem_u32(&bars[s]), (st / STAGES) & 1);
    const uint32_t sb = smem_u32(smem + s * F::STAGE_BYTES);
    fence_acc(acc_s);
    fence_acc(acc_w);
    wgmma_fence();
    mma_kk<T>(acc_s, sb + c * HALF, sb + BOX, 0u);
    mma_kk<T>(acc_w, sb + 2 * BOX + c * HALF, sb + 3 * BOX, 0u);
    wgmma_commit();
    fence_acc(acc_s);
    fence_acc(acc_w);
    wgmma_wait<1>();
    fence_acc(acc_s);
    fence_acc(acc_w);
    if (st > 0 && t == 0)
      mbar_arrive(smem_u32(&bars[STAGES + (st - 1) % STAGES]));
  }
  wgmma_wait<0>();
  fence_acc(acc_s);
  fence_acc(acc_w);
  // Both consumers' products are done (the stage ring is free) and the
  // producer's warps have written qn_s.
  named_sync(4, 352);
  // Park W in the ring, f32, interleaved by thread: its 64 registers go to
  // the epilogue's temporaries (ptxas spills otherwise).
  float* wsm = reinterpret_cast<float*>(smem) + c * 64 * 128 + t;
#pragma unroll
  for (int i = 0; i < 64; ++i) wsm[i * 128] = acc_w[i];
  asm volatile("" ::: "memory");  // read W back from shared memory below

  // Accumulators: rows j = 64 c + 16 w + g (+ 8 h); register 4 jj + 2 h +
  // e is column (key step) 8 jj + 2 tq + e.
  const float* gb = gates + static_cast<size_t>(bh) * SLOTS * Sp + t0;
  float* rw = rows + static_cast<size_t>(bh) * RSLOTS * Sp + t0;
  float gt[2], dvv[2], ddv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = c * 64 + w * 16 + g + 8 * h;
    gt[h] = gb[kG * Sp + j];
    float rs = 0.f, hn = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = 8 * jj + 2 * tq + e, r = 4 * jj + 2 * h + e;
        const float sd =
            s <= j ? acc_s[r] * scale * expf(gb[kA * Sp + s] - gt[h]) : 0.f;
        acc_s[r] = sd;
        rs += sd;
        hn += sd * wsm[r * 128];
      }
    rs = mlstm_wg::quad_sum(rs);
    hn = mlstm_wg::quad_sum(hn);
    float qyv = 0.f;
    if (ci > 0)
      for (int tile = 0; tile < td; ++tile)
        qyv += qy[(static_cast<size_t>(tile) * BH + bh) * Sp + t0 + j];
    const float dec = gb[kDecay * Sp + j] * scale, minv = gb[kMinv * Sp + j];
    const float den = dec * qn_s[j] + rs;
    const float dv = fmaxf(fabsf(den), minv);
    const float dd = fabsf(den) > minv
                         ? -copysignf(1.f, den) * (dec * qyv + hn) / (dv * dv)
                         : 0.f;
    dvv[h] = dv;
    ddv[h] = dd;
    if (tq == 0) {
      rw[kU * Sp + j] = dec / dv;
      rw[kZ * Sp + j] = dec * dd;
    }
  }
  const size_t LL = static_cast<size_t>(WL) * WL, part = BH * nc * LL;
  T* gh = gp + blk * LL;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = c * 64 + w * 16 + g + 8 * h;
    const float inv = 1.f / dvv[h];
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int s = 8 * jj + 2 * tq, r = 4 * jj + 2 * h;
      float gv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        gv[e] = s + e <= j ? scale * expf(gb[kA * Sp + s + e] - gt[h]) *
                                 (wsm[(r + e) * 128] * inv + ddv[h])
                           : 0.f;
      const size_t at = static_cast<size_t>(j) * WL + s;
      put_split<T>(gh, gh + part, at, gv[0], gv[1]);
      put_split<T>(gh + 2 * part, gh + 3 * part, at, acc_s[r] * inv,
                   acc_s[r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------- walk
struct WalkB {
  // A ring of half-chunk stages (64 steps): q (two 64-column boxes,
  // rewritten in place as hi of u q), lo (two), dh (two), 8 KB a box.
  static constexpr int STAGES = 3;
  static constexpr int STAGE_BYTES = 6 * HALF;
  // G_k for the TMA store: [consumer][hi, lo][2 boxes of 64 x 64].
  static constexpr int OUT_BYTES = 2 * 2 * 2 * HALF;
  // gn's column partials: [consumer][chunk parity][16 row groups][64] f32.
  static constexpr int RED_BYTES = 2 * 2 * 16 * 64 * 4;
  static constexpr int SMEM = STAGES * STAGE_BYTES + OUT_BYTES + RED_BYTES +
                              1024 + 2 * STAGES * 8;
};

// Walk: hand the tile over as G of slab `slab` (lo halves at slab + lo):
// round it into hi + lo boxes of shared memory at ob (swizzled) and store
// them with TMA.  No product in flight.
template <typename T>
__device__ __forceinline__ void store_g(const float (&acc)[64],
                                        unsigned char* ob,
                                        const CUtensorMap* tmG, int t, int c,
                                        int d0, int e0, int slab, int lo) {
  const int lane = t % 32, orow = (t / 32) * 16 + lane / 4, tq = lane % 4;
  if (t == 0) bulk_wait_read();  // the last hand-over's stores read ob
  named_sync(1 + c, 128);
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = orow + 8 * h;
      const int o =
          (jj / 8) * HALF + r * 128 + ((jj % 8) ^ (r % 8)) * 16 + 4 * tq;
      uint32_t hv, lv;
      mlstm_wg::split2<T>(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1], hv,
                          lv);
      *reinterpret_cast<uint32_t*>(ob + o) = hv;
      *reinterpret_cast<uint32_t*>(ob + 2 * HALF + o) = lv;
    }
  fence_proxy_async();
  named_sync(1 + c, 128);
  if (t == 0) {
    const uint32_t o0 = smem_u32(ob);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      tma_store(tmG, o0 + u * HALF, e0 + 64 * u, d0 + c * 64, slab);
      tma_store(tmG, o0 + (2 + u) * HALF, e0 + 64 * u, d0 + c * 64,
                slab + lo);
    }
    bulk_commit();
  }
}

// One block a (128 x 128 tile of the state's gradient, rows d and columns
// e, batch * head): the forward's state pass run in reverse.  The tile is
// the f32 wgmma accumulator from dC (or 0) down through the chunks; at the
// start of chunk ci it is G_ci, the gradient of the state after chunk ci,
// handed to the grads pass in hi + lo (TMA stores to gk, slab bh * ncs +
// ci; ncs = nc, or nc - 1 where the state has no gradient: the last
// chunk's G is then 0 and not stored), then G <-
// scale_c[ci] G + (u q)^T dh over the chunk: A MN-major from q's TMA'd
// boxes rewritten in place as hi(u_t q_t) with lo beside them, B = dh
// MN-major, half-chunk stages of 64 steps.  The column block at e = 0
// carries gn the same way in f32 on the CUDA cores (sum_t z_t q_t, from the
// unrounded q) and stores gn_ci beside G_ci.  Where dC or dn is given, the
// block's share of <C, dC> + <n, dn> (C, n the final state) goes to ep
// first.
template <typename T>
__global__ void __launch_bounds__(WG_THREADS, 1)
    walk_wg_kernel(__grid_constant__ const CUtensorMap tmQ,
                   __grid_constant__ const CUtensorMap tmDh,
                   __grid_constant__ const CUtensorMap tmG,
                   const float* __restrict__ rows,
                   const float* __restrict__ chunks,
                   const float* __restrict__ dc, const float* __restrict__ dn,
                   const float* __restrict__ C, const float* __restrict__ n,
                   float* __restrict__ gn_out, float* __restrict__ ep, int D,
                   int nc, int ncs, int BH, int plant) {
  using F = WalkB;
  constexpr int STAGES = F::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = mlstm_wg::align1024(smem_raw);
  unsigned char* obuf = smem + STAGES * F::STAGE_BYTES;
  float* red = reinterpret_cast<float*>(obuf + F::OUT_BYTES);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(obuf + F::OUT_BYTES + F::RED_BYTES);
  const int tiles = (D + 127) / 128;
  const int bh = blockIdx.y;
  const int d0 = (blockIdx.x / tiles) * 128, e0 = (blockIdx.x % tiles) * 128;
  const int nh = 2 * (nc - 1);  // half-chunks of chunks nc - 1 .. 1
  const bool has_state = dc != nullptr || dn != nullptr;
  ring_init<STAGES>(bars);
  if (threadIdx.x < 128) {  // the producer
    if (threadIdx.x == 0) {
      for (int p = 0; p < nh; ++p) {
        const uint32_t full = ring_fill<STAGES>(bars, p, 4 * HALF);
        const uint32_t sb = smem_u32(smem + (p % STAGES) * F::STAGE_BYTES);
        const int row = (nc - 1 - p / 2) * WL + (p % 2) * 64;
        tma_load(sb, &tmQ, d0, row, bh, full);
        tma_load(sb + HALF, &tmQ, d0 + 64, row, bh, full);
        tma_load(sb + 4 * HALF, &tmDh, e0, row, bh, full);
        tma_load(sb + 5 * HALF, &tmDh, e0 + 64, row, bh, full);
      }
    }
    return;
  }
  const int c = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const size_t Sp = static_cast<size_t>(nc) * WL;
  const float* uv = rows + static_cast<size_t>(bh) * RSLOTS * Sp + kU * Sp;
  const float* zv = rows + static_cast<size_t>(bh) * RSLOTS * Sp + kZ * Sp;
  const float* sc = chunks + static_cast<size_t>(bh) * 3 * nc + kScale * nc;
  const bool do_n = e0 == 0;
  const int lc = (t % 8) ^ ((t / 8) % 8);
  const int nd = d0 + c * 64 + t;  // the row of gn thread t < 64 carries
  unsigned char* ob = obuf + c * 4 * HALF;  // hi boxes, then lo boxes
  const int row0 = d0 + c * 64 + w * 16 + g, col0 = e0 + 2 * tq;
  const size_t DD = static_cast<size_t>(D) * D;
  float acc[64];
  float gnv = 0.f, prt = 0.f;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 x = make_float2(0.f, 0.f);
      const int row = row0 + 8 * h, col = col0 + 8 * jj;
      if (dc != nullptr && row < D && col < D) {
        const size_t at = bh * DD + static_cast<size_t>(row) * D + col;
        x = *reinterpret_cast<const float2*>(dc + at);
        const float2 cv = *reinterpret_cast<const float2*>(C + at);
        prt += x.x * cv.x + x.y * cv.y;
      }
      acc[4 * jj + 2 * h] = x.x;
      acc[4 * jj + 2 * h + 1] = x.y;
    }
  if (do_n && t < 64 && dn != nullptr && nd < D) {
    gnv = dn[static_cast<size_t>(bh) * D + nd];
    prt += gnv * n[static_cast<size_t>(bh) * D + nd];
  }
  if (has_state) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      prt += __shfl_xor_sync(0xffffffffu, prt, o);
    if (lane == 0) red[c * 4 + w] = prt;
    named_sync(3, 256);
    if (c == 0 && t == 0) {
      float sum = 0.f;
      for (int i = 0; i < 8; ++i) sum += red[i];
      ep[static_cast<size_t>(bh) * gridDim.x + blockIdx.x] = sum;
    }
    named_sync(3, 256);  // red is reused for gn below
  }
  float part[8];
  for (int p = 0; p < nh; ++p) {
    const int s = p % STAGES, ci = nc - 1 - p / 2, half = p % 2;
    const size_t r0 = static_cast<size_t>(ci) * WL + half * 64 + t / 8;
    float ucur[4], zcur[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      ucur[ii] = uv[r0 + 16 * ii];
      zcur[ii] = zv[r0 + 16 * ii];
    }
    mbar_wait(smem_u32(&bars[s]), (p / STAGES) & 1);
    unsigned char* kb = smem + s * F::STAGE_BYTES + c * HALF;
    unsigned char* lb = kb + 2 * HALF;
    if (half == 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e) part[e] = 0.f;
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = t / 8 + 16 * ii;
      const int off = r * 128 + (t % 8) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(kb + off);
      const T* x = reinterpret_cast<const T*>(&raw);
      uint32_t hv[4], lv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x0 = to_f(x[2 * e]), x1 = to_f(x[2 * e + 1]);
        part[2 * e] += zcur[ii] * x0;
        part[2 * e + 1] += zcur[ii] * x1;
        mlstm_wg::split2<T>(ucur[ii] * x0, ucur[ii] * x1, hv[e], lv[e]);
      }
      *reinterpret_cast<uint4*>(kb + off) =
          make_uint4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<uint4*>(lb + off) =
          make_uint4(lv[0], lv[1], lv[2], lv[3]);
    }
    float* rb = red + (c * 2 + ((p / 2) & 1)) * 16 * 64;
    if (do_n && half == 1) {
#pragma unroll
      for (int e = 0; e < 8; ++e) rb[(t / 8) * 64 + lc * 8 + e] = part[e];
    }
    fence_proxy_async();
    named_sync(1 + c, 128);
    if (half == 0) {
      // The chunk after this one is done: free its last stage, hand G_ci
      // over, decay the tile.
      wgmma_wait<0>();
      fence_acc(acc);
      if (p > 0 && t == 0)
        mbar_arrive(smem_u32(&bars[STAGES + (p - 1) % STAGES]));
      if ((plant & kPlantReset) && ci == nc / 2) {
#pragma unroll
        for (int x = 0; x < 64; ++x) acc[x] = 0.f;
        gnv = 0.f;
      }
      if (ci < ncs) {
        store_g<T>(acc, ob, &tmG, t, c, d0, e0, bh * ncs + ci, BH * ncs);
        if (do_n && t < 64 && nd < D)
          gn_out[(static_cast<size_t>(bh) * nc + ci) * D + nd] = gnv;
      }
      const float f = sc[ci];
#pragma unroll
      for (int x = 0; x < 64; ++x) acc[x] *= f;
    }
    if (do_n && half == 1 && t < 64) {
      float colsum = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) colsum += rb[r * 64 + t];
      gnv = sc[ci] * gnv + colsum;
    }
    const uint32_t ka = smem_u32(kb), la = smem_u32(lb);
    const uint32_t vb = smem_u32(smem + s * F::STAGE_BYTES + 4 * HALF);
    fence_acc(acc);
    wgmma_fence();
    mma_nn<T>(acc, ka, la, vb);
    wgmma_commit();
    if (half == 1) {
      // The chunk's first half has retired: free its stage.
      fence_acc(acc);
      wgmma_wait<1>();
      fence_acc(acc);
      if (t == 0) mbar_arrive(smem_u32(&bars[STAGES + (p - 1) % STAGES]));
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if ((plant & kPlantReset) && nc / 2 == 0) {
#pragma unroll
    for (int x = 0; x < 64; ++x) acc[x] = 0.f;
    gnv = 0.f;
  }
  if (ncs > 0) {
    store_g<T>(acc, ob, &tmG, t, c, d0, e0, bh * ncs, BH * ncs);
    if (do_n && t < 64 && nd < D)
      gn_out[static_cast<size_t>(bh) * nc * D + nd] = gnv;
  }
  if (t == 0) bulk_wait();  // the G_k stores have landed
}

struct GradsB {
  static constexpr int STAGES = 4;
  static constexpr int STAGE_BYTES = 3 * BOX;  // three 16 KB operand slots
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

// Grads: rows r0 and r0 + 8 of the consumer's tile (steps t0 + row, those
// below S) in T to out at base + row * D + col (columns j0 + 8 jj + 2 tq +
// e below D); with x, each row's f32 dot with x's (the accumulator before
// rounding), summed over the tile's columns, to sums[row].
template <typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[64], T* out,
                                           const T* x, float* sums,
                                           size_t base, int r0, int j0,
                                           int tq, int left, int D) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const bool ok = row < left;
    float dot = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int col = j0 + 8 * jj + 2 * tq;
      if (!ok || col >= D) continue;
      const size_t at = base + static_cast<size_t>(row) * D + col;
      const float a0 = acc[4 * jj + 2 * h], a1 = acc[4 * jj + 2 * h + 1];
      if (x != nullptr) {
        const float2 xv = load2(x + at);
        dot += xv.x * a0 + xv.y * a1;
      }
      mlstm_wg::store2<T>(out + at, a0, a1);
    }
    if (x != nullptr) {
      dot = mlstm_wg::quad_sum(dot);
      if (tq == 0 && ok) sums[row] = dot;
    }
  }
}

// ---------------------------------------------------------------- grads
// One block a (128 columns j, chunk ci, batch * head), the three gradients
// one after the other in one accumulator, each consumer 64 rows (steps):
//   dq = G k + u Y + z n_k     2 stages {G hi, k, G lo} (64 keys each);
//                              u Y + z n_k and q . dq (to rp) in the
//                              epilogue, from the f32 accumulator
//   dk = w (v G_ci^T + gn_ci)  D / 64 stages {v, G_ci hi, G_ci lo}
//        + G^T q               2 stages {G hi, q, G lo} (64 queries each);
//                              k . dk to cp
//   dv = w (k G_ci)            D / 64 stages {k, G_ci hi, G_ci lo}
//        + P^T dh              2 stages {P hi, dh, P lo}
// G_ci's stages (slab bh * ncs + ci) only where the state after the chunk
// has a gradient (ci < ncs: not the last chunk without dC, dn).  The accumulator is scaled between the
// stages of a gradient, with no product in flight.
template <typename T>
__global__ void __launch_bounds__(WG_THREADS, 1)
    grads_wg_kernel(__grid_constant__ const CUtensorMap tmQ64,
                    __grid_constant__ const CUtensorMap tmK64,
                    __grid_constant__ const CUtensorMap tmDh64,
                    __grid_constant__ const CUtensorMap tmK128,
                    __grid_constant__ const CUtensorMap tmV128,
                    __grid_constant__ const CUtensorMap tmGp128,
                    __grid_constant__ const CUtensorMap tmGp64,
                    __grid_constant__ const CUtensorMap tmGk128,
                    __grid_constant__ const CUtensorMap tmGk64,
                    const T* __restrict__ q, const T* __restrict__ k,
                    const float* __restrict__ gates,
                    const float* __restrict__ rows,
                    const float* __restrict__ nk,
                    const float* __restrict__ gn,
                    const float* __restrict__ y, T* __restrict__ dq,
                    T* __restrict__ dk, T* __restrict__ dv,
                    float* __restrict__ rp, float* __restrict__ cp, int S,
                    int D, int nc, int ncs, int BH, int plant) {
  using F = GradsB;
  constexpr int STAGES = F::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = mlstm_wg::align1024(smem_raw);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + STAGES * F::STAGE_BYTES);
  const int j0 = blockIdx.x * 128, ci = blockIdx.y, bh = blockIdx.z;
  const int t0 = ci * WL, blk = bh * nc + ci, P = BH * nc;
  const int gs = bh * ncs + ci, GP = BH * ncs;
  const int n1 = ci < ncs ? D / 64 : 0;
  ring_init<STAGES>(bars);
  if (threadIdx.x < 128) {  // the producer
    if (threadIdx.x == 0) {
      int st = 0;
      for (int u = 0; u < 2; ++u, ++st) {  // dq: G k
        const uint32_t full = ring_fill<STAGES>(bars, st, F::STAGE_BYTES);
        const uint32_t sb = smem_u32(smem + (st % STAGES) * F::STAGE_BYTES);
        tma_load(sb, &tmGp128, 64 * u, 0, blk, full);
        tma_load(sb + BOX, &tmK64, j0, t0 + 64 * u, bh, full);
        tma_load(sb + BOX + HALF, &tmK64, j0 + 64, t0 + 64 * u, bh, full);
        tma_load(sb + 2 * BOX, &tmGp128, 64 * u, 0, blk + P, full);
      }
      for (int e = 0; e < n1; ++e, ++st) {  // dk: v G_ci^T
        const uint32_t full = ring_fill<STAGES>(bars, st, F::STAGE_BYTES);
        const uint32_t sb = smem_u32(smem + (st % STAGES) * F::STAGE_BYTES);
        tma_load(sb, &tmV128, 64 * e, t0, bh, full);
        tma_load(sb + BOX, &tmGk128, 64 * e, j0, gs, full);
        tma_load(sb + 2 * BOX, &tmGk128, 64 * e, j0, gs + GP, full);
      }
      for (int u = 0; u < 2; ++u, ++st) {  // dk: G^T q
        const uint32_t full = ring_fill<STAGES>(bars, st, F::STAGE_BYTES);
        const uint32_t sb = smem_u32(smem + (st % STAGES) * F::STAGE_BYTES);
        tma_load(sb, &tmGp64, 0, 64 * u, blk, full);
        tma_load(sb + HALF, &tmGp64, 64, 64 * u, blk, full);
        tma_load(sb + BOX, &tmQ64, j0, t0 + 64 * u, bh, full);
        tma_load(sb + BOX + HALF, &tmQ64, j0 + 64, t0 + 64 * u, bh, full);
        tma_load(sb + 2 * BOX, &tmGp64, 0, 64 * u, blk + P, full);
        tma_load(sb + 2 * BOX + HALF, &tmGp64, 64, 64 * u, blk + P, full);
      }
      for (int e = 0; e < n1; ++e, ++st) {  // dv: k G_ci
        const uint32_t full = ring_fill<STAGES>(bars, st, F::STAGE_BYTES);
        const uint32_t sb = smem_u32(smem + (st % STAGES) * F::STAGE_BYTES);
        tma_load(sb, &tmK128, 64 * e, t0, bh, full);
        tma_load(sb + BOX, &tmGk64, j0, 64 * e, gs, full);
        tma_load(sb + BOX + HALF, &tmGk64, j0 + 64, 64 * e, gs, full);
        tma_load(sb + 2 * BOX, &tmGk64, j0, 64 * e, gs + GP, full);
        tma_load(sb + 2 * BOX + HALF, &tmGk64, j0 + 64, 64 * e, gs + GP,
                 full);
      }
      for (int u = 0; u < 2; ++u, ++st) {  // dv: P^T dh
        const uint32_t full = ring_fill<STAGES>(bars, st, F::STAGE_BYTES);
        const uint32_t sb = smem_u32(smem + (st % STAGES) * F::STAGE_BYTES);
        tma_load(sb, &tmGp64, 0, 64 * u, blk + 2 * P, full);
        tma_load(sb + HALF, &tmGp64, 64, 64 * u, blk + 2 * P, full);
        tma_load(sb + BOX, &tmDh64, j0, t0 + 64 * u, bh, full);
        tma_load(sb + BOX + HALF, &tmDh64, j0 + 64, t0 + 64 * u, bh, full);
        tma_load(sb + 2 * BOX, &tmGp64, 0, 64 * u, blk + 3 * P, full);
        tma_load(sb + 2 * BOX + HALF, &tmGp64, 64, 64 * u, blk + 3 * P,
                 full);
      }
    }
    return;
  }
  const int c = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const size_t Sp = static_cast<size_t>(nc) * WL;
  const float* gb = gates + static_cast<size_t>(bh) * SLOTS * Sp + t0;
  const float* rw = rows + static_cast<size_t>(bh) * RSLOTS * Sp + t0;
  const size_t seq = (static_cast<size_t>(bh) * S + t0) * D;
  const size_t part_at = (static_cast<size_t>(blockIdx.x) * BH + bh) * Sp + t0;
  const int r0 = c * 64 + w * 16 + g;  // this thread's rows r0, r0 + 8
  const int left = S - t0;
  float acc[64];
  int st = 0;

  // dq = G k + u Y + z n_k.
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int u = 0; u < 2; ++u, ++st) {
    const uint32_t sb = ring_wait<STAGES>(bars, smem, st, F::STAGE_BYTES);
    fence_acc(acc);
    wgmma_fence();
    mma_kn<T>(acc, sb + c * HALF, sb + 2 * BOX + c * HALF, sb + BOX);
    ring_retire<STAGES>(acc, bars, st, t);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (ci > 0 && !(plant & kPlantDqInter)) {
    const float* nb = nk + (static_cast<size_t>(bh) * (nc - 1) + ci - 1) * D;
    const float* yb = y + (static_cast<size_t>(bh) * Sp + t0) * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const float u = rw[kU * Sp + row], z = rw[kZ * Sp + row];
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int col = j0 + 8 * jj + 2 * tq;
        if (col >= D) continue;
        const float2 yv = *reinterpret_cast<const float2*>(
            yb + static_cast<size_t>(row) * D + col);
        const float2 nv = *reinterpret_cast<const float2*>(nb + col);
        acc[4 * jj + 2 * h] += u * yv.x + z * nv.x;
        acc[4 * jj + 2 * h + 1] += u * yv.y + z * nv.y;
      }
    }
  }
  store_rows<T>(acc, dq, q, rp + part_at, seq, r0, j0, tq, left, D);

  // dk = w (v G_ci^T + gn_ci) + G^T q.
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int e = 0; e < n1; ++e, ++st) {
    const uint32_t sb = ring_wait<STAGES>(bars, smem, st, F::STAGE_BYTES);
    fence_acc(acc);
    wgmma_fence();
    mma_kk<T>(acc, sb + c * HALF, sb + BOX, sb + 2 * BOX);
    ring_retire<STAGES>(acc, bars, st, t);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (n1 > 0) {
    const float* gnb = gn + static_cast<size_t>(blk) * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float wr = gb[kW * Sp + r0 + 8 * h];
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int col = j0 + 8 * jj + 2 * tq;
        const float2 gv = col < D
                              ? *reinterpret_cast<const float2*>(gnb + col)
                              : make_float2(0.f, 0.f);
        acc[4 * jj + 2 * h] = wr * (acc[4 * jj + 2 * h] + gv.x);
        acc[4 * jj + 2 * h + 1] = wr * (acc[4 * jj + 2 * h + 1] + gv.y);
      }
    }
  }
  for (int u = 0; u < 2; ++u, ++st) {
    const uint32_t sb = ring_wait<STAGES>(bars, smem, st, F::STAGE_BYTES);
    fence_acc(acc);
    wgmma_fence();
    mma_nn<T>(acc, sb + c * HALF, sb + 2 * BOX + c * HALF, sb + BOX);
    ring_retire<STAGES>(acc, bars, st, t);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  store_rows<T>(acc, dk, k, cp + part_at, seq, r0, j0, tq, left, D);

  // dv = w (k G_ci) + P^T dh.
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int e = 0; e < n1; ++e, ++st) {
    const uint32_t sb = ring_wait<STAGES>(bars, smem, st, F::STAGE_BYTES);
    fence_acc(acc);
    wgmma_fence();
    mma_kn<T>(acc, sb + c * HALF, 0u, sb + BOX);
    mma_kn<T>(acc, sb + c * HALF, 0u, sb + 2 * BOX);
    ring_retire<STAGES>(acc, bars, st, t);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (n1 > 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float wr = gb[kW * Sp + r0 + 8 * h];
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        acc[4 * jj + 2 * h] *= wr;
        acc[4 * jj + 2 * h + 1] *= wr;
      }
    }
  }
  for (int u = 0; u < 2; ++u, ++st) {
    const uint32_t sb = ring_wait<STAGES>(bars, smem, st, F::STAGE_BYTES);
    fence_acc(acc);
    wgmma_fence();
    mma_nn<T>(acc, sb + c * HALF, sb + 2 * BOX + c * HALF, sb + BOX);
    ring_retire<STAGES>(acc, bars, st, t);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  store_rows<T>(acc, dv, static_cast<const T*>(nullptr), nullptr, seq, r0,
                j0, tq, left, D);
}

template <typename T>
int launch_wg(const void* q, const void* k, const void* v, const float* lf,
              const float* li, const void* dh, const float* dc,
              const float* dn, const float* C, const float* n,
              const float* gates, const float* chunks, const void* ck,
              const float* nk, void* dq, void* dk, void* dv, float* dlf,
              float* dli, float* rows, float* y, float* qy, void* gp,
              void* gk, float* gn, float* rp, float* cp, float* ep, int BH,
              int S, int D, int plant, cudaStream_t st) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  constexpr bool f16 = std::is_same<T, __half>::value;
  const int nc = (S + WL - 1) / WL, td = (D + 127) / 128;
  const bool has_state = dc != nullptr || dn != nullptr;
  const int ncs = has_state ? nc : nc - 1;  // G_k slabs a batch * head
  const uint64_t seq[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S),
                           static_cast<uint64_t>(BH)};
  const uint64_t cdims[3] = {static_cast<uint64_t>(D),
                             static_cast<uint64_t>(D),
                             2ull * BH * (nc > 1 ? nc - 1 : 1)};
  const uint64_t kdims[3] = {static_cast<uint64_t>(D),
                             static_cast<uint64_t>(D),
                             2ull * BH * (ncs > 0 ? ncs : 1)};
  const uint64_t pdims[3] = {WL, WL, 4ull * BH * nc};
  const uint32_t b128[3] = {64, 128, 1}, b64[3] = {64, 64, 1};
  CUtensorMap tq128, tk128, tv128, tdh128, tq64, tk64, tdh64, tc128, tgp128,
      tgp64, tgk128, tgk64;
  if (!encode(fn, &tq128, q, f16, 3, seq, b128) ||
      !encode(fn, &tk128, k, f16, 3, seq, b128) ||
      !encode(fn, &tv128, v, f16, 3, seq, b128) ||
      !encode(fn, &tdh128, dh, f16, 3, seq, b128) ||
      !encode(fn, &tq64, q, f16, 3, seq, b64) ||
      !encode(fn, &tk64, k, f16, 3, seq, b64) ||
      !encode(fn, &tdh64, dh, f16, 3, seq, b64) ||
      !encode(fn, &tc128, ck, f16, 3, cdims, b128) ||
      !encode(fn, &tgp128, gp, f16, 3, pdims, b128) ||
      !encode(fn, &tgp64, gp, f16, 3, pdims, b64) ||
      !encode(fn, &tgk128, gk, f16, 3, kdims, b128) ||
      !encode(fn, &tgk64, gk, f16, 3, kdims, b64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if ((err = mlstm_wg::allow_smem(y_wg_kernel<T>, YPass::SMEM)) ||
      (err = mlstm_wg::allow_smem(intra_wg_kernel<T>, IntraB::SMEM)) ||
      (err = mlstm_wg::allow_smem(walk_wg_kernel<T>, WalkB::SMEM)) ||
      (err = mlstm_wg::allow_smem(grads_wg_kernel<T>, GradsB::SMEM)))
    return static_cast<int>(err);
  const float scale = rsqrtf(static_cast<float>(D));
  if (nc > 1) {
    y_wg_kernel<T><<<dim3(td, nc - 1, BH), WG_THREADS, YPass::SMEM, st>>>(
        tdh128, tc128, static_cast<const T*>(q), y, qy, S, D, nc, BH);
    if ((err = cudaGetLastError())) return static_cast<int>(err);
  }
  intra_wg_kernel<T><<<BH * nc, WG_THREADS, IntraB::SMEM, st>>>(
      tq128, tk128, tdh128, tv128, gates, nk, qy, static_cast<const T*>(q),
      rows, static_cast<T*>(gp), S, D, nc, BH, td, scale);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  walk_wg_kernel<T><<<dim3(td * td, BH), WG_THREADS, WalkB::SMEM, st>>>(
      tq64, tdh64, tgk64, rows, chunks, dc, dn, C, n, gn,
      has_state ? ep : nullptr, D, nc, ncs, BH, plant);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  grads_wg_kernel<T><<<dim3(td, nc, BH), WG_THREADS, GradsB::SMEM, st>>>(
      tq64, tk64, tdh64, tk128, tv128, tgp128, tgp64, tgk128, tgk64,
      static_cast<const T*>(q), static_cast<const T*>(k), gates, rows, nk, gn,
      y, static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), rp,
      cp, S, D, nc, ncs, BH, plant);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  final_kernel<<<BH, THREADS, 0, st>>>(lf, li, rp, cp, ep, dlf, dli, S, nc,
                                       WL, BH, td, has_state ? td * td : 0,
                                       plant);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace mlstm_bwd
}  // namespace repro

// The backward's simt route.  q, k, v, dh, dq, dk, dv (B*H, S, D) in
// `dtype`; log_f, log_i, dlog_f, dlog_i (B*H, S) f32; dc (B*H, D, D), dn
// (B*H, D) f32 or null.  The simt forward's recompute on the same inputs
// (the top of the file): C, n the final state, gates, chunks, ck and nk,
// all f32.  Scratch from the wrapper, nc =
// ceil(S / L), Sp = nc * L, td = ceil(D / 128), all f32: rows [B*H][4][Sp],
// gk [B*H][nc][D][D], gn [B*H][nc][D], sdm and wm [B*H][nc][L][L], y
// [B*H][Sp][D], qy, rp and cp [td][B*H][Sp], ep [B*H][td * td].  plant:
// chip_smoke.py's planted faults, 0 otherwise.  1 <= L <= 128.  Returns
// cudaGetLastError() after the last launch.
extern "C" int mlstm_chunkwise_bwd_launch(
    const void* q, const void* k, const void* v, const void* log_f,
    const void* log_i, const void* dh, const void* dc, const void* dn,
    const void* C, const void* n, const void* gates, const void* chunks,
    const void* ck, const void* nk, void* dq, void* dk, void* dv,
    void* dlog_f, void* dlog_i, void* rows, void* gk, void* gn,
    void* sdm, void* wm, void* y, void* qy, void* rp, void* cp, void* ep,
    int BH, int S, int D, int L, int dtype, int plant, void* stream) {
  if (L < 1 || L > repro::mlstm_bwd::LMAX || S < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_MLSTM_BWD(T)                                                  \
  repro::mlstm_bwd::launch<T>(                                              \
      static_cast<const T*>(q), static_cast<const T*>(k),                   \
      static_cast<const T*>(v), static_cast<const float*>(log_f),           \
      static_cast<const float*>(log_i), static_cast<const T*>(dh),          \
      static_cast<const float*>(dc), static_cast<const float*>(dn),         \
      static_cast<const float*>(C), static_cast<const float*>(n),           \
      static_cast<const float*>(gates), static_cast<const float*>(chunks),  \
      static_cast<const float*>(ck), static_cast<const float*>(nk),         \
      static_cast<T*>(dq),                                                  \
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dlog_f), \
      static_cast<float*>(dlog_i), static_cast<float*>(rows),               \
      static_cast<float*>(gk), static_cast<float*>(gn),                     \
      static_cast<float*>(sdm), static_cast<float*>(wm),                    \
      static_cast<float*>(y), static_cast<float*>(qy),                      \
      static_cast<float*>(rp), static_cast<float*>(cp),                     \
      static_cast<float*>(ep), BH, S, D, L, plant,                          \
      static_cast<cudaStream_t>(stream))
  switch (dtype) {
    case repro::kF32: return REPRO_MLSTM_BWD(float);
    case repro::kBF16: return REPRO_MLSTM_BWD(__nv_bfloat16);
    case repro::kF16: return REPRO_MLSTM_BWD(__half);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_MLSTM_BWD
}

// The backward's wgmma route (where the forward takes its own: bf16/f16, D
// % 64 == 0, chunks of 128, 16-byte-aligned q, k, v, dh).  The arguments
// of mlstm_chunkwise_bwd_launch but the chunk (128), with the forward's
// wgmma recompute: ck its C_k hi halves (lo after them, [2][B*H*max(nc-1,
// 1)][D][D] in `dtype`).  Scratch from the wrapper, nc = ceil(S / 128), Sp
// = nc * 128, td = ceil(D / 128): rows f32 [B*H][4][Sp]; y f32 [B*H][Sp]
// [D] (null where nc == 1); qy, rp, cp f32 [td][B*H][Sp]; gp (dtype) [4]
// [B*H*nc][128][128]; gk (dtype) [2][B*H*max(ncs, 1)][D][D] (ncs = nc,
// or nc - 1 where neither dc nor dn is given); gn f32 [B*H][nc][D]; ep
// f32 [B*H][td * td].  Returns cudaGetLastError() after the last launch.
extern "C" int mlstm_chunkwise_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* log_f,
    const void* log_i, const void* dh, const void* dc, const void* dn,
    const void* C, const void* n, const void* gates, const void* chunks,
    const void* ck, const void* nk, void* dq, void* dk, void* dv,
    void* dlog_f, void* dlog_i, void* rows, void* y, void* qy, void* gp,
    void* gk, void* gn, void* rp, void* cp, void* ep, int BH, int S, int D,
    int dtype, int plant, void* stream) {
  if (S < 1 || D < 64 || D % 64)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_MLSTM_BWD_WG(T)                                               \
  repro::mlstm_bwd::launch_wg<T>(                                           \
      q, k, v, static_cast<const float*>(log_f),                            \
      static_cast<const float*>(log_i), dh, static_cast<const float*>(dc),  \
      static_cast<const float*>(dn), static_cast<const float*>(C),          \
      static_cast<const float*>(n), static_cast<const float*>(gates),       \
      static_cast<const float*>(chunks), ck, static_cast<const float*>(nk), \
      dq, dk, dv, static_cast<float*>(dlog_f), static_cast<float*>(dlog_i), \
      static_cast<float*>(rows), static_cast<float*>(y),                    \
      static_cast<float*>(qy), gp, gk, static_cast<float*>(gn),             \
      static_cast<float*>(rp), static_cast<float*>(cp),                     \
      static_cast<float*>(ep), BH, S, D, plant,                             \
      static_cast<cudaStream_t>(stream))
  switch (dtype) {
    case repro::kBF16: return REPRO_MLSTM_BWD_WG(__nv_bfloat16);
    case repro::kF16: return REPRO_MLSTM_BWD_WG(__half);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_MLSTM_BWD_WG
}

// Dynamic shared memory of the backward's wgmma kernels in bytes: pass 0
// (Y), 1 (intra), 2 (walk), 3 (grads).
extern "C" int mlstm_chunkwise_bwd_wgmma_smem(int pass) {
  using namespace repro::mlstm_bwd;
  return pass == 0 ? YPass::SMEM
         : pass == 1 ? IntraB::SMEM
         : pass == 2 ? WalkB::SMEM
                     : GradsB::SMEM;
}
