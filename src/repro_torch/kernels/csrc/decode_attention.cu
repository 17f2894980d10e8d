// Paged decode attention for Hopper: one new token per request against a
// KV pool read in place through the block table, as a split-KV
// ("flash-decoding") pair of launches.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py:78
// (`decode_attention`, body `_decode_kernel`) together with the page gather
// that repro/backends/pallas_backend.py:82 (`paged_decode_attention`) puts
// in front of it.  Here nothing is gathered: the kernel follows the table.
//
// What bounds it on an H100: bytes.  Every valid K/V row is read once
// (2 * kv_len * Hkv * D elements per request) and the arithmetic is 4 flops
// per element read.  The TPU kernel walks the positions of one (request,
// KV head) in order on one core; a block per (request, KV head) on the H100
// leaves most of the 132 SMs idle when B * Hkv is small (recurrentgemma's
// MQA decode: 8 blocks).  So the positions are cut into `splits` ranges:
//
// 1. The partial pass, grid (Hkv, B, splits).  A block walks one range of
//    positions below kv_len[b] for its (request, KV head) and serves all
//    g = Hq / Hkv query rows.  A group of LPT lanes takes one token at a
//    time: each lane loads its 16-byte chunks of the K and V rows straight
//    into registers (head_dim spread across the lanes: at D 256 in bf16 a
//    lane holds 8 elements and a whole warp takes the token), the score of
//    each query row is reduced with warp shuffles, and the lane folds the
//    token into its own f32 online softmax (running max m, sum l,
//    accumulator over its elements).  The next two tokens' rows are in
//    flight while one is scored.  The scaled queries sit in shared memory in
//    f32.  At the end the lane groups of a warp merge by shuffles, each
//    warp leaves its (m, l, acc) in shared memory, and the block folds the
//    warps in order and writes one f32 partial per query row: m, l and the
//    D-long unnormalised accumulator.
//    A range with no positions writes m = -1e30, l = 0.
// 2. The merge pass, one block per (request, query head), folds the
//    partials in split order: m = max m_i, l = sum l_i e^(m_i - m),
//    out = sum acc_i e^(m_i - m) / l, in q's dtype.  A row with kv_len == 0
//    (a batch-padding row) has l == 0 and writes 0, not NaN.  With the
//    log-sum-exp output (decode context parallelism: each rank attends its
//    slice of the cache and the ranks' pairs are merged) the pass writes
//    out unrounded in f32 and lse = m + log l, the log of the row's softmax
//    denominator over the scaled scores; a row with no position (a rank
//    whose slice holds none yet) writes out = 0 and lse = -inf, so its
//    weight in the ranks' merge is 0.
//
// `splits` (from the wrapper) depends on B, Hkv and the table's capacity
// MB * BS only, never on kv_len, so a call shape has one launch shape.  The
// mask value is -1e30 as in the Pallas kernel.  An entry outside [0, NB)
// below kv_len, or kv_len past MB * BS, is the caller's bug: the kernel
// reads nothing there and writes NaN for that (request, head) (the split
// that meets the entry writes m = NaN, the merge spreads it), so the fault
// shows as non-finite logits instead of another request's page read in
// silence.
//
// The contiguous `decode_attention` entry is the same pair with no table:
// request b's cache is block b of a pool of B blocks of BS = Smax
// positions, and kv_len past Smax is clamped (every position valid, as in
// the plain version), not poisoned.
#include "common.cuh"

namespace repro {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;        // warps of a partial-pass block
constexpr int kMergeThreads = 128;
constexpr int kMaxSplits = 512;  // must match _MAX_SPLITS in the wrapper

// One lane's share of a K or V row: CH 16-byte chunks.
template <typename T, int CH>
struct Row {
  uint4 c[CH];
};

template <typename T, int CH>
__device__ __forceinline__ void load_row(Row<T, CH>& r, const T* base,
                                         int j, int lpt, int chunks) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = j + i * lpt;
    r.c[i] = c < chunks ? __ldg(reinterpret_cast<const uint4*>(base + c * VEC))
                        : make_uint4(0, 0, 0, 0);
  }
}

template <typename T, int CH>
__device__ __forceinline__ void unpack(const Row<T, CH>& r,
                                       float (&f)[CH * (16 / sizeof(T))]) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const T* e = reinterpret_cast<const T*>(&r.c[i]);
#pragma unroll
    for (int v = 0; v < VEC; ++v) f[i * VEC + v] = to_f(e[v]);
  }
}

// G: the query rows a block can hold (>= g); CH: 16-byte chunks per lane.
template <typename T, int G, int CH>
__global__ void __launch_bounds__(kWarps * 32) decode_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ kv_len, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int Hq, int Hkv, int D, int NB, int BS,
    int MB, int chunk, int lpt, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int E = CH * VEC;  // elements of a row a lane holds
  extern __shared__ __align__(16) float sm[];
  __shared__ int bad;
  const int h = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int splits = gridDim.z;
  const int g = Hq / Hkv, chunks = D / VEC;
  float* Qs = sm;                   // [G][D] scaled queries, rows past g 0
  float* Acc = Qs + G * D;          // [kWarps][g][D] each warp's acc
  float* Ml = Acc + kWarps * g * D;  // [kWarps][g][2] its m, l; [g][2] more
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int groups = 32 / lpt, grp = lane / lpt, j = lane % lpt;
  const int workers = kWarps * groups;

  const int cap = MB * BS;
  const int len = min(max(kv_len[b], 0), cap);
  const int p0 = s * chunk, p1 = min(p0 + chunk, len);
  if (tid == 0) bad = 0;
  // Queries in float4 columns: elements 4 f .. 4 f + 3 of chunk c of row r
  // at float4 (r * Q4 + f) * chunks + c, so the lanes of a group (one chunk
  // each) read consecutive 16-byte words, without bank conflicts.
  constexpr int Q4 = VEC / 4;
  const T* qb =
      q + (static_cast<size_t>(b) * Hq + static_cast<size_t>(h) * g) * D;
  for (int i = tid; i < G * chunks; i += blockDim.x) {
    const int r = i / chunks, c = i % chunks;
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      Qs[((r * Q4 + v / 4) * chunks + c) * 4 + v % 4] =
          r < g ? to_f(qb[i * VEC + v]) * scale : 0.f;
  }
  __syncthreads();

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  // No table: the contiguous entry, request b's cache is block b.
  const int* tb = table != nullptr ? table + static_cast<size_t>(b) * MB
                                   : nullptr;
  // Load the K and V rows of position `pos` if it lies in the range; an
  // entry outside the pool is flagged and nothing is read.
  auto fetch = [&](int pos, Row<T, CH>& kr, Row<T, CH>& vr) -> bool {
    if (pos >= p1) return false;
    int blk = b, slot = pos;
    if (tb != nullptr) {
      blk = tb[pos / BS];
      slot = pos % BS;
    }
    if (blk < 0 || blk >= NB) {
      bad = 1;
      return false;
    }
    const size_t off = ((static_cast<size_t>(blk) * Hkv + h) * BS + slot) * D;
    load_row(kr, kp + off, j, lpt, chunks);
    load_row(vr, vp + off, j, lpt, chunks);
    return true;
  };

  // Every lane of a warp runs the same trip count (base is warp-uniform),
  // so the shuffles below see full warps; a group past p1 only skips its
  // update.  The rows of the next two tokens are in flight while one is
  // scored.
  Row<T, CH> kc = {}, vc = {}, k1 = {}, v1 = {}, k2 = {}, v2 = {};
  int pos = p0 + warp * groups + grp;
  bool ok = fetch(pos, kc, vc);
  bool ok1 = fetch(pos + workers, k1, v1);
  for (int base = p0 + warp * groups; base < p1; base += workers) {
    const bool ok2 = fetch(pos + 2 * workers, k2, v2);
    float kf[E], vf[E];
    unpack(kc, kf);
    unpack(vc, vf);
    // All G rows without branches (rows past g score 0 and are never
    // written), so the row chains interleave.
    float sc[G];
#pragma unroll
    for (int r = 0; r < G; ++r) {
      sc[r] = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const float4* qr = reinterpret_cast<const float4*>(Qs) +
                           r * Q4 * chunks + min(j + i * lpt, chunks - 1);
#pragma unroll
        for (int f = 0; f < Q4; ++f) {
          const float4 q4 = qr[f * chunks];
          const float* kk = kf + i * VEC + 4 * f;
          sc[r] = fmaf(q4.x, kk[0], sc[r]);
          sc[r] = fmaf(q4.y, kk[1], sc[r]);
          sc[r] = fmaf(q4.z, kk[2], sc[r]);
          sc[r] = fmaf(q4.w, kk[3], sc[r]);
        }
      }
    }
    for (int o = lpt / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int r = 0; r < G; ++r)
        sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], o);
    }
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const float m_new = ok ? fmaxf(m[r], sc[r]) : m[r];
      const float alpha = __expf(m[r] - m_new);
      const float p = ok ? __expf(sc[r] - m_new) : 0.f;
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e] * alpha);
      m[r] = m_new;
    }
    kc = k1;
    vc = v1;
    ok = ok1;
    k1 = k2;
    v1 = v2;
    ok1 = ok2;
    pos += workers;
  }

  // Merge the lane groups of each warp (shuffles); each warp then leaves
  // its (m, l, acc) in shared memory and the block folds the warps.
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (r < g) {
      for (int o = lpt; o < 32; o <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
        const float mn = fmaxf(m[r], mo);
        const float a = __expf(m[r] - mn), c = __expf(mo - mn);
        l[r] = l[r] * a + lo * c;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
          acc[r][e] = acc[r][e] * a + ao * c;
        }
        m[r] = mn;
      }
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r < g) {
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          const int ch = j + i * lpt;
          if (ch < chunks) {
            float* ar = Acc + (warp * g + r) * D + ch * VEC;
#pragma unroll
            for (int v = 0; v < VEC; ++v) ar[v] = acc[r][i * VEC + v];
          }
        }
        if (j == 0) {
          Ml[2 * (warp * g + r)] = m[r];
          Ml[2 * (warp * g + r) + 1] = l[r];
        }
      }
    }
  }
  __syncthreads();
  // Per query row: the block's max, each warp's weight e^(m_w - m) (kept
  // in place of m_w) and l, warps in order.
  float* Mr = Ml + 2 * kWarps * g;  // [g][2] the block's m, l
  for (int r = tid; r < g; r += blockDim.x) {
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, Ml[2 * (w * g + r)]);
    float ls = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float e = __expf(Ml[2 * (w * g + r)] - mx);
      ls = fmaf(Ml[2 * (w * g + r) + 1], e, ls);
      Ml[2 * (w * g + r)] = e;
    }
    Mr[2 * r] = mx;
    Mr[2 * r + 1] = ls;
  }
  __syncthreads();

  const size_t row0 = static_cast<size_t>(b) * Hq + static_cast<size_t>(h) * g;
  const float nan = __int_as_float(0x7fc00000);
  for (int r = tid; r < g; r += blockDim.x) {
    float* ml = part_ml + ((row0 + r) * splits + s) * 2;
    ml[0] = bad ? nan : Mr[2 * r];
    ml[1] = Mr[2 * r + 1];
  }
  for (int i = tid; i < g * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    for (int w = 0; w < kWarps; ++w)
      x = fmaf(Acc[(w * g + r) * D + d], Ml[2 * (w * g + r)], x);
    part_acc[((row0 + r) * splits + s) * D + d] = x;
  }
}

// out32 / lse null: the row in q's dtype to out; out32 non-null: the row in
// f32 to out32 instead, and lse (non-null with it) its log-sum-exp.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads) decode_merge_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    const int* __restrict__ kv_len, T* __restrict__ out,
    float* __restrict__ out32, float* __restrict__ lse, int Hq, int D,
    int splits, int cap, int paged) {
  // ms: each split's m, then its weight e^(m_i - m); ls: its l.
  __shared__ float ms[kMaxSplits], ls[kMaxSplits];
  __shared__ float red[2];
  const int row = blockIdx.x, b = row / Hq;
  const float* ml = part_ml + static_cast<size_t>(row) * splits * 2;
  for (int s = threadIdx.x; s < splits; s += blockDim.x) {
    ms[s] = ml[2 * s];
    ls[s] = ml[2 * s + 1];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    // The max and the NaN poisoning, by the first warp.
    float m = kNegInf;
    bool poisoned = paged && kv_len[b] > cap;
    for (int s = threadIdx.x; s < splits; s += 32) {
      poisoned |= isnan(ms[s]);
      m = fmaxf(m, ms[s]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    poisoned = __any_sync(0xffffffffu, poisoned);
    if (threadIdx.x == 0) red[0] = poisoned ? __int_as_float(0x7fc00000) : m;
  }
  __syncthreads();
  const float m = red[0];
  // Each split's weight e^(m_i - m) in parallel; l in split order.
  float* e = ms;
  for (int s = threadIdx.x; s < splits; s += blockDim.x)
    e[s] = __expf(ms[s] - m);
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.f;
    for (int s = 0; s < splits; ++s) l = fmaf(ls[s], e[s], l);
    red[1] = l;
  }
  __syncthreads();
  const float l = red[1];
  if (lse != nullptr && threadIdx.x == 0)
    lse[row] = isnan(m) ? m
                        : (l == 0.f ? -__int_as_float(0x7f800000)
                                    : m + logf(l));
  const float* acc = part_acc + static_cast<size_t>(row) * splits * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) a = fmaf(acc[s * D + d], e[s], a);
    // NaN m (poisoned) makes e and l NaN, so the row stays NaN.
    const float x = isnan(m) ? m : (l == 0.f ? 0.f : a / l);
    if (out32 != nullptr)
      out32[static_cast<size_t>(row) * D + d] = x;
    else
      out[static_cast<size_t>(row) * D + d] = from_f<T>(x);
  }
}

template <typename T, int G, int CH>
cudaError_t launch_pair(const void* q, const void* kp, const void* vp,
                        const int* table, const int* kv_len, float* part,
                        void* out, float* out32, float* lse, int B, int Hq,
                        int Hkv, int D, int NB,
                        int BS, int MB, int splits, int lpt, float scale,
                        cudaStream_t stream) {
  const int g = Hq / Hkv, cap = MB * BS;
  const int chunk = (cap + splits - 1) / splits;
  const size_t smem =
      sizeof(float) * ((G + kWarps * g) * D + 2 * (kWarps + 1) * g);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_partial_kernel<T, G, CH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  float* part_ml = part;
  float* part_acc = part + static_cast<size_t>(B) * Hq * splits * 2;
  decode_partial_kernel<T, G, CH><<<dim3(Hkv, B, splits), kWarps * 32, smem,
                                    stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, kv_len, part_ml, part_acc, Hq, Hkv, D,
      NB, BS, MB, chunk, lpt, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T><<<B * Hq, kMergeThreads, 0, stream>>>(
      part_ml, part_acc, kv_len, static_cast<T*>(out), out32, lse, Hq, D,
      splits, cap, table != nullptr);
  return cudaGetLastError();
}

// Picks G (query rows a block holds: 10 is recurrentgemma's MQA group) and
// CH (16-byte chunks per lane).
template <typename T>
cudaError_t dispatch(const void* q, const void* kp, const void* vp,
                     const int* table, const int* kv_len, float* part,
                     void* out, float* out32, float* lse, int B, int Hq,
                     int Hkv, int D, int NB, int BS, int MB, int splits,
                     float scale, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int g = Hq / Hkv, chunks = D / VEC;
  if (D % VEC || g > 16 || splits < 1 || splits > kMaxSplits)
    return cudaErrorInvalidValue;
  int ch = 1, lpt = 1;
  if (chunks <= 32) {
    while (lpt < chunks) lpt <<= 1;
  } else if (chunks % 32 == 0 && chunks <= 64) {
    ch = chunks / 32;
    lpt = 32;
  } else {
    return cudaErrorInvalidValue;
  }
#define REPRO_PAIR(GG, CC)                                                   \
  return launch_pair<T, GG, CC>(q, kp, vp, table, kv_len, part, out, out32, \
                                lse, B, Hq, Hkv, D, NB, BS, MB, splits, lpt, \
                                scale, stream)
#define REPRO_BY_G(CC)       \
  if (g <= 1) REPRO_PAIR(1, CC);  \
  if (g <= 2) REPRO_PAIR(2, CC);  \
  if (g <= 4) REPRO_PAIR(4, CC);  \
  if (g <= 8) REPRO_PAIR(8, CC);  \
  if (g <= 10) REPRO_PAIR(10, CC); \
  REPRO_PAIR(16, CC)
  if (ch == 1) {
    REPRO_BY_G(1);
  }
  REPRO_BY_G(2);
#undef REPRO_BY_G
#undef REPRO_PAIR
}

}  // namespace repro

// part: f32 scratch of B * Hq * splits * (D + 2) elements (the wrapper's
// torch.empty): m and l of every partial, then the accumulators.  table:
// (B, MB) int32, or null for the contiguous entry (NB = B, MB = 1).  out32
// and lse: null, or the f32 (B, Hq, D) output and (B, Hq) log-sum-exp that
// take out's place (out is then not written).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* kv_len, void* part, void* out, int B, int Hq, int Hkv, int D,
    int NB, int BS, int MB, int splits, float scale, int dtype, void* stream,
    void* out32, void* lse) {
  const int* tb = static_cast<const int*>(table);
  const int* kl = static_cast<const int*>(kv_len);
  float* pt = static_cast<float*>(part);
  float* o32 = static_cast<float*>(out32);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return static_cast<int>(repro::dispatch<float>(
          q, k_pool, v_pool, tb, kl, pt, out, o32, ls, B, Hq, Hkv, D, NB, BS,
          MB, splits, scale, s));
    case repro::kBF16:
      return static_cast<int>(repro::dispatch<__nv_bfloat16>(
          q, k_pool, v_pool, tb, kl, pt, out, o32, ls, B, Hq, Hkv, D, NB, BS,
          MB, splits, scale, s));
    case repro::kF16:
      return static_cast<int>(repro::dispatch<__half>(
          q, k_pool, v_pool, tb, kl, pt, out, o32, ls, B, Hq, Hkv, D, NB, BS,
          MB, splits, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
