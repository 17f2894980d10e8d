// RG-LRU scan for Hopper: the diagonal linear recurrence
// h_t = a_t * h_{t-1} + u_t over (B, S, D) with a float32 carry.
//
// Replaces the Pallas kernel repro/kernels/rglru.py:55 (`rglru_scan`, body
// `_rglru_kernel`).  The TPU kernel walks a (B, D/bd, S/bs) grid with time
// innermost and carries h in a VMEM scratch across the sequential time
// axis; it pads S and D to its blocks (a = 1, u = 0 past S).  Here blocks
// run in no order, so the time loop runs inside one thread per channel,
// with the carry in a register.
//
// Semantics (those of the TPU kernel): a, u and h0 are read as f32; the
// carry starts at h0 (zeros without one); each step is a product and a sum,
// each rounded to f32 (no fused multiply-add, so the result is the plain
// PyTorch version's bit for bit); h_seq is stored in a's dtype and h_last
// is the final f32 carry rounded once to a's dtype.
//
// What bounds it on an H100: bytes (3 * B * S * D elements move, 2 flops
// each).  One step's dependency chain is a multiply and an add, ~8 cycles,
// so a 4,096-step chain takes ~19 us against the 75 us its bytes take at
// the prefill's shape (B 4, S 4096, D 2560, bf16): the time axis can stay
// sequential, and exact, if enough bytes are in flight.  Two routes
// (repro_torch.kernels.rglru._route):
//
// * tma: a block of kWarps warps takes kCols = 128 channels of one batch
//   row, one a thread (80 blocks at the prefill's shape).  Thread 0 keeps a
//   ring of kStages shared-memory stages full with TMA loads of a (steps x
//   kCols) box of a and of u each (3-D tensor maps (D, S, B), so a box
//   never reads into the next batch row; TMA zero-fills past S and D), each
//   completing on its stage's mbarrier.  The threads walk a stage's rows in
//   order, kRegRows rows at a time through registers, write each rounded h
//   into a shared-memory output stage, and thread 0 stores the finished
//   stage with TMA (clipped at S and D) and refills the ring slot just
//   consumed.  The chain stops at t = S - 1: a zero-filled a would reset
//   the carry.  Boxes of 256-byte rows (bf16) and a ring of 3 measured
//   faster on an H100 than 64- or 128-byte rows spread over every SM, or
//   deeper rings.  Needs D * sizeof(T) % 16 == 0 and 16-byte-aligned bases.
// * simt: the first design, for the strides TMA refuses.  One thread owns
//   one (b, d) channel for the whole sequence and loads the next kChunk
//   steps of a and u into registers before it runs them; loads and stores
//   are coalesced across channels.
#include "hopper.cuh"

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

// ------------------------------------------------------- backward, simt
// The gradient of the scan (the TPU kernel has none): for t = S - 1 down to
// 0, with the f32 carry c (dh_last, or 0), g = dh_t + c, du_t = g,
// da_t = g * h_{t-1} (h_{-1} = h0, or 0), c = a_t * g; dh0 = c at the end.
// Each product and sum rounded to f32 (no fused multiply-add), so the
// result is the plain version's (ref.rglru_scan_bwd_ref) bit for bit.
// h_{t-1} is the forward's stored h_seq, not a recomputed f32 carry
// (repro_torch.kernels.rglru says why).  One thread owns one (b, d)
// channel and walks back kChunk steps at a time through registers.
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
    rglru_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                          const T* __restrict__ dh, const T* __restrict__ h0,
                          const T* __restrict__ dh_last, T* __restrict__ da,
                          T* __restrict__ du, T* __restrict__ dh0, int S,
                          int D) {
  const int d = blockIdx.x * kScanThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t row = static_cast<size_t>(b) * D + d;
  const size_t base = static_cast<size_t>(b) * S * D + d;
  const float hinit = h0 != nullptr ? to_f(h0[row]) : 0.f;
  float c = dh_last != nullptr ? to_f(dh_last[row]) : 0.f;
  int t = S - 1;
  for (; t + 1 >= kChunk; t -= kChunk) {  // steps t, t - 1, ..., t - kChunk + 1
    float av[kChunk], gv[kChunk], hv[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int tt = t - i;
      const size_t off = base + static_cast<size_t>(tt) * D;
      av[i] = to_f(a[off]);
      gv[i] = to_f(dh[off]);
      hv[i] = tt > 0 ? to_f(h[off - D]) : hinit;
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const size_t off = base + static_cast<size_t>(t - i) * D;
      const float g = __fadd_rn(gv[i], c);
      du[off] = from_f<T>(g);
      da[off] = from_f<T>(__fmul_rn(g, hv[i]));
      c = __fmul_rn(av[i], g);
    }
  }
  for (; t >= 0; --t) {  // the first steps, one at a time
    const size_t off = base + static_cast<size_t>(t) * D;
    const float g = __fadd_rn(to_f(dh[off]), c);
    du[off] = from_f<T>(g);
    da[off] = from_f<T>(__fmul_rn(g, t > 0 ? to_f(h[off - D]) : hinit));
    c = __fmul_rn(to_f(a[off]), g);
  }
  if (dh0 != nullptr) dh0[row] = from_f<T>(c);
}

template <typename T>
void launch_scan_bwd(const void* a, const void* h, const void* dh,
                     const void* h0, const void* dh_last, void* da, void* du,
                     void* dh0, int B, int S, int D, cudaStream_t stream) {
  dim3 grid((D + kScanThreads - 1) / kScanThreads, B);
  rglru_scan_bwd_kernel<T><<<grid, kScanThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(dh), static_cast<const T*>(h0),
      static_cast<const T*>(dh_last), static_cast<T*>(da),
      static_cast<T*>(du), static_cast<T*>(dh0), S, D);
}

// ------------------------------------------------------------------- tma
namespace scan_tma {

// Planted faults (a bit mask; must match repro_torch.kernels.ref.
// SCAN_PLANT_*), 0 on every real call.  Each acts on stage nst / 2:
// consumed one ring phase early (its load deferred until after the block
// has read the slot, which still holds the stage kStages before); its
// output store dropped; and, at the last stage, the carry run on through
// the zero-filled rows past S before h_last is taken.
enum { kPlantEarly = 1, kPlantTail = 2, kPlantStore = 4 };

constexpr int kWarps = 4;           // slabs of 32 channels a block
constexpr int kCols = 32 * kWarps;  // channels a block, one a thread
constexpr int kStageBytes = 16384;  // of a, and of u, a stage
constexpr int kStages = 3;          // ring of input stages
constexpr int kOut = 2;             // output stages
constexpr int kRegRows = 32;        // steps of a and u held in registers

template <typename T>
struct Tile {
  static constexpr int ROW = kCols * static_cast<int>(sizeof(T));
  static constexpr int R = kStageBytes / ROW;  // steps a stage: 64 (16-bit)
  static constexpr int U = R < kRegRows ? R : kRegRows;
  static constexpr int SMEM = (2 * kStages + kOut) * kStageBytes +
                              kStages * static_cast<int>(sizeof(uint64_t));
};

// One step of one channel: h = a * h + u, the product and the sum each
// rounded to f32; returns h rounded to T.
template <typename T>
__device__ __forceinline__ T step(T a, T u, float& h) {
  h = __fadd_rn(__fmul_rn(to_f(a), h), to_f(u));
  return from_f<T>(h);
}

template <typename T>
__global__ void __launch_bounds__(kCols)
    scan_kernel(__grid_constant__ const CUtensorMap tmA,
                __grid_constant__ const CUtensorMap tmU,
                __grid_constant__ const CUtensorMap tmH,
                const T* __restrict__ h0, T* __restrict__ h_last, int S,
                int D, int plant) {
  using C = Tile<T>;
  constexpr int BOX = C::R * kCols;  // elements of a stage
  extern __shared__ __align__(128) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);  // [kStages][R][kCols]
  T* su = sa + kStages * BOX;          // [kStages][R][kCols]
  T* so = su + kStages * BOX;          // [kOut][R][kCols]
  uint64_t* full = reinterpret_cast<uint64_t*>(so + kOut * BOX);

  const int t = threadIdx.x;  // channel d0 + t
  const int d0 = blockIdx.x * kCols, b = blockIdx.y, d = d0 + t;
  const int nst = (S + C::R - 1) / C::R;
  const int kp = nst / 2;  // the planted stage
  const bool early = (plant & kPlantEarly) && kp >= kStages;

  auto load = [&](int k) {  // thread 0: stage k into ring slot k % kStages
    const int s = k % kStages;
    const uint32_t bar = smem_u32(&full[s]);
    mbar_expect_tx(bar, 2 * kStageBytes);
    tma_load(smem_u32(sa + s * BOX), &tmA, d0, k * C::R, b, bar);
    tma_load(smem_u32(su + s * BOX), &tmU, d0, k * C::R, b, bar);
  };
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    mbar_init_fence();
    for (int k = 0; k < kStages && k < nst; ++k) load(k);
  }
  __syncthreads();

  float h = h0 != nullptr && d < D ? to_f(h0[static_cast<size_t>(b) * D + d])
                                   : 0.f;
  for (int k = 0; k < nst; ++k) {
    const int s = k % kStages, o = k % kOut;
    if (!(early && k == kp)) mbar_wait(smem_u32(&full[s]), (k / kStages) & 1);
    if (k >= kOut) {  // output slot o: its last store has read it
      if (t == 0) bulk_wait_read<kOut - 1>();
      __syncthreads();
    }
    // Row r of a slot is kCols consecutive elements, one a thread: a warp's
    // reads and writes of a row are free of bank conflicts.
    const T* pa = sa + s * BOX + t;
    const T* pu = su + s * BOX + t;
    T* po = so + o * BOX + t;
    const int rows = (plant & kPlantTail) ? C::R : min(C::R, S - k * C::R);
    if (rows == C::R) {
      // U rows of a and u into registers, then their steps: the loads of a
      // block of rows all precede its stores, above which the compiler could
      // not otherwise move them (the slots may alias), so a shared-memory
      // latency is paid once a block of rows, not once a step.
#pragma unroll
      for (int r0 = 0; r0 < C::R; r0 += C::U) {
        T av[C::U], uv[C::U];
#pragma unroll
        for (int i = 0; i < C::U; ++i) {
          av[i] = pa[kCols * (r0 + i)];
          uv[i] = pu[kCols * (r0 + i)];
        }
#pragma unroll
        for (int i = 0; i < C::U; ++i)
          po[kCols * (r0 + i)] = step(av[i], uv[i], h);
      }
    } else {
      for (int r = 0; r < rows; ++r)
        po[kCols * r] = step(pa[kCols * r], pu[kCols * r], h);
    }
    fence_proxy_async();  // this thread's h rows, before the async store
    __syncthreads();      // every thread has read slot s and written slot o
    if (t == 0) {
      if (!((plant & kPlantStore) && k == kp))
        tma_store(&tmH, smem_u32(so + o * BOX), d0, k * C::R, b);
      bulk_commit();  // a group per stage, empty where the store is dropped
      if (early && k == kp) {  // the deferred load, into the slot just read
        load(k);
        mbar_wait(smem_u32(&full[s]), (k / kStages) & 1);
      }
      const int next = k + kStages;
      if (next < nst && !(early && next == kp)) load(next);
    }
  }
  if (d < D) h_last[static_cast<size_t>(b) * D + d] = from_f<T>(h);
  if (t == 0) bulk_wait();  // every store has landed
}

// The backward on the forward's ring, walked from the last stage down.  A
// block of kCols channels keeps a ring of kBwdStages stages of three
// (R x kCols) boxes, a, dh and h one row behind (rows kR - 1 .. kR + R - 2:
// TMA zero-fills row -1, where h0 is read instead), each stage complete on
// one mbarrier; the threads walk a stage's rows from the last, U rows at a
// time through registers, write g and g * h_{t-1} into two output stages,
// which thread 0 stores with TMA (clipped at S and D) before refilling the
// ring slot with the stage kBwdStages further down.  Rows past S (a ragged
// last stage) are skipped.  Shared memory: 3 x 3 + 2 x 2 stages of 16 KB.
constexpr int kBwdStages = 3;

template <typename T>
struct BwdTile {
  static constexpr int R = Tile<T>::R;
  static constexpr int U = Tile<T>::U;
  static constexpr int SMEM = (3 * kBwdStages + 2 * kOut) * kStageBytes +
                              kBwdStages * static_cast<int>(sizeof(uint64_t));
};

template <typename T>
__global__ void __launch_bounds__(kCols)
    scan_bwd_kernel(__grid_constant__ const CUtensorMap tmA,
                    __grid_constant__ const CUtensorMap tmH,
                    __grid_constant__ const CUtensorMap tmG,
                    __grid_constant__ const CUtensorMap tmDA,
                    __grid_constant__ const CUtensorMap tmDU,
                    const T* __restrict__ h0, const T* __restrict__ dh_last,
                    T* __restrict__ dh0, int S, int D) {
  using C = BwdTile<T>;
  constexpr int BOX = C::R * kCols;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);  // [kBwdStages][R][kCols]
  T* sh = sa + kBwdStages * BOX;       // h_{t-1}
  T* sg = sh + kBwdStages * BOX;       // dh
  T* sda = sg + kBwdStages * BOX;      // [kOut][R][kCols]
  T* sdu = sda + kOut * BOX;
  uint64_t* full = reinterpret_cast<uint64_t*>(sdu + kOut * BOX);

  const int t = threadIdx.x;
  const int d0 = blockIdx.x * kCols, b = blockIdx.y, d = d0 + t;
  const int nst = (S + C::R - 1) / C::R;

  auto load = [&](int i) {  // thread 0: stage nst - 1 - i into slot i % n
    const int k = nst - 1 - i, s = i % kBwdStages;
    const uint32_t bar = smem_u32(&full[s]);
    mbar_expect_tx(bar, 3 * kStageBytes);
    tma_load(smem_u32(sa + s * BOX), &tmA, d0, k * C::R, b, bar);
    tma_load(smem_u32(sh + s * BOX), &tmH, d0, k * C::R - 1, b, bar);
    tma_load(smem_u32(sg + s * BOX), &tmG, d0, k * C::R, b, bar);
  };
  if (t == 0) {
    for (int s = 0; s < kBwdStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    mbar_init_fence();
    for (int i = 0; i < kBwdStages && i < nst; ++i) load(i);
  }
  __syncthreads();

  const size_t row = static_cast<size_t>(b) * D + d;
  const float hinit = h0 != nullptr && d < D ? to_f(h0[row]) : 0.f;
  float c = dh_last != nullptr && d < D ? to_f(dh_last[row]) : 0.f;
  for (int i = 0; i < nst; ++i) {
    const int k = nst - 1 - i, s = i % kBwdStages, o = i % kOut;
    mbar_wait(smem_u32(&full[s]), (i / kBwdStages) & 1);
    if (i >= kOut) {  // output slot o: its last stores have read it
      if (t == 0) bulk_wait_read<kOut - 1>();
      __syncthreads();
    }
    const T* pa = sa + s * BOX + t;
    const T* ph = sh + s * BOX + t;
    const T* pg = sg + s * BOX + t;
    T* pda = sda + o * BOX + t;
    T* pdu = sdu + o * BOX + t;
    const int rows = min(C::R, S - k * C::R);
    // h_{t-1} of the sequence's first step is h0, not TMA's zero fill.
    auto hprev = [&](int r, T hv) {
      return k == 0 && r == 0 ? hinit : to_f(hv);
    };
    if (rows == C::R) {
#pragma unroll
      for (int r0 = C::R - C::U; r0 >= 0; r0 -= C::U) {
        T av[C::U], hv[C::U], gv[C::U];
#pragma unroll
        for (int j = 0; j < C::U; ++j) {
          av[j] = pa[kCols * (r0 + j)];
          hv[j] = ph[kCols * (r0 + j)];
          gv[j] = pg[kCols * (r0 + j)];
        }
#pragma unroll
        for (int j = C::U - 1; j >= 0; --j) {
          const float g = __fadd_rn(to_f(gv[j]), c);
          pdu[kCols * (r0 + j)] = from_f<T>(g);
          pda[kCols * (r0 + j)] = from_f<T>(__fmul_rn(g, hprev(r0 + j, hv[j])));
          c = __fmul_rn(to_f(av[j]), g);
        }
      }
    } else {
      for (int r = rows - 1; r >= 0; --r) {
        const float g = __fadd_rn(to_f(pg[kCols * r]), c);
        pdu[kCols * r] = from_f<T>(g);
        pda[kCols * r] = from_f<T>(__fmul_rn(g, hprev(r, ph[kCols * r])));
        c = __fmul_rn(to_f(pa[kCols * r]), g);
      }
    }
    fence_proxy_async();  // this thread's rows, before the async stores
    __syncthreads();      // every thread has read slot s and written slot o
    if (t == 0) {
      tma_store(&tmDA, smem_u32(sda + o * BOX), d0, k * C::R, b);
      tma_store(&tmDU, smem_u32(sdu + o * BOX), d0, k * C::R, b);
      bulk_commit();
      if (i + kBwdStages < nst) load(i + kBwdStages);
    }
  }
  if (dh0 != nullptr && d < D) dh0[row] = from_f<T>(c);
  if (t == 0) bulk_wait();
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

template <typename T>
int launch(const void* a, const void* u, const void* h0, void* h_seq,
           void* h_last, int B, int S, int D, int plant,
           cudaStream_t stream) {
  using C = Tile<T>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const uint64_t dims[3] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B)};
  const uint32_t box[3] = {kCols, C::R, 1};
  auto map = [&](CUtensorMap* m, const void* ptr) {
    return encode(fn, m, ptr, map_type<T>(), sizeof(T), 3, dims, box,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
  };
  CUtensorMap ta, tu, th;
  if (!map(&ta, a) || !map(&tu, u) || !map(&th, h_seq))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err) return static_cast<int>(err);
  dim3 grid((D + kCols - 1) / kCols, B);
  scan_kernel<T><<<grid, kCols, C::SMEM, stream>>>(
      ta, tu, th, static_cast<const T*>(h0), static_cast<T*>(h_last), S, D,
      plant);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* a, const void* h, const void* dh, const void* h0,
               const void* dh_last, void* da, void* du, void* dh0, int B,
               int S, int D, cudaStream_t stream) {
  using C = BwdTile<T>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const uint64_t dims[3] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B)};
  const uint32_t box[3] = {kCols, C::R, 1};
  auto map = [&](CUtensorMap* m, const void* ptr) {
    return encode(fn, m, ptr, map_type<T>(), sizeof(T), 3, dims, box,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
  };
  CUtensorMap ta, th, tg, tda, tdu;
  if (!map(&ta, a) || !map(&th, h) || !map(&tg, dh) || !map(&tda, da) ||
      !map(&tdu, du))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err) return static_cast<int>(err);
  dim3 grid((D + kCols - 1) / kCols, B);
  scan_bwd_kernel<T><<<grid, kCols, C::SMEM, stream>>>(
      ta, th, tg, tda, tdu, static_cast<const T*>(h0),
      static_cast<const T*>(dh_last), static_cast<T*>(dh0), S, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace scan_tma
}  // namespace repro

// The simt route.  h0 may be null (a zero carry).  Returns
// cudaGetLastError() after the launch.
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

// The tma route: D * element size a multiple of 16 bytes, a, u, h_seq
// 16-byte aligned, S >= 1.  h0 may be null.  plant: chip_smoke.py's planted
// faults, 0 otherwise.  Returns cudaGetLastError() after the launch.
extern "C" int rglru_scan_tma_launch(const void* a, const void* u,
                                     const void* h0, void* h_seq,
                                     void* h_last, int B, int S, int D,
                                     int dtype, int plant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return repro::scan_tma::launch<float>(a, u, h0, h_seq, h_last, B, S, D,
                                            plant, s);
    case repro::kBF16:
      return repro::scan_tma::launch<__nv_bfloat16>(a, u, h0, h_seq, h_last,
                                                    B, S, D, plant, s);
    case repro::kF16:
      return repro::scan_tma::launch<__half>(a, u, h0, h_seq, h_last, B, S,
                                             D, plant, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tma route's tile for `dtype`: what 0, its steps a stage (where the
// planted faults act); 1, its ring's stages; 2, its dynamic shared memory
// a block in bytes.
extern "C" int rglru_scan_tma_tile(int dtype, int what) {
  using namespace repro::scan_tma;
  using F = Tile<float>;
  using H = Tile<__half>;
  const bool f32 = dtype == repro::kF32;
  return what == 0 ? (f32 ? F::R : H::R)
         : what == 1 ? kStages
                     : (f32 ? F::SMEM : H::SMEM);
}

// The backward's simt route.  h0, dh_last and dh0 may be null (dh0 is
// null exactly when h0 is).  Returns cudaGetLastError() after the launch.
extern "C" int rglru_scan_bwd_launch(const void* a, const void* h,
                                     const void* dh, const void* h0,
                                     const void* dh_last, void* da, void* du,
                                     void* dh0, int B, int S, int D,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      repro::launch_scan_bwd<float>(a, h, dh, h0, dh_last, da, du, dh0, B, S,
                                    D, s);
      break;
    case repro::kBF16:
      repro::launch_scan_bwd<__nv_bfloat16>(a, h, dh, h0, dh_last, da, du,
                                            dh0, B, S, D, s);
      break;
    case repro::kF16:
      repro::launch_scan_bwd<__half>(a, h, dh, h0, dh_last, da, du, dh0, B,
                                     S, D, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward's tma route: the forward's tma conditions on a, h, dh, da,
// du; S >= 1.  Returns cudaGetLastError() after the launch.
extern "C" int rglru_scan_bwd_tma_launch(const void* a, const void* h,
                                         const void* dh, const void* h0,
                                         const void* dh_last, void* da,
                                         void* du, void* dh0, int B, int S,
                                         int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return repro::scan_tma::launch_bwd<float>(a, h, dh, h0, dh_last, da,
                                                du, dh0, B, S, D, s);
    case repro::kBF16:
      return repro::scan_tma::launch_bwd<__nv_bfloat16>(
          a, h, dh, h0, dh_last, da, du, dh0, B, S, D, s);
    case repro::kF16:
      return repro::scan_tma::launch_bwd<__half>(a, h, dh, h0, dh_last, da,
                                                 du, dh0, B, S, D, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
