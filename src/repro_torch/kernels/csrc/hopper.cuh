// Hopper machinery shared by the port's wgmma + TMA kernels (gemm_wgmma.cuh,
// flash_attention.cu, mlstm_chunkwise.cu) and the TMA-fed scan
// (rglru_scan.cu): mbarriers, TMA loads, stores and
// tensor maps, wgmma shared-memory descriptors and the wgmma instructions
// themselves, register hand-over between warpgroups.  Needs sm_90a.
//
// Conventions.  Every tile that wgmma reads is a 128-byte-swizzled TMA box
// of 64 16-bit columns (128 bytes a row), so 8 rows make one 1024-byte
// swizzle atom and every box starts 1024-byte aligned.  A K-major operand
// (the contraction runs along the 128-byte row) steps 16 columns = 32
// bytes a k16 step; an MN-major one (the contraction runs down the rows)
// steps 16 rows = 2048 bytes, with the next 64-column box LBO bytes on.
#pragma once

#include <cuda.h>

#include <type_traits>

#include "common.cuh"

namespace repro {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of `bar` with this parity has completed.  A phase
// that has not completed within 5 s is a fault of the kernel: trap, so the
// launch fails instead of holding the card forever.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins % 1024 == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > 5000000000ull)
        __trap();
    }
  }
}

// One 2-D box of `map` at (c0 inner, c1 outer) into shared memory at dst;
// its bytes count against the transaction count of barrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The same for a 3-D map, coordinates innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// Add a 3-D box of shared memory at src into `map`'s tensor at (c0, c1,
// c2), element by element (f32 adds in the L2); tracked by this thread's
// bulk groups.
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map,
                                               uint32_t src, int c0, int c1,
                                               int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// Store a 2-D box of shared memory at src into `map`'s tensor at (c0, c1)
// (the part of the box inside the tensor); tracked by this thread's bulk
// groups.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
// The same for a 3-D map.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until all but the newest N of this thread's bulk groups have read
// their shared memory.
template <int N = 0>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Wait until this thread's bulk groups have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (all >> 4), layout type 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// Keep the compiler from moving accumulator (or register operand) reads or
// writes across the asynchronous wgmma instructions.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Order this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma operands written by st.shared).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Hand registers from the producer warpgroup to the consumers.  Every warp
// of a warpgroup executes it together.
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Sync the `threads` threads (a multiple of 32) that use named barrier id.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------ wgmma m64nNk16
// Accumulator layout: warp w of the warpgroup holds rows 16 w + lane / 4
// and + 8; register 4 j + 2 h + e is column 8 j + 2 (lane % 4) + e of row
// + 8 h.  A register A fragment (4 x 32 bits) is mma.sync's m16n8k16 A
// fragment of the warp's 16 rows.  TA / TB = 1 marks an MN-major operand.
#define REPRO_WG_REGS_64 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31" \
  "}, "
#define REPRO_WG_OUTS_64 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31])

#define REPRO_WG_REGS_128 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63" \
  "}, "
#define REPRO_WG_OUTS_128 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define REPRO_WG_REGS_256 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, " \
  "%88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127" \
  "}, "
#define REPRO_WG_OUTS_256 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), \
  "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
  "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), \
  "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), \
  "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
  "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), \
  "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
  "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), \
  "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
  "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), \
  "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), \
  "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d (64 x 16, f32) (+)= A (64 x 16) * B (16 x 16), both from shared memory.
template <int TA, int TB, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db, int accumulate) {
#define REPRO_WG_SS(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "  \
               "{%0, %1, %2, %3, %4, %5, %6, %7}, "                         \
               "%8, %9, p, 1, 1, %11, %12;\n}\n"                           \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),            \
                 "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])             \
               : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB))
  if constexpr (std::is_same<T, __half>::value)
    REPRO_WG_SS("f16");
  else
    REPRO_WG_SS("bf16");
#undef REPRO_WG_SS
}

// d (64 x 64, f32) (+)= A (64 x 16) * B (16 x 64), both from shared memory.
template <int TA, int TB, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
#define REPRO_WG_SS(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
               REPRO_WG_REGS_64 "%32, %33, p, 1, 1, %35, %36;\n}\n"       \
               : REPRO_WG_OUTS_64                                            \
               : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB))
  if constexpr (std::is_same<T, __half>::value)
    REPRO_WG_SS("f16");
  else
    REPRO_WG_SS("bf16");
#undef REPRO_WG_SS
}

// d (64 x 64, f32) (+)= A (64 x 16, registers) * B (16 x 64, shared memory).
template <int TB, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
#define REPRO_WG_RS(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
               REPRO_WG_REGS_64 "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
               : REPRO_WG_OUTS_64                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                 "r"(accumulate), "n"(TB))
  if constexpr (std::is_same<T, __half>::value)
    REPRO_WG_RS("f16");
  else
    REPRO_WG_RS("bf16");
#undef REPRO_WG_RS
}

// d (64 x 128, f32) (+)= A (64 x 16) * B (16 x 128), both from shared memory.
template <int TA, int TB, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
#define REPRO_WG_SS(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
               REPRO_WG_REGS_128 "%64, %65, p, 1, 1, %67, %68;\n}\n"       \
               : REPRO_WG_OUTS_128                                            \
               : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB))
  if constexpr (std::is_same<T, __half>::value)
    REPRO_WG_SS("f16");
  else
    REPRO_WG_SS("bf16");
#undef REPRO_WG_SS
}

// d (64 x 128, f32) (+)= A (64 x 16, registers) * B (16 x 128, shared memory).
template <int TB, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
#define REPRO_WG_RS(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
               REPRO_WG_REGS_128 "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
               : REPRO_WG_OUTS_128                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                 "r"(accumulate), "n"(TB))
  if constexpr (std::is_same<T, __half>::value)
    REPRO_WG_RS("f16");
  else
    REPRO_WG_RS("bf16");
#undef REPRO_WG_RS
}

// d (64 x 256, f32) (+)= A (64 x 16) * B (16 x 256), both from shared memory.
template <int TA, int TB, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da,
                                         uint64_t db, int accumulate) {
#define REPRO_WG_SS(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "  \
               REPRO_WG_REGS_256 "%128, %129, p, 1, 1, %131, %132;\n}\n"       \
               : REPRO_WG_OUTS_256                                            \
               : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB))
  if constexpr (std::is_same<T, __half>::value)
    REPRO_WG_SS("f16");
  else
    REPRO_WG_SS("bf16");
#undef REPRO_WG_SS
}

// d (64 x 256, f32) (+)= A (64 x 16, registers) * B (16 x 256, shared memory).
template <int TB, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
#define REPRO_WG_RS(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "  \
               REPRO_WG_REGS_256 "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n" \
               : REPRO_WG_OUTS_256                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                 "r"(accumulate), "n"(TB))
  if constexpr (std::is_same<T, __half>::value)
    REPRO_WG_RS("f16");
  else
    REPRO_WG_RS("bf16");
#undef REPRO_WG_RS
}


#undef REPRO_WG_REGS_64
#undef REPRO_WG_OUTS_64
#undef REPRO_WG_REGS_128
#undef REPRO_WG_OUTS_128
#undef REPRO_WG_REGS_256
#undef REPRO_WG_OUTS_256

// ------------------------------------------------------------- tensor maps
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the runtime (the libraries link
// no libcuda); nullptr where the driver has none.  The driver call fails
// unless the calling thread has a current context, which the runtime binds
// only at the first of its own calls there that needs one; a thread whose
// first CUDA call is an encode (PyTorch's autograd thread, running a
// backward that starts with a TMA kernel) binds the current device's
// context here first, once.
inline EncodeTiled encode_tiled() {
  static thread_local bool bound = false;
  if (!bound) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
      return nullptr;
    bound = true;
  }
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A contiguous tensor of `rank` dims (innermost first) of `bytes`-wide
// elements, boxes of `box` elements with 128-byte swizzle (or `swizzle`);
// TMA zero-fills a box past the edges (and a reduce or a store skips
// them).
inline bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr,
                   CUtensorMapDataType type, uint64_t bytes, int rank,
                   const uint64_t* dims, const uint32_t* box,
                   CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  cuuint64_t d[5], strides[4];
  cuuint32_t b[5], elem[5];
  uint64_t stride = bytes;
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    elem[i] = 1;
    stride *= dims[i];
    if (i + 1 < rank) strides[i] = stride;
  }
  return fn(map, type, rank, const_cast<void*>(ptr), d, strides, b, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same for a 16-bit (bf16, or f16 where `f16`) tensor.
inline bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr,
                   bool f16, int rank, const uint64_t* dims,
                   const uint32_t* box) {
  return encode(fn, map, ptr,
                f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, rank, dims, box);
}

}  // namespace repro
