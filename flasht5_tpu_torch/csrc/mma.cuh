// Tensor-core and asynchronous-copy helpers shared by the port's kernels
// (fused_linear_ce.cu, quant_matmul.cu, attention.cuh, wgmma_attention.cuh):
// mma.sync m16n8k16 and the ldmatrix forms that feed it, cp.async, and
// Hopper's mbarriers, TMA tile loads and wgmma (inline PTX; K-major and
// MN-major shared-memory operands, A from registers), and the host's TMA
// descriptors.
// Nothing here launches.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ft5 {
namespace mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mma.sync m16n8k16 bf16 -> f32 and ldmatrix
// ---------------------------------------------------------------------------
//
// Fragments of m16n8k16 (g = lane / 4, tq = lane % 4): A (16 x 16) in four
// registers of two bf16 each, rows g and g + 8, columns 2 tq and 2 tq + 8;
// B (16 x 8) in two, column g, rows 2 tq and 2 tq + 8; the accumulator
// c[2h + e] is row g + 8h, column 2 tq + e.

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// two f32 as one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// cp.async (16 bytes, or fewer with the rest zero-filled)
// ---------------------------------------------------------------------------

// copies `bytes` (0..16) of src and zero-fills the rest of the 16
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// mbarrier and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
// wait until the barrier has completed the phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}
// a 2-D tile {c0 (innermost), c1} of `map` into dst, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// a 3-D tile {c0 (innermost), c1, c2} of `map` into dst, completing on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// generic-proxy writes to shared memory made visible to wgmma / TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a barrier over `threads` threads (a multiple of 32) on barrier `id` > 0
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
// a warpgroup's registers a thread, lowered or raised (all four warps of
// the warpgroup execute it)
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}
// 2^x by the special-function unit (ex2.approx.ftz: about 2 ulp; results
// below the normal range flushed to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// wgmma (sm_90a)
// ---------------------------------------------------------------------------
//
// Operands in shared memory in the 128-byte swizzled K-major layout that a
// TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes for a box 64 bf16 wide:
// row r of the tile at byte 128 r, its 16-byte chunk c at chunk c ^ (r % 8).
// The tile base must be 1024-byte aligned. A descriptor's start address
// moves 32 bytes for each k16 step inside the 64-wide row.

__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p) {
  const uint64_t addr = smem_addr(p);
  uint64_t d = 0;
  d |= (addr & 0x3FFFF) >> 4;           // start address, 16-byte units
  d |= static_cast<uint64_t>(1) << 16;  // leading byte offset (unused here)
  d |= static_cast<uint64_t>(1024 >> 4) << 32;  // 8 rows of 128 bytes
  d |= static_cast<uint64_t>(1) << 62;  // 128-byte swizzle
  return d;
}

// The same swizzled tiles read MN-major (the transpose bit set in the
// instruction): a B operand whose N runs along the 128-byte rows, as V
// (keys x D, row-major) is for O += P V, with K (the keys) down the rows.
// 8 K rows make one 1024-byte swizzle atom (the stride byte offset); the
// next 64 columns of N lie `panel_bytes` on (the leading byte offset: a
// tile 128 columns wide is two TMA boxes of 64, one panel each). A
// descriptor's start address moves 16 rows (2048 bytes) for each k16 step.
__device__ __forceinline__ uint64_t wgmma_desc_sw128_mn(const void* p,
                                                        int panel_bytes) {
  const uint64_t addr = smem_addr(p);
  uint64_t d = 0;
  d |= (addr & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((panel_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads across a wgmma wait
__device__ __forceinline__ void fence_regs(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}
template <int R>
__device__ __forceinline__ void fence_all(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) fence_regs(r[i]);
}

// d (64 x 128, f32, 64 registers a thread) += A (64 x 16) B (16 x 128),
// A and B K-major bf16 in shared memory. The accumulator of thread t
// (warp w = t / 32 of the warpgroup, g = lane / 4, tq = lane % 4):
// d[4j + 2h + e] is row 16 w + g + 8h, column 8j + 2tq + e.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x N, f32, N / 2 registers a thread, the layout of
// wgmma_m64n128k16's) += A (64 x 16) B (16 x N), for N of 32, 64 and 128.
// ss: A K-major from shared memory (descriptor da); rs: A from registers,
// a[0..3] the mma.sync m16n8k16 A fragment of the warp's 16 rows (rows g
// and g + 8, columns 2 tq and 2 tq + 8), exactly the accumulator's
// (row, column pair) entries of 16 columns packed to bf16. B from shared
// memory: K-major (TB 0, wgmma_desc_sw128) or MN-major (TB 1,
// wgmma_desc_sw128_mn). scale_d 0 writes d = A B (d is not read).
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  template <int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, "
      "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, "
      "1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, "
      "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, "
      "%19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  template <int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, "
      "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, "
      "%33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, "
      "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, "
      "%33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  template <int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, "
      "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, "
      "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
  }
};

// ---------------------------------------------------------------------------
// TMA descriptors (host)
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (no link against libcuda)
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

inline EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// a row-major (rows, cols) array of `elem` bytes, boxes of (box_rows,
// box_cols), zeros outside
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type,
                     const void* ptr, int rows, int cols, int elem,
                     int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// planes of a row-major (rows, cols) array, one after the other (an
// (n_planes, rows, cols) array of `elem` bytes), boxes of (1, box_rows,
// box_cols): rows past `rows` of a plane read as zeros, never the next
// plane's
inline bool make_map_3d(CUtensorMap* map, CUtensorMapDataType type,
                        const void* ptr, int n_planes, int rows, int cols,
                        int elem, int box_rows, int box_cols,
                        CUtensorMapSwizzle swizzle) {
  EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n_planes)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * elem,
      static_cast<cuuint64_t>(rows) * cols * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace mma
}  // namespace ft5
