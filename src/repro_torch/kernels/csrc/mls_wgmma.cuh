// Hopper building blocks of K3's wgmma variant (mls_matmul.cu): mbarriers,
// TMA 2-D tile loads, the int8 warpgroup MMA from shared memory, register
// rebalancing, and the exact int32 -> fp32 conversion of a group's dot.
//
// Layout: every operand tile is K-major int8, 128 bytes of k per row (one
// 128-byte swizzle row), loaded by TMA with CU_TENSOR_MAP_SWIZZLE_128B into
// a 1024-byte aligned buffer, so 8 rows form one 1024-byte swizzle atom.
// The wgmma descriptor of such a tile (sw128_desc) says so: layout 128B
// swizzle, 1024 bytes between 8-row groups.  A k step of 32 bytes inside
// the 128-byte row advances the descriptor's start address by 32 bytes,
// the swizzle being applied by the hardware to the address bits.
//
// Accumulator layout of wgmma.m64n128k32 (as mma.sync's m16n8 per n8
// tile): thread t of the warpgroup (warp w = t / 32, lane l) holds
// d[4j + 0..1] at row 16w + l/4, columns 8j + 2(l%4) + {0, 1}, and
// d[4j + 2..3] eight rows below, for j = 0..15.
#pragma once

#include <cuda.h>

#include <cstdint>

namespace mls {
namespace wg {

// a wait longer than this (ns) traps: a hang becomes a launch error
constexpr unsigned long long kWatchdogNs = 20ull * 1000 * 1000 * 1000;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// ---- mbarriers ----------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(addr), "r"(parity)
      : "memory");
  return ok != 0;
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const unsigned long long t0 = globaltimer();
  while (!mbar_try_wait(addr, parity))
    if (globaltimer() - t0 > kWatchdogNs) __trap();
}

// ---- TMA ------------------------------------------------------------------
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// The box at (c0 along the inner dimension, c1 along the outer) of `map`
// into `dst`; completion counted in bytes on `bar`.  Elements past the
// tensor's edge arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------
// Descriptor of a K-major tile in the 128-byte swizzle (1024-byte atoms).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t start = (smem_u32(tile) & 0x3FFFF) >> 4;
  return start | (1ull << 16) | ((1024ull >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// d (+)= A (64 x 32 bytes) . B (128 x 32 bytes)^T, s8 x s8 -> s32, both
// operands K-major in shared memory; scale_d 0 starts the sum at zero.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
// Keeps the compiler from moving reads of d above the last wgmma_wait.
__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---- register rebalancing between warpgroups -------------------------------
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// float(p), exactly, for |p| < 2^22, on the fp32 pipes instead of the
// quarter-rate I2F: 1.5 * 2^23 has an ulp of 1, so adding p to its bits
// adds p to its value, and subtracting 1.5 * 2^23 again is exact.
__device__ __forceinline__ float exact_float(int p) {
  return __fsub_rn(__int_as_float(0x4B400000 + p), 12582912.0f);
}

}  // namespace wg
}  // namespace mls
