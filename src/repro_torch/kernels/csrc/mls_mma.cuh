// The integer group dot shared by the quantized-domain GEMM (mls_matmul.cu,
// K3) and the implicit conv (implicit_conv.cu, K4): cp.async staging of
// raw codes, their decoding through the 256-entry fraction table, and the
// exact dot of one k chunk on int8 tensor cores (mma.sync.m16n8k16) or,
// for formats whose fractions exceed int8, on CUDA cores in int32.
//
// Layout (both bodies): a warp owns 16 rows of the A operand, As[r * KCP
// + k] for r < 16, and the B operand's columns Bs[n * KCP + k] (k-major
// per column).  Thread (gid = lane / 4, tig = lane % 4) holds the m16n8
// accumulator of each n8 tile t: p[t][0..1] at row gid, columns 8t + 2tig
// + {0, 1}; p[t][2..3] at row gid + 8.  Integer sums are exact, so the two
// bodies give the same numbers.
#pragma once

#include <cstdint>

namespace mls {

constexpr int kKStep = 16;  // MMA k step (m16n8k16)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Four codes (one byte each of v) decoded to int8 fractions, packed.
__device__ __forceinline__ uint32_t decode4(const int* lut, uint32_t v) {
  return (lut[v & 0xFF] & 0xFF) | (lut[(v >> 8) & 0xFF] & 0xFF) << 8 |
         (lut[(v >> 16) & 0xFF] & 0xFF) << 16 | (uint32_t)lut[v >> 24] << 24;
}

// Stage `rows` rows x KC bytes of one operand's chunk into raw[row * pitch
// + k] with THREADS threads: element (row0 + r, kof + k) at row stride sr
// and k stride sk; rows past `limit` and k past `kw` read as code 0
// (fraction 0).  async: sk == 1, 16-byte aligned rows, chunk starts and
// pitch, kw % 16 == 0.
template <int KC, int THREADS>
__device__ __forceinline__ void stage_operand(uint8_t* raw, int pitch, const uint8_t* src,
                                              long long sr,
                                              long long sk, int rows, int row0, int limit,
                                              long long kof, int kw, bool async) {
  if (async) {
    constexpr int kPieces = KC / 16;
    for (int t = threadIdx.x; t < rows * kPieces; t += THREADS) {
      const int r = t / kPieces, kp = (t % kPieces) * 16;
      if (kp >= kw) continue;  // past the group: never read
      const bool ok = row0 + r < limit;
      const uint8_t* g = ok ? src + (long long)(row0 + r) * sr + kof + kp : src;
      cp_async16(raw + r * pitch + kp, g, ok ? 16 : 0);
    }
  } else {
    for (int t = threadIdx.x; t < rows * KC; t += THREADS) {
      int r, k;
      if (sk == 1) {
        r = t / KC;
        k = t % KC;
      } else {
        k = t / rows;
        r = t % rows;
      }
      const int gr = row0 + r;
      raw[r * pitch + k] = (gr < limit && k < kw) ? src[(long long)gr * sr + (kof + k) * sk] : 0;
    }
  }
}

// p += the warp's exact dot over the first kw (<= KC) k of one chunk:
// int8 MMAs in 16-wide k steps (entries past kw must be zero) or int32
// multiply-adds on CUDA cores.  As: the warp's 16 A rows; Bs: NT * 8
// columns; both at pitch KCP elements of type Dec (int8_t or int).
template <bool kMma, int KC, int NT, typename Dec>
__device__ __forceinline__ void group_dot(int (&p)[NT][4], const Dec* As, const Dec* Bs,
                                          int KCP, int gid, int tig, int kw) {
  if constexpr (kMma) {
    const int steps = (kw + kKStep - 1) / kKStep;
#pragma unroll
    for (int s = 0; s < KC / kKStep; ++s) {
      if (s < steps) {
        const int k0 = s * kKStep + tig * 4;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(As + gid * KCP + k0);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(As + (gid + 8) * KCP + k0);
#pragma unroll
        for (int t = 0; t < NT; ++t)
          mma_s8(p[t], a0, a1, *reinterpret_cast<const uint32_t*>(Bs + (t * 8 + gid) * KCP + k0));
      }
    }
  } else {
    for (int k = 0; k < kw; ++k) {
      const int a_lo = As[gid * KCP + k], a_hi = As[(gid + 8) * KCP + k];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int b0 = Bs[(t * 8 + 2 * tig) * KCP + k];
        const int b1 = Bs[(t * 8 + 2 * tig + 1) * KCP + k];
        p[t][0] += a_lo * b0;
        p[t][1] += a_lo * b1;
        p[t][2] += a_hi * b0;
        p[t][3] += a_hi * b1;
      }
    }
  }
}

}  // namespace mls
