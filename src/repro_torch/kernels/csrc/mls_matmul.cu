// Quantized-domain GEMM (paper Eq. 6-8) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/mls_matmul.py _kernel (K3):
// out (M, N) = sum over k-blocks g, in order, of
//   (int dot of the decoded codes of group g) * (s_g^x[row, g] * s_g^w[g, col])
// then times (s_t^x * s_t^w) * 2^(2(e_min - M)).  The reference order is
//   acc = +0.0f;  for g: acc = fl(acc + fl(float(p_g) * fl(sx_g * sw_g)));
//   out = fl(acc * fl(fl(xst * wst) * unit))
// and every launch below keeps it: the same products and the same
// additions in the same order, so the result is bit-identical to
// kernels/ref.py mls_matmul_ref by construction.
//
// Bound: device memory.  A code is one byte and the integer work is
// 2*M*N*K operations, about 30 per byte moved on the main path's shapes,
// far below the card's int8 ridge; the deep weight-gradient GEMMs
// (K = N*OH*OW up to 131072, M = C*9 <= 576, N <= 64) have only 3-9
// output tiles, so a block per tile walking every group left most SMs idle.
// Design:
//   - Two variants of one main loop, chosen in Python
//     (kernels/mls_matmul.py matmul_plan) from the tile count against the
//     132 SMs and the workspace size:
//       walk  - a block owns an output tile and walks the groups in order,
//               adding each group's term to its fp32 sum (many output
//               tiles, or one group: forward and data-gradient GEMMs);
//       split - phase 1 (mls_matmul_terms): a block per (row tile, column
//               tile, group), all parallel, stores the rounded term
//               fl(float(p) * fl(sx * sw)) to a workspace T (G, M, N);
//               phase 2 (mls_matmul_sum): a thread per output element adds
//               T[0..G-1] in k order from +0.0f, then applies the tensor
//               scale.  The stage-1 weight gradient runs 3072 blocks in
//               phase 1 instead of 3.
//   - int8 tensor cores: a decoded fraction is an integer with
//     |F| <= max_fraction (124 for <2,4>, 12 for <2,1>, 15 for <0,4>), so a
//     group's dot is an exact s8 x s8 -> s32 mma.sync.m16n8k16.  The k step
//     16 divides 128 and 144, so k_block 144 wastes no slots.  mma.sync,
//     not wgmma: these shapes are bound by bytes, a 64-row wgmma tile buys
//     nothing at N = 16, and mma.sync keeps one register layout for the
//     int8 and int32 bodies.  Formats with max_fraction > 127 (<3,1>: 192,
//     <2,5>: 252) take the int32 CUDA-core body instead: a dispatch on the
//     format made in Python, not a fallback.  Both bodies give each thread
//     the same outputs (the m16n8 accumulator layout), so the epilogues are
//     shared.
//   - The tile's N extent (16, 32 or 64) follows N, so a 16-wide GEMM does
//     not compute 48 columns of zeros.
//   - Staging: two stages of raw codes in shared memory, filled with
//     cp.async (16 B, zero-filled past the ragged edge) while the previous
//     chunk is decoded through the 256-entry table into int8 (int32 for the
//     int32 body) in the layout the MMA reads.  An operand whose k axis is
//     not contiguous and 16-byte aligned, or a k_block that is not a
//     multiple of 16, is staged with plain loads instead (any strides:
//     the weight may arrive K-major or N-major).  The staging, the decode
//     and both dot bodies live in mls_mma.cuh, shared with K4.
// Group scales come in any compact layout (sg_shapes) through strides, 0
// along a broadcast axis.  -fmad=false keeps each product and sum rounded
// on its own (mls_common.cuh).
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mls_common.cuh"
#include "mls_mma.cuh"

namespace {

constexpr int kBM = 64;         // output rows per block: 4 warps x 16
constexpr int kKStep = mls::kKStep;  // MMA k step (m16n8k16)
constexpr int kThreads = 128;   // 4 warps
constexpr int kSumThreads = 64; // phase 2: one thread per output element
constexpr int kSumUnroll = 32;  // terms in flight per phase-2 thread
constexpr int kMaxGridYZ = 65535;

struct Args {
  const uint8_t* xc;
  long long sxm, sxk;
  const float* xsg;
  long long sxsg_m, sxsg_g;
  const uint8_t* wc;
  long long swk, swn;
  const float* wsg;
  long long swsg_g, swsg_n;
  const float* xst;
  const float* wst;
  float unit;
  float* out;    // walk: (M, N)
  float* terms;  // split: T (G, M, N)
  int M, N, K, k_block, e, m;
  bool x_async, w_async;  // stage the operand with cp.async
};

// One CTA: a kBM x BN output tile over groups [g_begin, g_end).  kMma: the
// int8 tensor-core body (else int32 on CUDA cores).  kSplit: each group's
// term goes to T (phase 1), else into the block's fp32 sum (walk).
template <int BN, bool kMma, bool kSplit>
__device__ __forceinline__ void matmul_tile(const Args& a, int g_begin, int g_end) {
  constexpr int KC = kMma ? 64 : 32;        // k bytes staged per chunk
  constexpr int KCP = kMma ? KC + 16 : KC + 1;  // decoded row pitch (elements)
  constexpr int NT = BN / 8;                // n8 tiles per warp
  constexpr int kRows = kBM + BN;           // A rows then B columns
  using Dec = typename std::conditional<kMma, int8_t, int>::type;

  __shared__ int lut[256];
  __shared__ __align__(16) uint8_t raw[2][kRows * KC];
  __shared__ __align__(16) Dec dec[kRows * KCP];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * BN;
  for (int i = tid; i < 256; i += kThreads) lut[i] = mls::decode_frac(i, a.e, a.m);

  const int n_chunks = (a.k_block + KC - 1) / KC;  // per group
  const int total = (g_end - g_begin) * n_chunks;
  auto stage = [&](int q) {
    if (q < total) {
      const int g = g_begin + q / n_chunks, c = q % n_chunks;
      const long long kof = (long long)g * a.k_block + c * KC;
      const int kw = min(KC, a.k_block - c * KC);
      uint8_t* s = raw[q % 2];
      mls::stage_operand<KC, kThreads>(s, KC, a.xc, a.sxm, a.sxk, kBM, row0, a.M, kof, kw,
                                       a.x_async);
      mls::stage_operand<KC, kThreads>(s + kBM * KC, KC, a.wc, a.swn, a.swk, BN, col0, a.N, kof,
                                       kw, a.w_async);
    }
    mls::cp_async_commit();  // one group per chunk, empty past the end
  };

  int p[NT][4];
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[t][i] = 0;
      acc[t][i] = 0.0f;
    }
  // this thread's outputs: rows r_lo, r_lo + 8; columns col0 + 8t + 2tig + {0, 1}
  const int r_lo = row0 + warp * 16 + gid, r_hi = r_lo + 8;

  __syncthreads();  // lut
  stage(0);
  stage(1);
  for (int q = 0; q < total; ++q) {
    mls::cp_async_wait<1>();  // chunk q has landed (this thread's copies)
    __syncthreads();       // ... everyone's; the last chunk's MMAs are done
    {  // decode raw stage q % 2 -> dec, 4 codes per step
      const uint32_t* src = reinterpret_cast<const uint32_t*>(raw[q % 2]);
      for (int t = tid; t < kRows * (KC / 4); t += kThreads) {
        const int r = t / (KC / 4), w = t % (KC / 4);
        const uint32_t v = src[t];
        if constexpr (kMma) {
          *reinterpret_cast<uint32_t*>(dec + r * KCP + w * 4) = mls::decode4(lut, v);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) dec[r * KCP + w * 4 + i] = lut[(v >> (8 * i)) & 0xFF];
        }
      }
    }
    __syncthreads();  // dec ready; raw stage q % 2 is free
    stage(q + 2);
    const int g = g_begin + q / n_chunks, c = q % n_chunks;
    const int kw = min(KC, a.k_block - c * KC);
    const Dec* As = dec + warp * 16 * KCP;
    const Dec* Bs = dec + kBM * KCP;
    mls::group_dot<kMma, KC, NT>(p, As, Bs, KCP, gid, tig, kw);
    if (c == n_chunks - 1) {  // the group's dot is complete: its term
      const float sx_lo = r_lo < a.M ? a.xsg[r_lo * a.sxsg_m + g * a.sxsg_g] : 0.0f;
      const float sx_hi = r_hi < a.M ? a.xsg[r_hi * a.sxsg_m + g * a.sxsg_g] : 0.0f;
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = col0 + t * 8 + 2 * tig + j;
          const float sw = col < a.N ? a.wsg[g * a.swsg_g + col * a.swsg_n] : 0.0f;
          if constexpr (kSplit) {
            float* tg = a.terms + (long long)g * a.M * a.N;
            if (col < a.N && r_lo < a.M)
              tg[(long long)r_lo * a.N + col] = mls::group_term(p[t][j], sx_lo, sw);
            if (col < a.N && r_hi < a.M)
              tg[(long long)r_hi * a.N + col] = mls::group_term(p[t][2 + j], sx_hi, sw);
          } else {
            acc[t][j] = mls::group_combine(acc[t][j], p[t][j], sx_lo, sw);
            acc[t][2 + j] = mls::group_combine(acc[t][2 + j], p[t][2 + j], sx_hi, sw);
          }
          p[t][j] = 0;
          p[t][2 + j] = 0;
        }
    }
  }
  if constexpr (!kSplit) {
    const float st = mls::tensor_scale(*a.xst, *a.wst, a.unit);
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = col0 + t * 8 + 2 * tig + j;
        if (col < a.N && r_lo < a.M) a.out[(long long)r_lo * a.N + col] = __fmul_rn(acc[t][j], st);
        if (col < a.N && r_hi < a.M)
          a.out[(long long)r_hi * a.N + col] = __fmul_rn(acc[t][2 + j], st);
      }
  }
}

// walk: grid (row tiles, column tiles); every group in order.
template <int BN, bool kMma>
__global__ void __launch_bounds__(kThreads) mls_matmul_walk(const Args a) {
  matmul_tile<BN, kMma, false>(a, 0, a.K / a.k_block);
}

// split, phase 1: grid (row tiles, column tiles, groups); one group each.
template <int BN, bool kMma>
__global__ void __launch_bounds__(kThreads) mls_matmul_terms(const Args a) {
  matmul_tile<BN, kMma, true>(a, blockIdx.z, blockIdx.z + 1);
}

// split, phase 2: out[i] = fl(sum_g T[g, i] in k order from +0.0f) * scale.
__global__ void __launch_bounds__(kSumThreads) mls_matmul_sum(const float* __restrict__ terms,
                                                              long long mn, int groups,
                                                              const float* __restrict__ xst,
                                                              const float* __restrict__ wst,
                                                              float unit,
                                                              float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= mn) return;
  const float* t = terms + i;
  float acc = 0.0f;
  int g = 0;
  for (; g + kSumUnroll <= groups; g += kSumUnroll) {
    float v[kSumUnroll];  // loads in flight; the adds stay in order
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u) v[u] = __ldcs(t + (long long)(g + u) * mn);
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u) acc = __fadd_rn(acc, v[u]);
  }
  for (; g < groups; ++g) acc = __fadd_rn(acc, __ldcs(t + (long long)g * mn));
  out[i] = __fmul_rn(acc, mls::tensor_scale(*xst, *wst, unit));
}

template <int BN, bool kMma>
cudaError_t launch(const Args& a, bool split, cudaStream_t s) {
  const unsigned tm = (a.M + kBM - 1) / kBM, tn = (a.N + BN - 1) / BN;
  if (tn > kMaxGridYZ) return cudaErrorInvalidValue;
  if (!split) {
    mls_matmul_walk<BN, kMma><<<dim3(tm, tn), kThreads, 0, s>>>(a);
    return cudaGetLastError();
  }
  const int groups = a.K / a.k_block;
  if (groups > kMaxGridYZ) return cudaErrorInvalidValue;
  mls_matmul_terms<BN, kMma><<<dim3(tm, tn, groups), kThreads, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long mn = (long long)a.M * a.N;
  mls_matmul_sum<<<(unsigned)((mn + kSumThreads - 1) / kSumThreads), kSumThreads, 0, s>>>(
      a.terms, mn, groups, a.xst, a.wst, a.unit, a.out);
  return cudaGetLastError();
}

template <bool kMma>
cudaError_t launch_bn(const Args& a, int bn, bool split, cudaStream_t s) {
  switch (bn) {
    case 16: return launch<16, kMma>(a, split, s);
    case 32: return launch<32, kMma>(a, split, s);
    case 64: return launch<64, kMma>(a, split, s);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// The tile constants, in the order kBM, kKStep, kThreads, kSumThreads, for
// the launch descriptors (kernels/mls_matmul.py launch_spec) to read from
// the binary.
extern "C" int mls_matmul_constants(int* out, int n) {
  const int c[] = {kBM, kKStep, kThreads, kSumThreads};
  for (int i = 0; i < n && i < 4; ++i) out[i] = c[i];
  return 4;
}

// body: 0 = int8 tensor cores, 1 = int32 CUDA cores; split: 1 = terms into
// `terms` (G*M*N floats, allocated by the caller) then the ordered sum,
// 0 = walk (`terms` unused).  bn: the tile's N extent, 16, 32 or 64.
extern "C" int mls_matmul(const uint8_t* xc, long long sxm, long long sxk,
                          const float* xsg, long long sxsg_m, long long sxsg_g,
                          const uint8_t* wc, long long swk, long long swn,
                          const float* wsg, long long swsg_g, long long swsg_n,
                          const float* xst, const float* wst, float unit,
                          float* out, float* terms, int M, int N, int K, int k_block,
                          int e, int m, int bn, int body, int split, void* stream) {
  if (k_block <= 0 || K % k_block || (body != 0 && body != 1))
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (split && !terms) return (int)cudaErrorInvalidValue;
  Args a;
  a.xc = xc; a.sxm = sxm; a.sxk = sxk;
  a.xsg = xsg; a.sxsg_m = sxsg_m; a.sxsg_g = sxsg_g;
  a.wc = wc; a.swk = swk; a.swn = swn;
  a.wsg = wsg; a.swsg_g = swsg_g; a.swsg_n = swsg_n;
  a.xst = xst; a.wst = wst; a.unit = unit;
  a.out = out; a.terms = terms;
  a.M = M; a.N = N; a.K = K; a.k_block = k_block; a.e = e; a.m = m;
  // cp.async needs 16-byte pieces: k contiguous, rows and groups 16-aligned
  a.x_async = sxk == 1 && k_block % 16 == 0 && sxm % 16 == 0 && aligned16(xc);
  a.w_async = swk == 1 && k_block % 16 == 0 && swn % 16 == 0 && aligned16(wc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      body == 0 ? launch_bn<true>(a, bn, split != 0, s) : launch_bn<false>(a, bn, split != 0, s);
  return (int)err;
}
