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
//   - A third variant for the compute-bound LM shapes (M, N >= 128, many
//     groups: chatglm3-6b's w_up is 8192 x 4096 x 13696, ~1700 int8
//     operations a byte, above the card's ridge of ~590), where the walk
//     above reaches 4% of the int8 rate:
//       wgmma - mls_matmul_decode turns both operands' codes into int8
//               fractions once, K-major and contiguous (x as (M, K), w as
//               (N, K), from any strides), into a scratch the wrapper
//               allocates; mls_matmul_wgmma then gives each block a 128 x
//               128 output tile: one producer warp keeps a ring of
//               kWgStages TMA loads in flight (128 bytes of k a stage, a
//               whole group at k_block 128, and the stage's group scales),
//               and two consumer warpgroups each run four
//               wgmma.m64n128k32.s32.s8.s8 a stage on their 64 rows (the
//               first of a group with scale-d 0), then fold the group's
//               int32 dot into their fp32 sums in k order, as the walk
//               does.  The warpgroups take the tensor cores in turns, so
//               that one's fold runs while the other's wgmmas do.
//               Blocks take their tiles in bands of row tiles, so that the
//               blocks resident at once share operand strips in L2.
//     What bounds it: the 128 x 128 tiles re-read the operands from L2
//     (about 7 GB at chatglm3-6b's w_up GEMMs, against 0.09 GB of codes),
//     and the fold is 5 fp32-pipe operations an output (exact int->float,
//     two products, one add), more issue slots a group than its wgmmas
//     take cycles; not the int8 rate.  Its building blocks are in
//     mls_wgmma.cuh.
// Group scales come in any compact layout (sg_shapes) through strides, 0
// along a broadcast axis.  -fmad=false keeps each product and sum rounded
// on its own (mls_common.cuh).
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mls_common.cuh"
#include "mls_mma.cuh"
#include "mls_wgmma.cuh"

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

// ---------------------------------------------------------------------------
// wgmma variant
// ---------------------------------------------------------------------------
constexpr int kWgBM = 128;     // output rows per block: 2 consumer warpgroups x 64
constexpr int kWgBN = 128;     // output columns per block (wgmma n)
constexpr int kWgBK = 128;     // k bytes per stage: one 128-byte swizzle row
constexpr int kWgStages = 4;   // ring depth
constexpr int kWgThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kWgGroupM = 8;   // row tiles that neighbouring blocks share (L2 reuse)
constexpr int kWgTile = kWgBM * kWgBK;  // bytes of one operand tile (= kWgBN * kWgBK)
constexpr int kDecRows = 128;  // decode: rows per block
constexpr int kDecK = 128;     // decode: k per block
constexpr int kDecThreads = 256;  // decode: 4 x 16 bytes a thread

struct WgSmem {
  uint8_t a[kWgStages][kWgTile];  // x fractions, rows x 128 k (1024-aligned)
  uint8_t b[kWgStages][kWgTile];  // w fractions, columns x 128 k
  float sx[kWgStages][kWgBM];     // the stage's group scales of the block's rows
  float sw[kWgStages][kWgBN];     // ... and columns
  uint64_t full[kWgStages];       // tiles and scales landed
  uint64_t empty[kWgStages];      // consumers done with the stage
};
constexpr int kWgSmemBytes = sizeof(WgSmem) + 1024;  // + slack to align to 1024

struct WgArgs {
  const float* xsg;
  long long sxsg_m, sxsg_g;
  const float* wsg;
  long long swsg_g, swsg_n;
  const float* xst;
  const float* wst;
  float unit;
  float* out;
  int M, N, K, k_block;
};

// Decode pass: blockIdx.z 0 turns x (M, K) at strides (sr, sk) into x
// fractions (M, K), 1 turns w (K, N) into (N, K); a block decodes kDecRows
// rows x kDecK k, four 16-byte pieces a thread.  A k-contiguous, 16-byte
// aligned operand takes 16-byte loads (all four in flight at once) and
// stores; any other layout is read along its smaller stride into shared
// memory and stored k-contiguous from there.
struct DecArgs {
  const uint8_t* src[2];
  long long sr[2], sk[2];
  int rows[2];
  bool vec[2];
  int8_t* dst[2];
  int K, e, m;
};

__global__ void __launch_bounds__(kDecThreads) mls_matmul_decode(const DecArgs a) {
  constexpr int kChunks = kDecK / 16;                        // 16-byte pieces of a row
  constexpr int kPer = kDecRows * kChunks / kDecThreads;     // pieces a thread
  constexpr int kRowStep = kDecThreads / kChunks;            // rows between a thread's pieces
  const int op = blockIdx.z, R = a.rows[op];
  const int row0 = blockIdx.y * kDecRows;
  if (row0 >= R) return;  // the other operand's taller grid
  __shared__ int lut[256];
  __shared__ __align__(16) int8_t tile[kDecRows][kDecK + 16];
  for (int i = threadIdx.x; i < 256; i += kDecThreads) lut[i] = mls::decode_frac(i, a.e, a.m);
  const uint8_t* src = a.src[op];
  const long long sr = a.sr[op], sk = a.sk[op], k0 = (long long)blockIdx.x * kDecK;
  const int r = threadIdx.x / kChunks, kk = (threadIdx.x % kChunks) * 16;
  int8_t* dst = a.dst[op] + k0 + kk;
  if (a.vec[op]) {  // all loads in flight before the table is read
    uint4 v[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int row = row0 + r + u * kRowStep;
      v[u] = row < R ? *reinterpret_cast<const uint4*>(src + row * sr + k0 + kk) : uint4{};
    }
    __syncthreads();  // lut
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int row = row0 + r + u * kRowStep;
      if (row < R)
        *reinterpret_cast<uint4*>(dst + (long long)row * a.K) =
            make_uint4(mls::decode4(lut, v[u].x), mls::decode4(lut, v[u].y),
                       mls::decode4(lut, v[u].z), mls::decode4(lut, v[u].w));
    }
    return;
  }
  __syncthreads();  // lut
  for (int t = threadIdx.x; t < kDecRows * kDecK; t += kDecThreads) {
    int rr, k;
    if (sk <= sr) {
      rr = t / kDecK;
      k = t % kDecK;
    } else {
      k = t / kDecRows;
      rr = t % kDecRows;
    }
    tile[rr][k] = row0 + rr < R ? (int8_t)lut[src[(row0 + rr) * sr + (k0 + k) * sk]] : 0;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int rr = r + u * kRowStep;
    if (row0 + rr < R)
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + rr) * a.K) =
          *reinterpret_cast<const uint4*>(&tile[rr][kk]);
  }
}

// Main pass: a kWgBM x kWgBN output tile per block over every group in
// order.  Warp 0 produces, warpgroups 1 and 2 consume (rows 0-63, 64-127).
// The grid is 1-D: block b takes its tile in kWgGroupM-row-tile bands, down
// a band's rows first, so the blocks resident at once share few row and
// column strips of the operands in L2.  The consumers take the tensor
// cores in turns (named barriers 1 and 2): warpgroup 1 issues stage q,
// then warpgroup 2 issues it, then warpgroup 1 stage q + 1, so that one
// warpgroup's fold runs while the other's wgmmas do.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

__global__ void __launch_bounds__(kWgThreads, 1)
    mls_matmul_wgmma(__grid_constant__ const CUtensorMap tmap_x,
                     __grid_constant__ const CUtensorMap tmap_w, const WgArgs a) {
  namespace wg = mls::wg;
  extern __shared__ uint8_t smem_raw[];
  WgSmem& s = *reinterpret_cast<WgSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int group = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int tm = (a.M + kWgBM - 1) / kWgBM, tn = (a.N + kWgBN - 1) / kWgBN;
  const int band = blockIdx.x / (kWgGroupM * tn), in_band = blockIdx.x % (kWgGroupM * tn);
  const int band_rows = min(tm - band * kWgGroupM, kWgGroupM);
  const int row0 = (band * kWgGroupM + in_band % band_rows) * kWgBM;
  const int col0 = (in_band / band_rows) * kWgBN;
  const int stages = a.K / kWgBK, per_group = a.k_block / kWgBK;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      wg::mbar_init(&s.full[i], 32);  // the producer warp's lanes
      wg::mbar_init(&s.empty[i], 8);  // one lane of each consumer warp
    }
    wg::fence_barrier_init();
  }
  __syncthreads();

  if (group == 0) {  // producer warpgroup: warp 0 works, warps 1-3 leave
    wg::setmaxnreg_dec<40>();
    if (tid >= 32) return;
    const int lane = tid;
    if (lane == 0) {
      wg::prefetch_tensormap(&tmap_x);
      wg::prefetch_tensormap(&tmap_w);
    }
    // the next stage's scales are loaded while this one waits for its slot
    constexpr int kPer = kWgBM / 32;
    float vx[kPer], vw[kPer];
    auto load_scales = [&](int q) {
      const int g = q / per_group;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int r = row0 + lane + 32 * u, c = col0 + lane + 32 * u;
        vx[u] = r < a.M ? a.xsg[r * a.sxsg_m + g * a.sxsg_g] : 0.0f;
        vw[u] = c < a.N ? a.wsg[g * a.swsg_g + c * a.swsg_n] : 0.0f;
      }
    };
    load_scales(0);
    for (int q = 0; q < stages; ++q) {
      const int st = q % kWgStages;
      wg::mbar_wait(&s.empty[st], ((q / kWgStages) & 1) ^ 1);  // the first round passes
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        s.sx[st][lane + 32 * u] = vx[u];
        s.sw[st][lane + 32 * u] = vw[u];
      }
      if (lane == 0) {
        wg::mbar_arrive_expect_tx(&s.full[st], 2 * kWgTile);
        wg::tma_load_2d(s.a[st], &tmap_x, &s.full[st], q * kWgBK, row0);
        wg::tma_load_2d(s.b[st], &tmap_w, &s.full[st], q * kWgBK, col0);
      } else {
        wg::mbar_arrive(&s.full[st]);
      }
      if (q + 1 < stages) load_scales(q + 1);
    }
    return;
  }

  wg::setmaxnreg_inc<232>();
  const int c = group - 1;  // this warpgroup's 64 rows of the tile
  const int warp = tid / 32, lane = tid % 32;
  const int rl = c * 64 + warp * 16 + lane / 4;  // tile rows rl and rl + 8
  const int cq = 2 * (lane % 4);                 // columns 8j + cq + {0, 1}
  int p[64];
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    p[i] = 0;
    acc[i] = 0.0f;
  }
  for (int q = 0; q < stages; ++q) {
    const int st = q % kWgStages;
    wg::mbar_wait(&s.full[st], (q / kWgStages) & 1);
    const bool first = q % per_group == 0;
    const uint64_t da = wg::sw128_desc(s.a[st] + c * 64 * kWgBK);
    const uint64_t db = wg::sw128_desc(s.b[st]);
    if (c == 0 ? q > 0 : true) bar_sync(c == 0 ? 2 : 1);  // my turn on the tensor cores
    wg::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kWgBK / 32; ++k)  // 32 bytes of k: +2 in the descriptor's 16-byte units
      wg::wgmma_m64n128k32_s8(p, da + 2 * k, db + 2 * k, first && k == 0 ? 0 : 1);
    wg::wgmma_commit();
    bar_arrive(c == 0 ? 1 : 2);  // the other warpgroup's turn
    wg::wgmma_wait<0>();
    wg::fence_operands(p);
    if (q % per_group == per_group - 1) {  // the group's dot is complete: its term
      const float sx_lo = s.sx[st][rl], sx_hi = s.sx[st][rl + 8];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 sw = *reinterpret_cast<const float2*>(&s.sw[st][8 * j + cq]);
        // mls::group_combine's roundings, with float(p) taken exactly on the fp32 pipes
        acc[4 * j] = __fadd_rn(acc[4 * j], __fmul_rn(wg::exact_float(p[4 * j]),
                                                     __fmul_rn(sx_lo, sw.x)));
        acc[4 * j + 1] = __fadd_rn(acc[4 * j + 1], __fmul_rn(wg::exact_float(p[4 * j + 1]),
                                                             __fmul_rn(sx_lo, sw.y)));
        acc[4 * j + 2] = __fadd_rn(acc[4 * j + 2], __fmul_rn(wg::exact_float(p[4 * j + 2]),
                                                             __fmul_rn(sx_hi, sw.x)));
        acc[4 * j + 3] = __fadd_rn(acc[4 * j + 3], __fmul_rn(wg::exact_float(p[4 * j + 3]),
                                                             __fmul_rn(sx_hi, sw.y)));
      }
    }
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&s.empty[st]);  // tiles and scales read: refill the slot
  }
  if (c == 0) bar_sync(2);  // warpgroup 2's last turn
  const float scale = mls::tensor_scale(*a.xst, *a.wst, a.unit);
  const bool pairs = (a.N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + rl + 8 * h;
    if (r >= a.M) continue;
    float* o = a.out + (long long)r * a.N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * j + cq;
      const float v0 = __fmul_rn(acc[4 * j + 2 * h], scale);
      const float v1 = __fmul_rn(acc[4 * j + 2 * h + 1], scale);
      if (pairs && col + 1 < a.N) {
        *reinterpret_cast<float2*>(o + col) = make_float2(v0, v1);
      } else {
        if (col < a.N) o[col] = v0;
        if (col + 1 < a.N) o[col + 1] = v1;
      }
    }
  }
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime so that
// the library links against nothing new.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a K-contiguous (rows, K) int8 matrix in kWgBK x 128-row
// boxes, 128-byte swizzle, zeros past the edge.
bool tile_map(CUtensorMap* map, const int8_t* base, int rows, int K) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)kWgBK, 128u};
  const cuuint32_t elem[2] = {1u, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// The tile constants, in the order kBM, kKStep, kThreads, kSumThreads,
// kWgBM, kWgBN, kWgBK, kWgStages, kDecRows, kDecK, for the launch
// descriptors (kernels/mls_matmul.py launch_spec) to read from the binary.
extern "C" int mls_matmul_constants(int* out, int n) {
  const int c[] = {kBM, kKStep, kThreads, kSumThreads, kWgBM, kWgBN, kWgBK, kWgStages,
                   kDecRows, kDecK};
  constexpr int kCount = sizeof(c) / sizeof(c[0]);
  for (int i = 0; i < n && i < kCount; ++i) out[i] = c[i];
  return kCount;
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

// The wgmma variant: the decode pass of both operands into `scratch`
// ((M + N) * K bytes, allocated by the caller: x fractions (M, K), then w
// fractions (N, K)), then the main pass.  k_block must be a multiple of
// kWgBK, and |a group's dot| < 2^22 (the caller's plan checks both).
extern "C" int mls_matmul_wgmma_call(const uint8_t* xc, long long sxm, long long sxk,
                                     const float* xsg, long long sxsg_m, long long sxsg_g,
                                     const uint8_t* wc, long long swk, long long swn,
                                     const float* wsg, long long swsg_g, long long swsg_n,
                                     const float* xst, const float* wst, float unit, float* out,
                                     uint8_t* scratch, int M, int N, int K, int k_block, int e,
                                     int m, void* stream) {
  if (k_block <= 0 || k_block % kWgBK || K % k_block || !scratch)
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const long long tm = (M + kWgBM - 1) / kWgBM, tn = (N + kWgBN - 1) / kWgBN;
  const unsigned dec_rows = ((M > N ? M : N) + kDecRows - 1) / kDecRows;
  if (tm * tn > 0x7fffffffLL || dec_rows > kMaxGridYZ) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* xd = reinterpret_cast<int8_t*>(scratch);
  int8_t* wd = xd + (long long)M * K;
  DecArgs d;
  d.src[0] = xc; d.sr[0] = sxm; d.sk[0] = sxk; d.rows[0] = M; d.dst[0] = xd;
  d.src[1] = wc; d.sr[1] = swn; d.sk[1] = swk; d.rows[1] = N; d.dst[1] = wd;
  d.vec[0] = sxk == 1 && sxm % 16 == 0 && aligned16(xc);
  d.vec[1] = swk == 1 && swn % 16 == 0 && aligned16(wc);
  d.K = K; d.e = e; d.m = m;
  mls_matmul_decode<<<dim3(K / kDecK, dec_rows, 2), kDecThreads, 0, s>>>(d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tx, tw;
  if (!tile_map(&tx, xd, M, K) || !tile_map(&tw, wd, N, K)) return (int)cudaErrorInvalidValue;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  static bool smem_set[64] = {};  // the attribute, once per device
  if (device >= 64 || !smem_set[device]) {
    err = cudaFuncSetAttribute(mls_matmul_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWgSmemBytes);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) smem_set[device] = true;
  }
  WgArgs a;
  a.xsg = xsg; a.sxsg_m = sxsg_m; a.sxsg_g = sxsg_g;
  a.wsg = wsg; a.swsg_g = swsg_g; a.swsg_n = swsg_n;
  a.xst = xst; a.wst = wst; a.unit = unit; a.out = out;
  a.M = M; a.N = N; a.K = K; a.k_block = k_block;
  mls_matmul_wgmma<<<(unsigned)(tm * tn), kWgThreads, kWgSmemBytes, s>>>(tx, tw, a);
  return (int)cudaGetLastError();
}
