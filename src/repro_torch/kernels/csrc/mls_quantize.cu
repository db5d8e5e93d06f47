// MLS dynamic quantization (paper Alg. 2) for Hopper.
//
// Replaces the TPU kernels of src/repro/kernels/mls_quantize.py:
//   K1 _kernel_rowwise  (groupings "nc" and "n": group scales in the kernel)
//   K2 _kernel_given_sg (groupings "c" and "none": scales given to it)
//
// Bound: device memory.  Per element K1 must read 4 B of x and 1 B of
// rounding bytes and write a 1 B code (plus 4 B per group); its few dozen
// integer/float operations are far below the card's compute rate.
// K1 design, two passes of one C call (mls_quantize_rows), about 10 B of
// traffic per element:
//   pass A (quantize_amax): a fixed grid of up to 2 x 132 blocks strides
//     over x with 16-byte loads and writes one partial max |x| per block.
//     Max is exact in any order, so no atomics are needed, and NaN
//     propagates as in torch.amax (fmaxf would drop it).
//   pass B (quantize_groups_warp): every block first reduces the partials
//     (about 1 KB, from L2) to the tensor scale s_t = max > 0 ? max : 1,
//     block 0 stores it, and the warps then stride over the groups.  A warp
//     loads its group once into registers (float4 x and 4 rounding bytes
//     per 32-bit load: 32 lanes x 4 for a 128-wide group), takes the group
//     max from them and codes from the same registers, storing 4 codes per
//     32-bit store.  Groups
//     wider than kWarpGroupMax ("n": a whole row, up to N*OH*OW = 131072)
//     take a block each (quantize_groups_block) with the same loads; such a
//     group does not fit the block's registers, so it reads x twice, the
//     second time mostly from L2.  Widths that are not a multiple of 4
//     (or unaligned operands) take the same kernels with scalar accesses.
// K2 ("c": a group is k_block columns over all rows; "none": one group)
// makes its scales on the card too, in one C call (mls_quantize_cols) and
// no PyTorch op; the TPU computed them in XLA before its pallas_call:
//   pass A: partial column maxima of |x| (quantize_cols_amax: a thread
//     owns 4 columns and walks rows, P row slices x column tiles, about
//     2 x 132 blocks), or for one group K1's quantize_amax;
//   a reduction: a block per column group (quantize_cols_reduce), then one
//     block makes s_t and every s_g (quantize_scales), so a code block
//     reads one scale, not P x G partials;
//   the code pass (quantize_codes): a thread owns 4 columns for the whole
//     launch, so its group scale and s_t * s_g are loaded and multiplied
//     once, with no per-element index arithmetic (no i % K); per row a
//     float4 of x, 32 bits of rounding bytes, one 32-bit store of 4 codes.
//     Widths off 4 (the implicit "none" path's (N*C*Hp, Wp) operand) take
//     the same passes with scalar accesses.
// mls_quantize_given_sg is the code pass alone, for callers that bring
// s_t and s_g.  K2 is bound by its element arithmetic (one IEEE division
// per element, as K1's pass B) more than by its 6 B per element.  Results
// are bit-identical to the plain version (kernels/ref.py quantize_ref):
// see mls_common.cuh.
#include <cuda_runtime.h>

#include <cstdint>

#include "mls_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpGroupMax = 1024;      // wider groups take a block each
constexpr int kAmaxBlocks = 2 * 132;     // pass A's grid at most
constexpr int kAmaxChunk = kThreads * 16;  // elements a block reads per stride step
constexpr int kRowBlocks = 8 * 132;      // pass B (warp per group) grid at most
constexpr int kColAmaxBlocks = 2 * 132;  // K2 "c" pass A: blocks aimed at
constexpr int kCodeBlocks = 8 * 132;     // K2 code pass: blocks aimed at

// m, nan_max'ed with the four |q|
__device__ __forceinline__ float abs_max4(float m, float4 q) {
  m = mls::nan_max(m, mls::abs_bits(q.x));
  m = mls::nan_max(m, mls::abs_bits(q.y));
  m = mls::nan_max(m, mls::abs_bits(q.z));
  return mls::nan_max(m, mls::abs_bits(q.w));
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Pass A: partials[b] = max |x| over block b's stride steps.
__global__ void __launch_bounds__(kThreads) quantize_amax(const float* __restrict__ x,
                                                          long long n, bool vec,
                                                          float* __restrict__ partials) {
  __shared__ float red[kWarps + 1];
  float m = 0.0f;
  for (long long base = (long long)blockIdx.x * kAmaxChunk; base < n;
       base += (long long)gridDim.x * kAmaxChunk) {
    if (vec && base + kAmaxChunk <= n) {
      float4 v[4];  // four 16-byte loads in flight
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = reinterpret_cast<const float4*>(x + base)[u * kThreads + threadIdx.x];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        m = abs_max4(m, v[u]);
    } else {
      for (long long i = base + threadIdx.x; i < n && i < base + kAmaxChunk; i += kThreads)
        m = mls::nan_max(m, mls::abs_bits(x[i]));
    }
  }
  m = mls::block_max<kThreads>(m, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = m;
}

// Pass B's prologue: s_t from pass A's partials (0 -> 1, NaN -> 1, as
// quantize_ref's torch.where(s_t > 0, s_t, 1)); block 0 stores it.
__device__ __forceinline__ float tensor_scale_of(const float* __restrict__ partials,
                                                 int n_partials, float* __restrict__ s_t_out,
                                                 float* red) {
  float m = 0.0f;
  for (int i = threadIdx.x; i < n_partials; i += kThreads) m = mls::nan_max(m, partials[i]);
  m = mls::block_max<kThreads>(m, red);
  const float s_t = mls::tensor_scale_of_max(m);
  if (blockIdx.x == 0 && threadIdx.x == 0) *s_t_out = s_t;
  return s_t;
}

// Pass B, a warp per (row, group) of width gw <= 128 * S; warps stride over
// the M * (K / gw) groups.  Element i of a lane's 4*S registers is group
// element (i/4)*128 + lane*4 + i%4 (vec: float4 and 32-bit accesses) or
// i*32 + lane (scalar).
template <int S>
__global__ void __launch_bounds__(kThreads) quantize_groups_warp(
    const float* __restrict__ x, const uint8_t* __restrict__ r,
    const float* __restrict__ partials, int n_partials, float* __restrict__ s_t_out,
    uint8_t* __restrict__ codes, float* __restrict__ s_g_out, long long M, long long K,
    int gw, bool vec, mls::Fmt f) {
  __shared__ float red[kWarps + 1];
  const float s_t = tensor_scale_of(partials, n_partials, s_t_out, red);
  const int lane = threadIdx.x % 32;
  const long long per_row = K / gw, groups = M * per_row;
  for (long long gid = (long long)blockIdx.x * kWarps + threadIdx.x / 32; gid < groups;
       gid += (long long)gridDim.x * kWarps) {  // uniform across the warp
    const long long base = (gid / per_row) * K + (gid % per_row) * gw;
    float v[4 * S];
    uint32_t rb[S];  // byte u of rb[s]: the rounding byte of element 4s + u
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (vec) {
        const int j = s * 128 + lane * 4;
        const bool in = j < gw;
        const float4 q = in ? *reinterpret_cast<const float4*>(x + base + j)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        rb[s] = in ? *reinterpret_cast<const uint32_t*>(r + base + j) : 0u;
        v[4 * s] = q.x; v[4 * s + 1] = q.y; v[4 * s + 2] = q.z; v[4 * s + 3] = q.w;
      } else {
        rb[s] = 0u;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = (4 * s + u) * 32 + lane;
          v[4 * s + u] = j < gw ? x[base + j] : 0.0f;
          rb[s] |= (j < gw ? (uint32_t)r[base + j] : 0u) << (8 * u);
        }
      }
    }
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < 4 * S; ++i) amax = mls::nan_max(amax, mls::abs_bits(v[i]));
    amax = mls::warp_max(amax);
    const float s_g = mls::group_scale(mls::scale_ratio(amax, s_t), f);
    if (lane == 0) s_g_out[gid] = s_g;
    const float denom = __fmul_rn(s_t, s_g);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      uint32_t c = 0u;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        c |= (uint32_t)mls::element_code(v[4 * s + u], (rb[s] >> (8 * u)) & 0xFF, denom, f)
             << (8 * u);
      if (vec) {
        const int j = s * 128 + lane * 4;
        if (j < gw) *reinterpret_cast<uint32_t*>(codes + base + j) = c;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = (4 * s + u) * 32 + lane;
          if (j < gw) codes[base + j] = (c >> (8 * u)) & 0xFF;
        }
      }
    }
  }
}

// Pass B for wide groups: one block per (row, group).
__global__ void __launch_bounds__(kThreads) quantize_groups_block(
    const float* __restrict__ x, const uint8_t* __restrict__ r,
    const float* __restrict__ partials, int n_partials, float* __restrict__ s_t_out,
    uint8_t* __restrict__ codes, float* __restrict__ s_g_out, long long K, int gw, bool vec,
    mls::Fmt f) {
  __shared__ float red[kWarps + 1];
  const float s_t = tensor_scale_of(partials, n_partials, s_t_out, red);
  const long long per_row = K / gw, gid = blockIdx.x;
  const long long base = (gid / per_row) * K + (gid % per_row) * gw;
  const int step = vec ? 4 * kThreads : kThreads;
  float amax = 0.0f;
  for (int j = vec ? 4 * threadIdx.x : threadIdx.x; j < gw; j += step) {
    if (vec) {
      const float4 q = *reinterpret_cast<const float4*>(x + base + j);
      amax = abs_max4(amax, q);
    } else {
      amax = mls::nan_max(amax, mls::abs_bits(x[base + j]));
    }
  }
  __syncthreads();  // red is reused
  amax = mls::block_max<kThreads>(amax, red);
  const float s_g = mls::group_scale(mls::scale_ratio(amax, s_t), f);
  if (threadIdx.x == 0) s_g_out[gid] = s_g;
  const float denom = __fmul_rn(s_t, s_g);
  for (int j = vec ? 4 * threadIdx.x : threadIdx.x; j < gw; j += step) {
    if (vec) {
      const float4 q = *reinterpret_cast<const float4*>(x + base + j);
      const uchar4 b = *reinterpret_cast<const uchar4*>(r + base + j);
      *reinterpret_cast<uchar4*>(codes + base + j) = make_uchar4(
          mls::element_code(q.x, b.x, denom, f), mls::element_code(q.y, b.y, denom, f),
          mls::element_code(q.z, b.z, denom, f), mls::element_code(q.w, b.w, denom, f));
    } else {
      codes[base + j] = mls::element_code(x[base + j], r[base + j], denom, f);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: groupings "c" (k_block columns over all rows) and "none"
// ---------------------------------------------------------------------------
// The column tiling of K2's column passes.  A thread owns one slot of V
// columns (V = 4 with float4 / 32-bit accesses, else 1) for the whole
// launch and walks rows; a block is RB row lanes x S slots (S a power of
// two from 32 to kThreads) and covers column tile blockIdx.x.  Row
// iteration `it` of a block is rows it * RB .. it * RB + RB - 1; block
// (ct, p) takes iterations p, p + P, p + 2P, ...  So a thread's column,
// group and group scale are fixed: no per-element index arithmetic.
struct ColTiling {
  int v, s, rb, ct, p;
  long long iters;
};

__host__ __device__ __forceinline__ ColTiling col_tiling(long long M, int K, bool vec,
                                                         int target_blocks) {
  ColTiling t;
  t.v = vec ? 4 : 1;
  const int slots = (K + t.v - 1) / t.v;
  t.s = 32;
  while (t.s < slots && t.s < kThreads) t.s <<= 1;
  t.rb = kThreads / t.s;
  t.ct = (slots + t.s - 1) / t.s;
  t.iters = (M + t.rb - 1) / t.rb;
  long long p = (target_blocks + t.ct - 1) / t.ct;
  if (p > t.iters) p = t.iters;
  t.p = p < 1 ? 1 : (int)p;
  return t;
}

constexpr int kColUnroll = 4;  // row iterations whose loads are in flight together

// "c" pass A: part[p, col] = max |x[row, col]| over the rows of row slice
// p (blockIdx.y).  NaN kept (mls::nan_max).
__global__ void __launch_bounds__(kThreads) quantize_cols_amax(const float* __restrict__ x,
                                                               long long M, int K,
                                                               ColTiling t,
                                                               float* __restrict__ part) {
  __shared__ float buf[kThreads * 4];
  const int ls = threadIdx.x % t.s, lr = threadIdx.x / t.s;
  const int col = (blockIdx.x * t.s + ls) * t.v;
  float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (col < K) {
    for (long long it0 = blockIdx.y; it0 < t.iters; it0 += (long long)kColUnroll * t.p) {
      float4 q[kColUnroll];
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u) {
        const long long row = (it0 + (long long)u * t.p) * t.rb + lr;
        q[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (it0 + (long long)u * t.p < t.iters && row < M) {
          if (t.v == 4) q[u] = *reinterpret_cast<const float4*>(x + row * K + col);
          else q[u].x = x[row * K + col];
        }
      }
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u) {
        m[0] = mls::nan_max(m[0], mls::abs_bits(q[u].x));
        m[1] = mls::nan_max(m[1], mls::abs_bits(q[u].y));
        m[2] = mls::nan_max(m[2], mls::abs_bits(q[u].z));
        m[3] = mls::nan_max(m[3], mls::abs_bits(q[u].w));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) buf[threadIdx.x * 4 + u] = m[u];
  __syncthreads();
  if (lr == 0 && col < K) {
    for (int u = 0; u < t.v && col + u < K; ++u) {
      float v = buf[ls * 4 + u];
      for (int r = 1; r < t.rb; ++r) v = mls::nan_max(v, buf[(r * t.s + ls) * 4 + u]);
      part[(long long)blockIdx.y * K + col + u] = v;
    }
  }
}

// "c" reduction: gmax[g] = max of part[0..P), columns of group g.
__global__ void __launch_bounds__(kThreads) quantize_cols_reduce(
    const float* __restrict__ part, int P, int K, int gw, float* __restrict__ gmax) {
  __shared__ float red[kWarps + 1];
  const int g = blockIdx.x;
  float m = 0.0f;
  for (int i = threadIdx.x; i < P * gw; i += kThreads) {
    const int p = i / gw, j = i - p * gw;
    m = mls::nan_max(m, part[(long long)p * K + (long long)g * gw + j]);
  }
  m = mls::block_max<kThreads>(m, red);
  if (threadIdx.x == 0) gmax[g] = m;
}

// The scales, one block: vals holds G runs of `per` partial maxima (one
// run per scaling group); mls::scales_of_maxima makes s_t and every s_g.
__global__ void __launch_bounds__(kThreads) quantize_scales(const float* __restrict__ vals,
                                                            int G, int per,
                                                            float* __restrict__ s_t_out,
                                                            float* __restrict__ s_g,
                                                            mls::Fmt f) {
  __shared__ float red[kWarps + 1];
  mls::scales_of_maxima<kThreads>(vals, G, per, s_t_out, s_g, f, red);
}

// The code pass: codes of x against s_t and the compact group scale
// s_g[(col / gw) * sg_stride] (stride 0: one scale).  A thread's V
// columns lie in one group (vec needs gw % 4 == 0), so it loads its scale
// once; per row it loads a float4 of x and 32 bits of rounding bytes and
// stores 4 codes in one 32-bit store (scalar: one of each).
__global__ void __launch_bounds__(kThreads) quantize_codes(
    const float* __restrict__ x, const uint8_t* __restrict__ r,
    const float* __restrict__ s_t_ptr, const float* __restrict__ s_g, int gw, int sg_stride,
    uint8_t* __restrict__ codes, long long M, int K, ColTiling t, mls::Fmt f) {
  const int ls = threadIdx.x % t.s, lr = threadIdx.x / t.s;
  const int col = (blockIdx.x * t.s + ls) * t.v;
  if (col >= K) return;
  const float denom = __fmul_rn(*s_t_ptr, s_g[(col / gw) * sg_stride]);
  for (long long it0 = blockIdx.y; it0 < t.iters; it0 += 2LL * t.p) {
    float4 q[2];
    uint32_t rb[2];
    bool in[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // two rows' loads in flight
      const long long row = (it0 + (long long)u * t.p) * t.rb + lr;
      in[u] = it0 + (long long)u * t.p < t.iters && row < M;
      const long long at = in[u] ? row * K + col : 0;
      if (t.v == 4) {
        q[u] = *reinterpret_cast<const float4*>(x + at);
        rb[u] = *reinterpret_cast<const uint32_t*>(r + at);
      } else {
        q[u].x = x[at];
        rb[u] = r[at];
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (!in[u]) continue;
      const long long at = ((it0 + (long long)u * t.p) * t.rb + lr) * K + col;
      if (t.v == 4) {
        const uint32_t c = (uint32_t)mls::element_code(q[u].x, rb[u] & 0xFF, denom, f) |
                           (uint32_t)mls::element_code(q[u].y, (rb[u] >> 8) & 0xFF, denom, f)
                               << 8 |
                           (uint32_t)mls::element_code(q[u].z, (rb[u] >> 16) & 0xFF, denom, f)
                               << 16 |
                           (uint32_t)mls::element_code(q[u].w, rb[u] >> 24, denom, f) << 24;
        *reinterpret_cast<uint32_t*>(codes + at) = c;
      } else {
        codes[at] = mls::element_code(q[u].x, (uint8_t)rb[u], denom, f);
      }
    }
  }
}

mls::Fmt make_fmt(int e, int m, int e_min, int gs_m, int gs_emin) {
  mls::Fmt f;
  f.e = e;
  f.m = m;
  f.e_min = e_min;
  f.gs_m = gs_m;
  f.gs_emin = gs_emin;
  return f;
}

}  // namespace

// The launch constants, in the order kThreads, kWarpGroupMax, kAmaxBlocks,
// kAmaxChunk, kRowBlocks, kColAmaxBlocks, kCodeBlocks, for the launch
// descriptors (kernels/mls_quantize.py launch_spec_rows / launch_spec_cols
// / launch_spec_given_sg) to read from the binary.
extern "C" int mls_quantize_constants(int* out, int n) {
  const int c[] = {kThreads, kWarpGroupMax, kAmaxBlocks, kAmaxChunk, kRowBlocks,
                   kColAmaxBlocks, kCodeBlocks};
  for (int i = 0; i < n && i < 7; ++i) out[i] = c[i];
  return 7;
}

extern "C" const char* mls_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1: pass A into `partials` (n_partials floats: min(kAmaxBlocks,
// ceil(M*K / kAmaxChunk)), at least 1), then pass B, which stores s_t,
// the codes and the (M, K / group_width) group scales.
extern "C" int mls_quantize_rows(const float* x, const uint8_t* r, float* partials,
                                 int n_partials, float* s_t, uint8_t* codes, float* s_g,
                                 long long M, long long K, int group_width, int e, int m,
                                 int e_min, int gs_m, int gs_emin, void* stream) {
  const long long n = M * K;
  if (group_width <= 0 || K % group_width || n_partials < 1 || n_partials > kAmaxBlocks)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const mls::Fmt f = make_fmt(e, m, e_min, gs_m, gs_emin);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  quantize_amax<<<n_partials, kThreads, 0, s>>>(x, n, aligned(x, 16), partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long groups = M * (K / group_width);
  const bool vec = group_width % 4 == 0 && aligned(x, 16) && aligned(r, 4) &&
                   aligned(codes, 4);
  if (group_width <= kWarpGroupMax) {
    long long blocks = (groups + kWarps - 1) / kWarps;
    if (blocks > kRowBlocks) blocks = kRowBlocks;
    const int slots = (group_width + 127) / 128;
#define ROWS_WARP(S)                                                              \
  quantize_groups_warp<S><<<(unsigned)blocks, kThreads, 0, s>>>(                   \
      x, r, partials, n_partials, s_t, codes, s_g, M, K, group_width, vec, f)
    if (slots <= 1) ROWS_WARP(1);
    else if (slots <= 2) ROWS_WARP(2);
    else if (slots <= 4) ROWS_WARP(4);
    else ROWS_WARP(8);
#undef ROWS_WARP
  } else {
    quantize_groups_block<<<(unsigned)groups, kThreads, 0, s>>>(
        x, r, partials, n_partials, s_t, codes, s_g, K, group_width, vec, f);
  }
  return (int)cudaGetLastError();
}

// K2, the scales and the codes of grouping "c" (group_width = k_block,
// G = K / k_block column groups) or "none" (group_width = K, G = 1).  With
// G > 1: pass A quantize_cols_amax into `part` (P x K partial column
// maxima, P = col_tiling(M, K, vec, kColAmaxBlocks).p), the reduction
// quantize_cols_reduce into `gmax` (G floats), quantize_scales; with
// G = 1: K1's pass A quantize_amax into `part` (n_part = min(kAmaxBlocks,
// ceil(M*K / kAmaxChunk)) floats), quantize_scales.  Then the code pass.
// It stores s_t, s_g (G floats) and the codes.  vec: float4 / 32-bit
// accesses (K and group_width multiples of 4, x 16-byte and r, codes
// 4-byte aligned).
extern "C" int mls_quantize_cols(const float* x, const uint8_t* r, float* part,
                                 long long n_part, float* gmax, float* s_t, uint8_t* codes,
                                 float* s_g, long long M, int K, int group_width, int vec,
                                 int e, int m, int e_min, int gs_m, int gs_emin, void* stream) {
  if (M <= 0 || K <= 0 || group_width <= 0 || K % group_width) return (int)cudaErrorInvalidValue;
  if (vec && (K % 4 || group_width % 4 || !aligned(x, 16) || !aligned(r, 4) ||
              !aligned(codes, 4)))
    return (int)cudaErrorInvalidValue;
  const mls::Fmt f = make_fmt(e, m, e_min, gs_m, gs_emin);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = K / group_width;
  const long long n = M * K;
  cudaError_t err;
  if (G == 1) {
    long long parts = (n + kAmaxChunk - 1) / kAmaxChunk;
    if (parts > kAmaxBlocks) parts = kAmaxBlocks;
    if (n_part != parts) return (int)cudaErrorInvalidValue;
    quantize_amax<<<(unsigned)parts, kThreads, 0, s>>>(x, n, aligned(x, 16), part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    quantize_scales<<<1, kThreads, 0, s>>>(part, 1, (int)parts, s_t, s_g, f);
  } else {
    const ColTiling ta = col_tiling(M, K, vec != 0, kColAmaxBlocks);
    if (n_part != (long long)ta.p * K || !gmax) return (int)cudaErrorInvalidValue;
    quantize_cols_amax<<<dim3(ta.ct, ta.p), kThreads, 0, s>>>(x, M, K, ta, part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    quantize_cols_reduce<<<G, kThreads, 0, s>>>(part, ta.p, K, group_width, gmax);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    quantize_scales<<<1, kThreads, 0, s>>>(gmax, G, 1, s_t, s_g, f);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const ColTiling tb = col_tiling(M, K, vec != 0, kCodeBlocks);
  quantize_codes<<<dim3(tb.ct, tb.p), kThreads, 0, s>>>(x, r, s_t, s_g, group_width, G > 1,
                                                        codes, M, K, tb, f);
  return (int)cudaGetLastError();
}

// K2's code pass alone, against a given s_t and compact scales
// s_g[(col / k_block) * sg_stride].
extern "C" int mls_quantize_given_sg(const float* x, const uint8_t* r, const float* s_t,
                                     const float* s_g, uint8_t* codes, long long M, int K,
                                     int k_block, int sg_stride, int vec, int e, int m,
                                     int e_min, int gs_m, int gs_emin, void* stream) {
  if (M <= 0 || K <= 0 || k_block <= 0 || K % k_block) return (int)cudaErrorInvalidValue;
  if (vec && (K % 4 || k_block % 4 || !aligned(x, 16) || !aligned(r, 4) || !aligned(codes, 4)))
    return (int)cudaErrorInvalidValue;
  const mls::Fmt f = make_fmt(e, m, e_min, gs_m, gs_emin);
  const ColTiling tb = col_tiling(M, K, vec != 0, kCodeBlocks);
  quantize_codes<<<dim3(tb.ct, tb.p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, r, s_t, s_g, k_block, sg_stride, codes, M, K, tb, f);
  return (int)cudaGetLastError();
}
