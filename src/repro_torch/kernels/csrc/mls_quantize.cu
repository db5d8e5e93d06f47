// MLS dynamic quantization (paper Alg. 2) for Hopper.
//
// Replaces the TPU kernels of src/repro/kernels/mls_quantize.py:
//   K1 _kernel_rowwise  (groupings "nc" and "n": group scales in the kernel)
//   K2 _kernel_given_sg (groupings "c" and "none": precomputed scales)
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
// K2 is a grid-stride elementwise pass; its tensor scale and compact
// scales are computed before the launch, as on the TPU.  Results are
// bit-identical to the plain version (kernels/ref.py quantize_ref): see
// mls_common.cuh.
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

// max that keeps NaN, as torch.amax does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide max of v; every thread gets it.  `red` holds kWarps + 1 floats.
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float m = threadIdx.x < kWarps ? red[threadIdx.x] : 0.0f;
    m = warp_max(m);
    if (threadIdx.x == 0) red[kWarps] = m;
  }
  __syncthreads();
  return red[kWarps];
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
        m = nan_max(nan_max(nan_max(nan_max(m, fabsf(v[u].x)), fabsf(v[u].y)),
                            fabsf(v[u].z)), fabsf(v[u].w));
    } else {
      for (long long i = base + threadIdx.x; i < n && i < base + kAmaxChunk; i += kThreads)
        m = nan_max(m, fabsf(x[i]));
    }
  }
  m = block_max(m, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = m;
}

// Pass B's prologue: s_t from pass A's partials (0 -> 1, NaN -> 1, as
// quantize_ref's torch.where(s_t > 0, s_t, 1)); block 0 stores it.
__device__ __forceinline__ float tensor_scale_of(const float* __restrict__ partials,
                                                 int n_partials, float* __restrict__ s_t_out,
                                                 float* red) {
  float m = 0.0f;
  for (int i = threadIdx.x; i < n_partials; i += kThreads) m = nan_max(m, partials[i]);
  m = block_max(m, red);
  const float s_t = m > 0.0f ? m : 1.0f;
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
    for (int i = 0; i < 4 * S; ++i) amax = nan_max(amax, fabsf(v[i]));
    amax = warp_max(amax);
    const float s_g = mls::group_scale(__fdiv_rn(amax, s_t), f);
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
      amax = nan_max(nan_max(nan_max(nan_max(amax, fabsf(q.x)), fabsf(q.y)), fabsf(q.z)),
                     fabsf(q.w));
    } else {
      amax = nan_max(amax, fabsf(x[base + j]));
    }
  }
  __syncthreads();  // red is reused
  amax = block_max(amax, red);
  const float s_g = mls::group_scale(__fdiv_rn(amax, s_t), f);
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

// Element codes against compact scales: s_g[(col / k_block) * sg_stride]
// ("c": stride 1 over K/k_block scales; "none": stride 0, one scale).
__global__ void quantize_given_sg(const float* __restrict__ x,
                                  const uint8_t* __restrict__ r,
                                  const float* __restrict__ s_t_ptr,
                                  const float* __restrict__ s_g,
                                  uint8_t* __restrict__ codes, long long M,
                                  long long K, int k_block, int sg_stride,
                                  mls::Fmt f) {
  const float s_t = *s_t_ptr;
  const long long n = M * K;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float sg = s_g[((i % K) / k_block) * sg_stride];
    codes[i] = mls::element_code(x[i], r[i], __fmul_rn(s_t, sg), f);
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

constexpr int kGivenMaxBlocks = 132 * 32;  // the given-scale pass strides beyond

// The launch constants, in the order kThreads, kWarpGroupMax,
// kGivenMaxBlocks, kAmaxBlocks, kAmaxChunk, kRowBlocks, for the launch
// descriptors (kernels/mls_quantize.py launch_spec_rows /
// launch_spec_given_sg) to read from the binary.
extern "C" int mls_quantize_constants(int* out, int n) {
  const int c[] = {kThreads, kWarpGroupMax, kGivenMaxBlocks, kAmaxBlocks, kAmaxChunk,
                   kRowBlocks};
  for (int i = 0; i < n && i < 6; ++i) out[i] = c[i];
  return 6;
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

extern "C" int mls_quantize_given_sg(const float* x, const uint8_t* r,
                                     const float* s_t, const float* s_g,
                                     uint8_t* codes, long long M, long long K,
                                     int k_block, int sg_stride, int e, int m,
                                     int e_min, int gs_m, int gs_emin,
                                     void* stream) {
  const mls::Fmt f = make_fmt(e, m, e_min, gs_m, gs_emin);
  const long long n = M * K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kGivenMaxBlocks) blocks = kGivenMaxBlocks;
    quantize_given_sg<<<(unsigned)blocks, kThreads, 0, s>>>(
        x, r, s_t, s_g, codes, M, K, k_block, sg_stride, f);
  }
  return (int)cudaGetLastError();
}
