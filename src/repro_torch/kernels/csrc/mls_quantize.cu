// MLS dynamic quantization (paper Alg. 2) for Hopper.
//
// Replaces the TPU kernels of src/repro/kernels/mls_quantize.py:
//   K1 _kernel_rowwise  (groupings "nc" and "n": group scales in the kernel)
//   K2 _kernel_given_sg (groupings "c" and "none": precomputed scales)
//
// Bound: device memory.  Per element the kernel reads 4 B of x and 1 B of
// rounding bytes and writes a 1 B code (plus 4 B per group), and does a few
// dozen integer/float operations, far below the card's compute rate.
// Design: a group is reduced where it lives.  "nc" groups (k_block wide)
// take one warp each: a shuffle max, one scale, then each lane codes its
// elements from L1/L2.  Groups wider than kWarpGroupMax ("n": a whole row,
// up to N*OH*OW = 131072 in the weight-gradient GEMM) take one block each
// with a shared-memory reduction.  K2 is a grid-stride elementwise pass.
// The tensor scale s_t (a global max) and K2's compact scales are computed
// before the launch, as on the TPU.  Results are bit-identical to the plain
// version (kernels/ref.py quantize_ref): see mls_common.cuh.
#include <cuda_runtime.h>

#include <cstdint>

#include "mls_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One warp per (row, group) of width gw; n_groups = K / gw groups per row.
__global__ void quantize_groups_warp(const float* __restrict__ x,
                                     const uint8_t* __restrict__ r,
                                     const float* __restrict__ s_t_ptr,
                                     uint8_t* __restrict__ codes,
                                     float* __restrict__ s_g_out, long long M,
                                     long long K, int gw, mls::Fmt f) {
  const long long n_groups = K / gw;
  const long long gid = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (gid >= M * n_groups) return;  // uniform across the warp
  const long long base = (gid / n_groups) * K + (gid % n_groups) * gw;
  float amax = 0.0f;
  for (int j = lane; j < gw; j += 32) amax = fmaxf(amax, fabsf(x[base + j]));
  amax = warp_max(amax);
  const float s_t = *s_t_ptr;
  const float s_g = mls::group_scale(__fdiv_rn(amax, s_t), f);
  if (lane == 0) s_g_out[gid] = s_g;
  const float denom = __fmul_rn(s_t, s_g);
  for (int j = lane; j < gw; j += 32)
    codes[base + j] = mls::element_code(x[base + j], r[base + j], denom, f);
}

// One block per (row, group) for wide groups.
__global__ void quantize_groups_block(const float* __restrict__ x,
                                      const uint8_t* __restrict__ r,
                                      const float* __restrict__ s_t_ptr,
                                      uint8_t* __restrict__ codes,
                                      float* __restrict__ s_g_out, long long K,
                                      int gw, mls::Fmt f) {
  __shared__ float part[kWarps];
  const long long n_groups = K / gw;
  const long long gid = blockIdx.x;
  const long long base = (gid / n_groups) * K + (gid % n_groups) * gw;
  float amax = 0.0f;
  for (int j = threadIdx.x; j < gw; j += kThreads)
    amax = fmaxf(amax, fabsf(x[base + j]));
  amax = warp_max(amax);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = threadIdx.x < kWarps ? part[threadIdx.x] : 0.0f;
  if (threadIdx.x < 32) amax = warp_max(amax);
  __shared__ float s_g_shared;
  const float s_t = *s_t_ptr;
  if (threadIdx.x == 0) {
    s_g_shared = mls::group_scale(__fdiv_rn(amax, s_t), f);
    s_g_out[gid] = s_g_shared;
  }
  __syncthreads();
  const float denom = __fmul_rn(s_t, s_g_shared);
  for (int j = threadIdx.x; j < gw; j += kThreads)
    codes[base + j] = mls::element_code(x[base + j], r[base + j], denom, f);
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

constexpr int kWarpGroupMax = 1024;  // wider groups take a block each
constexpr int kGivenMaxBlocks = 132 * 32;  // the given-scale pass strides beyond

// The launch constants, in the order kThreads, kWarpGroupMax,
// kGivenMaxBlocks, for the launch descriptors (kernels/mls_quantize.py
// launch_spec_rows / launch_spec_given_sg) to read from the binary.
extern "C" int mls_quantize_constants(int* out, int n) {
  const int c[] = {kThreads, kWarpGroupMax, kGivenMaxBlocks};
  for (int i = 0; i < n && i < 3; ++i) out[i] = c[i];
  return 3;
}

extern "C" const char* mls_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int mls_quantize_rows(const float* x, const uint8_t* r,
                                 const float* s_t, uint8_t* codes, float* s_g,
                                 long long M, long long K, int group_width,
                                 int e, int m, int e_min, int gs_m,
                                 int gs_emin, void* stream) {
  const mls::Fmt f = make_fmt(e, m, e_min, gs_m, gs_emin);
  const long long groups = M * (K / group_width);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups > 0) {
    if (group_width <= kWarpGroupMax) {
      const long long blocks = (groups + kWarps - 1) / kWarps;
      quantize_groups_warp<<<(unsigned)blocks, kThreads, 0, s>>>(
          x, r, s_t, codes, s_g, M, K, group_width, f);
    } else {
      quantize_groups_block<<<(unsigned)groups, kThreads, 0, s>>>(
          x, r, s_t, codes, s_g, K, group_width, f);
    }
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
