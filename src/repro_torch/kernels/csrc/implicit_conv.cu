// Implicit-GEMM forward conv with MLS quantization in the GEMM prologue
// (paper Alg. 2 fused into the quantized-domain GEMM of Eq. 6-8) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/implicit_conv.py
// _implicit_kernel (K4, with its _gather_tile).  It computes
//   out (M0, O) = conv(x, w) in the MLS quantized domain
// as the virtual GEMM (M0 = N*OH*OW, K0 = C*kh*kw) @ (K0, O), rows in
// (n, oh, ow) order and features in (c, kh, kw) order: the layout im2col
// builds, but no patch matrix is ever written.  Each block owns one output
// tile and walks the k-blocks g = 0..K0/k_block-1 in order (no split-K);
// a k-block is cb whole input channels' kh*kw taps.  Per k-block it
//   - gathers its patch elements straight from the padded NCHW input;
//   - quantizes them: "nc" takes K1's group max, IEEE division by s_t and
//     group scale; "c", "n" and "none" take the compact scales computed
//     ahead.  The rounding byte of element (m, k) is r[m, k] of the same
//     (M0, K0) tensor the im2col path hands K1;
//   - contracts the codes with the weight codes in exact int32 and adds
//     p * (s_g^x * s_g^w) to the fp32 sum (K3's combine);
// then multiplies by (s_t^x * s_t^w) * unit.  Every step is a device
// function of mls_common.cuh that K1/K2/K3 call too, so the result is
// bit-identical to im2col + K1/K2 + K3 on the same rounding bytes.
//
// Bound: device memory.  The work reads the input once (4 B per element),
// one rounding byte per patch element and the weight codes, and writes
// 4 B per output; its 2*M0*K0*O integer operations are far below the int8
// rate.  This first version is simple, not at that bound: K3's layout (a
// 64x64 output tile per block, 256 threads with a 4x4 register tile each,
// codes decoded to integer fractions in shared memory), and each thread
// gathers and codes one fixed row of the tile, so the "nc" group max is a
// per-thread max and a 4-way reduction in shared memory.  The input is
// read twice for "nc" (max, then codes, the second from L1/L2) and once
// per 64-wide tile of output channels (one tile for ResNet-20's O <= 64).
// Staging the halo band with TMA, wgmma int8 dots and a coalesced
// rounding-byte layout are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "mls_common.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kKC = 32;  // contraction chunk staged per __syncthreads
constexpr int kThreads = 256;
constexpr int kRowThreads = kThreads / kBM;  // threads that share a tile row

struct ConvDims {
  int c, hp, wp, kh, kw, sh, sw, oh, ow;
};

// Offset in the padded input of feature k = (c, i, j) of a patch, from the
// patch's top-left element.
__device__ __forceinline__ long long tap_offset(int k, const ConvDims& d) {
  const int kk = d.kh * d.kw;
  const int ch = k / kk, t = k - ch * kk;
  const int i = t / d.kw, j = t - i * d.kw;
  return ((long long)ch * d.hp + i) * d.wp + j;
}

__global__ void __launch_bounds__(kThreads) implicit_conv_kernel(
    const float* __restrict__ xp, const uint8_t* __restrict__ r,
    const float* __restrict__ xst_ptr, const float* __restrict__ xsg,
    long long sxsg_m, long long sxsg_g, const uint8_t* __restrict__ wc,
    long long swk, long long swn, const float* __restrict__ wsg,
    long long swsg_g, long long swsg_n, const float* __restrict__ wst_ptr,
    float unit, float* __restrict__ out, int M, int N, int K, int k_block,
    ConvDims d, mls::Fmt f) {
  __shared__ int lut[256];
  __shared__ int xs[kKC][kBM + 1];
  __shared__ int ws[kKC][kBN + 1];
  __shared__ float part[kThreads];  // partial "nc" group maxima
  __shared__ float row_sg[kBM];     // "nc" group scale of each tile row
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const bool nc = xsg == nullptr;  // "nc": group scales made here
  lut[tid] = mls::decode_frac(tid, f.e, f.m);

  // The tile row this thread gathers and codes in every chunk (t = tid +
  // kThreads*q covers row t % kBM = tid % kBM), its first feature, and the
  // offset of its patch's top-left element in the padded input.
  const int my_r = tid % kBM, my_k = tid / kBM;
  const int my_m = row0 + my_r;
  const bool my_valid = my_m < M;
  long long base = 0;
  const uint8_t* my_rb = r;
  if (my_valid) {
    const int ohw = d.oh * d.ow;
    const int n = my_m / ohw, rem = my_m - n * ohw;
    const int oh = rem / d.ow, ow = rem - oh * d.ow;
    base = ((long long)n * d.c * d.hp + (long long)oh * d.sh) * d.wp +
           (long long)ow * d.sw;
    my_rb = r + (long long)my_m * K;
  }
  const float xst = *xst_ptr;
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int nkb = K / k_block;
  for (int g = 0; g < nkb; ++g) {
    const int kg = g * k_block;
    float denom;  // s_t * s_g of this thread's row in group g
    if (nc) {
      // K1's group scale: max |x| over the group (padding zeros included,
      // as in im2col's cols), IEEE-divided by s_t, ceil-rounded
      float amax = 0.0f;
      if (my_valid)
        for (int k = my_k; k < k_block; k += kRowThreads)
          amax = fmaxf(amax, fabsf(xp[base + tap_offset(kg + k, d)]));
      part[tid] = amax;
      __syncthreads();
      if (tid < kBM) {
        float a = part[tid];
        for (int q = 1; q < kRowThreads; ++q) a = fmaxf(a, part[tid + q * kBM]);
        row_sg[tid] = mls::group_scale(__fdiv_rn(a, xst), f);
      }
      __syncthreads();
      denom = __fmul_rn(xst, row_sg[my_r]);
    } else {
      denom = my_valid ? __fmul_rn(xst, xsg[my_m * sxsg_m + g * sxsg_g]) : 0.0f;
    }

    int p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = 0;
    for (int k0 = 0; k0 < k_block; k0 += kKC) {
      const int kc = min(kKC, k_block - k0);
      // quantize prologue: this thread's row, features my_k, my_k + 4, ...
      for (int k = my_k; k < kKC; k += kRowThreads) {
        int v = 0;
        if (my_valid && k < kc) {
          const int kf = kg + k0 + k;
          v = lut[mls::element_code(xp[base + tap_offset(kf, d)], my_rb[kf],
                                    denom, f)];
        }
        xs[k][my_r] = v;
      }
      const long long kbase = (long long)kg + k0;
      for (int t = tid; t < kBN * kKC; t += kThreads) {
        int n, k;
        if (swk == 1) { n = t / kKC; k = t % kKC; } else { k = t / kBN; n = t % kBN; }
        const int gn = col0 + n;
        ws[k][n] = (gn < N && k < kc) ? lut[wc[(kbase + k) * swk + gn * swn]] : 0;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kKC; ++k) {
        int a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) p[i][j] += a[i] * b[j];
      }
      __syncthreads();
    }
    // K3's inter-group combine, group g after group g - 1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = ty + 16 * i, gr = row0 + lr;
      float sx = 0.0f;
      if (gr < M) sx = nc ? row_sg[lr] : xsg[gr * sxsg_m + g * sxsg_g];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = col0 + tx + 16 * j;
        const float sw = gn < N ? wsg[g * swsg_g + gn * swsg_n] : 0.0f;
        acc[i][j] = mls::group_combine(acc[i][j], p[i][j], sx, sw);
      }
    }
  }
  const float st = mls::tensor_scale(xst, *wst_ptr, unit);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = col0 + tx + 16 * j;
      if (gr < M && gn < N) out[(long long)gr * N + gn] = __fmul_rn(acc[i][j], st);
    }
  }
}

}  // namespace

// The tile constants, in the order kBM, kBN, kKC, kThreads, for the launch
// descriptors (kernels/implicit_conv.py launch_spec) to read from the binary.
extern "C" int implicit_conv_constants(int* out, int n) {
  const int c[] = {kBM, kBN, kKC, kThreads};
  for (int i = 0; i < n && i < 4; ++i) out[i] = c[i];
  return 4;
}

// xp: the padded input (n, c, hp, wp), fp32, contiguous.  r: the rounding
// bytes (M0, K0).  xsg: the compact activation group scales with element
// strides (0 along a broadcast axis), or NULL for grouping "nc".  wc, wsg:
// the weight's codes (K0, O) and compact scales, strided.  out: (M0, O).
extern "C" int implicit_conv(const float* xp, const uint8_t* r,
                             const float* xst, const float* xsg,
                             long long sxsg_m, long long sxsg_g,
                             const uint8_t* wc, long long swk, long long swn,
                             const float* wsg, long long swsg_g,
                             long long swsg_n, const float* wst, float unit,
                             float* out, int n, int c, int hp, int wp, int o,
                             int kh, int kw, int sh, int sw, int k_block,
                             int e, int m, int e_min, int gs_m, int gs_emin,
                             void* stream) {
  const ConvDims d{c, hp, wp, kh, kw, sh, sw, (hp - kh) / sh + 1,
                   (wp - kw) / sw + 1};
  const mls::Fmt f{e, m, e_min, gs_m, gs_emin};
  const int M = n * d.oh * d.ow, K = c * kh * kw;
  if (M > 0 && o > 0) {
    const dim3 grid((M + kBM - 1) / kBM, (o + kBN - 1) / kBN);
    implicit_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        xp, r, xst, xsg, sxsg_m, sxsg_g, wc, swk, swn, wsg, swsg_g, swsg_n,
        wst, unit, out, M, o, K, k_block, d, f);
  }
  return (int)cudaGetLastError();
}
