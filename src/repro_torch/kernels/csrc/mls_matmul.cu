// Quantized-domain GEMM (paper Eq. 6-8) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/mls_matmul.py _kernel (K3):
// out (M, N) = sum over k-blocks g, in order, of
//   (int dot of the decoded codes of group g) * (s_g^x[row, g] * s_g^w[g, col])
// then times (s_t^x * s_t^w) * 2^(2(e_min - M)).
//
// Bound: on the main path's shapes, device memory and latency: a code is
// one byte, and the deep weight-gradient GEMMs (K = N*OH*OW up to 131072)
// have few output tiles.  The integer work (2*M*N*K operations) would be
// bound by the int8 tensor-core rate.
// Design, simple and exact first: one block per 64x64 output tile, 256
// threads with a 4x4 register tile each.  Each group's codes are staged in
// shared memory decoded to integer fractions through a 256-entry table,
// contracted in int32 (exact: QuantConfig keeps accumulation_bits < 24, so
// the sum also converts to float exactly), then scaled and added to the
// fp32 accumulator with one rounding for the product and one for the sum,
// groups 0..n-1 in order.  No split-K: any other order of the fp32 sums
// would round differently from the reference.  Group scales come in any
// compact layout (sg_shapes) through strides, 0 along a broadcast axis;
// code strides let the weight operand arrive transposed (K contiguous).
// max_fraction <= 127 for <2,4>, <2,1> and <0,4>, so a later version can
// feed int8 operands to wgmma; TMA staging and split-K with an ordered
// second pass are for later too.
#include <cuda_runtime.h>

#include <cstdint>

#include "mls_common.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kKC = 32;  // contraction chunk staged per __syncthreads
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) mls_matmul_kernel(
    const uint8_t* __restrict__ xc, long long sxm, long long sxk,
    const float* __restrict__ xsg, long long sxsg_m, long long sxsg_g,
    const uint8_t* __restrict__ wc, long long swk, long long swn,
    const float* __restrict__ wsg, long long swsg_g, long long swsg_n,
    const float* __restrict__ xst, const float* __restrict__ wst, float unit,
    float* __restrict__ out, int M, int N, int K, int k_block, int e, int m) {
  __shared__ int lut[256];
  __shared__ int xs[kKC][kBM + 1];
  __shared__ int ws[kKC][kBN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  lut[tid] = mls::decode_frac(tid, e, m);
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int nkb = K / k_block;
  for (int g = 0; g < nkb; ++g) {
    int p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = 0;
    for (int k0 = 0; k0 < k_block; k0 += kKC) {
      const int kc = min(kKC, k_block - k0);
      const long long kbase = (long long)g * k_block + k0;
      for (int t = tid; t < kBM * kKC; t += kThreads) {
        int r, k;
        if (sxk == 1) { r = t / kKC; k = t % kKC; } else { k = t / kBM; r = t % kBM; }
        const int gr = row0 + r;
        xs[k][r] = (gr < M && k < kc) ? lut[xc[gr * sxm + (kbase + k) * sxk]] : 0;
      }
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
    // inter-group combine: acc += p * (s_g^x * s_g^w), two roundings
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = row0 + ty + 16 * i;
      const float sx = gr < M ? xsg[gr * sxsg_m + g * sxsg_g] : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = col0 + tx + 16 * j;
        const float sw = gn < N ? wsg[g * swsg_g + gn * swsg_n] : 0.0f;
        acc[i][j] = mls::group_combine(acc[i][j], p[i][j], sx, sw);
      }
    }
  }
  const float st = mls::tensor_scale(*xst, *wst, unit);
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
// descriptors (kernels/mls_matmul.py launch_spec) to read from the binary.
extern "C" int mls_matmul_constants(int* out, int n) {
  const int c[] = {kBM, kBN, kKC, kThreads};
  for (int i = 0; i < n && i < 4; ++i) out[i] = c[i];
  return 4;
}

extern "C" int mls_matmul(const uint8_t* xc, long long sxm, long long sxk,
                          const float* xsg, long long sxsg_m, long long sxsg_g,
                          const uint8_t* wc, long long swk, long long swn,
                          const float* wsg, long long swsg_g, long long swsg_n,
                          const float* xst, const float* wst, float unit,
                          float* out, int M, int N, int K, int k_block, int e,
                          int m, void* stream) {
  if (M > 0 && N > 0) {
    const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
    mls_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        xc, sxm, sxk, xsg, sxsg_m, sxsg_g, wc, swk, swn, wsg, swsg_g, swsg_n,
        xst, wst, unit, out, M, N, K, k_block, e, m);
  }
  return (int)cudaGetLastError();
}
