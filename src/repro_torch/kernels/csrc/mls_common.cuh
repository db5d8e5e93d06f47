// Bit-level MLS math shared by the quantize (mls_quantize.cu), GEMM
// (mls_matmul.cu) and implicit-conv (implicit_conv.cu) kernels: paper
// Alg. 2, the code decoding of Eq. 7 and the group combine of Eq. 8.
//
// Every function here reproduces the plain PyTorch version
// (src/repro_torch/core/quantize.py, kernels/ref.py) bit for bit.  The
// build passes -fmad=false, so no a*b+c is contracted into an FMA; the
// float divisions are IEEE (no fast math); powers of two are built from
// the exponent bits, never from exp2f.
#pragma once

#include <cstdint>

namespace mls {

// Format constants of one <E,M> element format and its <Eg,Mg> group-scale
// format, passed by value to every kernel.
struct Fmt {
  int e;        // element exponent bits
  int m;        // element mantissa bits
  int e_min;    // 1 - 2^E (0 for E == 0)
  int gs_m;     // group-scale mantissa bits
  int gs_emin;  // max(gs e_min, -120)
};

constexpr int kZeroExp = -(1 << 30);  // exponent of zero / fp32 subnormals

// Exact float 2^e for any int e (subnormal results included).
__device__ __forceinline__ float pow2(int e) {
  if (e >= -126) return __int_as_float((min(e, 128) + 127) << 23);
  if (e >= -149) return __int_as_float(1 << (e + 149));
  return 0.0f;
}

// Exponent of a non-negative float: x = frac * 2^e, frac in [1, 2).
__device__ __forceinline__ int exponent_of(float x) {
  const int raw = (__float_as_int(x) >> 23) & 0xFF;
  return raw == 0 ? kZeroExp : raw - 127;
}

// Fraction of a non-negative float (0 for zero / subnormals).
__device__ __forceinline__ float fraction_of(float x) {
  const int bits = __float_as_int(x);
  if (((bits >> 23) & 0xFF) == 0) return 0.0f;
  return __int_as_float((bits & 0x7FFFFF) | (127 << 23));
}

// Ceil-rounded <Eg,Mg> group scale of a ratio s_gf in [0, 1] (Alg. 2 l.4-8).
__device__ __forceinline__ float group_scale(float s_gf, const Fmt f) {
  int e = exponent_of(s_gf);
  float frac = fraction_of(s_gf);
  if (e < f.gs_emin) frac = 1.0f;
  e = max(f.gs_emin, min(e, 0));
  int man = (int)ceilf(__fmul_rn(__fsub_rn(frac, 1.0f), (float)(1 << f.gs_m)));
  if (man >= (1 << f.gs_m)) {
    man = 0;
    e = max(f.gs_emin, min(e + 1, 0));
  }
  const float mant = __fadd_rn(1.0f, __fmul_rn((float)man, pow2(-f.gs_m)));
  return __fmul_rn(mant, pow2(e));
}

// Packed sign|exp|man code of one element given its scale denominator
// s_t * s_g (Alg. 2 l.9-16).  r_u8 is the stochastic-rounding byte:
// r = (r_u8 + 0.5)/256 - 0.5.  The divisions by 256 and by the grid step
// are by powers of two, whose quotients are exact (no overflow: x_f <= 1,
// step >= 2^-127 for 8-bit codes): they are taken as the products by the
// exact reciprocals, the same numbers as the plain version's divisions.
// Only x / (s_t * s_g) is an IEEE division.  Here the rounding offset r
// in [-1/2, 1/2) is given; r = 0 rounds to nearest, half up (quantize_ref
// without rounding bytes).
__device__ __forceinline__ uint8_t element_code_offset(float x, float r, float denom,
                                                       const Fmt f) {
  const float absx = fabsf(x);
  const int sign_bit = x < 0.0f ? 1 : 0;
  const float x_f = denom > 0.0f ? __fdiv_rn(absx, denom) : 0.0f;
  if (f.e == 0) {
    // fixed point: uniform grid man/2^M over [0, 1); the code is q itself
    float q = floorf(__fadd_rn(__fadd_rn(__fmul_rn(x_f, pow2(f.m)), r), 0.5f));
    q = fminf(fmaxf(q, 0.0f), (float)((1 << f.m) - 1));
    return (uint8_t)((sign_bit << f.m) | (int)q);
  }
  const int e_eff = max(f.e_min, min(exponent_of(x_f), -1));
  const float step = pow2(e_eff - f.m);
  float q = floorf(__fadd_rn(__fadd_rn(__fmul_rn(x_f, pow2(f.m - e_eff)), r), 0.5f));
  const float qmax =
      e_eff == -1 ? (float)((2 << f.m) - 1) : (float)(2 << f.m);
  q = fminf(fmaxf(q, 0.0f), qmax);
  const float xbar = __fmul_rn(q, step);
  const int e2 = exponent_of(xbar);
  int man, exp_stored;
  if (e2 >= f.e_min) {
    man = (int)rintf(
        __fmul_rn(__fsub_rn(fraction_of(xbar), 1.0f), (float)(1 << f.m)));
    exp_stored = -e2;
  } else {
    man = (int)rintf(__fmul_rn(xbar, pow2(f.m - f.e_min)));
    exp_stored = 0;
  }
  return (uint8_t)((sign_bit << (f.e + f.m)) | (exp_stored << f.m) | man);
}

// The code with the rounding byte r_u8: offset (r_u8 + 0.5) / 256 - 0.5.
__device__ __forceinline__ uint8_t element_code(float x, uint8_t r_u8, float denom,
                                                const Fmt f) {
  return element_code_offset(
      x, __fsub_rn(__fmul_rn(__fadd_rn((float)r_u8, 0.5f), 0.00390625f), 0.5f), denom, f);
}

// |x| by clearing the sign bit, so a NaN keeps its payload as torch.abs
// keeps it on the CPU (the card's fabsf returns the canonical NaN, whose
// fraction bits a group scale made from it would then read).
__device__ __forceinline__ float abs_bits(float x) {
  return __int_as_float(__float_as_int(x) & 0x7fffffff);
}

// max that keeps NaN, as torch.amax does (fmaxf would drop it), for the
// non-negative values and NaNs that every caller reduces (abs_bits of x,
// and maxima of those).  Their bit patterns order as the floats do, with
// NaN above +inf, so an integer max keeps a NaN and its payload bit for
// bit; a float select may be compiled to max.NaN, which returns the
// canonical NaN.  That is torch.amax's result where the reduction meets
// one NaN payload; among NaNs of different payloads this keeps the
// largest, while torch.amax keeps whichever its own order meets.
__device__ __forceinline__ float nan_max(float a, float b) {
  return __int_as_float(max(__float_as_int(a), __float_as_int(b)));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide nan_max of v over THREADS threads; every thread gets it.
// `red` holds THREADS / 32 + 1 floats; the caller syncs before reusing it.
template <int THREADS>
__device__ __forceinline__ float block_max(float v, float* red) {
  constexpr int kWarps = THREADS / 32;
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

// The tensor scale of a max |x|: s_t = max > 0 ? max : 1 (0 and NaN give
// 1, as quantize_ref's torch.where(s_t > 0, s_t, 1)).
__device__ __forceinline__ float tensor_scale_of_max(float m) { return m > 0.0f ? m : 1.0f; }

// The ratio s_r / s_t that a group scale is made from.  A NaN max passes
// through unchanged: an IEEE division would hand back the card's canonical
// NaN, while the plain version's division on the CPU keeps the operand's
// payload, and group_scale reads the fraction bits.
__device__ __forceinline__ float scale_ratio(float s_r, float s_t) {
  return s_r != s_r ? s_r : __fdiv_rn(s_r, s_t);
}

// The scales of G groups from their maxima, in one block of THREADS
// threads: vals holds G runs of `per` maxima (one run per group).  s_t =
// max > 0 ? max : 1 over all of them, and s_g[g] = group_scale(max of run
// g / s_t): quantize_ref's quantize_group_scale(s_r / s_t) with s_r the
// group's max |x|.  K2 ("c", "none") and K4 ("c") make their scales here.
template <int THREADS>
__device__ __forceinline__ void scales_of_maxima(const float* __restrict__ vals, int G,
                                                 int per, float* __restrict__ s_t_out,
                                                 float* __restrict__ s_g, const Fmt f,
                                                 float* red) {
  float m = 0.0f;
  for (int i = threadIdx.x; i < G * per; i += THREADS) m = nan_max(m, vals[i]);
  const float s_t = tensor_scale_of_max(block_max<THREADS>(m, red));
  if (threadIdx.x == 0) *s_t_out = s_t;
  for (int g = threadIdx.x; g < G; g += THREADS) {
    float gm = 0.0f;
    for (int i = 0; i < per; ++i) gm = nan_max(gm, vals[g * per + i]);
    s_g[g] = group_scale(scale_ratio(gm, s_t), f);
  }
}

// Signed integer fraction F of a code: |value| = |F| * 2^(e_min - M).
__host__ __device__ __forceinline__ int decode_frac(int c, int e, int m) {
  const int man = c & ((1 << m) - 1);
  const int exp = (c >> m) & ((1 << e) - 1);
  const int sign_bit = (c >> (e + m)) & 1;
  const int top = (1 << e) - 1;
  const int f = exp == 0 ? man : ((1 << m) + man) << (top - exp);
  return sign_bit ? -f : f;
}

// One group's term of the fp32 sum (Eq. 8): p * (s_g^x * s_g^w), one
// rounding for each product.  p is a group's exact int32 dot (|p| < 2^24,
// so the conversion is exact).
__device__ __forceinline__ float group_term(int p, float sx, float sw) {
  return __fmul_rn((float)p, __fmul_rn(sx, sw));
}

// The term added to the sum, taken in k order: acc + p * (s_g^x * s_g^w).
// K3's split variant stores the terms and adds them in a second pass, in
// the same order: the same roundings.
__device__ __forceinline__ float group_combine(float acc, int p, float sx,
                                               float sw) {
  return __fadd_rn(acc, group_term(p, sx, sw));
}

// The output scale applied once after the last group:
// (s_t^x * s_t^w) * 2^(2(e_min - M)).
__device__ __forceinline__ float tensor_scale(float xst, float wst,
                                              float unit) {
  return __fmul_rn(__fmul_rn(xst, wst), unit);
}

}  // namespace mls
