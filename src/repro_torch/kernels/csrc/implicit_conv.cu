// Implicit-GEMM forward conv with MLS quantization in the GEMM prologue
// (paper Alg. 2 fused into the quantized-domain GEMM of Eq. 6-8) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/implicit_conv.py
// _implicit_kernel (K4, with its _gather_tile).  It computes
//   out (M0, O) = conv(x, w) in the MLS quantized domain
// as the virtual GEMM (M0 = N*OH*OW, K0 = C*kh*kw) @ (K0, O), rows in
// (n, oh, ow) order and features in (c, kh, kw) order: the layout im2col
// builds, but no patch matrix is ever written, and no padded copy of x
// either.  The rounding byte of element (m, k) is r[m, k] of the same
// (M0, K0) tensor the im2col path hands K1, and every step is a device
// function of mls_common.cuh / mls_mma.cuh that K1/K2/K3 call too, so the
// result is bit-identical to im2col + K1/K2 + K3 on the same bytes.
//
// Bound: device memory.  The work reads the input once (4 B per element),
// one rounding byte per patch element (9 per input element for 3x3) and
// the weight codes, and writes 4 B per output; its 2*M0*K0*O integer
// operations are far below the int8 rate.  Design, one C call:
//   scale passes, by grouping, all without atomics (max is exact in any
//   order) and keeping NaN as torch.amax does:
//   - "nc", "none": pass A (conv_amax): partial maxima of |x| over the
//     pixels some patch covers (VALID or a stride can leave a tail out,
//     and a stride wider than the window skips rows and columns), up to
//     2 x 132 blocks; the main kernel's blocks reduce them to the tensor
//     scale (and "none"'s one group scale) themselves.
//   - "n" (a group per patch): conv_win_amax, a thread per output row,
//     writes each patch's max |x| and a partial max per block; the main
//     kernel's blocks make s_t from the partials and their rows' group
//     scales from the patch maxima.
//   - "c" (a group is cb whole channels' taps over all patches): a tap's
//     max over the patches it covers, taken over the group's taps, is
//     the max over the pixels of the group's channels that some patch
//     covers.  So conv_chan_amax takes a warp per (image, channel) plane's
//     covered max, conv_group_reduce a block per group (K2's
//     quantize_cols_reduce pattern), and conv_chan_scales one block makes
//     s_t and the group scales (mls::scales_of_maxima, K2's).
//   main kernel (implicit_conv_kernel): a block per 64-row x BN output
//     tile (BN = 16, 32 or 64 from O) walks the scaling groups in k order
//     (no split-K); a group is cb whole channels' kh*kw taps.  8 warps
//     share the prologue's element codes (the element arithmetic, not the
//     bytes, sets the pace, and stage 3 has one tile per SM); for the dot,
//     warp w takes rows 16 * (w % 4) and half the tile's columns.  Per
//     group:
//     - the tile's halo band, cb channels x the input rows its patches
//       touch x the padded width, is staged once in shared memory with
//       4-byte cp.async; padding is the copy's zero fill.  64 rows may
//       span two images (the band then runs on into the next image's
//       rows); the host sizes shared memory for the tallest band.
//     - "nc" group maxima come from the band: x is read from device
//       memory once.
//     - the rounding bytes are staged as the tile's 64 x KC chunk, each
//       row KC contiguous bytes at m*K0 + g*k_block + c*KC, with 16-byte
//       cp.async copies (k_block and K0 multiples of 16; else byte loads).
//     - tap offsets into the band are precomputed per kernel (the same for
//       every group: whole channels) and row offsets per tile, so no
//       element takes a division.
//     - codes go through the fraction table into int8 (int32) rows in the
//       layout mma.sync.m16n8k16 reads, and the group dot runs on int8
//       tensor cores when every fraction fits int8 (max_fraction <= 127),
//       else on CUDA cores in int32: K3's staging, decode and bodies,
//       shared through mls_mma.cuh.
//     - the combine stays mls::group_combine in k order, then the tensor
//       scale (K3's epilogue).
//   emit (the kEmit instances, the JAX kernel's emit_codes): the tiles of
//     column 0 (blockIdx.y == 0) also store the prologue's codes (M0, K0)
//     and "nc"'s and "n"'s row group scales, block (0, 0) s_t and the
//     compact "c"/"none" scales, so each byte has one writer.  The default
//     instances (kEmit false) carry none of these stores.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mls_common.cuh"
#include "mls_mma.cuh"

namespace {

constexpr int kBM = 64;           // output rows per tile: 4 row warps x 16
constexpr int kThreads = 256;     // 8 warps: 4 row warps x 2 column halves
constexpr int kWarpsM = 4;
constexpr int kAmaxThreads = 256;  // pass A
constexpr int kAmaxBlocks = 2 * 132;
constexpr int kBandBytesMax = 160 * 1024;  // staged band, at most
constexpr int kMaxGridY = 65535;

// The C entry point's groupings.  "c" reads s_t and its compact group
// scales from the scratch its own passes fill.
enum Mode { kModeNc = 0, kModeNone = 1, kModeC = 2, kModeN = 3 };

// Which pixels some patch covers: padded row i is covered iff i % sh < kh
// (always when sh <= kh) and i is below the last patch's end (hcov).
struct Cov {
  int ph, pw, sh, sw, kh, kw;
  __device__ __forceinline__ bool row(int hh) const { return (hh + ph) % sh < kh; }
  __device__ __forceinline__ bool col(int ww) const { return (ww + pw) % sw < kw; }
};

struct ConvArgs {
  const float* x;  // (n, c, h, w) unpadded
  const uint8_t* r;
  const float* partials;  // pass A ("nc", "none") or conv_win_amax ("n")
  int n_partials;
  const float* s_r;  // "n": each patch's max |x|
  const float* xst;  // "c": s_t and the compact group scales
  const float* xsg;
  const uint8_t* wc;
  long long swk, swn;
  const float* wsg;
  long long swsg_g, swsg_n;
  const float* wst;
  float unit;
  float* out;
  uint8_t* codes_out;  // emit: (M0, K0) codes, the compact x scales, s_t
  float* sg_out;
  float* st_out;
  int M, O, K, k_block, cb, mode;
  int n, c, h, w, hp, wp, ph, pw, kh, kw, sh, sw, oh, ow;
  int band_rows;  // the tallest band of any tile: the band's channel pitch in rows
  bool r_async, w_async;
  mls::Fmt f;
};

// The rows of the padded input stack (image-major, n * hp + padded row)
// that output row m's patch starts on.
__host__ __device__ __forceinline__ int patch_row(int m, int oh, int ow, int hp, int sh) {
  const int q = m / ow;
  return (q / oh) * hp + (q % oh) * sh;
}

// Shared-memory layout of one block (bytes), for a tile width BN and body.
template <int BN, bool kMma>
struct Smem {
  static constexpr int KC = kMma ? 64 : 32;          // k staged per chunk
  static constexpr int KCP = kMma ? KC + 16 : KC + 1;  // decoded row pitch (elements)
  static constexpr int RBP = KC + 16;                // rounding-byte row pitch (bytes)
  using Dec = typename std::conditional<kMma, int8_t, int>::type;
  int band, toff, roff, rs, red2, lut, red, rbuf, deca, rawb, decb, total;
  __host__ __device__ static int up16(int b) { return (b + 15) & ~15; }
  __host__ __device__ Smem(int cb, int band_rows, int wp, int k_block) {
    band = 0;
    toff = up16(band + cb * band_rows * wp * 4);
    roff = up16(toff + k_block * 4);
    rs = roff + kBM * 4;
    red2 = rs + kBM * 4;
    lut = red2 + kThreads * 4;
    red = lut + 256 * 4;
    rbuf = up16(red + (kThreads / 32 + 1) * 4);
    deca = up16(rbuf + kBM * RBP);
    rawb = up16(deca + kBM * KCP * (int)sizeof(Dec));
    decb = up16(rawb + BN * KC);
    total = up16(decb + BN * KCP * (int)sizeof(Dec));
  }
};

// Pass A: partials[b] = max |x| over the covered rows of block b's row
// iterations.  Covered rows: (plane, hh) with hh < hcov, columns < wcov; a
// block is rb row lanes x s threads; iteration it covers covered rows it *
// rb .. it * rb + rb - 1 of the R = planes * hcov; block b takes b, b + P, ...
__global__ void __launch_bounds__(kAmaxThreads) conv_amax(const float* __restrict__ x,
                                                          int planes, int H, int W,
                                                          int hcov, int wcov, int s,
                                                          const Cov cov,
                                                          float* __restrict__ partials) {
  __shared__ float red[kAmaxThreads / 32 + 1];
  const int ls = threadIdx.x % s, lr = threadIdx.x / s, rb = kAmaxThreads / s;
  const long long rows = (long long)planes * hcov;
  float m = 0.0f;
  for (long long it = blockIdx.x; it * rb < rows; it += gridDim.x) {
    const long long row = it * rb + lr;
    if (row >= rows) continue;
    const long long plane = row / hcov;
    const int hh = (int)(row - plane * hcov);
    if (!cov.row(hh)) continue;
    const float* src = x + (plane * H + hh) * W;
    for (int col = ls; col < wcov; col += s)
      if (cov.col(col)) m = mls::nan_max(m, mls::abs_bits(src[col]));
  }
  m = mls::block_max<kAmaxThreads>(m, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = m;
}

// The tensor scale alone (covered_tensor_scale), one block.
__global__ void __launch_bounds__(kAmaxThreads) conv_scale(const float* __restrict__ partials,
                                                           int n_partials,
                                                           float* __restrict__ s_t) {
  __shared__ float red[kAmaxThreads / 32 + 1];
  float m = 0.0f;
  for (int i = threadIdx.x; i < n_partials; i += kAmaxThreads) m = mls::nan_max(m, partials[i]);
  m = mls::block_max<kAmaxThreads>(m, red);
  if (threadIdx.x == 0) *s_t = mls::tensor_scale_of_max(m);
}

// "n": s_r[m] = max |x| over output row m's patch (the padding's zeros
// never raise a max), a thread per row; rows m = (turn * P + b) * kAmaxThreads
// + lane; partials[b] = max over block b's rows.
__global__ void __launch_bounds__(kAmaxThreads) conv_win_amax(const ConvArgs a,
                                                              float* __restrict__ s_r,
                                                              float* __restrict__ partials) {
  __shared__ float red[kAmaxThreads / 32 + 1];
  float bm = 0.0f;
  const long long ohw = (long long)a.oh * a.ow;
  for (long long m = (long long)blockIdx.x * kAmaxThreads + threadIdx.x; m < a.M;
       m += (long long)gridDim.x * kAmaxThreads) {
    const long long img = m / ohw;
    const int q = (int)(m - img * ohw), i0 = (q / a.ow) * a.sh - a.ph,
              j0 = (q % a.ow) * a.sw - a.pw;
    float mx = 0.0f;
    for (int ch = 0; ch < a.c; ++ch) {
      const float* plane = a.x + (img * a.c + ch) * a.h * a.w;
      for (int i = max(i0, 0); i < min(i0 + a.kh, a.h); ++i)
        for (int j = max(j0, 0); j < min(j0 + a.kw, a.w); ++j)
          mx = mls::nan_max(mx, mls::abs_bits(plane[i * a.w + j]));
    }
    s_r[m] = mx;
    bm = mls::nan_max(bm, mx);
  }
  bm = mls::block_max<kAmaxThreads>(bm, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = bm;
}

// "c": pm[ch * N + img] = max |x| over the covered pixels of plane (img,
// ch), a warp per plane, so each group's planes are one contiguous run.
__global__ void __launch_bounds__(kAmaxThreads) conv_chan_amax(const float* __restrict__ x,
                                                               int N, int C, int H, int W,
                                                               int hcov, int wcov,
                                                               const Cov cov,
                                                               float* __restrict__ pm) {
  const int lane = threadIdx.x % 32;
  const long long p = (long long)blockIdx.x * (kAmaxThreads / 32) + threadIdx.x / 32;
  if (p >= (long long)N * C) return;  // the whole warp: no block-wide sync follows
  const float* src = x + p * H * W;
  float m = 0.0f;
  for (int hh = 0; hh < hcov; ++hh) {
    if (!cov.row(hh)) continue;
    for (int col = lane; col < wcov; col += 32)
      if (cov.col(col)) m = mls::nan_max(m, mls::abs_bits(src[hh * W + col]));
  }
  m = mls::warp_max(m);
  if (lane == 0) pm[(p % C) * N + p / C] = m;
}

// "c": gmax[g] = max of the group's run of `per` plane maxima, a block per group.
__global__ void __launch_bounds__(kAmaxThreads) conv_group_reduce(const float* __restrict__ pm,
                                                                  int per,
                                                                  float* __restrict__ gmax) {
  __shared__ float red[kAmaxThreads / 32 + 1];
  float m = 0.0f;
  for (int i = threadIdx.x; i < per; i += kAmaxThreads)
    m = mls::nan_max(m, pm[(long long)blockIdx.x * per + i]);
  m = mls::block_max<kAmaxThreads>(m, red);
  if (threadIdx.x == 0) gmax[blockIdx.x] = m;
}

// "c": s_t and the G group scales, one block.
__global__ void __launch_bounds__(kAmaxThreads) conv_chan_scales(const float* __restrict__ gmax,
                                                                 int G,
                                                                 float* __restrict__ s_t,
                                                                 float* __restrict__ s_g,
                                                                 mls::Fmt f) {
  __shared__ float red[kAmaxThreads / 32 + 1];
  mls::scales_of_maxima<kAmaxThreads>(gmax, G, 1, s_t, s_g, f, red);
}

template <int BN, bool kMma, bool kEmit>
__global__ void __launch_bounds__(kThreads, 3) implicit_conv_kernel(const ConvArgs a) {
  using L = Smem<BN, kMma>;
  using Dec = typename L::Dec;
  constexpr int KC = L::KC, KCP = L::KCP, RBP = L::RBP;
  constexpr int NT = BN / 16;  // n8 tiles of each warp: half the tile's columns
  extern __shared__ __align__(16) unsigned char smem[];
  const L lay(a.cb, a.band_rows, a.wp, a.k_block);
  float* band = reinterpret_cast<float*>(smem + lay.band);
  int* toff = reinterpret_cast<int*>(smem + lay.toff);
  int* roff = reinterpret_cast<int*>(smem + lay.roff);
  float* rs = reinterpret_cast<float*>(smem + lay.rs);  // "nc", "n": each row's group scale
  float* red2 = reinterpret_cast<float*>(smem + lay.red2);
  int* lut = reinterpret_cast<int*>(smem + lay.lut);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  uint8_t* rbuf = smem + lay.rbuf;
  Dec* deca = reinterpret_cast<Dec*>(smem + lay.deca);
  uint8_t* rawb = smem + lay.rawb;
  Dec* decb = reinterpret_cast<Dec*>(smem + lay.decb);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;  // row warp, column half
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * BN, wcol0 = col0 + wn * (BN / 2);
  const int rows = min(kBM, a.M - row0);
  const int kk = a.kh * a.kw;

  // the tensor scale: from the partial maxima, or made by the "c" passes
  float xst, sg_none = 1.0f;
  if (a.mode != kModeC) {
    float m = 0.0f;
    for (int i = tid; i < a.n_partials; i += kThreads) m = mls::nan_max(m, a.partials[i]);
    m = mls::block_max<kThreads>(m, red);
    xst = mls::tensor_scale_of_max(m);
    if (a.mode == kModeNone) sg_none = mls::group_scale(mls::scale_ratio(m, xst), a.f);
  } else {
    xst = *a.xst;
  }
  for (int i = tid; i < 256; i += kThreads) lut[i] = mls::decode_frac(i, a.f.e, a.f.m);
  // tap k of a group -> its offset in the band (channel pitch band_rows rows)
  for (int k = tid; k < a.k_block; k += kThreads) {
    const int cl = k / kk, t = k - cl * kk, i = t / a.kw;
    toff[k] = (cl * a.band_rows + i) * a.wp + (t - i * a.kw);
  }
  // the band: padded rows [gr0, gr0 + bh) of the image-major stack
  const int gr0 = patch_row(row0, a.oh, a.ow, a.hp, a.sh);
  const int bh = patch_row(row0 + rows - 1, a.oh, a.ow, a.hp, a.sh) + a.kh - gr0;
  if (tid < kBM)
    roff[tid] = tid < rows ? (patch_row(row0 + tid, a.oh, a.ow, a.hp, a.sh) - gr0) * a.wp +
                                 ((row0 + tid) % a.ow) * a.sw
                           : 0;
  if (a.mode == kModeN && tid < kBM)  // a row's one group scale, for every group
    rs[tid] = tid < rows ? mls::group_scale(mls::scale_ratio(a.s_r[row0 + tid], xst), a.f)
                         : 0.0f;

  int p[NT][4];
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[t][i] = 0;
      acc[t][i] = 0.0f;
    }
  const int r_lo = row0 + wm * 16 + gid, r_hi = r_lo + 8;
  const int n_chunks = (a.k_block + KC - 1) / KC;
  const int nkb = a.K / a.k_block;
  __syncthreads();
  if constexpr (kEmit) {
    const bool first = blockIdx.x == 0 && blockIdx.y == 0;
    if (a.mode == kModeN && blockIdx.y == 0 && tid < rows) a.sg_out[row0 + tid] = rs[tid];
    if (first && a.mode == kModeNone && tid == 0) a.sg_out[0] = sg_none;
    if (first && a.mode == kModeC)
      for (int g = tid; g < nkb; g += kThreads) a.sg_out[g] = a.xsg[g];
    if (first && tid == 0) *a.st_out = xst;
  }

  for (int g = 0; g < nkb; ++g) {
    const long long kg = (long long)g * a.k_block;
    // stage the band of channels g*cb .. g*cb + cb - 1: a warp per row
    for (int br = warp; br < a.cb * bh; br += kThreads / 32) {
      const int cl = br / bh, row = br - cl * bh;
      const int grow = gr0 + row, img = grow / a.hp, hh = grow - img * a.hp - a.ph;
      const bool row_ok = img < a.n && hh >= 0 && hh < a.h;
      const float* src =
          a.x + (((long long)img * a.c + g * a.cb + cl) * a.h + (row_ok ? hh : 0)) * a.w;
      float* dst = band + (cl * a.band_rows + row) * a.wp;
      for (int j = lane; j < a.wp; j += 32) {
        const int col = j - a.pw;
        const bool ok = row_ok && col >= 0 && col < a.w;
        mls::cp_async4(dst + j, ok ? src + col : a.x, ok ? 4 : 0);
      }
    }
    for (int c = 0; c < n_chunks; ++c) {
      const long long kof = kg + (long long)c * KC;
      const int kw = min(KC, a.k_block - c * KC);
      mls::stage_operand<KC, kThreads>(rbuf, RBP, a.r, a.K, 1, kBM, row0, a.M, kof, kw,
                                       a.r_async);
      mls::stage_operand<KC, kThreads>(rawb, KC, a.wc, a.swn, a.swk, BN, col0, a.O, kof, kw,
                                       a.w_async);
      mls::cp_async_commit();
      mls::cp_async_wait<0>();
      __syncthreads();  // band (c == 0), bytes and weight codes of chunk c landed
      if (c == 0 && a.mode == kModeNc) {
        // K1's group scale per row: max |x| over the group's taps (padding
        // zeros included, as in im2col's cols), / s_t, ceil-rounded
        const int m = tid % kBM, half = tid / kBM;
        float mx = 0.0f;
        for (int k = half; k < a.k_block; k += kThreads / kBM)
          mx = mls::nan_max(mx, mls::abs_bits(band[toff[k] + roff[m]]));
        red2[tid] = mx;
        __syncthreads();
        if (tid < kBM) {
          float v = red2[tid];
          for (int q = 1; q < kThreads / kBM; ++q) v = mls::nan_max(v, red2[tid + q * kBM]);
          rs[tid] = mls::group_scale(mls::scale_ratio(v, xst), a.f);
          if constexpr (kEmit) {
            if (blockIdx.y == 0 && tid < rows)
              a.sg_out[(long long)(row0 + tid) * nkb + g] = rs[tid];
          }
        }
        __syncthreads();
      }
      // codes of the 64 x kw chunk, zeros up to the MMA's 16-wide k step:
      // item (row m, 4 features); a warp's lanes take consecutive rows, so
      // band, byte and code accesses fall in distinct banks
      const int kw16 = (kw + mls::kKStep - 1) / mls::kKStep * mls::kKStep;
      for (int it = tid; it < kBM * (kw16 / 4); it += kThreads) {
        const int m = it % kBM, k4 = (it / kBM) * 4;
        uint32_t codes = 0u;
        if (m < rows && k4 < kw) {
          const float sx = a.mode == kModeNc || a.mode == kModeN ? rs[m]
                           : a.mode == kModeNone                  ? sg_none
                                                                  : a.xsg[g];
          const float denom = __fmul_rn(xst, sx);
          const uint32_t rb = *reinterpret_cast<const uint32_t*>(rbuf + m * RBP + k4);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int k = c * KC + k4 + u;
            if (k4 + u < kw)
              codes |= (uint32_t)mls::element_code(band[toff[k] + roff[m]],
                                                   (rb >> (8 * u)) & 0xFF, denom, a.f)
                       << (8 * u);
          }
          if constexpr (kEmit) {
            if (blockIdx.y == 0) {
              uint8_t* dst = a.codes_out + (long long)(row0 + m) * a.K + kof + k4;
              if (k4 + 4 <= kw && (reinterpret_cast<uintptr_t>(dst) & 3) == 0)
                *reinterpret_cast<uint32_t*>(dst) = codes;
              else
                for (int u = 0; u < 4 && k4 + u < kw; ++u) dst[u] = (codes >> (8 * u)) & 0xFF;
            }
          }
        }
        if constexpr (kMma) {
          *reinterpret_cast<uint32_t*>(deca + m * KCP + k4) =
              k4 < kw ? mls::decode4(lut, codes) : 0u;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            deca[m * KCP + k4 + u] = k4 + u < kw ? lut[(codes >> (8 * u)) & 0xFF] : 0;
        }
      }
      // weight codes -> fractions, 4 per step (K3's decode)
      {
        const uint32_t* src = reinterpret_cast<const uint32_t*>(rawb);
        for (int t = tid; t < BN * (KC / 4); t += kThreads) {
          const int n = t / (KC / 4), w4 = (t % (KC / 4)) * 4;
          const uint32_t v = src[t];
          if constexpr (kMma) {
            *reinterpret_cast<uint32_t*>(decb + n * KCP + w4) = mls::decode4(lut, v);
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) decb[n * KCP + w4 + u] = lut[(v >> (8 * u)) & 0xFF];
          }
        }
      }
      __syncthreads();  // deca, decb ready
      mls::group_dot<kMma, KC, NT>(p, deca + wm * 16 * KCP, decb + wn * (BN / 2) * KCP, KCP,
                                   gid, tig, kw);
      if (c == n_chunks - 1) {  // group g complete: K3's combine, in k order
        float sx[2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int gr = h2 ? r_hi : r_lo;
          sx[h2] = gr >= a.M                                ? 0.0f
                   : a.mode == kModeNc || a.mode == kModeN  ? rs[gr - row0]
                   : a.mode == kModeNone                    ? sg_none
                                                            : a.xsg[g];
        }
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = wcol0 + t * 8 + 2 * tig + j;
            const float sw = col < a.O ? a.wsg[g * a.swsg_g + col * a.swsg_n] : 0.0f;
            acc[t][j] = mls::group_combine(acc[t][j], p[t][j], sx[0], sw);
            acc[t][2 + j] = mls::group_combine(acc[t][2 + j], p[t][2 + j], sx[1], sw);
            p[t][j] = 0;
            p[t][2 + j] = 0;
          }
      }
      __syncthreads();  // the buffers are free for the next chunk or group
    }
  }
  const float st = mls::tensor_scale(xst, *a.wst, a.unit);
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = wcol0 + t * 8 + 2 * tig + j;
      if (col < a.O && r_lo < a.M) a.out[(long long)r_lo * a.O + col] = __fmul_rn(acc[t][j], st);
      if (col < a.O && r_hi < a.M)
        a.out[(long long)r_hi * a.O + col] = __fmul_rn(acc[t][2 + j], st);
    }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Pass A's row tiling: s threads per covered row (a power of two from 32
// to kAmaxThreads), and the grid.
void amax_tiling(int planes, int hcov, int wcov, int* s, int* blocks) {
  *s = 32;
  while (*s < wcov && *s < kAmaxThreads) *s <<= 1;
  const long long rb = kAmaxThreads / *s;
  const long long iters = ((long long)planes * (hcov > 0 ? hcov : 0) + rb - 1) / rb;
  *blocks = (int)(iters < 1 ? 1 : iters > kAmaxBlocks ? kAmaxBlocks : iters);
}

// The tallest band over the output tiles, in padded rows.
int band_rows_max(int M, int oh, int ow, int hp, int sh, int kh) {
  int best = 0;
  for (int row0 = 0; row0 < M; row0 += kBM) {
    const int last = row0 + (M - row0 < kBM ? M - row0 : kBM) - 1;
    const int bh = patch_row(last, oh, ow, hp, sh) + kh - patch_row(row0, oh, ow, hp, sh);
    if (bh > best) best = bh;
  }
  return best;
}

int max_fraction(int e, int m) {
  int best = 0;
  for (int c = 0; c < (1 << (1 + e + m)); ++c) {
    const int v = mls::decode_frac(c, e, m);
    best = v > best ? v : -v > best ? -v : best;
  }
  return best;
}

template <int BN, bool kMma, bool kEmit>
cudaError_t launch_main(const ConvArgs& a, cudaStream_t s) {
  const Smem<BN, kMma> lay(a.cb, a.band_rows, a.wp, a.k_block);
  auto kernel = implicit_conv_kernel<BN, kMma, kEmit>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.M + kBM - 1) / kBM, (a.O + BN - 1) / BN);
  if (grid.y > kMaxGridY) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, lay.total, s>>>(a);
  return cudaGetLastError();
}

void covered(int h, int w, int kh, int kw, int sh, int sw, int ph, int pw, int oh, int ow,
             int* hcov, int* wcov) {
  const int hc = (oh - 1) * sh + kh - ph, wc = (ow - 1) * sw + kw - pw;
  *hcov = hc < h ? hc : h;
  *wcov = wc < w ? wc : w;
}

// conv_win_amax's grid ("n"): a thread per output row, at most kAmaxBlocks blocks.
int win_blocks(long long M) {
  const long long b = (M + kAmaxThreads - 1) / kAmaxThreads;
  return (int)(b < 1 ? 1 : b > kAmaxBlocks ? kAmaxBlocks : b);
}

}  // namespace

// The tile constants, in the order kBM, kThreads, kAmaxThreads,
// kAmaxBlocks, kBandBytesMax, for the launch descriptors
// (kernels/implicit_conv.py launch_spec) to read from the binary.
extern "C" int implicit_conv_constants(int* out, int n) {
  const int c[] = {kBM, kThreads, kAmaxThreads, kAmaxBlocks, kBandBytesMax};
  for (int i = 0; i < n && i < 5; ++i) out[i] = c[i];
  return 5;
}

// K4.  x: the unpadded input (n, c, h, w), fp32, contiguous; padded to
// (hp, wp) with (ph, pw) zero rows and columns at the top and left.  r: the
// rounding bytes (M0, K0).  mode: 0 "nc", 1 "none", 2 "c", 3 "n".  scratch
// (n_scratch floats) holds what the scale passes write:
//   "nc", "none": pass A's partials (as amax_tiling gives);
//   "n": the M0 patch maxima, then win_blocks(M0) partials;
//   "c": the n*c plane maxima, G group maxima, s_t, G group scales
//        (G = K0 / k_block).
// wc, wsg: the weight's codes (K0, O) and compact scales, strided.
// out: (M0, O).  bn: the main kernel's tile width, 16, 32 or 64 (every
// width gives the same bits; the wrapper's default is the narrowest that
// holds O).  codes_out, sg_out, st_out: all NULL, or (emit) the
// activation's codes (M0, K0), its compact group scales ("nc" (M0, K0 /
// k_block), "n" (M0, 1), "c" (1, K0 / k_block), "none" (1, 1)) and s_t.
extern "C" int implicit_conv(const float* x, const uint8_t* r, float* scratch,
                             long long n_scratch, const uint8_t* wc, long long swk,
                             long long swn, const float* wsg, long long swsg_g,
                             long long swsg_n, const float* wst, float unit, float* out,
                             uint8_t* codes_out, float* sg_out, float* st_out, int n,
                             int c, int h, int w, int o, int kh, int kw, int sh, int sw,
                             int ph, int pw, int hp, int wp, int k_block, int mode, int bn,
                             int e, int m, int e_min, int gs_m, int gs_emin, void* stream) {
  ConvArgs a;
  a.n = n; a.c = c; a.h = h; a.w = w; a.kh = kh; a.kw = kw; a.sh = sh; a.sw = sw;
  a.ph = ph; a.pw = pw; a.hp = hp; a.wp = wp;
  if (hp < kh || wp < kw || sh < 1 || sw < 1) return (int)cudaErrorInvalidValue;
  a.oh = (hp - kh) / sh + 1;
  a.ow = (wp - kw) / sw + 1;
  const int oh = a.oh, ow = a.ow;
  a.M = n * oh * ow; a.O = o; a.K = c * kh * kw; a.k_block = k_block; a.mode = mode;
  if (k_block <= 0 || k_block % (kh * kw) || c % (k_block / (kh * kw)) || mode < 0 ||
      mode > 3 || !scratch || (bn != 16 && bn != 32 && bn != 64))
    return (int)cudaErrorInvalidValue;
  a.cb = k_block / (kh * kw);
  if (a.M <= 0 || o <= 0) return (int)cudaGetLastError();
  a.f = mls::Fmt{e, m, e_min, gs_m, gs_emin};
  a.x = x; a.r = r; a.partials = nullptr; a.n_partials = 0; a.s_r = nullptr;
  a.xst = nullptr; a.xsg = nullptr;
  a.wc = wc; a.swk = swk; a.swn = swn; a.wsg = wsg; a.swsg_g = swsg_g; a.swsg_n = swsg_n;
  a.wst = wst; a.unit = unit; a.out = out;
  const bool emit = codes_out != nullptr;
  if (emit != (sg_out != nullptr) || emit != (st_out != nullptr))
    return (int)cudaErrorInvalidValue;
  a.codes_out = codes_out; a.sg_out = sg_out; a.st_out = st_out;
  a.band_rows = band_rows_max(a.M, oh, ow, a.hp, sh, kh);
  if ((long long)a.cb * a.band_rows * a.wp * 4 > kBandBytesMax) return (int)cudaErrorInvalidValue;
  a.r_async = a.K % 16 == 0 && k_block % 16 == 0 && aligned16(r);
  a.w_async = swk == 1 && k_block % 16 == 0 && swn % 16 == 0 && aligned16(wc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int hcov, wcov;
  covered(h, w, kh, kw, sh, sw, ph, pw, oh, ow, &hcov, &wcov);
  const Cov cov{ph, pw, sh, sw, kh, kw};
  if (mode == kModeNc || mode == kModeNone) {
    int threads, blocks;
    amax_tiling(n * c, hcov, wcov, &threads, &blocks);
    if (n_scratch != blocks) return (int)cudaErrorInvalidValue;
    a.partials = scratch;
    a.n_partials = blocks;
    conv_amax<<<blocks, kAmaxThreads, 0, s>>>(x, n * c, h, w, hcov, wcov, threads, cov,
                                              scratch);
  } else if (mode == kModeN) {
    const int blocks = win_blocks(a.M);
    if (n_scratch != (long long)a.M + blocks) return (int)cudaErrorInvalidValue;
    a.s_r = scratch;
    a.partials = scratch + a.M;
    a.n_partials = blocks;
    conv_win_amax<<<blocks, kAmaxThreads, 0, s>>>(a, scratch, scratch + a.M);
  } else {
    const int G = a.K / k_block;
    const long long planes = (long long)n * c;
    if (n_scratch != planes + 2LL * G + 1) return (int)cudaErrorInvalidValue;
    float* gmax = scratch + planes;
    a.xst = gmax + G;
    a.xsg = gmax + G + 1;
    conv_chan_amax<<<(unsigned)((planes + kAmaxThreads / 32 - 1) / (kAmaxThreads / 32)),
                     kAmaxThreads, 0, s>>>(x, n, c, h, w, hcov, wcov, cov, scratch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    conv_group_reduce<<<G, kAmaxThreads, 0, s>>>(scratch, a.cb * n, gmax);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    conv_chan_scales<<<1, kAmaxThreads, 0, s>>>(gmax, G, gmax + G, gmax + G + 1, a.f);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool mma = max_fraction(e, m) <= 127;
#define MAIN(EMIT)                                                                       \
  (mma ? (bn == 16   ? launch_main<16, true, EMIT>(a, s)                                \
          : bn == 32 ? launch_main<32, true, EMIT>(a, s)                                \
                     : launch_main<64, true, EMIT>(a, s))                               \
       : (bn == 16   ? launch_main<16, false, EMIT>(a, s)                               \
          : bn == 32 ? launch_main<32, false, EMIT>(a, s)                               \
                     : launch_main<64, false, EMIT>(a, s)))
  err = emit ? MAIN(true) : MAIN(false);
#undef MAIN
  return (int)err;
}

// K4's pass A alone: the tensor scale over the covered pixels
// (covered_tensor_scale), into s_t.
extern "C" int conv_tensor_scale(const float* x, float* partials, int n_partials, float* s_t,
                                 int n, int c, int h, int w, int kh, int kw, int sh, int sw,
                                 int ph, int pw, int hp, int wp, void* stream) {
  if (hp < kh || wp < kw || sh < 1 || sw < 1) return (int)cudaErrorInvalidValue;
  const int oh = (hp - kh) / sh + 1, ow = (wp - kw) / sw + 1;
  int hcov, wcov, threads, blocks;
  covered(h, w, kh, kw, sh, sw, ph, pw, oh, ow, &hcov, &wcov);
  amax_tiling(n * c, hcov, wcov, &threads, &blocks);
  if (n_partials != blocks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  conv_amax<<<blocks, kAmaxThreads, 0, s>>>(x, n * c, h, w, hcov, wcov, threads,
                                            Cov{ph, pw, sh, sw, kh, kw}, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  conv_scale<<<1, kAmaxThreads, 0, s>>>(partials, blocks, s_t);
  return (int)cudaGetLastError();
}
