// The static verifier's planted-overlap control (K5): a deliberately wrong
// fp32 tiled matmul for Hopper.
//
// Replaces the TPU kernel src/repro/analysis/kernel_verify.py
// _sabotage_overlap_jaxpr.kernel (launched there as a pallas_call with grid
// (1, 4, 2)).  It computes x (8, 16) @ w (16, 32) in 8x8 output tiles:
// block (i, j) walks the two 8-deep k-tiles in order, sums each tile's eight
// products in order and adds that partial to its fp32 accumulator
// (acc = 0 + p0, then acc + p1, as the TPU's acc_ref += dot), then stores
// the tile at block (i, j - j % 2).  That output map is the fault it plants:
// blocks j = 0 and 1 both write block column 0, j = 2 and 3 both write
// column 2, and columns 1 and 3 are never written.  Two blocks run at once
// on the card and race for each element of columns 0 and 2, so which
// writer's value survives is not determined; the verifier (analysis/
// kernel_verify.py) reports the overlap and the gap from the launch
// descriptor (kernels/sabotage.py launch_spec) without running anything.
// When `probe` is given, every element store also adds one to probe at the
// same position, so the race shows on the card as a count of 2 per element
// of columns 0 and 2 and 0 elsewhere.
//
// Bound: launch latency.  The work reads 128 + 512 floats and writes 256,
// 3,584 bytes, with 8,192 floating-point operations.  One thread per output
// element, products rounded with __fmul_rn and sums with __fadd_rn (no FMA:
// the build passes -fmad=false too), no shared memory, no library matmul.
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 8;  // output tile rows
constexpr int kBN = 8;  // output tile columns
constexpr int kBK = 8;  // contraction tile depth
constexpr int kThreads = kBM * kBN;

__global__ void __launch_bounds__(kThreads) sabotage_overlap_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ out, int* __restrict__ probe, int K, int N) {
  const int i = blockIdx.x, j = blockIdx.y;
  const int r = threadIdx.x / kBN, c = threadIdx.x % kBN;
  const int row = i * kBM + r, col = j * kBN + c;
  float acc = 0.0f;
  for (int k = 0; k < K / kBK; ++k) {  // the TPU's sequential k axis
    float p = 0.0f;
    for (int kk = 0; kk < kBK; ++kk) {
      const int kf = k * kBK + kk;
      p = __fadd_rn(p, __fmul_rn(x[row * K + kf], w[kf * N + col]));
    }
    acc = __fadd_rn(acc, p);
  }
  const int at = row * N + (j - j % 2) * kBN + c;  // the planted fault
  out[at] = acc;
  if (probe != nullptr) atomicAdd(probe + at, 1);
}

}  // namespace

// The tile constants, in the order kBM, kBN, kBK, kThreads, for the launch
// descriptor (kernels/sabotage.py launch_spec) to read from the binary.
extern "C" int sabotage_overlap_constants(int* out, int n) {
  const int c[] = {kBM, kBN, kBK, kThreads};
  for (int i = 0; i < n && i < 4; ++i) out[i] = c[i];
  return 4;
}

// x (M, K), w (K, N), out (M, N): fp32, contiguous; M, N multiples of 8 and
// K of 8.  probe: int32 (M, N) or NULL.  Grid (M/8, N/8), 64 threads.
extern "C" int sabotage_overlap(const float* x, const float* w, float* out,
                                int* probe, int M, int K, int N,
                                void* stream) {
  if (M > 0 && N > 0) {
    const dim3 grid(M / kBM, N / kBN);
    sabotage_overlap_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        x, w, out, probe, K, N);
  }
  return (int)cudaGetLastError();
}
