// Kernel B4: four-step steps 1–3 of a complex DFT, per frame.
//
// Replaces emspec/dsp/pallas/fft4.py::fft4_steps123 (_fft4_kernel,
// _fft4_frame).  With z reshaped row-major to (n1, n2):
//   step 1   A[k1, n2] = Σ_j (C1 − i·S1)[k1, j] · z[j, n2]
//   step 2   B = A ∘ TW                   (TW[k1, n2] = e^{−2πi·k1·n2/n})
//   step 3   X[k1, k2] = Σ_m B[k1, m] · (C2 − i·S2)[m, k2]
// The caller does the step-4 reindex (k = k1 + n1·k2), as on the TPU.
//
// Arithmetic: float32 FMAs on the CUDA cores, accumulated in one pass
// over j (or m).  The TPU kernel split every operand into bf16 hi/lo
// terms for its MXU; full float32 needs no split and is at least as
// accurate.  Tables come from the wrapper, built in float64 and cast to
// float32 (emspec_torch/dsp/kernels/fourstep.py::tables).  C1, S1, C2
// and S2 are symmetric bit for bit (the angle is built from the product
// j·k), so row j of C1 is its column j: threads with consecutive k1 read
// consecutive addresses.
//
// What bounds it on the H100: operations.  As dense DFT products the
// four-step form does 8·n·(n1 + n2) flops a frame, 1.6·(n1 + n2)/log2 n
// times an FFT's 5·n·log2 n (about 17× at n = 4096), against 16·n bytes
// of input and output, so the float32 rate, not device memory, is its
// limit; the roofline bound (PERF.md), which counts 5·n·log2 n, is set by
// the bytes.  Design: two
// launches through a global scratch B (8·n bytes a frame, L2-resident at
// the main path's batches), so that every factorization in
// fourstep._FACTORS (16×16 … 512×512) runs with at most 64 KB of shared
// memory a block, and a single frame (the live step, b = 1) still spreads
// over n2/16 + n1/16 blocks:
//   * steps 1+2: one unit = 16 columns of one frame; the (n1, 16) complex
//     tile sits in shared memory, each thread owns one k1 and 16 column
//     accumulators, the twiddle is applied before B is written;
//   * step 3: one unit = 16 rows of the (b·n1, n2) matrix B; the tile sits
//     in shared memory as [m][16], each thread owns one k2 and 16 row
//     accumulators; X is written coalesced along k2.
// No wgmma/TMA and no tensor cores yet: simple and right first.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;        // columns (steps 1+2) / rows (step 3) a unit
constexpr int kMaxX = 256;       // threads along k1 / k2 per unit
constexpr int kMinThreads = 128; // threads a block at least (units per block)

__global__ void __launch_bounds__(kMaxX) steps12_kernel(
    const float* __restrict__ zr, const float* __restrict__ zi,
    const float* __restrict__ c1, const float* __restrict__ s1,
    const float* __restrict__ twr, const float* __restrict__ twi,
    float* __restrict__ br, float* __restrict__ bi,
    long long units, int n1, int n2) {
  extern __shared__ float sm[];
  float* tr = sm + threadIdx.y * (2 * n1 * kTile);   // [j][16] real
  float* ti = tr + n1 * kTile;                       // [j][16] imag
  const long long unit = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = unit < units;
  const int per_frame = n2 / kTile;
  const long long frame = unit / per_frame;
  const int c0 = (int)(unit % per_frame) * kTile;
  const long long base = frame * n1 * (long long)n2 + c0;
  if (live) {
    for (int e = threadIdx.x; e < n1 * kTile; e += blockDim.x) {
      const long long g = base + (long long)(e / kTile) * n2 + (e % kTile);
      tr[e] = zr[g];
      ti[e] = zi[g];
    }
  }
  __syncthreads();
  if (!live) return;
  for (int k1 = threadIdx.x; k1 < n1; k1 += blockDim.x) {
    float ar[kTile], ai[kTile];
#pragma unroll
    for (int q = 0; q < kTile; ++q) ar[q] = ai[q] = 0.0f;
    for (int j = 0; j < n1; ++j) {
      const float c = c1[j * n1 + k1];       // = C1[k1, j] (symmetric)
      const float s = s1[j * n1 + k1];
      const float* xr = tr + j * kTile;
      const float* xi = ti + j * kTile;
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        ar[q] = fmaf(s, xi[q], fmaf(c, xr[q], ar[q]));
        ai[q] = fmaf(-s, xr[q], fmaf(c, xi[q], ai[q]));
      }
    }
    const long long row = base + (long long)k1 * n2;
    const int tw0 = k1 * n2 + c0;
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
      const float wr = twr[tw0 + q], wi = twi[tw0 + q];
      br[row + q] = ar[q] * wr + ai[q] * wi;
      bi[row + q] = ai[q] * wr - ar[q] * wi;
    }
  }
}

__global__ void __launch_bounds__(kMaxX) step3_kernel(
    const float* __restrict__ br, const float* __restrict__ bi,
    const float* __restrict__ c2, const float* __restrict__ s2,
    float* __restrict__ xr, float* __restrict__ xi,
    long long units, int n2) {
  extern __shared__ float sm[];
  float* tr = sm + threadIdx.y * (2 * n2 * kTile);   // [m][16] real
  float* ti = tr + n2 * kTile;                       // [m][16] imag
  const long long unit = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = unit < units;
  const long long r0 = unit * kTile;
  if (live) {
    for (int e = threadIdx.x; e < n2 * kTile; e += blockDim.x) {
      const int q = e / n2, m = e % n2;
      const long long g = (r0 + q) * n2 + m;
      tr[m * kTile + q] = br[g];
      ti[m * kTile + q] = bi[g];
    }
  }
  __syncthreads();
  if (!live) return;
  for (int k2 = threadIdx.x; k2 < n2; k2 += blockDim.x) {
    float ar[kTile], ai[kTile];
#pragma unroll
    for (int q = 0; q < kTile; ++q) ar[q] = ai[q] = 0.0f;
    for (int m = 0; m < n2; ++m) {
      const float c = c2[m * n2 + k2];
      const float s = s2[m * n2 + k2];
      const float* vr = tr + m * kTile;
      const float* vi = ti + m * kTile;
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        ar[q] = fmaf(s, vi[q], fmaf(c, vr[q], ar[q]));
        ai[q] = fmaf(-s, vr[q], fmaf(c, vi[q], ai[q]));
      }
    }
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
      xr[(r0 + q) * n2 + k2] = ar[q];
      xi[(r0 + q) * n2 + k2] = ai[q];
    }
  }
}

// Launch shape for a unit of `width` threads: (threads per unit, units a block)
dim3 block_of(int width) {
  const int x = width < kMaxX ? width : kMaxX;
  const int y = x < kMinThreads ? kMinThreads / x : 1;
  return dim3(x, y);
}

}  // namespace

// zr, zi: (b, n1, n2) float32, contiguous.  br, bi: scratch of the same
// shape.  xr, xi: the output X[k1, k2].  n1, n2: multiples of 16, ≤ 512.
extern "C" int emspec_fourstep(
    const float* zr, const float* zi, const float* c1, const float* s1,
    const float* twr, const float* twi, const float* c2, const float* s2,
    float* br, float* bi, float* xr, float* xi, long long b, int n1, int n2,
    void* stream) {
  if (n1 % kTile || n2 % kTile || n1 < kTile || n2 < kTile || n1 > 512
      || n2 > 512)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;

  const dim3 blk1 = block_of(n1);
  const int smem1 = (int)(sizeof(float) * 2 * n1 * kTile * blk1.y);
  cudaError_t err = cudaFuncSetAttribute(
      steps12_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return (int)err;
  const long long units1 = b * (n2 / kTile);
  steps12_kernel<<<(unsigned)((units1 + blk1.y - 1) / blk1.y), blk1, smem1,
                   st>>>(zr, zi, c1, s1, twr, twi, br, bi, units1, n1, n2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 blk3 = block_of(n2);
  const int smem3 = (int)(sizeof(float) * 2 * n2 * kTile * blk3.y);
  err = cudaFuncSetAttribute(
      step3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem3);
  if (err != cudaSuccess) return (int)err;
  const long long units3 = b * (n1 / kTile);
  step3_kernel<<<(unsigned)((units3 + blk3.y - 1) / blk3.y), blk3, smem3,
                 st>>>(br, bi, c2, s2, xr, xi, units3, n2);
  return (int)cudaGetLastError();
}
