// Kernel B4: four-step steps 1–3 of a complex DFT, per frame, as radix
// FFTs in shared memory.
//
// Replaces emspec/dsp/pallas/fft4.py::fft4_steps123 (_fft4_kernel,
// _fft4_frame).  With z reshaped row-major to (n1, n2):
//   step 1   A[k1, c]  = Σ_j z[j, c]·W_n1^{j·k1}     n2 column FFTs of n1 points
//   step 2   B = A ∘ TW,  TW[k1, c] = W_n^{k1·c}
//   step 3   X[k1, k2] = Σ_c B[k1, c]·W_n2^{c·k2}    n1 row FFTs of n2 points
// (W_m = e^{−2πi/m}).  The caller does the step-4 reindex (k = k1 + n1·k2),
// as on the TPU.  The TPU kernel evaluates steps 1 and 3 as dense DFT
// products on its MXU; here they are FFTs of the same function.
//
// Why FFTs and not dense products on the tensor cores: dense products do
// 8·n·(n1 + n2) flops a frame, 17× an FFT's 5·n·log2 n at 64 × 64.  Full
// float32 accuracy on the tensor cores needs a 3-pass TF32 split, and even
// at the ~165 TFLOP/s that split allows the products would take 0.15 ms at
// 5937 × 64 × 64 and 0.28 ms at 1376 × 128 × 128 — above the byte bounds
// of 0.116 and 0.108 ms.  A radix body's arithmetic takes ~0.02 ms at the
// float32 peak there, so only device-memory bytes bound it: 16·n bytes a
// frame (z in, X out) on the small route, twice that on the large one.
//
// Sub-FFTs: Stockham autosort passes of radix 16, the last pass of a line
// taking the remainder (2, 4 or 8): a line of m points takes
// ceil(log16 m) passes.  In a pass every thread holds P points (P/R
// butterflies) in registers: it loads them, the block syncs, it applies
// the inter-pass twiddles, runs its radix-R DFTs in registers, stores the
// results at their autosorted places in the same buffer, and the block
// syncs.  Thread t takes butterflies t + g·T (g < P/R, T threads); a
// butterfly is (line L, j) = (job mod lines, job div lines), so
// consecutive threads take consecutive lines.  Rows of a shared tile are
// padded by one complex value (row stride n2 + 1 float2): the column
// passes then read and write consecutive addresses and the row passes a
// stride of 2·n2 + 2 ≡ 2 (mod 32) words, neither with bank conflicts.
//
// Twiddles: the inter-pass W_{Ns·R}^{k·r} = W_512^{k·r·512/(Ns·R)} from a
// table of W_512^t (t < 512, staged in shared memory) and TW from an
// (n1, n2) table in device memory, both built in float64 on the host and
// cast to float32 (emspec_torch/dsp/kernels/fourstep.py::radix_tables).
// The radix-R DFTs' own W_16^t are float32 constants of the same values
// (W_16^4 = −i exactly).  No sincosf at run time.  A frame's arithmetic
// depends on (n1, n2) and the route only, never on b or on where the frame
// sits in the batch, so b = 1 gives frame 0 of a batch bit for bit.
//
// The FFT body (the radix DFTs, pass, line_fft, the tile copies) is
// radix_common.cuh, which kernel B1's on-chip routes (deposits.cu) share.
//
// Routes (the wrapper picks by n1·n2 alone):
//   * small, n1·n2 <= 16384: one launch, no scratch.  A block takes F
//     frames (F·n >= 2048, so >= 128 threads): it loads their (n1, n2)
//     tiles with 16-byte loads (8·n1·(n2 + 1) bytes a frame, 132 KB at
//     128 × 128), runs steps 1–3 in shared memory (TW applied as the last
//     column pass stores) and writes X with 16-byte stores.
//   * large, for 128 × 256 … 512 × 512 (B1's large route): a frame's tile
//     is over a block's 227 KB, so two launches through a global scratch
//     B: strips of 16 columns of one frame (steps 1+2), then strips of 16
//     rows of the (b·n1, n2) matrix B (step 3), with the same pass code.
// The MaxDynamicSharedMemorySize attribute is set once per kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cuda_runtime.h>

#include "radix_common.cuh"

namespace {

using namespace emspec::radix;

constexpr int kLog2Strip = 4;                 // large route: 16 columns / rows a block
constexpr int kStrip = 1 << kLog2Strip;
constexpr int kLog2BlockPoints = 11;          // small route: F·n >= 2048
constexpr int kSmallMaxLog2N = 14;            // small route: n <= 16384
constexpr int kMaxThreads = 512;

// Small route: F = 2^log2f frames a block, steps 1–3 in shared memory.
// P = 16 asks for two blocks an SM (<= 64 registers, a few values spill):
// one block's tile load then overlaps another's passes, which beat one
// block at ~105 registers on the card.
template <int P>
__global__ void __launch_bounds__(kMaxThreads, P == 16 ? 2 : 1) small_kernel(
    const float* __restrict__ zr, const float* __restrict__ zi,
    const float2* __restrict__ w512, const float2* __restrict__ tw,
    float* __restrict__ xr, float* __restrict__ xi, long long b, int log2n1,
    int log2n2, int log2f) {
  extern __shared__ float2 sm[];
  float2* w = sm;
  float2* tile = sm + kTable;                   // F tiles of (n1, n2 + 1)
  const int log2n = log2n1 + log2n2;
  const int fs = (1 << log2n1) * ((1 << log2n2) + 1);
  const long long f0 = (long long)blockIdx.x << log2f;
  // the F tiles' rows follow each other at stride n2 + 1, as the frames'
  // rows do at n2: one copy of frames·n1 rows (a ragged last block leaves
  // its missing frames unread and unwritten)
  const int rows = (b - f0 < (1 << log2f) ? (int)(b - f0) : 1 << log2f)
                   << log2n1;
  load_table(w, w512);
  load_tile<P>(tile, zr, zi, f0 << log2n, rows, log2n2, log2n2);
  __syncthreads();
  // steps 1+2: n1-point FFTs down the F·n2 columns, TW on the last pass
  line_fft<P>(tile, w, Lines{log2f + log2n2, log2n2, fs, 1, (1 << log2n2) + 1},
              log2n1, Step2{tw, log2n2, 0});
  // step 3: n2-point FFTs along the F·n1 rows
  line_fft<P>(tile, w, Lines{log2f + log2n1, 0, (1 << log2n2) + 1, 0, 1},
              log2n2, Step2{nullptr, 0, 0});
  store_tile<P>(tile, xr, xi, f0 << log2n, rows, log2n2, log2n2);
}

// Large route, launch 1: 16 columns c0 … c0 + 15 of one frame, steps 1+2,
// written to the scratch B in place of z.
template <int P>
__global__ void __launch_bounds__(kMaxThreads) cols_kernel(
    const float* __restrict__ zr, const float* __restrict__ zi,
    const float2* __restrict__ w512, const float2* __restrict__ tw,
    float* __restrict__ br, float* __restrict__ bi, int log2n1, int log2n2) {
  extern __shared__ float2 sm[];
  float2* w = sm;
  float2* tile = sm + kTable;                   // (n1, 16 + 1)
  const int strips = log2n2 - kLog2Strip;
  const long long f = blockIdx.x >> strips;
  const int c0 = (blockIdx.x & ((1 << strips) - 1)) << kLog2Strip;
  const long long at = (f << (log2n1 + log2n2)) + c0;
  load_table(w, w512);
  load_tile<P>(tile, zr, zi, at, 1 << log2n1, kLog2Strip, log2n2);
  __syncthreads();
  line_fft<P>(tile, w, Lines{kLog2Strip, kLog2Strip, 0, 1, kStrip + 1},
              log2n1, Step2{tw, log2n2, c0});
  store_tile<P>(tile, br, bi, at, 1 << log2n1, kLog2Strip, log2n2);
}

// Large route, launch 2: 16 rows of the (b·n1, n2) matrix B, step 3.
template <int P>
__global__ void __launch_bounds__(kMaxThreads) rows_kernel(
    const float* __restrict__ br, const float* __restrict__ bi,
    const float2* __restrict__ w512, float* __restrict__ xr,
    float* __restrict__ xi, int log2n2) {
  extern __shared__ float2 sm[];
  float2* w = sm;
  float2* tile = sm + kTable;                   // (16, n2 + 1)
  const long long at = (long long)blockIdx.x << (kLog2Strip + log2n2);
  load_table(w, w512);
  load_tile<P>(tile, br, bi, at, kStrip, log2n2, log2n2);
  __syncthreads();
  line_fft<P>(tile, w, Lines{kLog2Strip, 0, (1 << log2n2) + 1, 0, 1}, log2n2,
              Step2{nullptr, 0, 0});
  store_tile<P>(tile, xr, xi, at, kStrip, log2n2, log2n2);
}

constexpr int smem_bytes(int tile_points) {
  return (int)sizeof(float2) * (kTable + tile_points);
}
// the most each kernel asks for: 128 × (128 + 1); 512 × (16 + 1); 16 × (512 + 1)
constexpr int kSmallSmem = smem_bytes(128 * 129);
constexpr int kColsSmem = smem_bytes(512 * (kStrip + 1));
constexpr int kRowsSmem = smem_bytes(kStrip * 513);

// Allow a kernel its dynamic shared memory, once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

int log2_of(int v) {
  int l = 0;
  while (l < 30 && (1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

}  // namespace

// zr, zi: (b, n1, n2) float32, contiguous, 16-byte aligned.  w512: the
// W_512^t table, tw: TW (n1·n2 float2).  large = 0: the one-launch route
// (n1·n2 <= 16384), br and bi unused; large = 1: two launches through the
// scratch br, bi of the input's shape.  xr, xi: X[k1, k2].  n1, n2: powers
// of two in [16, 512].
extern "C" int emspec_fourstep(
    const float* zr, const float* zi, const void* w512, const void* tw,
    float* br, float* bi, float* xr, float* xi, long long b, int n1, int n2,
    int large, void* stream) {
  const int l1 = log2_of(n1), l2 = log2_of(n2);
  if (l1 < 4 || l2 < 4 || l1 > kLog2Table || l2 > kLog2Table
      || (!large && l1 + l2 > kSmallMaxLog2N)
      || (large && (br == nullptr || bi == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float2* w = static_cast<const float2*>(w512);
  const float2* t = static_cast<const float2*>(tw);
  if (!large) {
    static const cudaError_t attr16 = allow_smem(small_kernel<16>, kSmallSmem);
    static const cudaError_t attr32 = allow_smem(small_kernel<32>, kSmallSmem);
    if (attr16 != cudaSuccess) return (int)attr16;
    if (attr32 != cudaSuccess) return (int)attr32;
    const int log2n = l1 + l2;
    const int log2f = log2n < kLog2BlockPoints ? kLog2BlockPoints - log2n : 0;
    const int points = 1 << (log2n + log2f);
    const int smem = smem_bytes((n1 << log2f) * (n2 + 1));
    const unsigned blocks = (unsigned)((b + (1 << log2f) - 1) >> log2f);
    if (log2n < kSmallMaxLog2N)
      small_kernel<16><<<blocks, points / 16, smem, st>>>(
          zr, zi, w, t, xr, xi, b, l1, l2, log2f);
    else
      small_kernel<32><<<blocks, points / 32, smem, st>>>(
          zr, zi, w, t, xr, xi, b, l1, l2, log2f);
    return (int)cudaGetLastError();
  }
  static const cudaError_t attr_c = allow_smem(cols_kernel<16>, kColsSmem);
  static const cudaError_t attr_r = allow_smem(rows_kernel<16>, kRowsSmem);
  if (attr_c != cudaSuccess) return (int)attr_c;
  if (attr_r != cudaSuccess) return (int)attr_r;
  // 16 columns of n1 points a block: n1·16 points, 16 a thread
  cols_kernel<16><<<(unsigned)(b << (l2 - kLog2Strip)), n1,
                    smem_bytes(n1 * (kStrip + 1)), st>>>(zr, zi, w, t, br, bi,
                                                         l1, l2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rows_kernel<16><<<(unsigned)(b << (l1 - kLog2Strip)), n2,
                    smem_bytes(kStrip * (n2 + 1)), st>>>(br, bi, w, xr, xi, l2);
  return (int)cudaGetLastError();
}
