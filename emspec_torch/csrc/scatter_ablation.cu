// Probe: kernel B2 (histogram.cu) with single stages taken out, for
// timing where B2's time sits.
//
// Replaces bench_probes/scatter_ablation.py::hist_variant.  The TPU probe
// stubbed the one-hot GEMM stages of its histogram (O build, A build,
// GEMM); B2 has none of them, so this probe takes out B2's own stages.
// Every variant runs B2's device code (histogram_common.cuh: consume, its
// 16-byte loads and head/tail peel, the per-thread run merge, Sink and
// warp_add) on the route B2 takes for the shape (scatter.route_of: row or
// global), with one stage changed:
//   0 full       none: B2 itself, the same code as histogram.cu's kernels;
//   1 no_merge   warp_add without __match_any_sync and the peer tree:
//                every lane issues its own atomic — full minus this is
//                what the warp merge costs or saves;
//   2 no_atomic  the add of a lane or merged group becomes a plain store
//                of 1 where the group's sum is >= 0 (for values >= 0, as
//                every caller's: 1 where an in-range deposit lands) — full
//                minus this is the cost of the atomics;
//   3 no_zero    row route only: a block takes kNoZeroRows consecutive
//                rows and zero-fills its histogram once for them, so row r
//                holds the running sum of its group up to r — full minus
//                this is 3/4 of the zero-fill;
//   4 io_only    consume's loads, peel and validity mask, the sink a
//                per-thread register sum: cell i of a row holds thread
//                (i mod 512)'s sum (row route), flat cell c thread
//                (c mod the grid's threads)'s (global) — full minus this
//                is the cost of the histogram's adds.
// Each variant has a plain PyTorch version of its own arithmetic
// (emspec_torch/probes/scatter_ablation.py), with this file's thread map.
//
// What bounds it on the H100: as B2 — the inputs' 8 bytes a deposit and
// the output's 4 bytes a cell; in practice the warp steps' match and
// atomics.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cuda_runtime.h>

#include "histogram_common.cuh"

namespace {

using namespace emspec::hist;

constexpr int kMaxSmem = 232448;      // a block's shared memory (227 KB)
constexpr int kNoZeroRows = 4;

// B2's row_kernel, kNoZeroRows rows a block for no_zero.
template <int kStage>
__global__ void __launch_bounds__(kRowThreads) row_kernel(
    const int* __restrict__ ids, const float* __restrict__ vals,
    float* __restrict__ out, long long rows, long long m, int num_bins,
    int a0, int vec) {
  extern __shared__ __align__(16) float h[];
  if (kStage == kIoOnly) {
    const long long row = blockIdx.x;
    const Sink<false, unsigned, kIoOnly> sink{nullptr, m, num_bins};
    consume(ids, vals, sink, row * m, (row + 1) * m, a0, vec != 0,
            threadIdx.x, kRowThreads, threadIdx.x < 32u);
    float* orow = out + row * num_bins;
    for (int i = threadIdx.x; i < num_bins; i += kRowThreads)
      orow[i] = sink.acc;
    return;
  }
  const long long group = kStage == kNoZero ? kNoZeroRows : 1;
  const long long r0 = blockIdx.x * group;
  const long long r1 = min(rows, r0 + group);
  for (int i = threadIdx.x; i < num_bins; i += kRowThreads) h[i] = 0.0f;
  for (long long row = r0; row < r1; ++row) {
    __syncthreads();
    consume(ids, vals,
            Sink<false, unsigned, kStage == kNoZero ? kB2 : kStage>{
                h, m, num_bins},
            row * m, (row + 1) * m, a0, vec != 0, threadIdx.x, kRowThreads,
            threadIdx.x < 32u);
    __syncthreads();
    float* orow = out + row * num_bins;
    for (int i = threadIdx.x; i < num_bins; i += kRowThreads) orow[i] = h[i];
  }
}

// B2's global_kernel; io_only stores each thread's sum at the flat cells
// it owns.
template <int kStage, typename Key>
__global__ void __launch_bounds__(kGlobalThreads) global_kernel(
    const int* __restrict__ ids, const float* __restrict__ vals,
    float* __restrict__ out, long long total, long long m, int num_bins,
    int a0, int vec, long long cells) {
  const long long g = (long long)blockIdx.x * kGlobalThreads + threadIdx.x;
  const long long threads = (long long)gridDim.x * kGlobalThreads;
  const Sink<true, Key, kStage> sink{out, m, num_bins};
  consume(ids, vals, sink, 0, total, a0, vec != 0, g, threads,
          blockIdx.x == 0 && threadIdx.x < 32u);
  if (kStage == kIoOnly)
    for (long long c = g; c < cells; c += threads) out[c] = sink.acc;
}

template <int kStage>
int launch_row(const int* ids, const float* vals, float* out, long long rows,
               long long m, int num_bins, int a0, int vec, cudaStream_t st) {
  const int smem = kStage == kIoOnly ? 0 : 4 * num_bins;
  static const cudaError_t attr = cudaFuncSetAttribute(
      row_kernel<kStage>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const long long group = kStage == kNoZero ? kNoZeroRows : 1;
  row_kernel<kStage><<<(unsigned)((rows + group - 1) / group), kRowThreads,
                       smem, st>>>(ids, vals, out, rows, m, num_bins, a0,
                                   vec);
  return (int)cudaGetLastError();
}

template <int kStage>
int launch_global(const int* ids, const float* vals, float* out,
                  long long rows, long long m, int num_bins, int blocks,
                  int a0, int vec, cudaStream_t st) {
  const long long cells = rows * (long long)num_bins;
  if (cells < (1LL << 31) - 32)
    global_kernel<kStage, unsigned><<<(unsigned)blocks, kGlobalThreads, 0,
                                      st>>>(ids, vals, out, rows * m, m,
                                            num_bins, a0, vec, cells);
  else
    global_kernel<kStage, unsigned long long>
        <<<(unsigned)blocks, kGlobalThreads, 0, st>>>(
            ids, vals, out, rows * m, m, num_bins, a0, vec, cells);
  return (int)cudaGetLastError();
}

}  // namespace

// ids, vals: (rows, m) int32 / float32, contiguous; a0 = (ids address / 4)
// mod 4; vec = 1 when vals has the same 16-byte alignment; variant 0–4
// (above); route 0 (row, out written whole) or 1 (global, ``blocks``
// blocks, out zeroed by the caller on ``stream`` except for io_only,
// which writes every cell).  Returns the launch's cudaError_t.
extern "C" int emspec_hist_variant(const int* ids, const float* vals,
                                   float* out, long long rows, long long m,
                                   int num_bins, int variant, int route,
                                   int blocks, int a0, int vec,
                                   void* stream) {
  if (num_bins <= 0 || blocks <= 0 || route < 0 || route > 1
      || variant < 0 || variant > 4 || (route == 1 && variant == kNoZero)
      || (route == 0 && 4LL * num_bins > kMaxSmem))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 0) {
    switch (variant) {
      case kB2: return launch_row<kB2>(ids, vals, out, rows, m, num_bins, a0,
                                       vec, st);
      case kNoMerge: return launch_row<kNoMerge>(ids, vals, out, rows, m,
                                                 num_bins, a0, vec, st);
      case kNoAtomic: return launch_row<kNoAtomic>(ids, vals, out, rows, m,
                                                   num_bins, a0, vec, st);
      case kNoZero: return launch_row<kNoZero>(ids, vals, out, rows, m,
                                               num_bins, a0, vec, st);
      default: return launch_row<kIoOnly>(ids, vals, out, rows, m, num_bins,
                                          a0, vec, st);
    }
  }
  if (m == 0) return 0;
  switch (variant) {
    case kB2: return launch_global<kB2>(ids, vals, out, rows, m, num_bins,
                                        blocks, a0, vec, st);
    case kNoMerge: return launch_global<kNoMerge>(ids, vals, out, rows, m,
                                                  num_bins, blocks, a0, vec,
                                                  st);
    case kNoAtomic: return launch_global<kNoAtomic>(ids, vals, out, rows, m,
                                                    num_bins, blocks, a0,
                                                    vec, st);
    default: return launch_global<kIoOnly>(ids, vals, out, rows, m, num_bins,
                                           blocks, a0, vec, st);
  }
}
