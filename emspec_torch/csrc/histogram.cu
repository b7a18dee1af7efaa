// Kernel B2: per-row histogram (the reassignment scatter-add).
//
// Replaces emspec/dsp/pallas/scatter.py::histogram_matmul (_hist_kernel).
// The TPU kernel builds digit one-hots and contracts them on the MXU, a
// workaround for the TPU's lack of data-dependent writes; the GPU has
// them natively.  ids, vals (rows, m) → out (rows, num_bins): the sum of
// vals by id in each row.  An id outside [0, num_bins) adds nothing and
// its value never enters a sum, so a NaN or Inf behind a dropped id
// cannot reach the histogram.  ``passes`` (the TPU kernel's bf16 split
// count) has no counterpart: every add is a float32 add, exact to one
// rounding; only the order of the adds varies from run to run.  The
// global atomics flush subnormal values (red.global.add.f32 is .ftz);
// the pipeline's contributions lie far above that range.
//
// Two atomic routes, chosen by the wrapper from (rows, m, num_bins) alone
// (emspec_torch/dsp/kernels/scatter.py route_of), and a deterministic one
// a caller asks for (sorted, at the end of this file):
//   row     one block of 512 threads a row: a float32 histogram of
//           num_bins cells in shared memory, then one coalesced store of
//           the row (no zeroed output needed).  Taken where the rows
//           alone give every SM two blocks and four such blocks fit an
//           SM's shared memory;
//   global  no shared histogram: the blocks walk the flat rows·m stream
//           (the row of an element is its index div m) and add straight
//           into an output the wrapper has zeroed on the same stream,
//           with global atomics (red.global.add.f32).  Any number of
//           blocks a row, so few rows still spread over many SMs, and no
//           cap on num_bins: the route above a block's shared memory
//           (num_bins > 58,112).
// Common to both:
//   * 16-byte loads: ids and vals are read four at a time where the two
//     share their alignment; each range's head up to the next 16-byte
//     boundary and its tail (three elements at most each) take one warp
//     step of their own.  m is odd on every path (4097, 16385, 131073),
//     so each row starts at another alignment;
//   * hot cells: the ids of real audio cluster (the log raster folds many
//     high bins into its top rows; a steady tone keeps δ at 0), so lanes
//     of a warp often hit one cell and their atomics serialise.  Each
//     thread first merges runs of equal ids among its four elements, then
//     __match_any_sync finds the lanes of the warp that share an id, a
//     tree of shuffles over their ranks sums each group, and only the
//     group's lowest lane issues the atomic (warp_add says when).  A
//     dropped element gets a key of its own (~lane), so it never joins a
//     group.
// The warp merge, the sinks and the range walk (consume) are
// histogram_common.cuh, shared with kernel B6 and the scatter-ablation
// probe.
// What bounds each route on this card: reading the inputs, 8 bytes a
// deposit, and writing the output, 4 bytes a cell; in practice the warp
// steps' match and atomics (row: compare-and-swap loops in shared
// memory, global: L2 atomics, one per group of equal ids a warp step
// holds) and, for global, the zero-fill of 4·rows·num_bins bytes.  Why
// no route splits a row over blocks that each flush a shared histogram
// with global atomics: on the card it lost to global at every path's
// shape (PERF.md §6).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cuda_runtime.h>

#include "histogram_common.cuh"

namespace {

using namespace emspec::hist;

constexpr int kMaxSmem = 232448;      // a block's shared memory (227 KB)

// row route: one block a row
__global__ void __launch_bounds__(kRowThreads) row_kernel(
    const int* __restrict__ ids, const float* __restrict__ vals,
    float* __restrict__ out, long long m, int num_bins, int a0, int vec) {
  extern __shared__ __align__(16) float h[];
  const long long row = blockIdx.x;
  for (int i = threadIdx.x; i < num_bins; i += kRowThreads) h[i] = 0.0f;
  __syncthreads();
  consume<false, unsigned>(ids, vals, Sink<false, unsigned>{h, m, num_bins},
                           row * m, (row + 1) * m, a0, vec != 0, threadIdx.x,
                           kRowThreads, threadIdx.x < 32u);
  __syncthreads();
  float* orow = out + row * num_bins;
  for (int i = threadIdx.x; i < num_bins; i += kRowThreads) orow[i] = h[i];
}

template <typename Key>
__global__ void __launch_bounds__(kGlobalThreads) global_kernel(
    const int* __restrict__ ids, const float* __restrict__ vals,
    float* __restrict__ out, long long total, long long m, int num_bins,
    int a0, int vec) {
  consume<true, Key>(ids, vals, Sink<true, Key>{out, m, num_bins}, 0, total,
                     a0, vec != 0,
                     (long long)blockIdx.x * kGlobalThreads + threadIdx.x,
                     (long long)gridDim.x * kGlobalThreads,
                     blockIdx.x == 0 && threadIdx.x < 32u);
}

// The sorted route, deterministic: ``keys`` (row·num_bins + id) of every
// deposit sorted stably by the wrapper (torch.sort), −1 for a dropped id,
// and ``vals`` in the same order.  The first deposit of each run of equal
// keys sums its run in order onto the cell (0, or the value of an output
// added into) and stores the total.  No atomics, so a cell's sum is the
// same on every run, and, since the stable sort keeps each cell's
// deposits in deposit order, equal bit for bit to the plain version's
// (index_add_, which adds them in that order).  A run is one thread's
// sequential loop: fine for the raster's few deposits a cell; a cell of
// thousands of deposits would serialise on its thread.
template <typename Key>
__global__ void __launch_bounds__(kGlobalThreads) sorted_kernel(
    const Key* __restrict__ keys, const float* __restrict__ vals,
    float* __restrict__ out, long long n) {
  for (long long i = (long long)blockIdx.x * kGlobalThreads + threadIdx.x;
       i < n; i += (long long)gridDim.x * kGlobalThreads) {
    const Key k = keys[i];
    if (k < 0 || (i > 0 && keys[i - 1] == k)) continue;
    float s = out[k];
    for (long long j = i; j < n && keys[j] == k; ++j)
      s = __fadd_rn(s, vals[j]);
    out[k] = s;
  }
}

}  // namespace

// keys (int32 if key_bytes == 4, else int64) and vals: n sorted deposits
// (see sorted_kernel); out holds every cell a key names, zeroed or added
// into, on ``stream``.
extern "C" int emspec_histogram_sorted(const void* keys, int key_bytes,
                                       const float* vals, float* out,
                                       long long n, int blocks,
                                       void* stream) {
  if (n < 0 || blocks <= 0 || (key_bytes != 4 && key_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (key_bytes == 4)
    sorted_kernel<int><<<(unsigned)blocks, kGlobalThreads, 0, st>>>(
        static_cast<const int*>(keys), vals, out, n);
  else
    sorted_kernel<long long><<<(unsigned)blocks, kGlobalThreads, 0, st>>>(
        static_cast<const long long*>(keys), vals, out, n);
  return (int)cudaGetLastError();
}

// ids, vals: (rows, m) int32 / float32, contiguous; a0 = (ids address / 4)
// mod 4; vec = 1 when vals has the same 16-byte alignment.  route 0
// (row): out (rows, num_bins) is written whole; route 1 (global,
// ``blocks`` blocks) adds into an out the caller has zeroed on
// ``stream``.  No host synchronisation; returns the launch's cudaError_t.
extern "C" int emspec_histogram(const int* ids, const float* vals,
                                float* out, long long rows, long long m,
                                int num_bins, int route, int blocks, int a0,
                                int vec, void* stream) {
  if (num_bins <= 0 || blocks <= 0 || route < 0 || route > 1
      || (route == 0 && 4LL * num_bins > kMaxSmem))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 0) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
    row_kernel<<<(unsigned)rows, kRowThreads, 4 * num_bins, st>>>(
        ids, vals, out, m, num_bins, a0, vec);
    return (int)cudaGetLastError();
  }
  if (m == 0) return 0;
  if (rows * (long long)num_bins < (1LL << 31) - 32)
    global_kernel<unsigned><<<(unsigned)blocks, kGlobalThreads, 0, st>>>(
        ids, vals, out, rows * m, m, num_bins, a0, vec);
  else
    global_kernel<unsigned long long><<<(unsigned)blocks, kGlobalThreads, 0,
                                        st>>>(ids, vals, out, rows * m, m,
                                              num_bins, a0, vec);
  return (int)cudaGetLastError();
}
