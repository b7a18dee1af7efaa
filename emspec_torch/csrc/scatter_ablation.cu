// Probe: kernel B2 (histogram.cu) with single stages stubbed out, for
// timing where B2's time sits.
//
// Replaces bench_probes/scatter_ablation.py::hist_variant.  The TPU probe
// stubbed the one-hot GEMM stages of its histogram (O build, A build,
// GEMM); B2 has none of them, so this probe stubs B2's own stages:
//   0 full       B2 itself: zero-fill the shared histogram, atomicAdd
//                each in-range deposit, write the row;
//   1 no_atomic  plain shared-memory stores instead of atomics: a cell
//                becomes 1 where an in-range deposit with value >= 0
//                lands (every writer stores the same value, so the
//                result is defined) — full minus this is the cost of
//                the atomics and their contention;
//   2 no_zero    one zero-fill per kNoZeroRows rows instead of one a
//                row: a block takes kNoZeroRows consecutive rows and
//                never clears between them, so row r holds the running
//                sum of its group up to r — full minus this is 3/4 of
//                the zero-fill;
//   3 io_only    reads ids and, where in range, vals, as B2 does, and
//                writes the row: cell i holds thread (i mod kThreads)'s
//                running sum of its values, in index order.
// Each stub stays value-dependent, so the compiler drops no stage it was
// not asked to, and each has a plain PyTorch version of its own
// arithmetic (emspec_torch/probes/scatter_ablation.py).
//
// What bounds it on the H100: as B2 — shared-memory atomics and the
// inputs' 8 bytes a deposit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;     // as histogram.cu
constexpr int kNoZeroRows = 4;

template <int kVariant>
__global__ void __launch_bounds__(kThreads) variant_kernel(
    const int* __restrict__ ids, const float* __restrict__ vals,
    float* __restrict__ out, long long rows, long long m, int num_bins) {
  extern __shared__ float h[];
  if (kVariant == 3) {
    const long long row = blockIdx.x;
    float s = 0.0f;
    for (long long j = threadIdx.x; j < m; j += blockDim.x) {
      const int id = ids[row * m + j];
      if (id >= 0 && id < num_bins) s += vals[row * m + j];
    }
    for (int i = threadIdx.x; i < num_bins; i += blockDim.x)
      out[row * num_bins + i] = s;
    return;
  }
  const int group = kVariant == 2 ? kNoZeroRows : 1;
  for (int i = threadIdx.x; i < num_bins; i += blockDim.x) h[i] = 0.0f;
  for (int g = 0; g < group; ++g) {
    const long long row = (long long)blockIdx.x * group + g;
    if (row >= rows) break;
    __syncthreads();
    const int* ir = ids + row * m;
    const float* vr = vals + row * m;
    for (long long j = threadIdx.x; j < m; j += blockDim.x) {
      const int id = ir[j];
      if (id >= 0 && id < num_bins) {
        if (kVariant == 1) {
          if (vr[j] >= 0.0f) h[id] = 1.0f;
        } else {
          atomicAdd(&h[id], vr[j]);
        }
      }
    }
    __syncthreads();
    float* orow = out + row * (long long)num_bins;
    for (int i = threadIdx.x; i < num_bins; i += blockDim.x) orow[i] = h[i];
  }
}

template <int kVariant>
int launch(const int* ids, const float* vals, float* out, long long rows,
           long long m, int num_bins, cudaStream_t st) {
  const int smem = kVariant == 3 ? 0 : (int)sizeof(float) * num_bins;
  cudaError_t err = cudaFuncSetAttribute(
      variant_kernel<kVariant>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const long long group = kVariant == 2 ? kNoZeroRows : 1;
  variant_kernel<kVariant><<<(unsigned)((rows + group - 1) / group),
                             kThreads, smem, st>>>(ids, vals, out, rows, m,
                                                   num_bins);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int emspec_hist_variant(const int* ids, const float* vals,
                                   float* out, long long rows, long long m,
                                   int num_bins, int variant, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case 0: return launch<0>(ids, vals, out, rows, m, num_bins, st);
    case 1: return launch<1>(ids, vals, out, rows, m, num_bins, st);
    case 2: return launch<2>(ids, vals, out, rows, m, num_bins, st);
    case 3: return launch<3>(ids, vals, out, rows, m, num_bins, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
