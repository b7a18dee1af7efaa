// Kernel B2: per-row histogram (the reassignment scatter-add).
//
// Replaces emspec/dsp/pallas/scatter.py::histogram_matmul (_hist_kernel).
// The TPU kernel builds digit one-hots and contracts them on the MXU,
// a workaround for the TPU's lack of data-dependent writes; the GPU has
// them natively.  Here: one thread block per batch row, a float32
// histogram of num_bins cells in shared memory, atomicAdd per deposit,
// one coalesced write of the row at the end.
//
// Contract kept from the TPU kernel: an id outside [0, num_bins)
// contributes nothing, and its value is never read — a NaN or Inf behind
// a dropped id cannot reach the histogram.  ``passes`` (the TPU kernel's
// bf16 split count) has no counterpart: each float32 atomic add is exact
// to one rounding, the same class as the segment_sum reference; only the
// order of the adds varies from run to run.
//
// What bounds it on the H100: shared-memory atomic throughput and, at
// small num_bins, contention on hot cells (the low display rows collect
// many bins).  Device-memory traffic is the inputs once (8 bytes per
// deposit) and the output once.  The histogram must fit one block's
// shared memory (227 KB → 58,112 cells; the main path's S = 2560 uses
// 10 KB); the wrapper raises above that.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads) histogram_kernel(
    const int* __restrict__ ids, const float* __restrict__ vals,
    float* __restrict__ out, long long m, int num_bins) {
  extern __shared__ float h[];
  for (int i = threadIdx.x; i < num_bins; i += blockDim.x) h[i] = 0.0f;
  __syncthreads();
  const long long row = blockIdx.x;
  const int* ir = ids + row * m;
  const float* vr = vals + row * m;
  for (long long j = threadIdx.x; j < m; j += blockDim.x) {
    const int id = ir[j];
    if (id >= 0 && id < num_bins) atomicAdd(&h[id], vr[j]);
  }
  __syncthreads();
  float* orow = out + row * (long long)num_bins;
  for (int i = threadIdx.x; i < num_bins; i += blockDim.x) orow[i] = h[i];
}

}  // namespace

extern "C" int emspec_histogram(const int* ids, const float* vals,
                                float* out, long long rows, long long m,
                                int num_bins, void* stream) {
  const int smem = (int)sizeof(float) * num_bins;
  cudaError_t err = cudaFuncSetAttribute(
      histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  histogram_kernel<<<(unsigned)rows, kThreads, smem, (cudaStream_t)stream>>>(
      ids, vals, out, m, num_bins);
  return (int)cudaGetLastError();
}
