// Kernel B5: fused triple windowing — frames × [h, t·h, dh/dn].
//
// Replaces emspec/dsp/pallas/window.py::windowed_frames (_kernel).  Each
// frame element is read once and written three times, multiplied by the
// float32 window triple: out[w, r, k] = frames[r, k] · w3[w, k].  One
// IEEE multiply per output, nothing contracted or reassociated, so the
// result is bit-equal to frames[None] * w3 (the JAX test demands atol=0).
//
// What bounds it on the H100: device-memory bytes — 4 bytes read and 12
// written per element against 3 multiplies.  Design: one block per frame
// row, threads striding along the row (coalesced), the row read through
// its own stride so the frames may be the strided framing view of the
// signal (no copy first); w3 (12·N bytes) stays in L1/L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) window_kernel(
    const float* __restrict__ x, long long rows_per_lead,
    long long lead_stride, long long row_stride,
    const float* __restrict__ w3, float* __restrict__ out, long long rows,
    int n) {
  const long long r = blockIdx.x;
  const float* fr = x + (r / rows_per_lead) * lead_stride
                      + (r % rows_per_lead) * row_stride;
  const long long plane = rows * n;
  float* o = out + r * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float v = fr[k];
    o[k] = __fmul_rn(v, w3[k]);
    o[plane + k] = __fmul_rn(v, w3[n + k]);
    o[2 * plane + k] = __fmul_rn(v, w3[2 * n + k]);
  }
}

}  // namespace

// x: num_lead × rows_per_lead frames of n floats, frame (l, t) at
// x + l·lead_stride + t·row_stride, unit stride along the frame.
// out: (3, num_lead·rows_per_lead, n) contiguous.
extern "C" int emspec_window(const float* x, long long num_lead,
                             long long rows_per_lead, long long lead_stride,
                             long long row_stride, const float* w3,
                             float* out, int n, void* stream) {
  const long long rows = num_lead * rows_per_lead;
  if (rows == 0) return 0;
  window_kernel<<<(unsigned)rows, kThreads, 0, (cudaStream_t)stream>>>(
      x, rows_per_lead, lead_stride, row_stride, w3, out, rows, n);
  return (int)cudaGetLastError();
}
