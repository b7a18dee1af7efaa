// Kernel B5: fused triple windowing — frames × [h, t·h, dh/dn].
//
// Replaces emspec/dsp/pallas/window.py::windowed_frames (_kernel).  Each
// frame element is read once and written three times, multiplied by the
// float32 window triple: out[w, r, k] = frames[r, k] · w3[w, k].  One
// IEEE multiply per output (__fmul_rn), nothing contracted or
// reassociated, so the result is bit-equal to frames[None] * w3 (the JAX
// test demands atol=0).
//
// What bounds it on the H100: device-memory bytes — 4 bytes read and 12
// written per element against 3 multiplies; the writes are three quarters
// of it.  Design: a 2-D grid of several waves, x over 16-byte chunks of a
// row (256 threads a block), y over rows (striding past 65535).  A thread
// loads its chunk of w3 once and keeps it for every row it takes; the
// three planes go out as 16-byte streaming stores (__stcs: written once,
// never read back here).  The frames are read through their own strides,
// so they may be the strided framing view of the signal (no copy first):
// 16-byte loads where the frames' address and strides are 16-byte
// aligned, four 4-byte loads otherwise, chosen per launch.  A row length
// that is not a multiple of 4 takes one element a thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxGridY = 65535;

// W = 4: a 16-byte chunk a thread (n % 4 == 0), 16-byte loads if kVecLoad;
// W = 1: one element a thread.
template <int W, bool kVecLoad>
__global__ void __launch_bounds__(kThreads) window_kernel(
    const float* __restrict__ x, long long rows_per_lead,
    long long lead_stride, long long row_stride,
    const float* __restrict__ w3, float* __restrict__ out, long long rows,
    int n) {
  const int k = (blockIdx.x * blockDim.x + threadIdx.x) * W;
  if (k >= n) return;
  float w[3][W];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int i = 0; i < W; ++i) w[p][i] = w3[p * n + k + i];
  const long long plane = rows * n;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* fr = x + (r / rows_per_lead) * lead_stride
                        + (r % rows_per_lead) * row_stride + k;
    float v[W];
    if constexpr (kVecLoad) {
      const float4 q = *reinterpret_cast<const float4*>(fr);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) v[i] = fr[i];
    }
    float* o = out + r * n + k;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      if constexpr (W == 4)
        __stcs(reinterpret_cast<float4*>(o + p * plane),
               make_float4(__fmul_rn(v[0], w[p][0]), __fmul_rn(v[1], w[p][1]),
                           __fmul_rn(v[2], w[p][2]), __fmul_rn(v[3], w[p][3])));
      else
        o[p * plane] = __fmul_rn(v[0], w[p][0]);
    }
  }
}

template <int W, bool kVecLoad>
void launch(const float* x, long long rows_per_lead, long long lead_stride,
            long long row_stride, const float* w3, float* out,
            long long rows, int n, cudaStream_t st) {
  const dim3 grid((unsigned)((n / W + kThreads - 1) / kThreads),
                  (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
  window_kernel<W, kVecLoad><<<grid, kThreads, 0, st>>>(
      x, rows_per_lead, lead_stride, row_stride, w3, out, rows, n);
}

}  // namespace

// x: num_lead × rows_per_lead frames of n floats, frame (l, t) at
// x + l·lead_stride + t·row_stride, unit stride along the frame.
// w3: (3, n) contiguous; out: (3, num_lead·rows_per_lead, n) contiguous,
// both 16-byte aligned.
extern "C" int emspec_window(const float* x, long long num_lead,
                             long long rows_per_lead, long long lead_stride,
                             long long row_stride, const float* w3,
                             float* out, int n, void* stream) {
  const long long rows = num_lead * rows_per_lead;
  if (rows == 0 || n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (n % 4 != 0)
    launch<1, false>(x, rows_per_lead, lead_stride, row_stride, w3, out, rows,
                     n, st);
  else if (reinterpret_cast<std::uintptr_t>(x) % 16 == 0
           && lead_stride % 4 == 0 && row_stride % 4 == 0)
    launch<4, true>(x, rows_per_lead, lead_stride, row_stride, w3, out, rows,
                    n, st);
  else
    launch<4, false>(x, rows_per_lead, lead_stride, row_stride, w3, out, rows,
                     n, st);
  return (int)cudaGetLastError();
}
