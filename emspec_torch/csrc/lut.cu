// Kernel B3: colormap lookup into a (256, 4) uint8 RGBA table, on one body
// for two inputs:
//   emspec_lut         out[p] = table[clamp(idx[p], 0, 255)]        (int32)
//   emspec_lut_values  out[p] = table[clamp(rint(v[p]·255), 0, 255)] (float32)
//
// Replaces emspec/dsp/pallas/lut.py::lut_lookup (_lut_kernel).  The TPU
// kernel contracts a one-hot with the table on the MXU because per-pixel
// gathers are slow there; on the GPU the gather is native.  The float32
// form is the whole of apply_lut (emspec/post/colormap.py) in one pass:
// the quantization that four elementwise passes and an int32 intermediate
// did before now happens in registers.
//
// What bounds it on the H100: device-memory bandwidth, 8 bytes a pixel (4
// in, 4 out) and the 1 KB table.  So each thread moves 4 pixels with one
// 16-byte load and one 16-byte store of four packed RGBA words; the grid is
// a few blocks an SM with a grid-stride loop.  A head of up to 3 pixels and
// a tail of up to 3 are peeled and done one at a time, so a view at any
// 4-byte offset takes the vector loop (the wrapper gives the output the
// input's offset within 16 bytes).  The table is read through the
// read-only cache (__ldg): staging it in shared memory behind a
// __syncthreads timed slower on the H100 (PERF.md §6).
//
// Quantization, bit-equal to torch.round / jnp.round then clip: one IEEE
// multiply by 255 (__fmul_rn), rintf (round half to even), then clamp in
// float; a NaN compares false both ways and maps to 0.  An int index
// outside [0, 256) is clamped rather than read out of bounds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int lut_index(int i) {
  return i < 0 ? 0 : (i > 255 ? 255 : i);
}

__device__ __forceinline__ int lut_index(float v) {
  const float r = rintf(__fmul_rn(v, 255.0f));
  return r >= 255.0f ? 255 : (r > 0.0f ? (int)r : 0);
}

template <typename T> struct Vec4;
template <> struct Vec4<int> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

// in, out: npix values and npix RGBA words.  head: pixels before the first
// 16-byte boundary, which in and out share.
template <typename T>
__global__ void __launch_bounds__(kThreads) lut_kernel(
    const T* __restrict__ in, const unsigned* __restrict__ table,
    unsigned* __restrict__ out, long long npix, int head) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (tid < head) out[tid] = __ldg(table + lut_index(in[tid]));
  const long long nvec = (npix - head) >> 2;
  const auto* in4 = reinterpret_cast<const typename Vec4<T>::type*>(in + head);
  uint4* out4 = reinterpret_cast<uint4*>(out + head);
  for (long long v = tid; v < nvec; v += stride) {
    const auto x = in4[v];
    out4[v] = make_uint4(__ldg(table + lut_index(x.x)),
                         __ldg(table + lut_index(x.y)),
                         __ldg(table + lut_index(x.z)),
                         __ldg(table + lut_index(x.w)));
  }
  const long long tail = head + 4 * nvec;
  if (tid < npix - tail)
    out[tail + tid] = __ldg(table + lut_index(in[tail + tid]));
}

template <typename T>
int launch(const T* in, const void* table, void* out, long long npix,
           int head, int blocks, void* stream) {
  if (npix < 0 || blocks <= 0 || head < 0 || head > 3 || head > npix)
    return (int)cudaErrorInvalidValue;
  if (npix == 0) return 0;
  lut_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      in, static_cast<const unsigned*>(table), static_cast<unsigned*>(out),
      npix, head);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int emspec_lut(const int* idx, const void* table, void* out,
                          long long npix, int head, int blocks,
                          void* stream) {
  return launch(idx, table, out, npix, head, blocks, stream);
}

extern "C" int emspec_lut_values(const float* values, const void* table,
                                 void* out, long long npix, int head,
                                 int blocks, void* stream) {
  return launch(values, table, out, npix, head, blocks, stream);
}
