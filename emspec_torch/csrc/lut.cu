// Kernel B3: colormap lookup, out[p] = table[idx[p]] (256 × RGBA8).
//
// Replaces emspec/dsp/pallas/lut.py::lut_lookup (_lut_kernel).  The TPU
// kernel contracts a one-hot with the table on the MXU because per-pixel
// gathers are slow there; on the GPU the gather is native.  The 1 KB
// table is staged in shared memory as 256 packed 32-bit RGBA words, one
// thread per pixel, one 32-bit load of the index and one 32-bit store of
// the pixel — bit-equal to the gather by construction.
//
// What bounds it on the H100: device-memory bandwidth, 8 bytes per pixel
// (4 in, 4 out); a grid-stride loop keeps the block count bounded.  An
// index outside [0, 256) — which apply_lut's clip never produces — is
// clamped rather than read out of bounds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) lut_kernel(
    const int* __restrict__ idx, const unsigned int* __restrict__ table,
    unsigned int* __restrict__ out, long long npix) {
  __shared__ unsigned int tab[256];
  tab[threadIdx.x] = table[threadIdx.x];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < npix; p += stride) {
    const int i = idx[p];
    out[p] = tab[i < 0 ? 0 : (i > 255 ? 255 : i)];
  }
}

}  // namespace

extern "C" int emspec_lut(const int* idx, const void* table, void* out,
                          long long npix, void* stream) {
  if (npix == 0) return 0;
  long long blocks = (npix + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  lut_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      idx, static_cast<const unsigned int*>(table),
      static_cast<unsigned int*>(out), npix);
  return (int)cudaGetLastError();
}
