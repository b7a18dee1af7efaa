// Kernel B1: fused single-bank enhanced analysis — frames → reassigned
// deposits (ids, contrib), one thread block per frame, N <= 16384 (larger
// frames: deposits_large.cu).  Also kernel B6 at these sizes: the same
// block histograms its deposits instead of writing them.
//
// Replaces emspec/dsp/pallas/fft4.py::fft4_deposits (with its
// _deposits_kernel and _frame_quantized).  Same function, GPU formulation:
//   * per frame: t·h window; the raw and the t·h REAL DFTs, each as an
//     N/2-point complex FFT of the even/odd-packed samples plus the
//     real-input unpack (the two signals are never packed together: at
//     N = 8192 their spectra differ ~1,160× in magnitude and a joint pack
//     costs the raw spectrum ~10 bits);
//   * periodic-Hann 3-point stencils → X_h, X_dh (neighbours at k = 0 and
//     N/2 by Hermitian symmetry, as emspec/dsp/stft.py:stencil_from_raw);
//   * Auger–Flandrin Δt, Δω; f̂; round-half-even quantization (rintf), with
//     Δt/hop a true division; validity mask; contrib = |X_h|²/N²;
//   * id = (δ + reach)·rows + row, written in natural bin order k = 0..N/2
//     (the TPU kernel's (k1,k2)-major order was a layout artifact; the
//     histogram does not depend on order).  Invalid deposits carry id −1
//     and contrib 0, so nothing downstream reads them.
// The unpack and the per-bin epilogue are deposits_common.cuh, shared with
// the large-frame route.
//
// Kernel B6 replaces emspec/dsp/pallas/fft4.py::fft4_hist (_hist_kernel,
// _tile_hist): B1 and B2 fused.  The block's deposits go by shared-memory
// atomicAdd into a float32 relative histogram of P·rows cells placed after
// the spectra (ids below min_id, the streaming mask, and outside the
// histogram are dropped), and the row is written once: the deposits never
// reach device memory.
//
// What bounds it on the H100: the FFT's shared-memory traffic and the
// __syncthreads between its log2(N/2) radix-2 stages — the frame is read
// from device memory once (4·N bytes) and 8·(N/2+1) bytes are written, so
// device-memory bytes are not the limit.  Design: the whole frame's two
// half-size complex spectra stay in dynamic shared memory, 8·(N+2) bytes
// (64 KB at N = 8192; above 48 KB needs the MaxDynamicSharedMemorySize
// attribute, set before every launch), which caps N at 16384.  Twiddles
// come from a float64-built table e^{-2πij/N}, j < N/2, in device memory
// (L1/L2-resident).  No wgmma/TMA yet: simple and right first.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC, never --use_fast_math (log2f and the division must
// stay IEEE-accurate).

#include <cuda_runtime.h>

#include "deposits_common.cuh"

namespace {

using emspec::cmul;

constexpr int kThreads = 512;

// kHist = false: B1, writes ids and contrib (natural order, m + 1 a frame).
// kHist = true: B6, writes the frame's histogram row of num_bins cells.
template <bool kHist>
__global__ void __launch_bounds__(kThreads) deposits_kernel(
    const float* __restrict__ x, long long frames_per_lead,
    long long lead_stride, long long frame_stride,
    const float* __restrict__ th, const float2* __restrict__ tw,
    const float* __restrict__ logmap_a, const float* __restrict__ logmap_b,
    const float* __restrict__ power_floor,
    int* __restrict__ ids, float* __restrict__ out,
    int n, int log2m, int hop, float c_dh, float bin_scale, float hz_per_bin,
    float inv_n2, int rows, int reach, int min_id, int num_bins) {
  extern __shared__ float2 sm[];
  const int m = n >> 1;                 // half-size complex FFT length
  float2* z[2] = {sm, sm + (m + 1)};    // raw, t·h: frame → spectrum X[0..m]
  float* hist = reinterpret_cast<float*>(sm + 2 * (m + 1));   // B6 only
  const long long b = blockIdx.x;
  const float* fr = x + (b / frames_per_lead) * lead_stride
                      + (b % frames_per_lead) * frame_stride;

  // 1. window and pack z[i] = s[2i] + i·s[2i+1], stored bit-reversed
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float a0 = fr[2 * i], a1 = fr[2 * i + 1];
    const int r = __brev(i) >> (32 - log2m);
    z[0][r] = make_float2(a0, a1);
    z[1][r] = make_float2(a0 * th[2 * i], a1 * th[2 * i + 1]);
  }
  if (kHist)
    for (int i = threadIdx.x; i < num_bins; i += blockDim.x) hist[i] = 0.0f;
  __syncthreads();

  // 2. radix-2 decimation-in-time, both signals per stage
  const int half_m = m >> 1;
  for (int s = 0; s < log2m; ++s) {
    const int half = 1 << s;
    const int tw_shift = log2m - s;     // e^{-2πij/(2·half)} = tw[j·N/(2·half)]
    for (int q = threadIdx.x; q < m; q += blockDim.x) {
      const int sig = q >= half_m;
      const int bf = q - sig * half_m;
      const int j = bf & (half - 1);
      const int i0 = ((bf - j) << 1) + j;
      const int i1 = i0 + half;
      float2* zs = z[sig];
      const float2 u = zs[i0];
      const float2 v = cmul(zs[i1], tw[j << tw_shift]);
      zs[i0] = make_float2(u.x + v.x, u.y + v.y);
      zs[i1] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }

  // 3. real-input unpack, in place: pair (k, m−k) owned by one thread
  for (int q = threadIdx.x; q < 2 * (half_m + 1); q += blockDim.x) {
    const int sig = q > half_m;
    const int k = q - sig * (half_m + 1);
    float2* zs = z[sig];
    float2 lo, hi;
    emspec::unpack_pair(zs[k], zs[(m - k) & (m - 1)], tw[k], &lo, &hi);
    zs[k] = lo;
    if (k != m - k) zs[m - k] = hi;
  }
  __syncthreads();

  // 4. stencils, corrections, quantization, id packing for k = 0..N/2
  const emspec::EpilogueConsts c{*logmap_a, *logmap_b, *power_floor, c_dh,
                                 bin_scale, hz_per_bin, inv_n2, n, hop, rows,
                                 reach};
  const float2* X = z[0];
  const float2* Y = z[1];
  const long long out0 = b * (long long)(m + 1);
  for (int k = threadIdx.x; k <= m; k += blockDim.x) {
    const float2 Am1 = k == 0 ? make_float2(X[1].x, -X[1].y) : X[k - 1];
    const float2 Ap1 = k == m ? make_float2(X[m - 1].x, -X[m - 1].y) : X[k + 1];
    int id;
    float contrib;
    emspec::deposit_at(k, X[k], Am1, Ap1, Y[k], c, &id, &contrib);
    if (kHist) {
      if (emspec::lands(id, min_id, num_bins)) atomicAdd(&hist[id], contrib);
    } else {
      ids[out0 + k] = id;
      out[out0 + k] = contrib;
    }
  }
  if (kHist) {
    __syncthreads();
    float* row = out + b * (long long)num_bins;
    for (int i = threadIdx.x; i < num_bins; i += blockDim.x) row[i] = hist[i];
  }
}

template <bool kHist>
int launch(const float* x, long long num_lead, long long frames_per_lead,
           long long lead_stride, long long frame_stride, const float* th,
           const void* tw, const float* logmap_a, const float* logmap_b,
           const float* power_floor, int* ids, float* out, int n, int hop,
           float c_dh, float bin_scale, float hz_per_bin, float inv_n2,
           int rows, int reach, int min_id, int num_bins, void* stream) {
  int log2m = 0;
  while ((2 << log2m) < n) ++log2m;
  const int smem = (int)sizeof(float2) * (n + 2)
                   + (kHist ? (int)sizeof(float) * num_bins : 0);
  cudaError_t err = cudaFuncSetAttribute(
      deposits_kernel<kHist>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = num_lead * frames_per_lead;
  if (blocks == 0) return 0;
  deposits_kernel<kHist><<<(unsigned)blocks, kThreads, smem,
                           (cudaStream_t)stream>>>(
      x, frames_per_lead, lead_stride, frame_stride, th,
      static_cast<const float2*>(tw), logmap_a, logmap_b, power_floor, ids,
      out, n, log2m, hop, c_dh, bin_scale, hz_per_bin, inv_n2, rows, reach,
      min_id, num_bins);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int emspec_deposits(
    const float* x, long long num_lead, long long frames_per_lead,
    long long lead_stride, long long frame_stride,
    const float* th, const void* tw,
    const float* logmap_a, const float* logmap_b, const float* power_floor,
    int* ids, float* contrib, int n, int hop, float c_dh, float bin_scale,
    float hz_per_bin, float inv_n2, int rows, int reach, void* stream) {
  return launch<false>(x, num_lead, frames_per_lead, lead_stride,
                       frame_stride, th, tw, logmap_a, logmap_b, power_floor,
                       ids, contrib, n, hop, c_dh, bin_scale, hz_per_bin,
                       inv_n2, rows, reach, 0, 0, stream);
}

// B6, one block a frame: hist (frames, num_bins) float32, every cell
// written.
extern "C" int emspec_deposits_hist(
    const float* x, long long num_lead, long long frames_per_lead,
    long long lead_stride, long long frame_stride,
    const float* th, const void* tw,
    const float* logmap_a, const float* logmap_b, const float* power_floor,
    float* hist, int n, int hop, float c_dh, float bin_scale,
    float hz_per_bin, float inv_n2, int rows, int reach, int min_id,
    int num_bins, void* stream) {
  return launch<true>(x, num_lead, frames_per_lead, lead_stride,
                      frame_stride, th, tw, logmap_a, logmap_b, power_floor,
                      nullptr, hist, n, hop, c_dh, bin_scale, hz_per_bin,
                      inv_n2, rows, reach, min_id, num_bins, stream);
}
