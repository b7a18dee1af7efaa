// Kernel B1: fused single-bank enhanced analysis — frames → reassigned
// deposits (ids, contrib), one thread block per frame.
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

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__global__ void __launch_bounds__(kThreads) deposits_kernel(
    const float* __restrict__ x, long long frames_per_lead,
    long long lead_stride, long long frame_stride,
    const float* __restrict__ th, const float2* __restrict__ tw,
    const float* __restrict__ logmap_a, const float* __restrict__ logmap_b,
    const float* __restrict__ power_floor,
    int* __restrict__ ids, float* __restrict__ contrib,
    int n, int log2m, int hop, float c_dh, float bin_scale, float hz_per_bin,
    float inv_n2, int rows, int reach) {
  extern __shared__ float2 sm[];
  const int m = n >> 1;                 // half-size complex FFT length
  float2* z[2] = {sm, sm + (m + 1)};    // raw, t·h: frame → spectrum X[0..m]
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

  // 3. real-input unpack, in place: pair (k, m−k) owned by one thread;
  //    X[k] = Ze + W^k·Zo,  X[m−k] = conj(Ze − W^k·Zo)
  for (int q = threadIdx.x; q < 2 * (half_m + 1); q += blockDim.x) {
    const int sig = q > half_m;
    const int k = q - sig * (half_m + 1);
    float2* zs = z[sig];
    const float2 zk = zs[k];
    const float2 zmk = zs[(m - k) & (m - 1)];
    const float2 ze = make_float2(0.5f * (zk.x + zmk.x), 0.5f * (zk.y - zmk.y));
    const float2 zo = make_float2(0.5f * (zk.y + zmk.y), -0.5f * (zk.x - zmk.x));
    const float2 t = cmul(tw[k], zo);
    zs[k] = make_float2(ze.x + t.x, ze.y + t.y);
    if (k != m - k) zs[m - k] = make_float2(ze.x - t.x, t.y - ze.y);
  }
  __syncthreads();

  // 4. stencils, corrections, quantization, id packing for k = 0..N/2
  const float a = *logmap_a, bsc = *logmap_b, floor_p = *power_floor;
  const float2* X = z[0];
  const float2* Y = z[1];
  const long long out0 = b * (long long)(m + 1);
  for (int k = threadIdx.x; k <= m; k += blockDim.x) {
    const float2 A = X[k];
    const float2 Am1 = k == 0 ? make_float2(X[1].x, -X[1].y) : X[k - 1];
    const float2 Ap1 = k == m ? make_float2(X[m - 1].x, -X[m - 1].y) : X[k + 1];
    const float2 B = Y[k];
    const float xhr = 0.5f * A.x - 0.25f * (Am1.x + Ap1.x);
    const float xhi = 0.5f * A.y - 0.25f * (Am1.y + Ap1.y);
    const float xdr = c_dh * (Am1.y - Ap1.y);
    const float xdi = -c_dh * (Am1.x - Ap1.x);
    const float power = xhr * xhr + xhi * xhi;
    const float inv = 1.0f / (power > 1e-30f ? power : 1e-30f);
    const float dt = (B.x * xhr + B.y * xhi) * inv;
    const float dw = -(xdi * xhr - xdr * xhi) * inv;
    const float f_hat = ((float)k + dw * bin_scale) * hz_per_bin;
    const float dq = rintf(dt / (float)hop);
    const float rq = rintf((log2f(f_hat > 1e-6f ? f_hat : 1e-6f) - a) * bsc);
    const bool valid = power > floor_p && rq >= 0.0f && rq < (float)rows
                       && f_hat > 0.0f && fabsf(dt) <= 0.5f * (float)n;
    ids[out0 + k] = valid ? ((int)dq + reach) * rows + (int)rq : -1;
    contrib[out0 + k] = valid ? power * inv_n2 : 0.0f;
  }
}

}  // namespace

extern "C" int emspec_deposits(
    const float* x, long long num_lead, long long frames_per_lead,
    long long lead_stride, long long frame_stride,
    const float* th, const void* tw,
    const float* logmap_a, const float* logmap_b, const float* power_floor,
    int* ids, float* contrib, int n, int hop, float c_dh, float bin_scale,
    float hz_per_bin, float inv_n2, int rows, int reach, void* stream) {
  int log2m = 0;
  while ((2 << log2m) < n) ++log2m;
  const int smem = (int)sizeof(float2) * (n + 2);
  cudaError_t err = cudaFuncSetAttribute(
      deposits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = num_lead * frames_per_lead;
  if (blocks == 0) return 0;
  deposits_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, frames_per_lead, lead_stride, frame_stride, th,
      static_cast<const float2*>(tw), logmap_a, logmap_b, power_floor, ids,
      contrib, n, log2m, hop, c_dh, bin_scale, hz_per_bin, inv_n2, rows,
      reach);
  return (int)cudaGetLastError();
}
