// Kernel B1, large-frame routes: frames → reassigned deposits (ids,
// contrib) for N = 65536 … 262144, where a frame's two spectra no longer
// fit one block or B1's two-CTA cluster (deposits.cu).  Also kernel B6
// (the fused histogram) on the three-launch route, which B6 takes only
// when a caller forces it (``route="large"``, for timing): its own route
// above deposits.cu's is cluster_large (xcluster.cuh).
//
// Replaces emspec/dsp/pallas/fft4.py::fft4_deposits (_deposits_kernel,
// _frame_quantized with its half-spectrum route, _iota_grids) above 16384
// points.  Both routes compute what deposits.cu computes at N <= 32768,
// in natural bin order, id −1 and contrib 0 for every invalid deposit,
// for the bins of a window [k_lo, k_hi) with an optional band weight,
// through deposits_common.cuh's unpack_pair and deposit_at.
//
// Route "cluster_large" (one launch, a frame a thread-block cluster):
// xcluster.cuh, whose kernel this file instantiates for B1 and
// deposits_hist_copies.cu and deposits_hist_bands.cu for B6.
//
// Route "large" (three launches; B1's and B6's where a caller forces it,
// ``route="large"``, to time the one-launch routes against it):
//   1. pack (this file): each frame read once through its stride (the
//      framing unfold view goes in uncopied), the t·h window applied, the
//      raw and the t·h signal each even/odd-packed into an N/2-point
//      complex sequence z[i] = s[2i] + i·s[2i+1] — never packed together
//      (their spectra differ by ~10³ in magnitude) — as 2·b contiguous
//      (n1, n2) planes, sequence 2f the raw and 2f+1 the t·h of frame f;
//   2. kernel B4 (fourstep.cu, steps 1–3 as radix FFTs in shared memory:
//      one launch at 128×128, two through a scratch above) on those 2·b
//      sequences at fourstep._FACTORS[N/2] (128×128 … 256×512, b = 1
//      included);
//   3. finish (this file): one thread a bin.  It reads the B4 output
//      through the step-4 map — Z[j] lies at (j mod n1)·n2 + j div n1 —
//      unpacks X[k−1], X[k], X[k+1] and Y[k] with deposits_common.cuh's
//      unpack_pair (the Hermitian conjugates of X[1] and X[N/2−1] at
//      k = 0 and N/2, as in deposits.cu) and runs the shared epilogue.
//      Thread q of a frame takes bin k = q div n2 + n1·(q mod n2), so a
//      warp reads consecutive addresses of Z (and of its mirror
//      Z[m−j], in reverse); the bin k = N/2 is the extra thread q = m.
//      The writes of ids and contrib are strided by n1 and merge in L2.
//      B6 (hist = 1): each block histograms its bins in shared memory
//      (the streaming mask id >= min_id applied) and adds the nonzero
//      cells atomically into the zeroed output row.
//   What bounds it on the H100: device-memory bytes — pack reads ~4·N and
//   writes 8·N bytes a frame, B4 reads and writes the planes (16·N bytes
//   a frame, twice that above 16384 points where it goes through its
//   scratch), finish reads them and writes ids and contrib: ~50·N bytes a
//   frame against the 4·N in and 8·(N/2 + 1) out the function needs.  The
//   scratch planes (2·b·N/2 complex, 180 MB at 688 × 32768) come from the
//   wrapper's torch.empty, so PyTorch's caching allocator serves them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "deposits_common.cuh"
#include "radix_common.cuh"
#include "xcluster.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHistBinsPerBlock = 4096;   // B6: bins one block histograms

__global__ void __launch_bounds__(kThreads) pack_kernel(
    const float* __restrict__ x, long long frames_per_lead,
    long long lead_stride, long long frame_stride,
    const float* __restrict__ th, float* __restrict__ zr,
    float* __restrict__ zi, int m, int chunks) {
  const long long f = blockIdx.x / chunks;
  const int i = (blockIdx.x % chunks) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float* fr = x + (f / frames_per_lead) * lead_stride
                      + (f % frames_per_lead) * frame_stride;
  const float a0 = fr[2 * i], a1 = fr[2 * i + 1];
  const long long raw = 2 * f * (long long)m + i;
  const long long thw = raw + m;
  zr[raw] = a0;
  zi[raw] = a1;
  zr[thw] = a0 * th[2 * i];
  zi[thw] = a1 * th[2 * i + 1];
}

// X[j], 0 <= j <= m, of one real frame from Z (its B4 planes, (k1, k2)
// layout): the pair (j', m − j') with j' = min(j, m − j) unpacked as in
// deposits.cu.
__device__ __forceinline__ float2 spectrum_at(
    const float* __restrict__ zr, const float* __restrict__ zi,
    const float2* __restrict__ tw, int j, int m, int n1, int n2) {
  const bool upper = j > (m >> 1);
  const int jl = upper ? m - j : j;
  const int jm = jl == 0 ? 0 : m - jl;
  const int a0 = (jl % n1) * n2 + jl / n1;
  const int a1 = (jm % n1) * n2 + jm / n1;
  float2 lo, hi;
  emspec::unpack_pair(make_float2(zr[a0], zi[a0]), make_float2(zr[a1], zi[a1]),
                      tw[jl], &lo, &hi);
  return upper ? hi : lo;
}

template <bool kHist>
__global__ void __launch_bounds__(kThreads) finish_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const float2* __restrict__ tw, const float* __restrict__ logmap_a,
    const float* __restrict__ logmap_b, const float* __restrict__ power_floor,
    int* __restrict__ ids, float* __restrict__ out, int chunks, int per_block,
    int n, int n1, int n2, int hop, float c_dh, float bin_scale,
    float hz_per_bin, float inv_n2, int rows, int reach, int min_id,
    int num_bins, int k_lo, int k_hi, const float* __restrict__ band) {
  extern __shared__ float hist[];                 // B6 only
  const int m = n >> 1;
  const long long f = blockIdx.x / chunks;
  const int q0 = (blockIdx.x % chunks) * per_block;
  const int q1 = min(q0 + per_block, m + 1);
  const float* raw_r = xr + 2 * f * (long long)m;
  const float* raw_i = xi + 2 * f * (long long)m;
  const float* th_r = raw_r + m;
  const float* th_i = raw_i + m;
  const emspec::EpilogueConsts c{*logmap_a, *logmap_b, *power_floor, c_dh,
                                 bin_scale, hz_per_bin, inv_n2, n, hop, rows,
                                 reach};
  if (kHist) {
    for (int i = threadIdx.x; i < num_bins; i += blockDim.x) hist[i] = 0.0f;
    __syncthreads();
  }
  for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x) {
    const int k = q == m ? m : q / n2 + n1 * (q % n2);
    if (k < k_lo || k >= k_hi) continue;
    const float2 A = spectrum_at(raw_r, raw_i, tw, k, m, n1, n2);
    float2 Am1, Ap1;
    if (k == 0) {
      const float2 x1 = spectrum_at(raw_r, raw_i, tw, 1, m, n1, n2);
      Am1 = make_float2(x1.x, -x1.y);
    } else {
      Am1 = spectrum_at(raw_r, raw_i, tw, k - 1, m, n1, n2);
    }
    if (k == m) {
      const float2 x1 = spectrum_at(raw_r, raw_i, tw, m - 1, m, n1, n2);
      Ap1 = make_float2(x1.x, -x1.y);
    } else {
      Ap1 = spectrum_at(raw_r, raw_i, tw, k + 1, m, n1, n2);
    }
    const float2 B = spectrum_at(th_r, th_i, tw, k, m, n1, n2);
    int id;
    float contrib;
    emspec::deposit_at(k, A, Am1, Ap1, B,
                       band == nullptr ? 1.0f : band[k - k_lo], c, &id,
                       &contrib);
    if (kHist) {
      if (emspec::lands(id, min_id, num_bins)) atomicAdd(&hist[id], contrib);
    } else {
      const long long at = f * (long long)(k_hi - k_lo) + k - k_lo;
      ids[at] = id;
      out[at] = contrib;
    }
  }
  if (kHist) {
    __syncthreads();
    float* row = out + f * (long long)num_bins;
    for (int i = threadIdx.x; i < num_bins; i += blockDim.x)
      if (hist[i] != 0.0f) atomicAdd(&row[i], hist[i]);
  }
}

template <bool kHist>
int launch_finish(const float* xr, const float* xi, const void* tw,
                  const float* logmap_a, const float* logmap_b,
                  const float* power_floor, int* ids, float* out,
                  long long frames, int n, int n1, int n2, int hop,
                  float c_dh, float bin_scale, float hz_per_bin,
                  float inv_n2, int rows, int reach, int min_id, int num_bins,
                  int k_lo, int k_hi, const float* band, cudaStream_t st) {
  const int m = n >> 1;
  const int per_block = kHist ? kHistBinsPerBlock : kThreads;
  const int chunks = (m + 1 + per_block - 1) / per_block;
  const int smem = kHist ? (int)sizeof(float) * num_bins : 0;
  cudaError_t err = cudaFuncSetAttribute(
      finish_kernel<kHist>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  finish_kernel<kHist><<<(unsigned)(frames * chunks), kThreads, smem, st>>>(
      xr, xi, static_cast<const float2*>(tw), logmap_a, logmap_b,
      power_floor, ids, out, chunks, per_block, n, n1, n2, hop, c_dh,
      bin_scale, hz_per_bin, inv_n2, rows, reach, min_id, num_bins, k_lo,
      k_hi, band);
  return (int)cudaGetLastError();
}

}  // namespace

// B1, route cluster_large (N = 65536, 131072, 262144): the arguments of
// emspec_deposits (deposits.cu).  ids, contrib (frames, k_hi − k_lo).
extern "C" int emspec_deposits_cluster_large(
    const float* x, long long num_lead, long long frames_per_lead,
    long long lead_stride, long long frame_stride, const float* th,
    const void* w512, const void* tw4, const void* tw,
    const float* logmap_a, const float* logmap_b, const float* power_floor,
    int* ids, float* contrib, int n, int n1, int n2, int hop, float c_dh,
    float bin_scale, float hz_per_bin, float inv_n2, int rows, int reach,
    int k_lo, int k_hi, const float* band, void* stream) {
  XArgs a;
  if (n < 65536
      || !xargs(&a, x, frames_per_lead, lead_stride, frame_stride, th, w512,
                tw4, tw, logmap_a, logmap_b, power_floor, ids, contrib, n, n1,
                n2, hop, c_dh, bin_scale, hz_per_bin, inv_n2, rows, reach,
                k_lo, k_hi, band, 0, 0))
    return (int)cudaErrorInvalidValue;
  return xlaunch<kB1>(a, num_lead * frames_per_lead, n1, (cudaStream_t)stream);
}

// How many clusters of B1's route cluster_large at N (n1·n2 = N/2) the
// card holds at once (cudaOccupancyMaxActiveClusters) → *clusters; 0
// where it holds none (a cluster size the card refuses).
extern "C" int emspec_deposits_cluster_large_occupancy(int n, int n1, int n2,
                                                       int* clusters) {
  return xoccupancy<kB1>(n, n1, n2, 0, clusters);
}

// Stage 1.  zr, zi: (2·frames, N/2) float32 planes, written whole.
extern "C" int emspec_deposits_pack(
    const float* x, long long num_lead, long long frames_per_lead,
    long long lead_stride, long long frame_stride, const float* th,
    float* zr, float* zi, int n, void* stream) {
  const long long frames = num_lead * frames_per_lead;
  if (frames == 0) return 0;
  const int m = n >> 1;
  const int chunks = (m + kThreads - 1) / kThreads;
  pack_kernel<<<(unsigned)(frames * chunks), kThreads, 0,
                (cudaStream_t)stream>>>(x, frames_per_lead, lead_stride,
                                        frame_stride, th, zr, zi, m, chunks);
  return (int)cudaGetLastError();
}

// Stage 3.  xr, xi: B4's output for the packed planes, (2·frames, n1, n2)
// with n1·n2 = N/2.  hist = 0: ids, contrib (frames, k_hi − k_lo), bins
// k_lo … k_hi − 1 in natural order, band: k_hi − k_lo weights or null.
// hist = 1 (B6): out (frames, num_bins), zeroed by the caller; ids unused,
// the window the whole spectrum.
extern "C" int emspec_deposits_finish(
    const float* xr, const float* xi, const void* tw, const float* logmap_a,
    const float* logmap_b, const float* power_floor, int* ids, float* out,
    long long frames, int n, int n1, int n2, int hop, float c_dh,
    float bin_scale, float hz_per_bin, float inv_n2, int rows, int reach,
    int min_id, int num_bins, int hist, int k_lo, int k_hi,
    const float* band, void* stream) {
  if (n1 * n2 != n / 2 || k_lo < 0 || k_lo >= k_hi || k_hi > n / 2 + 1
      || (hist && (k_lo != 0 || k_hi != n / 2 + 1 || band != nullptr)))
    return (int)cudaErrorInvalidValue;
  if (frames == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return hist ? launch_finish<true>(xr, xi, tw, logmap_a, logmap_b,
                                    power_floor, ids, out, frames, n, n1, n2,
                                    hop, c_dh, bin_scale, hz_per_bin, inv_n2,
                                    rows, reach, min_id, num_bins, k_lo, k_hi,
                                    band, st)
              : launch_finish<false>(xr, xi, tw, logmap_a, logmap_b,
                                     power_floor, ids, out, frames, n, n1,
                                     n2, hop, c_dh, bin_scale, hz_per_bin,
                                     inv_n2, rows, reach, min_id, num_bins,
                                     k_lo, k_hi, band, st);
}
