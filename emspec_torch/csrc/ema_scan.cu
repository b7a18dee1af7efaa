// The batch post chain's EMA recurrence as one exact chunk-parallel scan:
//   ys[i, c] = α·ys[i−1, c] + b[i, c],  ys[−1, c] = y0[c],  i = 0 … t−1,
// and y_final[c] = ys[t−1, c].
//
// Replaces the sequential lax.scan of emspec/post/chain.py::_ema_scan (the
// JAX package runs it in XLA, not Pallas).  Each step is one IEEE
// multiply and then one IEEE add, so ys equals, bit for bit, the
// column-by-column evolution of the live step (postprocess_column: α·y,
// then + b) and the plain loop on the card.
//
// α is read from device memory when `alpha_dev` is given (the smoothing
// slider, a 0-d tensor: no host read, so a slider move never rebuilds
// anything), else taken by value (the AGC's constant decay).
//
// What bounds it on the H100: a one-thread-a-column walk is set by its
// dependent chain (t multiply-add pairs, ~8 cycles each: 27 µs at 5,937
// steps), while the bytes, 8·t·C (b read, ys written), take 7.3 µs at
// 5,937 × 512.  Design (ema_chunk.cuh): chunks of L steps in parallel —
// a thread a chunk of a column, or a warp where there are fewer than 32
// columns (the AGC series) — each speculating from a warm-up window W set
// by α, then a second launch that verifies every chunk boundary bit for
// bit and repairs what failed by walking, a warp a column, from the exact
// value.  The chain is L + W steps; at the display default (α = 0) W = 1
// and the scan is bound by its bytes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cuda_runtime.h>

#include "ema_chunk.cuh"

namespace {

using namespace ema_chunk;

struct ScanCell {
  using Raw = float;
  const float* __restrict__ b;
  float* __restrict__ ys;
  long long C, c;
  __device__ __forceinline__ float fetch(long long i) const {
    return __ldg(b + i * C + c);
  }
  __device__ __forceinline__ float input(float x) const { return x; }
  __device__ __forceinline__ void store(long long i, float y) const {
    ys[i * C + c] = y;
  }
};

// kWarp: a warp a (chunk, column), for C < kWarpForm
template <bool kWarp>
__global__ void __launch_bounds__(kThreads) ema_speculate_kernel(
    const float* __restrict__ b, const float* __restrict__ y0,
    const float* __restrict__ alpha_dev, float alpha_val,
    float* __restrict__ ys, float* __restrict__ y_final, float* rec,
    float* fin, long long t, long long C, long long L, long long K,
    int window) {
  const long long idx = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                        / (kWarp ? 32 : 1);
  if (idx >= K * C) return;
  const long long k = idx / C, c = idx - k * C;
  const float a = alpha_dev != nullptr ? *alpha_dev : alpha_val;
  speculate<kWarp>(ScanCell{b, ys, C, c}, a, y0, t, L, k, c, idx, window,
                   rec, fin, y_final);
}

__global__ void __launch_bounds__(32 * kRepairWarps) ema_repair_kernel(
    const float* __restrict__ b, const float* __restrict__ alpha_dev,
    float alpha_val, float* __restrict__ ys, float* __restrict__ y_final,
    const float* rec, const float* fin, unsigned long long* repaired,
    long long t, long long C, long long L, long long K) {
  const long long c =
      (long long)blockIdx.x * kRepairWarps + threadIdx.x / 32;
  if (c >= C) return;
  const float a = alpha_dev != nullptr ? *alpha_dev : alpha_val;
  repair(ScanCell{b, ys, C, c}, a, t, L, K, C, c, rec, fin, y_final,
         repaired);
}

}  // namespace

// b, ys: (t, C) float32 contiguous; y0, y_final: (C,); alpha_dev: one
// float32 on the device, or null to use alpha_val; scratch: 2·K·C float32
// (rec, fin), K = ⌈t / L⌉, L ≥ 16 (the repair's batches of 32 steps
// hold at most two chunk starts); repaired: one uint64 on the device, added to
// by the repair; window: −1, or W forced for every chunk (tests).
extern "C" int emspec_ema_scan(const float* b, const float* y0,
                               const float* alpha_dev, float alpha_val,
                               float* ys, float* y_final, float* scratch,
                               unsigned long long* repaired, int window,
                               long long t, long long C, long long L,
                               void* stream) {
  if (t < 0 || C < 0 || L < 16) return (int)cudaErrorInvalidValue;
  if (t == 0 || C == 0) return 0;
  const long long K = (t + L - 1) / L;
  const bool warp = C < kWarpForm;
  const long long threads = K * C * (warp ? 32 : 1);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  const long long rblocks = (C + kRepairWarps - 1) / kRepairWarps;
  if (blocks > 0x7fffffffLL || rblocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  float* rec = scratch;
  float* fin = scratch + K * C;
  cudaStream_t s = (cudaStream_t)stream;
  if (warp)
    ema_speculate_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        b, y0, alpha_dev, alpha_val, ys, y_final, rec, fin, t, C, L, K,
        window);
  else
    ema_speculate_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        b, y0, alpha_dev, alpha_val, ys, y_final, rec, fin, t, C, L, K,
        window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || K == 1) return (int)err;
  ema_repair_kernel<<<(unsigned)rblocks, 32 * kRepairWarps, 0, s>>>(
      b, alpha_dev, alpha_val, ys, y_final, rec, fin, repaired, t, C, L, K);
  return (int)cudaGetLastError();
}
