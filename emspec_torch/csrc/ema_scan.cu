// The batch post chain's EMA recurrence as one scan:
//   ys[i, c] = α·ys[i−1, c] + b[i, c],  ys[−1, c] = y0[c],  i = 0 … t−1,
// and y_final[c] = ys[t−1, c] (y0[c] when t = 0).
//
// Replaces the sequential lax.scan of emspec/post/chain.py::_ema_scan (the
// JAX package runs it in XLA, not Pallas), which the port ran as a Python
// loop of two launches a column.  Each step is one IEEE multiply and then
// one IEEE add (__fmul_rn, __fadd_rn): never contracted into an FMA, so ys
// equals, bit for bit, the column-by-column evolution of the live step
// (postprocess_column: α·y, then + b) and the plain loop on the card.
//
// α is read from device memory when `alpha_dev` is given (the smoothing
// slider, a 0-d tensor: no host read, so a slider move never rebuilds
// anything), else taken by value (the AGC's constant decay).
//
// What bounds it on the H100: the dependent chain, not the bytes.  Each
// column is a sequence of t multiply–add pairs, each waiting on the last
// (~8 cycles: t = 5,937 steps is ~27 µs at 1.75 GHz), while the bytes, 8·t·C
// (b read, ys written), take 7.3 µs at 5,937 × 512 at 3.35 TB/s.  Design:
// one thread a column walking i; neighbouring threads take neighbouring
// columns, so each warp step reads and writes one 128-byte line.  The
// loads run far ahead of the chain: a ring of kStages register buffers of
// kUnroll steps each; a stage is consumed (kUnroll dependent steps) and at
// once refilled with the steps kStages·kUnroll further on, so every load
// has (kStages − 1)·kUnroll dependent steps (~900 cycles) to arrive in —
// a device-memory round trip.  The stage loop is unrolled, so the ring
// stays in registers and no buffer is copied; the addresses advance by
// pointer bumps, and only the last two rounds test each step against t.
// Each step is then ~8 instructions of one warp against its 8-cycle
// chain.  (Two earlier designs, a double buffer of 16 swapped by copies
// and a ring whose every step recomputed its i·C address under a
// predicate, ran several times slower on the H100: the instructions a
// step, not memory latency, set their time.)  Small blocks
// (kThreads) spread C = 512 over 8 SMs; the AGC series (C = 1 mono, 16 at
// 16 channels) is one block, latency-bound by construction.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;      // steps a stage
constexpr int kStages = 8;       // stages in the ring

__global__ void __launch_bounds__(kThreads) ema_scan_kernel(
    const float* __restrict__ b, const float* __restrict__ y0,
    const float* __restrict__ alpha_dev, float alpha_val,
    float* __restrict__ ys, float* __restrict__ y_final, long long t,
    long long C) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float a = alpha_dev != nullptr ? *alpha_dev : alpha_val;
  float y = y0[c];
  const float* ld = b + c;    // the next step to load
  float* st = ys + c;         // the next step to store
  constexpr int kAhead = kStages * kUnroll;
  float buf[kStages][kUnroll];
#pragma unroll
  for (int s = 0; s < kStages; ++s)
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      buf[s][u] = s * kUnroll + u < t ? __ldg(ld) : 0.0f;
      ld += C;
    }
  long long i = 0;
  // every load of these rounds lies below t: no predicate
  for (; i + 2 * kAhead <= t; i += kAhead) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        y = __fadd_rn(__fmul_rn(a, y), buf[s][u]);
        *st = y;
        st += C;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        buf[s][u] = __ldg(ld);
        ld += C;
      }
    }
  }
  // the last one or two rounds, step by step against t
  for (; i < t; i += kAhead) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      const long long base = i + s * kUnroll;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (base + u < t) {
          y = __fadd_rn(__fmul_rn(a, y), buf[s][u]);
          *st = y;
          st += C;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        buf[s][u] = base + kAhead + u < t ? __ldg(ld) : 0.0f;
        ld += C;
      }
    }
  }
  y_final[c] = y;
}

}  // namespace

// b, ys: (t, C) float32 contiguous; y0, y_final: (C,); alpha_dev: one
// float32 on the device, or null to use alpha_val.
extern "C" int emspec_ema_scan(const float* b, const float* y0,
                               const float* alpha_dev, float alpha_val,
                               float* ys, float* y_final, long long t,
                               long long C, void* stream) {
  if (t < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const long long blocks = (C + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ema_scan_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      b, y0, alpha_dev, alpha_val, ys, y_final, t, C);
  return (int)cudaGetLastError();
}
