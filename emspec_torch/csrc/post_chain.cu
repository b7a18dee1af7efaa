// The batch post chain (emspec_torch/post/chain.py, stages 1–8) as two
// fused kernels around the EMA scan core of ema_chunk.cuh.
//
//   post_head: stages 1–3 and the row peak of every (t, lead) column,
//     peak = max over rows of 10·log10(P·ramp·gain + 1e-12), written
//     alone or as (1 − 0.99)·peak, the AGC series' scan input.  It
//     replaces _boost_db_peak (emspec/post/chain.py:131) without the
//     global coupling, which stays torch code.
//   post_tail: per cell, stages 1–3 again (P is read again rather than
//     v stored and read: 4 bytes a cell instead of 8), the AGC offset
//     from refs[t], the gate, the normalisation, b = (1 − α)·vis; the
//     smoothing EMA by the chunk-parallel scan (speculate, then verify
//     and repair); at store, brightness and clip.  It replaces
//     _agc_gate_norm, the smoothing _ema_scan and _brightness_clip of
//     emspec/post/chain.py:149, :209 and :159 (XLA in the JAX package).
//
// Rounding is torch's eager ops', so that the batch chain equals the
// live column-by-column chain bit for bit: the same order of products
// (P·ramp, then ·gain; enabled·strength, then ·(0 − ref)), one IEEE
// rounding an operation through the _rn intrinsics (no FMA
// contraction), IEEE division, the same log10f that torch's CUDA log10
// calls, torch.clamp's NaN propagation (fminf and fmaxf alone drop NaN)
// and amax's in the row peak.
//
// What bounds the chain on the H100: its bytes — power read once and vis
// written once, 8·t·C (24.3 MB at 5,937 × 512, 7.3 µs at 3.35 TB/s) —
// where the launches do not (at 372 × 512 they do).  post_head is one
// warp a column with 16-byte loads and a shuffle max; post_tail is the
// scan core with its input and its store fused in.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>

#include "ema_chunk.cuh"

namespace {

using namespace ema_chunk;

constexpr int kHeadWarps = 8;       // post_head: columns (warps) a block

__device__ __forceinline__ float db(float p, float ramp, float gain) {
  const float boosted = __fmul_rn(__fmul_rn(p, ramp), gain);     // 1-2
  return __fmul_rn(10.0f, log10f(__fadd_rn(boosted, (float)1e-12)));  // 3
}

// amax's combine: a NaN wins and stays
__device__ __forceinline__ float peak(float m, float v) {
  return (m != m) ? m : ((v != v || v > m) ? v : m);
}

// torch.clamp(x, 0.0, 1.0): NaN passes through
__device__ __forceinline__ float clamp01(float x) {
  return (x != x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kHeadWarps) post_head_kernel(
    const float* __restrict__ power, const float* __restrict__ ramp,
    const float* __restrict__ gain, float* __restrict__ out, long long cols,
    int rows, float coef, int scale) {
  const long long col =
      (long long)blockIdx.x * kHeadWarps + threadIdx.x / 32;
  if (col >= cols) return;
  const int lane = threadIdx.x & 31;
  const float g = *gain;
  const float* p = power + col * rows;
  float m = -INFINITY;
  if (kVec) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* r4 = reinterpret_cast<const float4*>(ramp);
    for (int q = lane; q < rows / 4; q += 32) {
      const float4 v = __ldg(p4 + q), r = __ldg(r4 + q);
      m = peak(m, db(v.x, r.x, g));
      m = peak(m, db(v.y, r.y, g));
      m = peak(m, db(v.z, r.z, g));
      m = peak(m, db(v.w, r.w, g));
    }
  } else {
    for (int q = lane; q < rows; q += 32)
      m = peak(m, db(__ldg(p + q), __ldg(ramp + q), g));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = peak(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) out[col] = scale ? __fmul_rn(coef, m) : m;
}

// One cell's stages 1–7 input and stage 8 output (column c of C = lead·rows)
struct TailCell {
  struct Raw {
    float p, ref;
  };
  const float* __restrict__ power;
  const float* __restrict__ refs;
  float* __restrict__ out;
  long long C, c, nlead, lead;
  float ramp, gain, es, gate, neg_range, range, oma, tb;

  __device__ __forceinline__ Raw fetch(long long i) const {
    return Raw{__ldg(power + i * C + c), __ldg(refs + i * nlead + lead)};
  }
  __device__ __forceinline__ float input(const Raw& r) const {
    const float v0 = db(r.p, ramp, gain);
    float v = __fadd_rn(v0, __fmul_rn(es, __fsub_rn(0.0f, r.ref)));  // 4
    if (v < gate) v = -200.0f;                                     // 5
    const float vis = clamp01(__fdiv_rn(__fsub_rn(v, neg_range), range));  // 6
    return __fmul_rn(oma, vis);                                    // 7: b
  }
  __device__ __forceinline__ void store(long long i, float y) const {
    out[i * C + c] = clamp01(__fmul_rn(y, tb));                    // 8
  }
};

struct TailArgs {
  const float *power, *refs, *ramp, *gain, *db_range, *gate, *strength,
      *enabled, *smoothing, *brightness;
  float* out;
  long long C, rows;
};

__device__ __forceinline__ TailCell tail_cell(const TailArgs& A,
                                              long long c) {
  const long long lead = c / A.rows;
  const float range = *A.db_range;
  return TailCell{A.power, A.refs, A.out, A.C, c, A.C / A.rows, lead,
                  A.ramp[c - lead * A.rows], *A.gain,
                  __fmul_rn(*A.enabled, *A.strength), *A.gate,
                  __fsub_rn(0.0f, range), range,
                  __fsub_rn(1.0f, *A.smoothing),
                  __fmul_rn(2.0f, *A.brightness)};
}

// kWarp: a warp a (chunk, column), for C < kWarpForm
template <bool kWarp>
__global__ void __launch_bounds__(kThreads) post_tail_speculate_kernel(
    TailArgs A, const float* __restrict__ y0, float* __restrict__ y_final,
    float* rec, float* fin, long long t, long long L, long long K,
    int window) {
  const long long idx = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                        / (kWarp ? 32 : 1);
  if (idx >= K * A.C) return;
  const long long k = idx / A.C, c = idx - k * A.C;
  speculate<kWarp>(tail_cell(A, c), *A.smoothing, y0, t, L, k, c, idx,
                   window, rec, fin, y_final);
}

__global__ void __launch_bounds__(32 * kRepairWarps) post_tail_repair_kernel(
    TailArgs A, float* __restrict__ y_final, const float* rec,
    const float* fin, unsigned long long* repaired, long long t, long long L,
    long long K) {
  const long long c =
      (long long)blockIdx.x * kRepairWarps + threadIdx.x / 32;
  if (c >= A.C) return;
  repair(tail_cell(A, c), *A.smoothing, t, L, K, A.C, c, rec, fin, y_final,
         repaired);
}

}  // namespace

// power: (cols, rows) float32 contiguous, cols = t·lead; ramp: (rows,);
// gain: one float32 on the device; out: (cols,) — the peak, or coef·peak
// when scale ≠ 0.  vec: 16-byte loads (rows % 4 = 0, power and ramp
// 16-byte aligned).
extern "C" int emspec_post_head(const float* power, const float* ramp,
                                const float* gain, float* out,
                                long long cols, int rows, float coef,
                                int scale, int vec, void* stream) {
  if (cols < 0 || rows < 1) return (int)cudaErrorInvalidValue;
  if (cols == 0) return 0;
  const long long blocks = (cols + kHeadWarps - 1) / kHeadWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    post_head_kernel<true><<<(unsigned)blocks, 32 * kHeadWarps, 0, s>>>(
        power, ramp, gain, out, cols, rows, coef, scale);
  else
    post_head_kernel<false><<<(unsigned)blocks, 32 * kHeadWarps, 0, s>>>(
        power, ramp, gain, out, cols, rows, coef, scale);
  return (int)cudaGetLastError();
}

// power, out: (t, C) float32 contiguous, C = lead·rows; refs: (t, lead);
// y0, y_final: (C,); the eight parameters: ramp (rows,) and seven float32
// scalars on the device; scratch: 2·K·C float32, K = ⌈t / L⌉, L ≥ 16;
// repaired,
// window: as emspec_ema_scan's.
extern "C" int emspec_post_tail(
    const float* power, const float* refs, const float* y0,
    const float* ramp, const float* gain, const float* db_range,
    const float* gate, const float* strength, const float* enabled,
    const float* smoothing, const float* brightness, float* out,
    float* y_final, float* scratch, unsigned long long* repaired, int window,
    long long t, long long C, long long rows, long long L, void* stream) {
  if (t < 0 || C < 0 || rows < 1 || L < 16 || C % rows != 0)
    return (int)cudaErrorInvalidValue;
  if (t == 0 || C == 0) return 0;
  const long long K = (t + L - 1) / L;
  const bool warp = C < kWarpForm;
  const long long threads = K * C * (warp ? 32 : 1);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  const long long rblocks = (C + kRepairWarps - 1) / kRepairWarps;
  if (blocks > 0x7fffffffLL || rblocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const TailArgs A{power, refs, ramp, gain, db_range, gate, strength,
                   enabled, smoothing, brightness, out, C, rows};
  float* rec = scratch;
  float* fin = scratch + K * C;
  cudaStream_t s = (cudaStream_t)stream;
  if (warp)
    post_tail_speculate_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        A, y0, y_final, rec, fin, t, L, K, window);
  else
    post_tail_speculate_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        A, y0, y_final, rec, fin, t, L, K, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || K == 1) return (int)err;
  post_tail_repair_kernel<<<(unsigned)rblocks, 32 * kRepairWarps, 0, s>>>(
      A, y_final, rec, fin, repaired, t, L, K);
  return (int)cudaGetLastError();
}
