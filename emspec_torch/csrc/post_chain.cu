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
//     smoothing EMA; at store, brightness and clip.  It replaces
//     _agc_gate_norm, the smoothing _ema_scan and _brightness_clip of
//     emspec/post/chain.py:149, :209 and :159 (XLA in the JAX package).
//
// Rounding is torch's eager ops', so that the batch chain equals the
// live column-by-column chain bit for bit: the same order of products
// (P·ramp, then ·gain; enabled·strength, then ·(0 − ref)), one IEEE
// rounding an operation through the _rn intrinsics (no FMA
// contraction), IEEE division, the same log10f that torch's CUDA log10
// calls, torch.clamp's NaN propagation (fminf and fmaxf alone drop NaN)
// and amax's in the row peak.  Subnormals are kept (no flush to zero):
// the state over a silent stretch is one.
//
// What bounds the chain on the H100: its bytes — power read once and vis
// written once, 8·t·C (24.3 MB at 5,937 × 512, 7.3 µs at 3.35 TB/s) —
// where the launches do not (at 372 × 512 they do), and for post_tail's
// scan at |α| > 0.5 the dependent chain of a column, t multiply-add pairs
// (~8 cycles a step: 24 µs at 5,937 steps and 1.98 GHz).  post_head is one warp a column with 16-byte loads and a
// shuffle max.  post_tail has two forms, chosen on the device from α and
// the test hook W (never on the host); both launches run in either, their
// grids from the shape alone:
//
// * |α| ≤ 0.5: the chunk-parallel scan of ema_chunk.cuh with its input
//   and its store fused in (speculate, then verify and repair).  Over a
//   run of zero inputs the exact state falls to 0, the speculation's
//   guess, so silence verifies.
// * |α| > 0.5 or NaN, W not forced: the pipelined form.  Above one half
//   a run of zero inputs holds the exact state on a nonzero subnormal
//   fixed point, k·2⁻¹⁴⁹ with RN(α·k·2⁻¹⁴⁹) = k·2⁻¹⁴⁹ (k_max = 1 at
//   0.6, 50 at 0.99), that the guess 0 never meets: every chunk of a
//   silent stretch failed verification and the repair walked the stretch
//   a step at a time, a warp a column, while the warm-up W grows as
//   1/(1 − α) (2,056 steps at 0.99).  Instead the first launch only
//   marks its scratch (``kMark``) and the second walks each column once
//   from y0: a block owns kPipeCols columns; warp 0 runs their chains (a
//   lane a column) alone on its scheduler, from b in shared memory, a
//   tile of kPipeTile steps at a time; each producer thread owns a row
//   of every tile — its power a 16-byte load a tile ahead, b into shared
//   memory, the vis of the tile two behind one 16-byte store.  Nothing
//   is speculated, so nothing is repaired, and silence, NaN and ±inf
//   cost what any input costs: the time is the chain's, at every α.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ema_chunk.cuh"

namespace {

using namespace ema_chunk;

constexpr int kHeadWarps = 8;       // post_head: columns (warps) a block
// the pipelined form: a block of the second launch (kPipeWarps warps;
// the chunk-parallel repair uses its first kRepairWarps) owns kPipeCols
// columns.  Warp 0 runs their chains alone on its scheduler (warps 4 and
// 8 share it and only keep the barriers: a busy warp beside the chain
// lengthens its steps); the other warps produce, a row of the kPipeCols
// columns a thread a tile.
constexpr int kPipeWarps = 12;
constexpr int kPipeCols = kRepairWarps;
constexpr int kPipeProducers = 32 * (kPipeWarps - kPipeWarps / 4);
constexpr int kPipeTile = kPipeProducers;   // steps a tile: a row a producer
constexpr int kPipeStride = (kPipeTile + 24) / 32 * 32 + 8;  // b or y a column
constexpr int kPipeGroup = 16;      // chain steps a batch of loads
static_assert(kPipeWarps >= kRepairWarps && kPipeWarps % 4 == 0 &&
                  kPipeCols == 4,
              "warps; a row of the block's columns is a float4");
static_assert(kPipeTile % kPipeGroup == 0 && kPipeStride % 4 == 0,
              "the chain's 16-byte loads and stores");

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
  __device__ __forceinline__ float vis(float y) const {
    return clamp01(__fmul_rn(y, tb));                              // 8
  }
  __device__ __forceinline__ void store(long long i, float y) const {
    out[i * C + c] = vis(y);
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

// The form post_tail's two launches take: pipelined where a run of zero
// inputs leaves a nonzero fixed point (|α| > 0.5, NaN) and W is not
// forced (the test hook keeps the chunk-parallel form at every α).  The
// first launch decides and, pipelined, fills rec and fin with kMark, a
// signalling NaN that no arithmetic returns: every boundary then
// verifies, and the second launch, which runs the repair unchanged (its
// loads wait on nothing), takes the pipelined form where fin[0] is the
// mark.
__device__ __forceinline__ bool pipelined(float a, int window) {
  return window < 0 && !(fabsf(a) <= 0.5f);
}
constexpr unsigned kMark = 0x7f800001u;

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
  const TailCell cell = tail_cell(A, c);
  const float a = *A.smoothing;
  // one chunk (K = 1) is chunk 0, exact from y0; else the second launch
  if (K > 1 && pipelined(a, window)) {
    if (!kWarp || (threadIdx.x & 31) == 0) {
      rec[idx] = __uint_as_float(kMark);
      fin[idx] = __uint_as_float(kMark);
    }
    return;
  }
  speculate<kWarp>(cell, a, y0, t, L, k, c, idx, window, rec, fin,
                   y_final);
}

// Row i of the block's columns c0 … into np (power) and nr (each
// column's ref), nothing past t; a 16-byte load where ``vec``.
__device__ __forceinline__ void pipe_fetch(const TailArgs& A, long long c0,
                                           const int (&lead)[kPipeCols],
                                           bool vec, int cols, long long i,
                                           long long t,
                                           float (&np)[kPipeCols],
                                           float (&nr)[kPipeCols]) {
  if (i >= t) return;
  const float* prow = A.power + i * A.C + c0;
  if (vec) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(prow));
    np[0] = v.x, np[1] = v.y, np[2] = v.z, np[3] = v.w;
  } else {
#pragma unroll
    for (int g = 0; g < kPipeCols; ++g)
      if (g < cols) np[g] = __ldg(prow + g);
  }
  const float* rrow = A.refs + i * (A.C / A.rows);
#pragma unroll
  for (int g = 0; g < kPipeCols; ++g) nr[g] = __ldg(rrow + lead[g]);
}

// The pipelined form over columns [c0, c0 + kPipeCols) (the whole block).
// Iteration n: each producer takes its row of tile n + 1's power and refs
// into registers (16-byte loads where the columns allow), turns its row
// of tile n into b and stores its row of tile n − 2's vis; warp 0 steps
// the chains through tile n − 1; one barrier closes it.  b and y of a
// tile lie [g][u], a column's steps contiguous: the chain loads and
// stores 16 bytes, kPipeGroup steps' loads issued a batch ahead.
__device__ void post_tail_pipelined(const TailArgs& A,
                                    const float* __restrict__ y0,
                                    float* __restrict__ y_final, long long t,
                                    long long c0, float a) {
  __shared__ __align__(16) float bs[2][kPipeCols][kPipeStride];
  __shared__ __align__(16) float ys[2][kPipeCols][kPipeStride];
  const long long tiles = (t + kPipeTile - 1) / kPipeTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (warp == 0) {
    const long long c = c0 + lane;
    const bool mine = lane < kPipeCols && c < A.C;
    float y = mine ? y0[c] : 0.0f;
    for (long long n = 0; n <= tiles + 1; ++n) {
      if (mine && n >= 1 && n <= tiles) {
        const int q = (int)((n - 1) & 1);
        const long long left = t - (n - 1) * kPipeTile;
        const int steps = left < kPipeTile ? (int)left : kPipeTile;
        const float4* b4 = reinterpret_cast<const float4*>(bs[q][lane]);
        float4* y4 = reinterpret_cast<float4*>(ys[q][lane]);
        int u = 0;
        if (steps >= kPipeGroup) {
          float4 nb[kPipeGroup / 4];
#pragma unroll
          for (int v = 0; v < kPipeGroup / 4; ++v) nb[v] = b4[v];
          for (; u + kPipeGroup <= steps; u += kPipeGroup) {
            float xb[kPipeGroup];
#pragma unroll
            for (int v = 0; v < kPipeGroup / 4; ++v) {
              xb[4 * v] = nb[v].x;
              xb[4 * v + 1] = nb[v].y;
              xb[4 * v + 2] = nb[v].z;
              xb[4 * v + 3] = nb[v].w;
            }
            if (u + 2 * kPipeGroup <= steps) {
#pragma unroll
              for (int v = 0; v < kPipeGroup / 4; ++v)
                nb[v] = b4[(u + kPipeGroup) / 4 + v];
            }
            float xy[kPipeGroup];
#pragma unroll
            for (int k = 0; k < kPipeGroup; ++k) {
              y = step(a, y, xb[k]);
              xy[k] = y;
            }
#pragma unroll
            for (int v = 0; v < kPipeGroup / 4; ++v)
              y4[u / 4 + v] = make_float4(xy[4 * v], xy[4 * v + 1],
                                          xy[4 * v + 2], xy[4 * v + 3]);
          }
        }
        for (; u < steps; ++u) {
          y = step(a, y, bs[q][lane][u]);
          ys[q][lane][u] = y;
        }
      }
      __syncthreads();
    }
    if (mine) y_final[c] = y;
    return;
  }
  if (warp % 4 == 0) {        // the chain's scheduler: warp 0 alone
    for (long long n = 0; n <= tiles + 1; ++n) __syncthreads();
    return;
  }
  // producer p owns row p of every tile
  const int p = (warp - 1 - warp / 4) * 32 + lane;
  const int cols = A.C - c0 < kPipeCols ? (int)(A.C - c0) : kPipeCols;
  // the columns differ only in their ramp and lead
  TailCell cell = tail_cell(A, c0);
  float ramp[kPipeCols];
  int lead[kPipeCols];
#pragma unroll
  for (int g = 0; g < kPipeCols; ++g) {
    const long long cg = c0 + (g < cols ? g : 0);
    lead[g] = (int)(cg / A.rows);
    ramp[g] = A.ramp[cg - lead[g] * A.rows];
  }
  float* orow = A.out + c0;
  const bool vec = cols == kPipeCols && A.C % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(A.power + c0) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(orow) % 16 == 0;
  float np[kPipeCols] = {}, nr[kPipeCols] = {};
  pipe_fetch(A, c0, lead, vec, cols, p, t, np, nr);
  for (long long n = 0; n <= tiles + 1; ++n) {
    float cp[kPipeCols], cr[kPipeCols];
#pragma unroll
    for (int g = 0; g < kPipeCols; ++g) cp[g] = np[g], cr[g] = nr[g];
    pipe_fetch(A, c0, lead, vec, cols, (n + 1) * kPipeTile + p, t, np, nr);
    if (n < tiles && n * kPipeTile + p < t) {
      const int q = (int)(n & 1);
#pragma unroll
      for (int g = 0; g < kPipeCols; ++g) {
        cell.ramp = ramp[g];
        bs[q][g][p] = cell.input(TailCell::Raw{cp[g], cr[g]});
      }
    }
    const long long i = (n - 2) * kPipeTile + p;
    if (n >= 2 && i < t) {
      const int q = (int)(n & 1);
      if (vec) {
        *reinterpret_cast<float4*>(orow + i * A.C) = make_float4(
            cell.vis(ys[q][0][p]), cell.vis(ys[q][1][p]),
            cell.vis(ys[q][2][p]), cell.vis(ys[q][3][p]));
      } else {
#pragma unroll
        for (int g = 0; g < kPipeCols; ++g)
          if (g < cols) orow[i * A.C + g] = cell.vis(ys[q][g][p]);
      }
    }
    __syncthreads();
  }
}

// The second launch: a block a kPipeCols (= kRepairWarps) columns.  Its
// first kRepairWarps warps verify and repair a column each; then, where
// the first launch left the mark, the whole block walks them pipelined.
__global__ void __launch_bounds__(32 * kPipeWarps) post_tail_repair_kernel(
    TailArgs A, const float* __restrict__ y0, float* __restrict__ y_final,
    const float* rec, const float* fin, unsigned long long* repaired,
    long long t, long long L, long long K) {
  const int warp = threadIdx.x / 32;
  const long long c0 = (long long)blockIdx.x * kPipeCols, c = c0 + warp;
  if (warp < kRepairWarps && c < A.C)
    repair(tail_cell(A, c), *A.smoothing, t, L, K, A.C, c, rec, fin,
           y_final, repaired);
  // read after the repair, which kept it in L1, so that nothing is held
  // across it
  if (__float_as_uint(fin[c0]) == kMark)
    post_tail_pipelined(A, y0, y_final, t, c0, *A.smoothing);
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
// scalars on the device; scratch: 2·K·C float32, K = ⌈t / L⌉, L ≥ 16 (the
// chunk-parallel form's rec and fin; the pipelined form marks them);
// repaired, window: as emspec_ema_scan's (the pipelined form repairs
// nothing; a forced window keeps the chunk-parallel form).
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
  post_tail_repair_kernel<<<(unsigned)rblocks, 32 * kPipeWarps, 0, s>>>(
      A, y0, y_final, rec, fin, repaired, t, L, K);
  return (int)cudaGetLastError();
}
