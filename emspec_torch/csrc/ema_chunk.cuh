// The exact chunk-parallel EMA scan shared by ema_scan.cu and
// post_chain.cu:
//   y[i] = fl(fl(α·y[i−1]) + b[i]),  y[−1] = y0,  i = 0 … t−1,
// each step one IEEE multiply then one IEEE add (__fmul_rn, __fadd_rn,
// never an FMA), so the result equals, bit for bit, the sequential loop
// and the live column-by-column chain.
//
// What bounds a sequential scan on the H100 is its dependent chain (t
// multiply-add pairs, ~8 cycles each), not its bytes.  This core cuts the
// chain by speculating and then proving the speculation bit-exact:
//
// * Chunking.  The t steps are cut into K chunks of L steps.  L comes
//   from (t, C) alone (the wrapper's ``chunk_len``), never from α or the
//   SM count.  With C ≥ 32 columns thread (k, c) owns chunk k of column
//   c, neighbouring threads neighbouring columns (coalesced); with fewer
//   (the AGC series) a warp owns it (``warp_run``), so one chunk's long
//   warm-up is not one thread's chain of load latencies.
// * Speculation (launch 1).  Chunk 0 starts from y0 and is exact.  Chunk
//   k ≥ 1 starts at step max(0, s_k − W) — from y0 when that is step 0,
//   else from the guess 0 — walks the warm-up steps without storing
//   them, records rec[k] = its value at step s_k − 1, stores its own L
//   steps and records fin[k] = its value at its last step.  The step is
//   monotone and contracts by α, so two runs over the same inputs from
//   different starts become bit-identical once they meet and stay so.
//   W = ⌈24 / −log2|α| + 4 / (1 − |α|)⌉: 24 bits of contraction, then
//   four times the ~1/(1 − α) steps a last one-ulp gap lingers (1 at
//   α = 0, where one computed step lands on the exact value; 43 at 0.6;
//   2,056 at 0.99), capped at s_k; |α| ≥ 1 or NaN starts every chunk
//   from y0.  α is read inside the kernel, never on the host.  W sets
//   only the speed.
// * Verification (launch 2).  Chunk k is exact when chunk k − 1 is and
//   rec[k] equals fin[k − 1] in its bits: its trajectory then continues
//   from the exact value.  Equal bits are equal futures, NaN included.
// * Repair (launch 2).  One warp a column finds the first failed
//   boundary f by ballots over 32 boundaries at once, then walks from the
//   exact fin[f − 1] two trajectories — the exact one, stored, and the
//   speculative one (restarted at each chunk's rec) — until their bits
//   agree: the stored speculative values are exact from there to the next
//   failed boundary, where the search resumes.  The walk takes 32 steps
//   at a time: each lane fetches one step's inputs (the next batch's
//   loads issued before this batch's chain), and every lane runs the
//   dependent chain on the inputs it gathers by shuffles before it.  A
//   column with no failed boundary returns after its ballots.  Each
//   chunk the walk stores into counts once into ``repaired``.  (Above
//   |α| = 0.5 a run of zero inputs holds the exact state on a nonzero
//   subnormal fixed point that the guess 0 never meets, so each chunk of
//   a silent stretch is repaired, exactly, at the walk's speed.
//   post_chain.cu's post_tail, whose gated cells feed exact zeros, scans
//   such α in its pipelined form instead; ema_scan keeps this core at
//   every α.)
//
// A ``Cell`` gives a thread's column its inputs and takes its outputs:
//   Raw fetch(long long i) const         — the loads of step i;
//   float input(const Raw&) const        — b from them;
//   void store(long long i, float y) const.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ema_chunk {

constexpr int kThreads = 128;       // launch 1: threads a block
constexpr int kRepairWarps = 4;     // launch 2: columns (warps) a block
constexpr int kUnroll = 8;          // thread form: steps fetched at once
constexpr int kWarpForm = 32;       // below this many columns, a warp a chunk
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float step(float a, float y, float b) {
  return __fadd_rn(__fmul_rn(a, y), b);
}

__device__ __forceinline__ bool same_bits(float x, float y) {
  return __float_as_uint(x) == __float_as_uint(y);
}

// W for a chunk starting at step s ≥ 1; ``forced`` ≥ 0 overrides it (a
// test hook: W = 0 makes every chunk start at s_k from its guess).
__device__ __forceinline__ long long window_len(float a, long long s,
                                                int forced) {
  if (forced >= 0) return forced < s ? (long long)forced : s;
  const float m = fabsf(a);
  if (m == 0.0f) return 1;
  if (!(m < 1.0f)) return s;
  const float w = ceilf(24.0f / -log2f(m) + 4.0f / (1.0f - m));
  return w >= (float)s ? s : (long long)w;
}

// Thread form: steps [i, end) from y, kUnroll steps' loads at once;
// stores them when kStore.
template <bool kStore, class Cell>
__device__ __forceinline__ float run(const Cell& cell, float a, float y,
                                     long long i, long long end) {
  for (; i + kUnroll <= end; i += kUnroll) {
    typename Cell::Raw raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = cell.fetch(i + u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      y = step(a, y, cell.input(raw[u]));
      if (kStore) cell.store(i + u, y);
    }
  }
  for (; i < end; ++i) {
    y = step(a, y, cell.input(cell.fetch(i)));
    if (kStore) cell.store(i, y);
  }
  return y;
}

// Every lane's input of a batch, gathered into each lane's registers
// before the chain, so no shuffle waits inside it.
__device__ __forceinline__ void gather(float x, float (&xs)[32]) {
#pragma unroll
  for (int u = 0; u < 32; ++u) xs[u] = __shfl_sync(kFull, x, u);
}

// Warp form: the same steps, 32 at a time across the lanes (lane l
// fetches and stores step i + l; every lane runs the chain), the next
// batch's loads issued before this batch's chain.
template <bool kStore, class Cell>
__device__ __forceinline__ float warp_run(const Cell& cell, float a, float y,
                                          long long i, long long end) {
  const int lane = threadIdx.x & 31;
  typename Cell::Raw raw{};
  if (i + lane < end) raw = cell.fetch(i + lane);
  for (; i < end; i += 32) {
    const int n = end - i < 32 ? (int)(end - i) : 32;
    float xs[32];
    gather(lane < n ? cell.input(raw) : 0.0f, xs);
    if (i + 32 + lane < end) raw = cell.fetch(i + 32 + lane);
    float mine = 0.0f;
    if (n == 32) {
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        y = step(a, y, xs[u]);
        mine = lane == u ? y : mine;
      }
    } else {
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        if (u < n) {
          y = step(a, y, xs[u]);
          mine = lane == u ? y : mine;
        }
      }
    }
    if (kStore && lane < n) cell.store(i + lane, mine);
  }
  return y;
}

// Launch 1 for chunk k of column c (a thread, or with kWarp a warp):
// ``slot`` = k·C + c indexes rec and fin.
template <bool kWarp, class Cell>
__device__ void speculate(const Cell& cell, float a, const float* y0,
                          long long t, long long L, long long k, long long c,
                          long long slot, int forced, float* rec, float* fin,
                          float* y_final) {
  const long long s = k * L;
  const long long e = s + L < t ? s + L : t;
  const long long start = k == 0 ? 0 : s - window_len(a, s, forced);
  const bool writer = !kWarp || (threadIdx.x & 31) == 0;
  float y = start == 0 ? y0[c] : 0.0f;
  y = kWarp ? warp_run<false>(cell, a, y, start, s)
            : run<false>(cell, a, y, start, s);
  if (k > 0 && writer) rec[slot] = y;
  y = kWarp ? warp_run<true>(cell, a, y, s, e) : run<true>(cell, a, y, s, e);
  if (writer) {
    fin[slot] = y;
    if (e == t) y_final[c] = y;
  }
}

// The walk from failed boundary f (the whole warp): → the chunk in which
// the two trajectories met, or K when the walk reached t (then y_final
// is its).  Batches of ≤ 32 steps end at chunk boundaries, where the
// speculative trajectory restarts from the next chunk's rec (loaded a
// chunk ahead; no integer division in the loop).
template <class Cell>
__device__ long long walk(const Cell& cell, float a, long long t, long long L,
                          long long K, long long C, long long c, long long f,
                          const float* rec, const float* fin, float* y_final,
                          unsigned long long* count) {
  const int lane = threadIdx.x & 31;
  float ye = fin[(f - 1) * C + c];
  float ys = rec[f * C + c];
  long long m = f, j = f * L;
  long long ce = j + L < t ? j + L : t;            // chunk m's end
  float rec_next = m + 1 < K ? rec[(m + 1) * C + c] : 0.0f;
  typename Cell::Raw raw{};
  if (j + lane < (j + 32 < ce ? j + 32 : ce)) raw = cell.fetch(j + lane);
  bool stored_m = false;
  while (j < t) {
    const long long e = j + 32 < ce ? j + 32 : ce;
    const int n = (int)(e - j);
    float xs[32];
    gather(lane < n ? cell.input(raw) : 0.0f, xs);
    // the next batch's loads, in this chunk or the next
    const long long ne = e < ce ? ce : (ce + L < t ? ce + L : t);
    if (e + lane < (e + 32 < ne ? e + 32 : ne)) raw = cell.fetch(e + lane);
    // both trajectories over the whole batch (once met they stay equal):
    // ``met``, the first step at which their bits agree
    float mine = 0.0f;
    int met = n;
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      if (u < n) {
        ye = step(a, ye, xs[u]);
        ys = step(a, ys, xs[u]);
        met = (met == n && same_bits(ye, ys)) ? u : met;
        mine = lane == u ? ye : mine;
      }
    }
    if (lane < met) cell.store(j + lane, mine);
    if (met > 0 && !stored_m) {
      ++*count;
      stored_m = true;
    }
    if (met < n) return m;
    j = e;
    if (j == ce && j < t) {
      ++m;
      ys = rec_next;
      ce = ne;
      rec_next = m + 1 < K ? rec[(m + 1) * C + c] : 0.0f;
      stored_m = false;
    }
  }
  if (lane == 0) y_final[c] = ye;
  return K;
}

// Launch 2, one warp a column c (the whole warp calls it).
template <class Cell>
__device__ void repair(const Cell& cell, float a, long long t, long long L,
                       long long K, long long C, long long c,
                       const float* rec, const float* fin, float* y_final,
                       unsigned long long* repaired) {
  const int lane = threadIdx.x & 31;
  unsigned long long count = 0;
  long long k0 = 1;     // every boundary below k0 is known exact
  while (k0 < K) {
    long long f = K;
    for (long long base = k0; base < K; base += 32) {
      const long long k = base + lane;
      const bool bad = k < K && !same_bits(rec[k * C + c],
                                           fin[(k - 1) * C + c]);
      const unsigned mask = __ballot_sync(kFull, bad);
      if (mask) {
        f = base + __ffs(mask) - 1;
        break;
      }
    }
    if (f >= K) break;
    k0 = walk(cell, a, t, L, K, C, c, f, rec, fin, y_final, &count) + 1;
  }
  if (lane == 0 && count) atomicAdd(repaired, count);
}

}  // namespace ema_chunk
