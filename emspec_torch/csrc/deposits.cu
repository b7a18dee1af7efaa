// Kernel B1: fused single-bank enhanced analysis — frames → reassigned
// deposits (ids, contrib), each frame's spectra held on chip from the read
// of its samples to the write of its deposits, for N = 512 … 32768
// (larger frames: deposits_large.cu).  Also kernel B6 at N <= 32768: the
// same block, or the same cluster, histograms its deposits instead of
// writing them.
//
// Replaces emspec/dsp/pallas/fft4.py::fft4_deposits (with its
// _deposits_kernel and _frame_quantized).  Same function, GPU formulation:
//   * per frame: t·h window; the raw and the t·h REAL DFTs, each as an
//     m = N/2-point complex FFT of the even/odd-packed samples
//     z[i] = s[2i] + i·s[2i+1] plus the real-input unpack (the two signals
//     are never packed together: at N = 8192 their spectra differ ~1,160×
//     in magnitude and a joint pack costs the raw spectrum ~10 bits);
//   * periodic-Hann 3-point stencils → X_h, X_dh (neighbours at k = 0 and
//     N/2 by Hermitian symmetry, as emspec/dsp/stft.py:stencil_from_raw);
//   * Auger–Flandrin Δt, Δω; f̂; round-half-even quantization (rintf), with
//     Δt/hop a true division; validity mask; contrib = |X_h|²/N²;
//   * id = (δ + reach)·rows + row, written in natural bin order k = 0..N/2
//     (the TPU kernel's (k1,k2)-major order was a layout artifact; the
//     histogram does not depend on order).  Invalid deposits carry id −1
//     and contrib 0, so nothing downstream reads them.
//   * optionally a bin window [k_lo, k_hi) and a per-bin band weight: a
//     band-sliced multires bank (emspec/pipeline.py:335-424
//     _deposits_banked, whose JAX chain runs a full rfft, slices and
//     weights; here only the window's bins are computed and written,
//     (frames, k_hi − k_lo), contrib = (|X_h|²·band)/N²).  The window's
//     edge bins read their true neighbours k_lo − 1 and k_hi.
// The unpack and the per-bin epilogue are deposits_common.cuh, shared with
// the large-frame route; the FFT is kernel B4's (radix_common.cuh).
//
// Kernel B6 replaces emspec/dsp/pallas/fft4.py::fft4_hist (_hist_kernel,
// _tile_hist): B1 and B2 fused.  The deposits go into a float32 relative
// histogram of P·rows cells in shared memory, placed after the spectra
// (ids below min_id, the streaming mask, and outside the histogram are
// dropped), and each output cell is stored once: the deposits never
// reach device memory, and no output is zeroed.  They add through B2's
// warp_add (histogram_common.cuh), merging every warp step as B2's global
// route does: the relative histogram of real audio is hot (a steady tone
// keeps δ at 0, the log raster folds tens of high bins into each of its
// top rows), and a shared float atomicAdd is a compare-and-swap loop whose
// lanes on one cell retry in turn.  B2's row route merges only hot steps
// because four blocks an SM hide those retries; B6 runs one block (or one
// rank) of 16 warps an SM, its spectra filling shared memory, and there
// B2's hot-step test measured slower than merging every step.
//   * block route (N <= 16384): the histogram after the block's two tiles;
//   * cluster route (N = 32768, num_bins <= kClusterHistCells = 6,912):
//     each rank of B1's cluster adds its bins' deposits into a histogram
//     of its own after its staged columns; a third cluster sync, then rank
//     0 stores cells [0, S/2) and rank 1 cells [S/2, S), each its own
//     cell plus the other rank's, read through distributed shared memory;
//     a fourth sync keeps both histograms alive until both are read.
//   Larger N or more cells: deposits_large.cu's three launches.
//
// Design.  With m = n1·n2 (n1, n2 = emspec_torch/dsp/fourstep.py
// _FACTORS[m]), a signal's z lies in a shared tile of n1 rows padded to
// n2 + 1 complex values, in B4's step-1 layout: z[i] at
// (i div n2)·(n2 + 1) + i mod n2, stored there straight from the frame
// (read once through its strides, 16 bytes a thread where the frame's
// address and strides allow, the t·h window applied on the way).  Steps
// 1–3 run with B4's line_fft exactly as its small_kernel runs them, which
// leaves Z[k] at the step-4 address (k mod n1)·(n2 + 1) + k div n1.  The
// epilogue reads the tiles and writes nothing back: a warp takes 30
// consecutive bins, each lane unpacks X[k] and Y[k] from Z[k] and
// Z[m − k] (the real-input unpack) and takes X[k ∓ 1] from its
// neighbouring lanes by shuffle; the ids/contrib stores are coalesced in
// natural order, and the strided shared reads (stride n2 + 1 ≡ 1 mod 16
// complex values) are free of bank conflicts.
// Routes, by N alone:
//   * block, N <= 16384: one block a frame holding both signals' tiles,
//     8·2·n1·(n2 + 1) bytes (66 KB at 8192, 132 KB at 16384) after the
//     W_512 table, the two tiles run as B4 runs two frames.
//   * cluster, N = 32768: one tile is 132 KB, so the pair takes a
//     thread-block cluster of two CTAs: rank 0 holds the raw and rank 1
//     the t·h spectrum.  After steps 1–3 the cluster syncs and each rank
//     copies, through distributed shared memory, the half of the other's
//     tile that its bins need (rank 0 bins 0 … m/4 − 1 and 3m/4 + 1 … m,
//     rank 1 the rest) into 67 KB of its own, in whole row runs; a second
//     cluster sync keeps each tile alive while it is copied, and the
//     epilogue reads local shared memory only (one scattered 8-byte
//     remote read a bin is far slower than these whole-row runs).
// A frame's arithmetic depends on N only, never on b or on where the frame
// sits in the batch, so b = 1 gives frame 0 of a batch bit for bit.
//
// What bounds it on the H100: device memory moves 4·N bytes in a frame
// (8·N at 32768, where both ranks read it, the second mostly from L2) and
// 8·(N/2 + 1) out, far below what the card takes; the pace is set on chip
// by the FFT's shared-memory passes, the epilogue's arithmetic and, at
// 32768, the copy between the ranks — one or two blocks an SM, whose
// phases run one after another.  B6 writes 4·P·rows bytes a frame instead
// of the deposits' 8·(N/2 + 1), and adds the shared atomics and the warp
// merge of its histogram to the epilogue.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC, never --use_fast_math (log2f and the division must
// stay IEEE-accurate).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "deposits_common.cuh"
#include "histogram_common.cuh"
#include "radix_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace emspec::radix;

constexpr int kThreads = 512;
constexpr int kBatch = 2;                  // loads a thread issues before using them
constexpr int kBinsPerWarp = 30;           // epilogue: lanes 1…30 own a bin
constexpr int kBlockMaxLog2M = 13;         // block route: m <= 8192
constexpr int kClusterLog2M = 14;          // cluster route: m = 16384
constexpr int kClusterP = 32;              // ... at P points a thread
constexpr int kStageStride = 67;           // staged columns a row (odd)
constexpr int kCopyBatch = 4;              // remote reads in flight a thread
constexpr int kMaxSmem = 232448;           // a block's most on the H100
constexpr int kClusterSmem =               // table, tile, staged columns
    (int)sizeof(float2) * (kTable + 128 * (128 + 1) + 128 * kStageStride);
constexpr int kClusterHistCells =          // B6's histogram beside them
    (kMaxSmem - kClusterSmem) / (int)sizeof(float);

// Everything a launch reads and writes; the frame f of the batch starts at
// x + (f div frames_per_lead)·lead_stride + (f mod frames_per_lead)·frame_stride.
struct Args {
  const float* x;
  long long frames_per_lead, lead_stride, frame_stride;
  int vec;                       // 1: 16-byte frame loads
  const float* th;               // the t·h window, N floats
  const float2* w512;            // B4's W_512^t table
  const float2* tw4;             // B4's step-2 TW, (n1, n2)
  const float2* tw;              // unpack: e^{−2πij/N}, j < N/2
  const float *logmap_a, *logmap_b, *power_floor;
  int* ids;                      // B1: (frames, k_hi − k_lo)
  float* out;                    // B1: contrib; B6: (frames, num_bins)
  int n, log2n1, log2n2, hop;
  float c_dh, bin_scale, hz_per_bin, inv_n2;
  int rows, reach, min_id, num_bins;
  int k_lo, k_hi;                // the bins written: [k_lo, k_hi)
  const float* band;             // (k_hi − k_lo) band weights, or null (1)
};

// A packed spectrum Z after steps 1–3, in shared memory: Z[k], k < m, at
// row k mod n1, column k div n1 — in a whole tile (stride n2 + 1, c0 = 0)
// or in a tile of staged columns c0, c0 + 1, … (mod n2) at row stride
// kStageStride.  Both strides are odd, so 16 consecutive k (consecutive
// rows) hit 16 distinct bank pairs.
struct Spectrum {
  const float2* z;
  int stride, c0;
  __device__ __forceinline__ int at(int k, int log2n1, int log2n2) const {
    return (k & ((1 << log2n1) - 1)) * stride
           + (((k >> log2n1) - c0) & ((1 << log2n2) - 1));
  }
};

// X[j], 0 <= j <= m, of a real frame from its packed spectrum Z: the pair
// (j', m − j'), j' = min(j, m − j), unpacked as deposits_large.cu's
// spectrum_at does, so all routes compute each X[j] from the same values
// in the same order.
__device__ __forceinline__ float2 spectrum_at(const Spectrum& Z,
                                              const float2* __restrict__ tw,
                                              int j, int log2n1, int log2n2) {
  const int m = 1 << (log2n1 + log2n2);
  const bool upper = j > (m >> 1);
  const int jl = upper ? m - j : j;
  const int jm = jl == 0 ? 0 : m - jl;
  float2 lo, hi;
  emspec::unpack_pair(Z.z[Z.at(jl, log2n1, log2n2)],
                      Z.z[Z.at(jm, log2n1, log2n2)], __ldg(tw + jl), &lo,
                      &hi);
  return upper ? hi : lo;
}

__device__ __forceinline__ float2 shfl(float2 v, int delta, bool up) {
  return up ? make_float2(__shfl_up_sync(0xffffffffu, v.x, delta),
                          __shfl_up_sync(0xffffffffu, v.y, delta))
            : make_float2(__shfl_down_sync(0xffffffffu, v.x, delta),
                          __shfl_down_sync(0xffffffffu, v.y, delta));
}

// Frame f → the packed raw signal into `raw` and the packed t·h signal into
// `thw` (either may be null), each in the step-1 layout.  16-byte loads
// give z[2g], z[2g+1], which share a tile row (n2 is even).  A thread
// issues kBatch loads before it stores any: with one or two blocks an SM,
// a load waited for one at a time would leave the memory system idle.
__device__ __forceinline__ void load_frame(float2* raw, float2* thw,
                                           const Args& a, long long f) {
  const float* fr = a.x + (f / a.frames_per_lead) * a.lead_stride
                        + (f % a.frames_per_lead) * a.frame_stride;
  const int m = 1 << (a.log2n1 + a.log2n2);
  const int mask = (1 << a.log2n2) - 1;
  const int T = blockDim.x;
  if (a.vec) {
    for (int g0 = threadIdx.x; g0 < m >> 1; g0 += kBatch * T) {
      float4 s[kBatch], t[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int g = g0 + j * T;
        if (g < m >> 1) {
          s[j] = __ldg(reinterpret_cast<const float4*>(fr) + g);
          if (thw != nullptr)
            t[j] = __ldg(reinterpret_cast<const float4*>(a.th) + g);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = 2 * (g0 + j * T);
        if (i >= m) break;
        const int at = (i >> a.log2n2) * (mask + 2) + (i & mask);
        if (raw != nullptr) {
          raw[at] = make_float2(s[j].x, s[j].y);
          raw[at + 1] = make_float2(s[j].z, s[j].w);
        }
        if (thw != nullptr) {
          thw[at] = make_float2(s[j].x * t[j].x, s[j].y * t[j].y);
          thw[at + 1] = make_float2(s[j].z * t[j].z, s[j].w * t[j].w);
        }
      }
    }
  } else {
    for (int i0 = threadIdx.x; i0 < m; i0 += kBatch * T) {
      float2 s[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * T;
        if (i < m) s[j] = make_float2(__ldg(fr + 2 * i), __ldg(fr + 2 * i + 1));
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * T;
        if (i >= m) break;
        const int at = (i >> a.log2n2) * (mask + 2) + (i & mask);
        if (raw != nullptr) raw[at] = s[j];
        if (thw != nullptr)
          thw[at] = make_float2(s[j].x * __ldg(a.th + 2 * i),
                                s[j].y * __ldg(a.th + 2 * i + 1));
      }
    }
  }
}

// Steps 1–3 of `count` (1 or 2) tiles at stride n1·(n2 + 1), as B4's
// small_kernel runs its frames: the column FFTs with TW on their last
// pass, then the row FFTs.
template <int P>
__device__ __forceinline__ void tile_fft(float2* tiles, const float2* w,
                                         const Args& a, int log2count) {
  const int l1 = a.log2n1, l2 = a.log2n2;
  const int fs = (1 << l1) * ((1 << l2) + 1);
  line_fft<P>(tiles, w, Lines{log2count + l2, l2, fs, 1, (1 << l2) + 1}, l1,
              Step2{a.tw4, l2, 0});
  line_fft<P>(tiles, w, Lines{log2count + l1, 0, (1 << l2) + 1, 0, 1}, l2,
              Step2{nullptr, 0, 0});
}

// Bins k0 <= k < k1 of frame f (inside the launch's window [k_lo, k_hi))
// from the packed raw spectrum Zx and the packed t·h spectrum Zy: B1
// writes ids and contrib at column k − k_lo, B6 adds into `hist` through
// warp_add, which all 32 lanes call: a lane without a bin of its own
// (lanes 0 and 31, k >= k1) or whose deposit does not land offers the
// dropped key ~lane.
// A warp takes 30 consecutive bins at a time: lane l unpacks X at
// k = base − 1 + l and Y at k (each clamped to what the bins need: X on
// k0 − 1 … k1, Y on k0 … k1 − 1, within 0…m) and lanes 1…30 take
// X[k ∓ 1] from their neighbours by shuffle, so each bin costs two reads
// of each spectrum (the Hermitian conjugates X[1], X[m − 1] stand in at
// k = 0 and m).  The loop bound is warp-uniform, as the shuffles need;
// kBatch rounds of reads go out before any is used.
template <bool kHist>
__device__ __forceinline__ void deposits_of(const Spectrum& Zx,
                                            const Spectrum& Zy, int k0,
                                            int k1, const Args& a,
                                            long long f, float* hist) {
  const int l1 = a.log2n1, l2 = a.log2n2;
  const int m = 1 << (l1 + l2);
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int stride = warps * kBinsPerWarp;
  const emspec::EpilogueConsts c{*a.logmap_a, *a.logmap_b, *a.power_floor,
                                 a.c_dh, a.bin_scale, a.hz_per_bin, a.inv_n2,
                                 a.n, a.hop, a.rows, a.reach};
  const long long out0 = f * (long long)(a.k_hi - a.k_lo) - a.k_lo;
  for (int b0 = k0 + (threadIdx.x >> 5) * kBinsPerWarp - 1; b0 + 1 < k1;
       b0 += kBatch * stride) {
    float2 X[kBatch], Y[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int k = b0 + j * stride + lane;
      X[j] = spectrum_at(Zx, a.tw, min(max(k, max(k0 - 1, 0)), min(k1, m)),
                         l1, l2);
      Y[j] = spectrum_at(Zy, a.tw, min(max(k, k0), k1 - 1), l1, l2);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int k = b0 + j * stride + lane;
      const float2 xm = shfl(X[j], 1, true), xp = shfl(X[j], 1, false);
      const bool own = lane != 0 && lane != 31 && k < k1;
      if (!kHist && !own) continue;
      const float2 Am1 = k == 0 ? make_float2(xp.x, -xp.y) : xm;
      const float2 Ap1 = k == m ? make_float2(xm.x, -xm.y) : xp;
      int id;
      float contrib;
      const float band = a.band == nullptr ? 1.0f : __ldg(a.band + k - a.k_lo);
      emspec::deposit_at(k, X[j], Am1, Ap1, Y[j], band, c, &id, &contrib);
      if (kHist) {
        const bool ok = own && emspec::lands(id, a.min_id, a.num_bins);
        emspec::hist::warp_add<false, unsigned>(
            hist, ok ? (unsigned)id : ~(unsigned)lane, ok, contrib);
      } else {
        a.ids[out0 + k] = id;
        a.out[out0 + k] = contrib;
      }
    }
  }
}

// Block route: one frame a block, 2m/P threads.  P = 16 (N < 16384) asks
// for two blocks an SM, as B4's small_kernel does.
template <int P, bool kHist>
__global__ void __launch_bounds__(kThreads, P == 16 ? 2 : 1) block_kernel(
    const Args a) {
  extern __shared__ float2 sm[];
  float2* w = sm;
  float2* tiles = sm + kTable;               // raw, then t·h
  const int m = 1 << (a.log2n1 + a.log2n2);
  const int fs = (1 << a.log2n1) * ((1 << a.log2n2) + 1);
  float* hist = reinterpret_cast<float*>(tiles + 2 * fs);     // B6 only
  const long long f = blockIdx.x;
  load_table(w, a.w512);
  load_frame(tiles, tiles + fs, a, f);
  if (kHist)
    for (int i = threadIdx.x; i < a.num_bins; i += blockDim.x) hist[i] = 0.0f;
  __syncthreads();
  tile_fft<P>(tiles, w, a, 1);
  const int stride = (1 << a.log2n2) + 1;
  deposits_of<kHist>(Spectrum{tiles, stride, 0}, Spectrum{tiles + fs, stride, 0},
                     a.k_lo, a.k_hi, a, f, hist);
  if (kHist) {
    __syncthreads();
    float* row = a.out + f * (long long)a.num_bins;
    for (int i = threadIdx.x; i < a.num_bins; i += blockDim.x) row[i] = hist[i];
  }
}

// Columns c0 … c0 + width − 1 (mod n2) of every row of another CTA's tile
// → `stage`, row stride kStageStride.  Consecutive threads read
// consecutive addresses of a row, kCopyBatch reads in flight each: the
// remote reads go out as whole runs, not one scattered value a bin.
__device__ __forceinline__ void copy_columns(float2* stage,
                                             const float2* other, int c0,
                                             int width, const Args& a) {
  const int n2 = 1 << a.log2n2, T = blockDim.x;
  const int total = width << a.log2n1;
  for (int e0 = threadIdx.x; e0 < total; e0 += kCopyBatch * T) {
    float2 v[kCopyBatch];
#pragma unroll
    for (int j = 0; j < kCopyBatch; ++j) {
      const int e = e0 + j * T, row = e / width;
      if (e < total) v[j] = other[row * (n2 + 1) + ((c0 + e - row * width) & (n2 - 1))];
    }
#pragma unroll
    for (int j = 0; j < kCopyBatch; ++j) {
      const int e = e0 + j * T, row = e / width;
      if (e >= total) break;
      stage[row * kStageStride + e - row * width] = v[j];
    }
  }
}

// Cluster route: frame f is the cluster of blocks 2f (rank 0, raw) and
// 2f + 1 (rank 1, t·h), each 16384 points in 512 threads.  Rank 0
// takes bins 0 … m/4 − 1 and 3m/4 + 1 … m, rank 1 bins m/4 … 3m/4, so
// that each reads about half of the other's tile: rank 0 the columns
// [3q, 4q) ∪ [0, q) of the t·h spectrum, rank 1 the columns [q − 1, 3q] of
// the raw one (q = n2/4; the ends hold X[m/4 − 1] and X[3m/4 + 1], the
// neighbours of its edge bins).  Each copies them into its own shared
// memory, the cluster syncs once more (after which neither tile is read
// remotely), and the epilogue reads only local shared memory.  A bin
// window cuts each rank's ranges (the staged columns cover them still).
// B6 (kHist): each rank's deposits go into its own histogram, then each
// rank stores half of the frame's cells, the two histograms summed.
template <bool kHist>
__global__ void __launch_bounds__((1 << kClusterLog2M) / kClusterP, 1)
    cluster_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  extern __shared__ float2 sm[];
  float2* w = sm;
  float2* tile = sm + kTable;
  const int n2 = 1 << a.log2n2, q = n2 >> 2;
  float2* stage = tile + (n2 + 1) * (1 << a.log2n1);
  float* hist =                              // B6 only
      reinterpret_cast<float*>(stage + kStageStride * (1 << a.log2n1));
  const int m = 1 << (a.log2n1 + a.log2n2);
  const long long f = blockIdx.x >> 1;
  load_table(w, a.w512);
  load_frame(rank == 0 ? tile : nullptr, rank == 0 ? nullptr : tile, a, f);
  if (kHist)
    for (int i = threadIdx.x; i < a.num_bins; i += blockDim.x) hist[i] = 0.0f;
  __syncthreads();
  tile_fft<kClusterP>(tile, w, a, 0);
  const int c0 = rank == 0 ? 3 * q : q - 1;
  cluster.sync();                            // both spectra transformed
  copy_columns(stage, cluster.map_shared_rank(tile, rank ^ 1), c0,
               rank == 0 ? 2 * q : 2 * q + 2, a);
  cluster.sync();                            // both copies done
  const Spectrum own{tile, n2 + 1, 0}, staged{stage, kStageStride, c0};
  const int lo = a.k_lo, hi = a.k_hi;
  if (rank == 0) {
    deposits_of<kHist>(own, staged, lo, min(hi, m / 4), a, f, hist);
    deposits_of<kHist>(own, staged, max(lo, 3 * m / 4 + 1), hi, a, f, hist);
  } else {
    deposits_of<kHist>(staged, own, max(lo, m / 4), min(hi, 3 * m / 4 + 1),
                       a, f, hist);
  }
  if (kHist) {
    cluster.sync();                          // both histograms complete
    const float* other = cluster.map_shared_rank(hist, rank ^ 1);
    const int half = a.num_bins >> 1;
    const int c1 = rank == 0 ? half : a.num_bins;
    float* row = a.out + f * (long long)a.num_bins;
    for (int i = (rank == 0 ? 0 : half) + threadIdx.x; i < c1; i += blockDim.x)
      row[i] = hist[i] + other[i];
    cluster.sync();                          // neither is read any more
  }
}

int log2_of(int v) {
  int l = 0;
  while (l < 30 && (1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

// The C entry points' arguments → Args; the load width from the frames'
// address and strides (never from the batch).  Returns false on a shape
// the kernels do not take.
bool make_args(Args* a, const float* x, long long frames_per_lead,
               long long lead_stride, long long frame_stride, const float* th,
               const void* w512, const void* tw4, const void* tw,
               const float* logmap_a, const float* logmap_b,
               const float* power_floor, int* ids, float* out, int n, int n1,
               int n2, int hop, float c_dh, float bin_scale, float hz_per_bin,
               float inv_n2, int rows, int reach, int min_id, int num_bins,
               int k_lo, int k_hi, const float* band) {
  const int l1 = log2_of(n1), l2 = log2_of(n2);
  if (l1 < 4 || l2 < 4 || l1 > kLog2Table || l2 > kLog2Table
      || n1 * n2 * 2 != n || k_lo < 0 || k_lo >= k_hi || k_hi > n / 2 + 1)
    return false;
  *a = Args{x, frames_per_lead, lead_stride, frame_stride,
            (reinterpret_cast<std::uintptr_t>(x) % 16 == 0
             && lead_stride % 4 == 0 && frame_stride % 4 == 0) ? 1 : 0,
            th, static_cast<const float2*>(w512),
            static_cast<const float2*>(tw4), static_cast<const float2*>(tw),
            logmap_a, logmap_b, power_floor, ids, out, n, l1, l2, hop, c_dh,
            bin_scale, hz_per_bin, inv_n2, rows, reach, min_id, num_bins,
            k_lo, k_hi, band};
  return true;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <bool kHist>
int launch_block(const Args& a, long long frames, cudaStream_t st) {
  static const cudaError_t attr16 = allow_smem(block_kernel<16, kHist>, kMaxSmem);
  static const cudaError_t attr32 = allow_smem(block_kernel<32, kHist>, kMaxSmem);
  if (attr16 != cudaSuccess) return (int)attr16;
  if (attr32 != cudaSuccess) return (int)attr32;
  const int log2m = a.log2n1 + a.log2n2;
  if (log2m > kBlockMaxLog2M) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float2)
                   * (kTable + 2 * (1 << a.log2n1) * ((1 << a.log2n2) + 1))
                   + (kHist ? (int)sizeof(float) * a.num_bins : 0);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (frames == 0) return 0;
  if (log2m < kBlockMaxLog2M)
    block_kernel<16, kHist><<<(unsigned)frames, (2 << log2m) / 16, smem, st>>>(a);
  else
    block_kernel<32, kHist><<<(unsigned)frames, (2 << log2m) / 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

cudaLaunchConfig_t cluster_config(long long frames, int smem, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(2 * frames));
  cfg.blockDim = dim3((1 << kClusterLog2M) / kClusterP);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 2;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// B1, block route (N <= 16384): ids, contrib (frames, k_hi − k_lo), bins
// k_lo … k_hi − 1 in natural order (0, N/2 + 1: the whole spectrum).
// n1·n2 = N/2 (fourstep._FACTORS); w512, tw4: B4's tables for (n1, n2);
// tw: e^{−2πij/N}, j < N/2; band: k_hi − k_lo weights, or null.
extern "C" int emspec_deposits(
    const float* x, long long num_lead, long long frames_per_lead,
    long long lead_stride, long long frame_stride, const float* th,
    const void* w512, const void* tw4, const void* tw,
    const float* logmap_a, const float* logmap_b, const float* power_floor,
    int* ids, float* contrib, int n, int n1, int n2, int hop, float c_dh,
    float bin_scale, float hz_per_bin, float inv_n2, int rows, int reach,
    int k_lo, int k_hi, const float* band, void* stream) {
  Args a;
  if (!make_args(&a, x, frames_per_lead, lead_stride, frame_stride, th, w512,
                 tw4, tw, logmap_a, logmap_b, power_floor, ids, contrib, n,
                 n1, n2, hop, c_dh, bin_scale, hz_per_bin, inv_n2, rows,
                 reach, 0, 0, k_lo, k_hi, band))
    return (int)cudaErrorInvalidValue;
  return launch_block<false>(a, num_lead * frames_per_lead,
                             (cudaStream_t)stream);
}

// B1, cluster route (N = 32768): the arguments of emspec_deposits.
extern "C" int emspec_deposits_cluster(
    const float* x, long long num_lead, long long frames_per_lead,
    long long lead_stride, long long frame_stride, const float* th,
    const void* w512, const void* tw4, const void* tw,
    const float* logmap_a, const float* logmap_b, const float* power_floor,
    int* ids, float* contrib, int n, int n1, int n2, int hop, float c_dh,
    float bin_scale, float hz_per_bin, float inv_n2, int rows, int reach,
    int k_lo, int k_hi, const float* band, void* stream) {
  Args a;
  if (!make_args(&a, x, frames_per_lead, lead_stride, frame_stride, th, w512,
                 tw4, tw, logmap_a, logmap_b, power_floor, ids, contrib, n,
                 n1, n2, hop, c_dh, bin_scale, hz_per_bin, inv_n2, rows,
                 reach, 0, 0, k_lo, k_hi, band)
      || a.log2n1 + a.log2n2 != kClusterLog2M)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr =
      allow_smem(cluster_kernel<false>, kClusterSmem);
  if (attr != cudaSuccess) return (int)attr;
  const long long frames = num_lead * frames_per_lead;
  if (frames == 0) return 0;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      cluster_config(frames, kClusterSmem, (cudaStream_t)stream, &cluster);
  return (int)cudaLaunchKernelEx(&cfg, cluster_kernel<false>, a);
}

// How many two-CTA clusters of the cluster route the card holds at once
// (cudaOccupancyMaxActiveClusters) → *clusters.
extern "C" int emspec_deposits_cluster_occupancy(int* clusters) {
  static const cudaError_t attr =
      allow_smem(cluster_kernel<false>, kClusterSmem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      cluster_config(1024, kClusterSmem, nullptr, &cluster);
  return (int)cudaOccupancyMaxActiveClusters(clusters,
                                              cluster_kernel<false>, &cfg);
}

// B6, block route (N <= 16384): hist (frames, num_bins) float32, every
// cell written; the arguments of emspec_deposits, then min_id, num_bins.
extern "C" int emspec_deposits_hist(
    const float* x, long long num_lead, long long frames_per_lead,
    long long lead_stride, long long frame_stride, const float* th,
    const void* w512, const void* tw4, const void* tw,
    const float* logmap_a, const float* logmap_b, const float* power_floor,
    float* hist, int n, int n1, int n2, int hop, float c_dh, float bin_scale,
    float hz_per_bin, float inv_n2, int rows, int reach, int min_id,
    int num_bins, void* stream) {
  Args a;
  if (!make_args(&a, x, frames_per_lead, lead_stride, frame_stride, th, w512,
                 tw4, tw, logmap_a, logmap_b, power_floor, nullptr, hist, n,
                 n1, n2, hop, c_dh, bin_scale, hz_per_bin, inv_n2, rows,
                 reach, min_id, num_bins, 0, n / 2 + 1, nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_block<true>(a, num_lead * frames_per_lead,
                            (cudaStream_t)stream);
}

// B6, cluster route (N = 32768, num_bins <= kClusterHistCells): the
// arguments of emspec_deposits_hist; hist (frames, num_bins) float32,
// every cell stored once.
extern "C" int emspec_deposits_hist_cluster(
    const float* x, long long num_lead, long long frames_per_lead,
    long long lead_stride, long long frame_stride, const float* th,
    const void* w512, const void* tw4, const void* tw,
    const float* logmap_a, const float* logmap_b, const float* power_floor,
    float* hist, int n, int n1, int n2, int hop, float c_dh, float bin_scale,
    float hz_per_bin, float inv_n2, int rows, int reach, int min_id,
    int num_bins, void* stream) {
  Args a;
  if (!make_args(&a, x, frames_per_lead, lead_stride, frame_stride, th, w512,
                 tw4, tw, logmap_a, logmap_b, power_floor, nullptr, hist, n,
                 n1, n2, hop, c_dh, bin_scale, hz_per_bin, inv_n2, rows,
                 reach, min_id, num_bins, 0, n / 2 + 1, nullptr)
      || a.log2n1 + a.log2n2 != kClusterLog2M || num_bins <= 0
      || num_bins > kClusterHistCells)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = allow_smem(cluster_kernel<true>, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const long long frames = num_lead * frames_per_lead;
  if (frames == 0) return 0;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = cluster_config(
      frames, kClusterSmem + (int)sizeof(float) * num_bins,
      (cudaStream_t)stream, &cluster);
  return (int)cudaLaunchKernelEx(&cfg, cluster_kernel<true>, a);
}
