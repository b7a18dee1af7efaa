// Kernel B2: per-row histogram (the reassignment scatter-add).
//
// Replaces emspec/dsp/pallas/scatter.py::histogram_matmul (_hist_kernel).
// The TPU kernel builds digit one-hots and contracts them on the MXU, a
// workaround for the TPU's lack of data-dependent writes; the GPU has
// them natively.  ids, vals (rows, m) → out (rows, num_bins): the sum of
// vals by id in each row.  An id outside [0, num_bins) adds nothing and
// its value never enters a sum, so a NaN or Inf behind a dropped id
// cannot reach the histogram.  ``passes`` (the TPU kernel's bf16 split
// count) has no counterpart: every add is a float32 add, exact to one
// rounding; only the order of the adds varies from run to run.  The
// global atomics flush subnormal values (red.global.add.f32 is .ftz);
// the pipeline's contributions lie far above that range.
//
// Two atomic routes, chosen by the wrapper from (rows, m, num_bins) alone
// (emspec_torch/dsp/kernels/scatter.py route_of), and a deterministic one
// a caller asks for ("sorted", at the end of this file, in two forms: the
// tiles kernel where the caller bounds how far a deposit lands from its
// frame, sorted_kernel after a global sort where it does not; its batch
// form for crowded columns, given the same bound, is histogram_batch.cu,
// and its form for one live hop into the pending ring histogram_ring.cu):
//   row     one block of 512 threads a row: a float32 histogram of
//           num_bins cells in shared memory, then one coalesced store of
//           the row (no zeroed output needed).  Taken where the rows
//           alone give every SM two blocks and four such blocks fit an
//           SM's shared memory;
//   global  no shared histogram: the blocks walk the flat rows·m stream
//           (the row of an element is its index div m) and add straight
//           into an output the wrapper has zeroed on the same stream,
//           with global atomics (red.global.add.f32).  Any number of
//           blocks a row, so few rows still spread over many SMs, and no
//           cap on num_bins: the route above a block's shared memory
//           (num_bins > 58,112).
// Common to both:
//   * 16-byte loads: ids and vals are read four at a time where the two
//     share their alignment; each range's head up to the next 16-byte
//     boundary and its tail (three elements at most each) take one warp
//     step of their own.  m is odd on every path (4097, 16385, 131073),
//     so each row starts at another alignment;
//   * hot cells: the ids of real audio cluster (the log raster folds many
//     high bins into its top rows; a steady tone keeps δ at 0), so lanes
//     of a warp often hit one cell and their atomics serialise.  Each
//     thread first merges runs of equal ids among its four elements, then
//     __match_any_sync finds the lanes of the warp that share an id, a
//     tree of shuffles over their ranks sums each group, and only the
//     group's lowest lane issues the atomic (warp_add says when).  A
//     dropped element gets a key of its own (~lane), so it never joins a
//     group.
// The warp merge, the sinks and the range walk (consume) are
// histogram_common.cuh, shared with kernel B6 and the scatter-ablation
// probe.
// What bounds each route on this card: reading the inputs, 8 bytes a
// deposit, and writing the output, 4 bytes a cell; in practice the warp
// steps' match and atomics (row: compare-and-swap loops in shared
// memory, global: L2 atomics, one per group of equal ids a warp step
// holds) and, for global, the zero-fill of 4·rows·num_bins bytes.  Why
// no route splits a row over blocks that each flush a shared histogram
// with global atomics: on the card it lost to global at every path's
// shape (PERF.md §6).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cuda_runtime.h>

#include "histogram_common.cuh"

namespace {

using namespace emspec::hist;

constexpr int kMaxSmem = 232448;      // a block's shared memory (227 KB)

// row route: one block a row
__global__ void __launch_bounds__(kRowThreads) row_kernel(
    const int* __restrict__ ids, const float* __restrict__ vals,
    float* __restrict__ out, long long m, int num_bins, int a0, int vec) {
  extern __shared__ __align__(16) float h[];
  const long long row = blockIdx.x;
  for (int i = threadIdx.x; i < num_bins; i += kRowThreads) h[i] = 0.0f;
  __syncthreads();
  consume<false, unsigned>(ids, vals, Sink<false, unsigned>{h, m, num_bins},
                           row * m, (row + 1) * m, a0, vec != 0, threadIdx.x,
                           kRowThreads, threadIdx.x < 32u);
  __syncthreads();
  float* orow = out + row * num_bins;
  for (int i = threadIdx.x; i < num_bins; i += kRowThreads) orow[i] = h[i];
}

template <typename Key>
__global__ void __launch_bounds__(kGlobalThreads) global_kernel(
    const int* __restrict__ ids, const float* __restrict__ vals,
    float* __restrict__ out, long long total, long long m, int num_bins,
    int a0, int vec) {
  consume<true, Key>(ids, vals, Sink<true, Key>{out, m, num_bins}, 0, total,
                     a0, vec != 0,
                     (long long)blockIdx.x * kGlobalThreads + threadIdx.x,
                     (long long)gridDim.x * kGlobalThreads,
                     blockIdx.x == 0 && threadIdx.x < 32u);
}

// The sorted route without a window bound, deterministic: ``keys``
// (row·num_bins + id) of every deposit sorted stably by the wrapper
// (torch.sort), −1 for a dropped id, and ``vals`` in the same order.  The
// first deposit of each run of equal keys sums its run in order onto the
// cell (0, or the value of an output added into) and stores the total.
// No atomics, so a cell's sum is the same on every run, and, since the
// stable sort keeps each cell's deposits in deposit order, equal bit for
// bit to the plain version's (index_add_, which adds them in that order).
// A run is one thread's sequential loop.  The global sort costs ~25× the
// bytes' bound; callers whose deposits land near their frame (the raster,
// every batch of the pipeline) take tiles_kernel below or
// histogram_batch.cu: this form is on no default path.
template <typename Key>
__global__ void __launch_bounds__(kGlobalThreads) sorted_kernel(
    const Key* __restrict__ keys, const float* __restrict__ vals,
    float* __restrict__ out, long long n) {
  for (long long i = (long long)blockIdx.x * kGlobalThreads + threadIdx.x;
       i < n; i += (long long)gridDim.x * kGlobalThreads) {
    const Key k = keys[i];
    if (k < 0 || (i > 0 && keys[i - 1] == k)) continue;
    float s = out[k];
    for (long long j = i; j < n && keys[j] == k; ++j)
      s = __fadd_rn(s, vals[j]);
    out[k] = s;
  }
}

// The sorted route with a window bound (tiles): deposits come in frames
// of K (a row holds T frames, T·K deposits, deposit s·K + k), each id is
// a cell c·C + f of T columns of C cells (C = K for the raster, whose
// frame's bins are its column's cells; the display pipeline's grid has
// C = 512 rows a column and K = 382 deposits a frame at the display
// default), and a deposit of frame s lands in a column c with |c − s| <=
// R (the caller guarantees it: the raster drops every deposit with |Δt| >
// N/2, so R = ceil(N / 2·hop); the display pipeline's ids carry δ within
// its reach).  A block owns a tile of TT columns × FF cells of one row in
// shared memory, read once from ``out`` (add) or zeroed, and written once
// at the end: no zero-fill, no global atomics, no sort.  Its 16 warps each
// own a band of consecutive cells of every column of the tile (warp
// ((f − f0)·M) >> 16, M = 2^20 div FF).  The block walks the deposits of
// the frames s that can reach the tile (t0 − R … t0 + TT − 1 + R) in
// (frame, bin) order, one piece a step: FP whole frames a piece where
// they fit 4,608 deposits (FP = 4608 div K: one frame of the raster at
// 8192, twelve of the display grid's 382), else each frame in pieces of
// PC chunks of 32 bins (32768's 16,385 bins in four).  A piece starts on
// a frame: a piece holding the end of one frame and the start of the
// next gives the warps that own both ends twice the chunks of the others
// (at the raster's ids such pieces measured 0.041 ms against 0.033 in two
// runs of three, PERF.md §6);
//   * stage (piece p + 1's loads issued before the walk of p, stored after
//     it): each deposit's key — its owning warp and tile cell, or −1
//     where it does not land in the tile (the column by a float64
//     reciprocal, corrected: no integer division) — and value, and for
//     each chunk the mask of warps that own a deposit of it
//     (__reduce_or_sync);
//   * walk (piece p): each warp takes the chunks whose mask holds its
//     bit, in bin order.  The lanes whose deposit it owns OR their bit
//     into their cell's word of a claim array in shared memory, which
//     then holds the lanes of that cell (what __match_any_sync finds, at
//     a fraction of its cost on this card), and the group's lowest lane
//     adds the group's values onto the cell one after another in lane
//     order (shuffles, __fadd_rn), stores it and clears the claim.
// A cell is only ever written by its warp, which meets the cell's deposits
// in (frame, bin) order, so every cell adds its deposits in deposit order:
// the plain version's sum (index_add_), bit for bit, the same on every
// run.  Bounded by the bytes: each deposit read (TT + 2R)/TT times (from
// L2 after the first), each cell read (add) and written once.
constexpr int kTileThreads = 512;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kPieceSlots = 9;                 // chunks a warp stages a piece
constexpr int kPieceChunks = kPieceSlots * kTileWarps;

struct TileGeom {
  int T, K, C, R, t0, f0, tt, ff, pc;
  int fp, ppf;                   // frames a piece (0: a frame in ppf pieces)
  int s0, s1;                    // the frames walked, s0 … s1
  unsigned owner_mul;
  double inv_c;
  const int* ids;
  const float* vals;
};

// The key of deposit id for the tile: its warp << 16 | tile cell, or −1.
__device__ __forceinline__ int tile_key(const TileGeom& g, int id) {
  if (id < 0 || id >= g.T * g.C) return -1;
  int c = (int)((double)id * g.inv_c);
  if (c * g.C > id) --c;
  else if ((c + 1) * g.C <= id) ++c;
  const int f = id - c * g.C;
  if (c < g.t0 || c >= g.t0 + g.tt || f < g.f0 || f >= g.f0 + g.ff)
    return -1;
  const unsigned warp = ((unsigned)(f - g.f0) * g.owner_mul) >> 16;
  return (int)(warp << 16) | ((c - g.t0) * g.ff + f - g.f0);
}

// Piece p of the walk: frames s0 + p·fp … (fp > 0), or bins from
// (p mod ppf)·pc·32 of frame s0 + p div ppf; its deposits [lo, hi) of the
// row.  A thread's slot i is chunk warp + 16·i.
__device__ __forceinline__ void piece_range(const TileGeom& g, int p,
                                            long long* lo, long long* hi) {
  if (g.fp > 0) {
    const int s = g.s0 + p * g.fp;
    *lo = (long long)s * g.K;
    *hi = (long long)min(s + g.fp, g.s1 + 1) * g.K;
  } else {
    const long long f0 = (long long)(g.s0 + p / g.ppf) * g.K;
    *lo = f0 + (p % g.ppf) * g.pc * 32;
    *hi = min(*lo + g.pc * 32, f0 + g.K);
  }
}

struct Piece {
  int id[kPieceSlots];
  float v[kPieceSlots];
};

__device__ __forceinline__ void piece_load(const TileGeom& g, int p,
                                           Piece* pc) {
  long long at, hi;
  piece_range(g, p, &at, &hi);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kPieceSlots; ++i) {
    const int ch = warp + i * kTileWarps;
    const long long k = at + (ch << 5) + lane;
    const bool in = ch < g.pc && k < hi;
    pc->id[i] = in ? __ldg(g.ids + k) : -1;
    pc->v[i] = in ? __ldg(g.vals + k) : 0.0f;
  }
}

__device__ __forceinline__ void piece_store(const TileGeom& g,
                                            const Piece& pc, int* keys,
                                            float* vals, unsigned* masks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kPieceSlots; ++i) {
    const int ch = warp + i * kTileWarps;
    if (ch >= g.pc) break;                     // warp-uniform
    const int key = tile_key(g, pc.id[i]);
    keys[(ch << 5) + lane] = key;
    vals[(ch << 5) + lane] = pc.v[i];
    const unsigned bits =
        __reduce_or_sync(kFull, key < 0 ? 0u : 1u << (key >> 16));
    if (lane == 0) masks[ch] = bits;
  }
}

// Each warp's chunks of the staged ``pc`` chunks, in bin order, onto the
// tile (the tiles form's piece).
__device__ __forceinline__ void walk_chunks(float* tile, unsigned* claim,
                                            const int* keys,
                                            const float* vals,
                                            const unsigned* masks, int pc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c0 = 0; c0 < pc; c0 += 32) {
    const bool mine = c0 + lane < pc && ((masks[c0 + lane] >> warp) & 1u);
    unsigned todo = __ballot_sync(kFull, mine);
    while (todo != 0u) {
      const int at = ((c0 + __ffs(todo) - 1) << 5) + lane;
      todo &= todo - 1u;
      const int key = keys[at];
      const float v = vals[at];
      const bool own = key >= 0 && (key >> 16) == warp;
      const int cell = key & 0xffff;
      if (own) atomicOr(claim + cell, 1u << lane);
      __syncwarp();
      const unsigned peers = own ? claim[cell] : 0u;
      const bool leader = own && (peers & ((1u << lane) - 1u)) == 0u;
      float acc = leader ? __fadd_rn(tile[cell], v) : 0.0f;
      unsigned more = leader ? peers & (peers - 1u) : 0u;
      while (__any_sync(kFull, more != 0u)) {
        const float u = __shfl_sync(kFull, v, more ? __ffs(more) - 1 : lane);
        if (more != 0u) {
          acc = __fadd_rn(acc, u);
          more &= more - 1u;
        }
      }
      if (leader) {
        tile[cell] = acc;
        claim[cell] = 0u;
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kTileThreads) tiles_kernel(
    const int* __restrict__ ids, const float* __restrict__ vals,
    float* __restrict__ out, int T, int K, int C, int R, int TT, int FF,
    int pc, int fp, int col_tiles, int row_tiles, int add) {
  extern __shared__ float sm[];
  const int rest = (int)(blockIdx.x % ((long long)col_tiles * row_tiles));
  const long long row = blockIdx.x / ((long long)col_tiles * row_tiles);
  const long long base = row * (long long)T * K;
  TileGeom g;
  g.T = T, g.K = K, g.C = C, g.R = R;
  g.t0 = (rest / row_tiles) * TT, g.f0 = (rest % row_tiles) * FF;
  g.tt = min(TT, T - g.t0), g.ff = min(FF, C - g.f0);
  g.owner_mul = (1u << 20) / (unsigned)g.ff;
  g.inv_c = 1.0 / C;
  g.pc = pc, g.fp = fp, g.ppf = fp > 0 ? 1 : ((K + 31) / 32 + pc - 1) / pc;
  g.ids = ids + base, g.vals = vals + base;
  float* tile = sm;                                         // TT·FF
  unsigned* claim = reinterpret_cast<unsigned*>(sm + TT * FF);    // TT·FF
  int* keys = reinterpret_cast<int*>(claim + TT * FF);      // pc·32
  float* pv = reinterpret_cast<float*>(keys + pc * 32);     // pc·32
  unsigned* masks = reinterpret_cast<unsigned*>(pv + pc * 32);    // pc
  float* rout = out + row * (long long)T * C;
  for (int i = threadIdx.x; i < g.tt * g.ff; i += kTileThreads) {
    const int c = i / g.ff;
    tile[i] = add ? rout[(long long)(g.t0 + c) * C + g.f0 + i - c * g.ff]
                  : 0.0f;
    claim[i] = 0u;
  }
  const int s0 = max(g.t0 - R, 0), s1 = min(g.t0 + g.tt - 1 + R, T - 1);
  g.s0 = s0, g.s1 = s1;
  const int steps = fp > 0 ? (s1 - s0 + fp) / fp : (s1 - s0 + 1) * g.ppf;
  Piece next;
  piece_load(g, 0, &next);
  for (int p = 0; p < steps; ++p) {
    piece_store(g, next, keys, pv, masks);
    __syncthreads();
    if (p + 1 < steps) piece_load(g, p + 1, &next);
    walk_chunks(tile, claim, keys, pv, masks, g.pc);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < g.tt * g.ff; i += kTileThreads) {
    const int c = i / g.ff;
    rout[(long long)(g.t0 + c) * C + g.f0 + i - c * g.ff] = tile[i];
  }
}

}  // namespace

// keys (int32 if key_bytes == 4, else int64) and vals: n sorted deposits
// (see sorted_kernel); out holds every cell a key names, zeroed or added
// into, on ``stream``.
extern "C" int emspec_histogram_sorted(const void* keys, int key_bytes,
                                       const float* vals, float* out,
                                       long long n, int blocks,
                                       void* stream) {
  if (n < 0 || blocks <= 0 || (key_bytes != 4 && key_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (key_bytes == 4)
    sorted_kernel<int><<<(unsigned)blocks, kGlobalThreads, 0, st>>>(
        static_cast<const int*>(keys), vals, out, n);
  else
    sorted_kernel<long long><<<(unsigned)blocks, kGlobalThreads, 0, st>>>(
        static_cast<const long long*>(keys), vals, out, n);
  return (int)cudaGetLastError();
}

// The tiles form of the sorted route: ids, vals (rows, T·K) — T frames of
// K deposits — out (rows, T·C) float32 — T columns of C cells — each cell
// written once (add = 1: out's value first); reach R; TT columns and FF
// cells a tile, pieces of fp frames (fp > 0) or of pc chunks of a frame,
// pc chunks staged a piece (the wrapper's tile_plan).  A lane's deposits
// T·K may pass 2^31 (every offset into them is 64-bit: a 37-minute
// render at 32768 points, hop 800); its cells T·C may not (the ids are
// int32).
extern "C" int emspec_histogram_tiles(const int* ids, const float* vals,
                                      float* out, long long rows, int T,
                                      int K, int C, int R, int TT, int FF,
                                      int pc, int fp, int add, void* stream) {
  if (T <= 0 || K <= 0 || C <= 0 || R < 0 || TT <= 0 || FF <= 0 || FF > C
      || TT * FF > 0xffff || pc <= 0 || pc > kPieceChunks || fp < 0
      || (fp > 0 && (long long)fp * K > 32LL * pc)
      || (fp == 0 && K <= 32 * pc) || (long long)T * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long smem = 8LL * TT * FF + pc * (32 * 8 + 4);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  static const cudaError_t attr = cudaFuncSetAttribute(
      tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int col_tiles = (T + TT - 1) / TT, row_tiles = (C + FF - 1) / FF;
  tiles_kernel<<<(unsigned)(rows * col_tiles * row_tiles), kTileThreads,
                 (size_t)smem, (cudaStream_t)stream>>>(
      ids, vals, out, T, K, C, R, TT, FF, pc, fp, col_tiles, row_tiles,
      add);
  return (int)cudaGetLastError();
}

// ids, vals: (rows, m) int32 / float32, contiguous; a0 = (ids address / 4)
// mod 4; vec = 1 when vals has the same 16-byte alignment.  route 0
// (row): out (rows, num_bins) is written whole; route 1 (global,
// ``blocks`` blocks) adds into an out the caller has zeroed on
// ``stream``.  No host synchronisation; returns the launch's cudaError_t.
extern "C" int emspec_histogram(const int* ids, const float* vals,
                                float* out, long long rows, long long m,
                                int num_bins, int route, int blocks, int a0,
                                int vec, void* stream) {
  if (num_bins <= 0 || blocks <= 0 || route < 0 || route > 1
      || (route == 0 && 4LL * num_bins > kMaxSmem))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 0) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
    row_kernel<<<(unsigned)rows, kRowThreads, 4 * num_bins, st>>>(
        ids, vals, out, m, num_bins, a0, vec);
    return (int)cudaGetLastError();
  }
  if (m == 0) return 0;
  if (rows * (long long)num_bins < (1LL << 31) - 32)
    global_kernel<unsigned><<<(unsigned)blocks, kGlobalThreads, 0, st>>>(
        ids, vals, out, rows * m, m, num_bins, a0, vec);
  else
    global_kernel<unsigned long long><<<(unsigned)blocks, kGlobalThreads, 0,
                                        st>>>(ids, vals, out, rows * m, m,
                                              num_bins, a0, vec);
  return (int)cudaGetLastError();
}
