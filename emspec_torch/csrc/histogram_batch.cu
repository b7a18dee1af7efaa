// Kernel B2, the sorted route's batch form: a whole batch's absolute
// (t, C) grid, each cell adding its deposits in (frame, bin) order.
//
// Replaces, for the enhanced batch sum, emspec/dsp/pallas/scatter.py::
// histogram_matmul (the absolute-grid scatter of emspec/pipeline.py
// _enhanced_power).  Inputs: ids, vals (lanes, T·K) — T frames of K
// deposits a lane, ids c·C + f into the lane's T columns of C cells, −1
// for none — and out (lanes, T·C) float32, written whole (or added into:
// its value first).  A deposit of frame s lands in a column c with
// |c − s| <= R (the caller's bound: the pipeline's reach); one outside
// [0, T·C) adds nothing, even when its value is NaN or Inf.  Each cell
// adds its deposits one after another in deposit order with __fadd_rn:
// the plain version's sum (index_add_), bit for bit, the same on every
// run.  No atomics on values, no sort, no scratch in device memory, one
// launch at a grid fixed by the shape.
//
// Design.  A CTA of 512 threads owns the cells of one lane's tile of TT
// columns in one of B row bands (the wrapper's batch_plan: B > 1 where
// the columns alone leave SMs idle, the 262144 cell's 8 columns) — rows in
// blocks of 2^b (b = row_shift), block f >> b in band (f >> b) mod B —
// and in shared memory its cells, read (add) and stored once.  Its 16
// warps own the band's row blocks in turn, warp (f >> b) div B mod 16, so
// the crowded top octave of log rows (the top 64 of 512 rows hold 59% of
// 8192's 4097 bins) spreads over every warp where the tiles form gave it
// one.  The CTA reads every deposit of the frames that reach its tile
// (t0 − R … t0 + TT − 1 + R) once, in rounds of kRound deposits (each warp
// kQ chunks of 32, the next round's loads in flight meanwhile), and keeps
// its own, at the next free slots of an entry array (each entry its cell
// and owner warp, its value) — the warps' counts scanned at one barrier a
// round — with each chunk of 32 entries the mask of the warps it holds.
// Two layouts, by shape (batch_plan's ``packed``): where a CTA keeps most
// of what it reads (8192, stress), each chunk of 32 raw deposits that
// holds any of its own gives one chunk of entries, its kept deposits in
// deposit order save that each cell's are made one run (group_offset:
// another order of different cells' adds changes nothing) and the rest
// empty, so no cell has two runs in a chunk; where it keeps few (north,
// hop 64, 262144's bands: most raw chunks hold one or two of its own), the
// kept deposits packed in deposit order, a chunk holding several raw
// chunks' — there two runs of one cell in a chunk take turns.  When the
// array is full (a piece, at most ``cap`` entries) the warps walk it: each
// warp the chunks whose mask holds its bit, in order; in each, the runs of
// its own cells, each run's first lane adding the run's values onto its
// cell in lane order (shuffles; lane 0 alone from the chunk's values as
// 16-byte words where one run is the whole chunk, a crowded top row).
// (Packing every layout gave a third of the walk steps at 8192 two runs
// of a cell to order; one raw chunk a chunk everywhere cost hop 64 and
// 262144 their sparse chunks' steps; __match_any_sync in the walk cost it
// half its time on the card.)  So the walk meets only the tile's own
// deposits, however far R reaches (wide's 64) and however many bands
// share a frame.
// A cell is only ever written by its warp, which meets the cell's deposits
// in (frame, bin) order, so the sums are the plain version's.  What bounds
// it on this card: the bytes (8 a deposit, 4 a cell) and the longest
// cell's chain of dependent adds (4 cycles each: the top rows gather
// hundreds of deposits a column); in practice the reads of deposits that
// other tiles keep ((TT + 2R)/TT·B of each), from L2, and the warps' walk
// steps (a reassigned frame puts 8 cells in a chunk of 32 at 8192).
// Why not a cluster that sends each deposit to its owner over distributed
// shared memory, as the ring form does: on the card its owners' arrays,
// indexed by deposit, held 1/S of their slots and the cluster met at a
// barrier a piece; it lost to the global sort at the 262144 and hop-64
// cells (PERF.md §6).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 8;                  // chunks of 32 a warp reads a round
constexpr int kRound = kWarps * kQ * 32;     // deposits a round
constexpr int kMaxBands = 16;
constexpr int kMaxShift = 4;           // rows a block: 16 at most
constexpr int kMaxCells = 0xffff;      // a CTA's cells (16-bit entries)
constexpr int kMaxSmem = 232448;       // a block's shared memory (227 KB)
constexpr unsigned kNone = 0xffffffffu;     // an empty entry
constexpr unsigned kFull = 0xffffffffu;

struct BatchArgs {
  const int* ids;
  const float* vals;
  float* out;
  int T, K, C, R, TT, col_tiles, log_b, shift, rb, cap, add;
};

// Where local cell i lives in shared memory: one word of padding every 32.
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// The grid row f of local row j of ``band``, or −1 past C: local rows are
// the band's row blocks in order.
__device__ __forceinline__ int cell_row(const BatchArgs& a, int band, int j) {
  const int f = ((j >> a.shift) << (a.shift + a.log_b)) | band << a.shift
                | (j & ((1 << a.shift) - 1));
  return f < a.C ? f : -1;
}

// One round's loads: this thread's lane of chunks warp·kQ + q.
struct Stage {
  int id[kQ];
  float v[kQ];
};

__device__ __forceinline__ void stage_load(const int* rid, const float* rval,
                                           long long at, long long hi,
                                           Stage* st) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const long long k = at + ((warp * kQ + q) << 5) + lane;
    st->id[q] = k < hi ? __ldg(rid + k) : -1;
    st->v[q] = k < hi ? __ldg(rval + k) : 0.0f;
  }
}

// A kept deposit's place among its chunk's kept deposits (``kept``, a
// chunk of 32 raw deposits), the chunk's cells in the order of their first
// deposit and each cell's deposits in lane order: each cell's deposits of
// the chunk one run of the entry array, its order kept (the deposits of
// other cells move, never two of one cell).  Where the chunk holds one
// cell (a crowded top row) its raw order; else __match_any_sync finds the
// cells and a scan over the lanes their places.
__device__ __forceinline__ int group_offset(unsigned word, unsigned kept,
                                           int lane) {
  if (kept == 0u) return 0;                           // warp-uniform
  const unsigned below = (1u << lane) - 1u;
  const unsigned first = __shfl_sync(kFull, word, __ffs(kept) - 1);
  if (__all_sync(kFull, word == kNone || word == first))
    return __popc(kept & below);
  const unsigned peers = __match_any_sync(kFull, word);
  const bool leader = word != kNone && (peers & below) == 0u;
  const int size = leader ? __popc(peers) : 0;
  int sum = size;                                      // inclusive scan
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, sum, d);
    if (lane >= d) sum += y;
  }
  const int start = __shfl_sync(kFull, sum - size, __ffs(peers) - 1);
  return start + __popc(peers & below);
}

// One step of a warp's walk: the chunk's 32 entries at ``e32``.  The runs
// of equal entries (cell and owner) that this warp owns: each run's first
// lane adds the run's values onto its cell in lane order.  kPacked: the
// chunk may hold two runs of one cell (from two raw chunks), which take
// turns in lane order — a run's turn the earlier runs whose cell shares 8
// hash bits with its own, one ballot a bit (runs of other cells that share
// them wait too, harmlessly); else each cell is one run.
template <bool kPacked>
__device__ __forceinline__ void walk_step(const uint2* e32, float* tile,
                                          int lane, int warp) {
  const uint2 e = e32[lane];
  const float x = __uint_as_float(e.y);
  const unsigned prev = __shfl_up_sync(kFull, e.x, 1);
  const unsigned starts = __ballot_sync(kFull, lane == 0 || prev != e.x);
  const bool leader = e.x != kNone && (int)(e.x >> 16) == warp
                      && ((starts >> lane) & 1u);
  const int at = padded(e.x & 0xffffu);
  if (__shfl_sync(kFull, leader ? 1 : 0, 0) && starts == 1u) {
    // one run, the whole chunk (warp-uniform): lane 0 alone
    if (lane == 0) {
      const uint4* q = reinterpret_cast<const uint4*>(e32);
      float acc = tile[at];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const uint4 w = q[i];
        acc = __fadd_rn(acc, __uint_as_float(w.y));
        acc = __fadd_rn(acc, __uint_as_float(w.w));
      }
      tile[at] = acc;
    }
    __syncwarp();
    return;
  }
  const unsigned above = starts & ~((2u << lane) - 1u);
  const int len = leader ? (above ? __ffs(above) - 1 : 32) - lane : 0;
  int turn = 0, turns = 0;
  if (kPacked) {
    const unsigned h = (e.x ^ (e.x >> 8)) & 0xffu;
    unsigned same = __ballot_sync(kFull, leader);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const unsigned bb = __ballot_sync(kFull, leader && ((h >> b) & 1u));
      same &= (h >> b) & 1u ? bb : ~bb;
    }
    turn = leader ? __popc(same & ((1u << lane) - 1u)) : 0;
    turns = (int)__reduce_max_sync(kFull, (unsigned)turn);
  }
  for (int t = 0; t <= turns; ++t) {
    const bool go = leader && turn == t;
    float acc = go ? __fadd_rn(tile[at], x) : 0.0f;
    const int n = (int)__reduce_max_sync(kFull, go ? (unsigned)len : 0u);
#pragma unroll 4
    for (int i = 1; i < n; ++i) {
      const float u = __shfl_sync(kFull, x, (lane + i) & 31);
      if (go && i < len) acc = __fadd_rn(acc, u);
    }
    if (go) tile[at] = acc;
    __syncwarp();
  }
}

// A warp's walk of one piece's ``chunks`` chunks: its chunks in order, 128
// chunks a window (a lane's four masks at once).
template <bool kPacked>
__device__ __forceinline__ void walk(const uint2* kv, const unsigned* masks,
                                     float* tile, int chunks, int lane,
                                     int warp) {
  for (int c0 = 0; c0 < chunks; c0 += 128) {
    unsigned nib = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + 4 * lane + q;
      nib |= (c < chunks && ((masks[c] >> warp) & 1u)) ? 1u << q : 0u;
    }
    unsigned lanes_todo = __ballot_sync(kFull, nib != 0u);
    while (lanes_todo != 0u) {
      const int from = __ffs(lanes_todo) - 1;
      lanes_todo &= lanes_todo - 1u;
      unsigned todo = __shfl_sync(kFull, nib, from);
      while (todo != 0u) {
        const int base = (c0 + 4 * from + __ffs(todo) - 1) << 5;
        todo &= todo - 1u;
        walk_step<kPacked>(kv + base, tile, lane, warp);
      }
    }
  }
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads) batch_kernel(BatchArgs a) {
  const int B = 1 << a.log_b;
  const int band = blockIdx.x & (B - 1);
  const int group = blockIdx.x >> a.log_b;            // lane·tiles + tile
  const int lane_row = group / a.col_tiles;
  const int t0 = (group - lane_row * a.col_tiles) * a.TT;
  const int tt = min(a.TT, a.T - t0);
  const int s0 = max(t0 - a.R, 0), s1 = min(t0 + tt - 1 + a.R, a.T - 1);
  const long long lo = (long long)s0 * a.K, hi = (long long)(s1 + 1) * a.K;
  const int cells = tt * a.rb, total = a.T * a.C;
  const double inv_c = 1.0 / a.C;
  const int smask = (1 << a.shift) - 1;
  extern __shared__ __align__(16) unsigned char sm[];
  uint2* kv = reinterpret_cast<uint2*>(sm);                       // cap
  unsigned* counts = reinterpret_cast<unsigned*>(kv + a.cap);     // 2·16
  unsigned* masks = counts + 2 * kWarps;                          // cap/32
  float* tile = reinterpret_cast<float*>(masks + a.cap / 32);     // cells
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row_k = (long long)lane_row * a.T * a.K;
  const int* rid = a.ids + row_k;
  const float* rval = a.vals + row_k;
  float* rout = a.out + (long long)lane_row * a.T * a.C;

  Stage st;
  stage_load(rid, rval, lo, hi, &st);
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    const int cc = i / a.rb;
    const int f = cell_row(a, band, i - cc * a.rb);
    tile[padded(i)] = a.add && f >= 0
                          ? rout[(long long)(t0 + cc) * a.C + f] : 0.0f;
  }
  if (kPacked)
    for (int i = threadIdx.x; i < a.cap / 32; i += kThreads) masks[i] = 0u;
  __syncthreads();

  long long raw = lo;
  int round = 0;
  while (raw < hi) {                                  // a piece
    int fill = 0;              // entries (kPacked), else chunks of them
    while (raw < hi && (kPacked ? fill + kRound <= a.cap
                                : fill + kRound / 32 <= a.cap / 32)) {
      // each deposit's cell and owner warp, kept where it is this CTA's
      unsigned word[kQ], kept[kQ];
      int off[kQ];
      float v[kQ];
      int n = 0;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int id = st.id[q];
        v[q] = st.v[q];
        word[q] = kNone;
        if (id >= 0 && id < total) {
          int c = (int)((double)id * inv_c);          // id div C, corrected
          if (c * a.C > id) --c;
          else if ((c + 1) * a.C <= id) ++c;
          const int f = id - c * a.C;
          const int blk = f >> a.shift;
          if (c >= t0 && c < t0 + tt && (blk & (B - 1)) == band) {
            const int j = blk >> a.log_b;
            word[q] = (unsigned)((c - t0) * a.rb + (j << a.shift)
                                 + (f & smask))
                      | (unsigned)(j & (kWarps - 1)) << 16;
          }
        }
        kept[q] = __ballot_sync(kFull, word[q] != kNone);
        if (kPacked) {
          n += __popc(kept[q]);
          off[q] = __popc(kept[q] & ((1u << lane) - 1u));
        } else {
          n += kept[q] != 0u;
          off[q] = group_offset(word[q], kept[q], lane);
        }
      }
      unsigned* cnt = counts + (round & 1) * kWarps;
      if (lane == 0) cnt[warp] = (unsigned)n;
      raw += kRound;
      if (raw < hi) stage_load(rid, rval, raw, hi, &st);   // the next round
      __syncthreads();
      int base = fill, sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; w += 4) {
        const uint4 c = *reinterpret_cast<const uint4*>(cnt + w);
        base += (w < warp ? (int)c.x : 0) + (w + 1 < warp ? (int)c.y : 0)
                + (w + 2 < warp ? (int)c.z : 0)
                + (w + 3 < warp ? (int)c.w : 0);
        sum += (int)(c.x + c.y + c.z + c.w);
      }
      // kPacked: the kept deposits in deposit order, each chunk of entries
      // the mask of its warps; else each raw chunk with deposits of this
      // CTA one chunk of entries, the rest of it empty, with its mask
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int k = __popc(kept[q]);
        if (k == 0) continue;                         // warp-uniform
        const unsigned bit = word[q] != kNone ? 1u << (word[q] >> 16) : 0u;
        if (kPacked) {
          const int pos = base + off[q];
          if (word[q] != kNone)
            kv[pos] = make_uint2(word[q], __float_as_uint(v[q]));
          const int x0 = base >> 5, x1 = (base + k - 1) >> 5;
          const unsigned b0 =
              __reduce_or_sync(kFull, (pos >> 5) == x0 ? bit : 0u);
          const unsigned b1 =
              __reduce_or_sync(kFull, (pos >> 5) == x1 ? bit : 0u);
          if (lane == 0) {
            atomicOr(masks + x0, b0);
            if (x1 != x0) atomicOr(masks + x1, b1);
          }
          base += k;
        } else {
          uint2* e32 = kv + (base << 5);
          if (word[q] != kNone)
            e32[off[q]] = make_uint2(word[q], __float_as_uint(v[q]));
          if (lane >= k) e32[lane] = make_uint2(kNone, 0u);
          const unsigned bits = __reduce_or_sync(kFull, bit);
          if (lane == 0) masks[base] = bits;
          ++base;
        }
      }
      fill += sum;
      ++round;
    }
    if (kPacked && (int)threadIdx.x < ((32 - (fill & 31)) & 31))
      kv[fill + threadIdx.x] = make_uint2(kNone, 0u);  // the tail empty
    __syncthreads();                                  // the piece is in
    const int chunks = kPacked ? (fill + 31) >> 5 : fill;
    walk<kPacked>(kv, masks, tile, chunks, lane, warp);
    __syncthreads();                                  // every warp walked it
    if (kPacked) {
      for (int i = threadIdx.x; i < chunks; i += kThreads) masks[i] = 0u;
      __syncthreads();
    }
  }

  // each cell stored once
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    const int cc = i / a.rb;
    const int f = cell_row(a, band, i - cc * a.rb);
    if (f >= 0) rout[(long long)(t0 + cc) * a.C + f] = tile[padded(i)];
  }
}

}  // namespace

// The batch form: ids, vals (lanes, T·K) int32 / float32, ids c·C + f;
// out (lanes, T·C) float32, written whole (add = 1: added into); reach R;
// TT columns a tile, 2^log_b row bands, row blocks of 2^shift rows, an
// entry array of ``cap`` entries, packed or a raw chunk a chunk of entries
// (the wrapper's batch_plan), on ``stream``.  As the tiles form: T·K may
// pass 2^31 (lo, hi and every deposit offset are 64-bit), T·C may not.
extern "C" int emspec_histogram_batch(const int* ids, const float* vals,
                                      float* out, long long lanes, int T,
                                      int K, int C, int R, int TT, int log_b,
                                      int shift, int cap, int packed,
                                      int add, void* stream) {
  if (lanes < 0 || T <= 0 || K <= 0 || C <= 0 || R < 0 || TT <= 0
      || log_b < 0 || (1 << log_b) > kMaxBands || shift < 0
      || shift > kMaxShift || cap < kRound || cap % 32 != 0
      || (long long)T * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  BatchArgs a;
  a.ids = ids, a.vals = vals, a.out = out;
  a.T = T, a.K = K, a.C = C, a.R = R, a.TT = TT < T ? TT : T;
  a.col_tiles = (T + a.TT - 1) / a.TT;
  a.log_b = log_b, a.shift = shift, a.cap = cap, a.add = add != 0;
  a.rb = (((C - 1) >> (shift + log_b)) + 1) << shift;       // local rows
  const long long cells = (long long)a.TT * a.rb;
  const long long smem = 8LL * cap + 4LL * (cap / 32) + 4LL * 2 * kWarps
                         + 4 * ((cells + (cells >> 5) + 16) & ~15LL);
  if (cells > kMaxCells || smem > kMaxSmem
      || (lanes * a.col_tiles << log_b) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(batch_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem),
      cudaFuncSetAttribute(batch_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem)};
  if (attr[packed != 0] != cudaSuccess) return (int)attr[packed != 0];
  const unsigned grid = (unsigned)(lanes * a.col_tiles << log_b);
  if (packed)
    batch_kernel<true><<<grid, kThreads, (size_t)smem,
                         (cudaStream_t)stream>>>(a);
  else
    batch_kernel<false><<<grid, kThreads, (size_t)smem,
                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
