// Kernel B2, the sorted route's ring form: one hop of the live step added
// into its pending ring in place, each cell in bin order.
//
// Replaces, for the live step, emspec/dsp/pallas/scatter.py::
// histogram_matmul and the roll of its relative histogram into the ring
// (emspec/pipeline.py _stream_step).  Inputs are B1's relative ids
// (δ + R)·C + row and values, (lanes, K), the pending ring (P, lanes, C)
// float32 with P = 2R + 1 slots of a lane's C rows, and the step's frame
// counter t (a 0-d int32 in device memory).  A deposit lands in column
// t + δ, slot (t + δ) mod P, row ``row``; it adds nothing where its id is
// outside [0, P·C) (B1's invalid deposit is −1) or its column is below 0,
// so a NaN or Inf behind such an id never lands.  Each cell adds its
// deposits one after another in deposit (bin) order with __fadd_rn,
// starting from the value it holds: the plain version's sum (index_add_
// of the ring ids into the ring), bit for bit, the same on every run.  A
// stream whose slot is zeroed when its column is emitted, and whose hops
// come in frame order, so sums every column in the batch's (frame, bin)
// order.
//
// Design: a thread-block cluster of S CTAs a lane (S = 1 … 16, a power of
// two, the wrapper's ring_plan), 512 threads each.  Rank o owns the rows
// in 8-row groups g with g mod S = o, and in each slot their cells;
// local row j = (g div S)·8 + row mod 8 (rb of them a slot, a multiple of
// 16), local cell slot·rb + j, owned by warp j mod 16 — so a crowded
// octave of rows spreads over every rank and every warp, and a rank's
// cells of a slot are runs of 8 consecutive rows (32-byte sectors).
//   1. Each rank copies its own rows' cells of every slot from the ring
//      into shared memory (cp.async: they do not depend on the ids), fills
//      its entry array (one 8-byte entry a deposit of the hop, kNone for
//      none) with kNone and its chunk masks and touched flags with 0, and
//      loads t and its own share of the hop, cs = ceil(chunks / S) chunks
//      of 32 deposits: each deposit is read once a hop, by one rank.  It
//      then arrives at the cluster barrier.
//   2. Each deposit's ring cell is computed in the kernel (the ring ids
//      are not an input) with its owner and the chunk's lanes of the same
//      cell (__match_any_sync: the cell's group, off the walk's path);
//      the rank waits at the barrier (every rank's arrays filled: the
//      loads landed meanwhile), then stores each entry — the local cell,
//      the group's lowest lane, its next lane and its length, and the
//      value — into the owning rank's array at the deposit's own index
//      over distributed shared memory, one 8-byte store, and for each
//      chunk the mask of each owner's warps that own one of its deposits
//      (one __reduce_or_sync an owner the chunk holds).
//   3. Cluster sync; no rank reads or writes another's memory after it.
//      Each warp walks the chunks whose mask holds its bit, in bin order
//      (128 chunks at a time, four masks a lane): each group's
//      lowest lane adds the group's values onto the cell in lane order —
//      following the group's next lanes by shuffles, or where a warp holds
//      a group of more than kLongGroup lanes (a crowded top row) from the
//      chunk's entries read as 16-byte words, one predicated add a lane —
//      and marks it touched.
//   4. Each touched cell stored back to the ring once.
// A small hop (at most 16 chunks: the display default's 382 deposits) takes
// the local form: no cluster, every CTA stages the whole hop and keeps its
// own rows' deposits, so no barrier joins the CTAs (on the card it beat
// the cluster's two barriers there, and lost above).
//
// Windows and bands, where a hop's entries or a lane's ring outgrow one
// CTA's shared memory (above 32768 points a hop holds 32,769 to 131,073
// deposits; a short hop or a tall raster gives a ring of up to 16,385 ×
// 4,096 cells a lane): the plan stages the hop in windows of W chunks
// (steps 1–3 once a window, window by window in bin order, into an entry
// array of W chunks; the rank's cells and touched flags stay resident
// across the windows, and are stored once after the last), and cuts a
// lane's ring into G bands of B slots, each band's cells owned by a
// cluster (or, local, S CTAs) of its own that reads the whole hop and
// keeps the deposits that land in its band.  A cell's owning warp meets
// its deposits window after window in bin order, so each cell's sum is
// still the plain version's.  A window ends at a cluster barrier and the
// next one's staging begins after a __syncthreads() and the cluster's
// arrive/wait, so no rank writes a peer's entries while the peer still
// walks the last window.  A shape that fits one window and one band keeps
// that plan (W the hop's chunks, B = P).
// A cell is only ever written by its warp, which meets the cell's
// deposits in bin order, so the sums are the plain version's.  One launch
// a hop, at a grid fixed by the shape (lanes·G·S CTAs); no zero fill, no
// global atomics, no sort, no scratch in device memory and no host read
// of t: the live step's CUDA graph captures it as it is.  The owner does
// not read the staging rank's memory on each step of its walk instead:
// that read's latency set the walk's pace on the card (PERF.md §6).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;       // a block's shared memory (227 KB)
constexpr int kMaxStage = 16;          // chunks a warp stages a window
constexpr int kLongGroup = 6;          // lanes of one cell: the unrolled sum
constexpr unsigned kNone = 0xffffffffu;     // a deposit that lands nowhere

// An entry's first word: the local cell (bits 0–15, at most 0xfffe), a
// next lane of the group (bit 16) and which (17–21), the group's lowest
// lane (22–26) and its length − 1 (27–31).
__device__ __forceinline__ unsigned entry_word(unsigned cell, unsigned peers,
                                               int lane) {
  const unsigned above = peers & ~((2u << lane) - 1u);
  return cell | (above != 0u ? 1u << 16 : 0u)
         | ((unsigned)(__ffs(above) - 1) & 31u) << 17
         | (unsigned)(__ffs(peers) - 1) << 22
         | (unsigned)(__popc(peers) - 1) << 27;
}
constexpr unsigned kFull = 0xffffffffu;

struct RingArgs {
  const int* ids;
  const float* vals;
  const int* t;
  float* ring;
  // chunks: the hop's chunks of 32; window: a window's (W); share: a
  // rank's chunks of a window; band: a band's slots (B), bands of them a lane
  int K, C, P, R, lanes, log_s, rb, chunks, window, share, band, bands;
};

// The walk over this rank's cells: the cells' slot and local row of this
// thread's i = threadIdx.x + n·kThreads, advanced without a division.
struct CellWalk {
  int slot, j, q, r;
  __device__ __forceinline__ CellWalk(int rb)
      : slot((int)threadIdx.x / rb), j((int)threadIdx.x % rb),
        q(kThreads / rb), r(kThreads % rb) {}
  __device__ __forceinline__ void next(int rb) {
    j += r, slot += q;
    if (j >= rb) j -= rb, ++slot;
  }
};

// The ring offset of local row j of ``slot`` on ``rank``, or −1 past C or
// past the last slot (the last band's end).
__device__ __forceinline__ long long cell_offset(const RingArgs& a, int rank,
                                                 int lane_row, int slot,
                                                 int j) {
  const int row = ((j >> 3) << (3 + a.log_s)) | (rank << 3) | (j & 7);
  if (row >= a.C || slot >= a.P) return -1;
  return ((long long)slot * a.lanes + lane_row) * a.C + row;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Where local cell i lives in shared memory: one word of padding every 32,
// so one row's cells of successive slots (rb, a multiple of 16, apart)
// fall in other banks when a warp's leaders read and write them together.
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// One step of a warp's walk: the chunk's 32 entries at ``e32``.  Each
// group's lowest lane (of this warp's cells) adds the group's values onto
// its cell in lane order: following the next lanes by shuffles, or, where
// a group holds more than kLongGroup lanes, from the chunk's values read
// as 16-byte words (one predicated add a lane above it).
__device__ __forceinline__ void walk_step(const uint2* e32, float* tile,
                                          unsigned char* touched, int lane,
                                          int warp) {
  const uint2 e = e32[lane];
  const unsigned cell = e.x & 0xffffu;
  const float x = __uint_as_float(e.y);
  const bool leader = e.x != kNone && (int)(cell & 15u) == warp
                      && (int)((e.x >> 22) & 31u) == lane;
  float acc = leader ? __fadd_rn(tile[padded(cell)], x) : 0.0f;
  if (__any_sync(kFull, leader && (e.x >> 27) >= kLongGroup)) {
    const uint4* q = reinterpret_cast<const uint4*>(e32);
    uint4 w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = q[i];
#pragma unroll
    for (int j = 1; j < 32; ++j) {
      const unsigned wx = j & 1 ? w[j >> 1].z : w[j >> 1].x;
      const unsigned wv = j & 1 ? w[j >> 1].w : w[j >> 1].y;
      if (leader && j > lane && wx != kNone
          && (int)((wx >> 22) & 31u) == lane)
        acc = __fadd_rn(acc, __uint_as_float(wv));
    }
  } else {
    int nx = leader && ((e.x >> 16) & 1u) ? (int)((e.x >> 17) & 31u) : -1;
    while (__any_sync(kFull, nx >= 0)) {
      const int from = nx >= 0 ? nx : lane;
      const float u = __shfl_sync(kFull, x, from);
      const unsigned w = __shfl_sync(kFull, e.x, from);
      if (nx >= 0) {
        acc = __fadd_rn(acc, u);
        nx = (w >> 16) & 1u ? (int)((w >> 17) & 31u) : -1;
      }
    }
  }
  if (leader) {
    tile[padded(cell)] = acc;
    touched[padded(cell)] = 1;
  }
  __syncwarp();
}

// kLocal: no cluster — each of the S CTAs of a lane's band stages the
// whole hop and keeps its own rows' deposits, so no CTA reads or writes
// another's memory and no cluster barrier is needed (a small hop:
// ring_plan).  Bounded to one CTA an SM, which its registers allowed
// anyway: the compiler then keeps each thread's staged ids and values in
// registers (the local form spilled without the bound).
template <bool kLocal>
__global__ void __launch_bounds__(kThreads, 1) ring_kernel(RingArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int S = 1 << a.log_s;
  const int rank = kLocal ? (int)(blockIdx.x & (S - 1))
                          : (int)cluster.block_rank();
  const int group = blockIdx.x >> a.log_s;        // lane_row · bands + band
  const int lane_row = group / a.bands;
  const int lo = (group - lane_row * a.bands) * a.band;   // its first slot
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cells = a.band * a.rb, n32 = a.window * 32;
  const int cells16 = (padded(cells) + 16) & ~15;
  extern __shared__ __align__(16) unsigned char sm[];
  uint2* kv = reinterpret_cast<uint2*>(sm);                       // n32
  float* tile = reinterpret_cast<float*>(kv + n32);               // cells16
  unsigned char* touched = reinterpret_cast<unsigned char*>(tile + cells16);
  unsigned* masks = reinterpret_cast<unsigned*>(touched + cells16);  // window

  // 1. this rank's cells of the band (asynchronously), its touched flags, t
  CellWalk cw(a.rb);
  for (int i = threadIdx.x; i < cells; i += kThreads, cw.next(a.rb)) {
    const long long off = cell_offset(a, rank, lane_row, lo + cw.slot, cw.j);
    if (off >= 0) __pipeline_memcpy_async(tile + padded(i), a.ring + off, 4);
  }
  __pipeline_commit();
  const int* rid = a.ids + (long long)lane_row * a.K;
  const float* rval = a.vals + (long long)lane_row * a.K;
  const int t = __ldg(a.t);
  const uint4 none = make_uint4(kNone, 0u, kNone, 0u), zero = {};
  for (int i = threadIdx.x; i < cells16 / 16; i += kThreads)
    reinterpret_cast<uint4*>(touched)[i] = zero;
  const int total = a.P * a.C;

  for (int c0 = 0; c0 < a.chunks; c0 += a.window) {
    // the window's chunks [c0, c0 + wn); this rank's share of them
    const int wn = min(a.window, a.chunks - c0);
    const int c_lo = c0 + (kLocal ? 0 : rank * a.share);
    const int c_hi = kLocal ? c0 + wn : min(c_lo + a.share, c0 + wn);
    int id[kMaxStage];
    float v[kMaxStage];
#pragma unroll
    for (int s = 0; s < kMaxStage; ++s) {
      const int ch = c_lo + warp + s * kWarps;
      const int k = (ch << 5) + lane;
      const bool in = ch < c_hi && k < a.K;
      id[s] = in ? __ldg(rid + k) : -1;
      v[s] = in ? __ldg(rval + k) : 0.0f;
    }
    // every warp of this rank has walked the last window's entries
    if (c0 > 0) __syncthreads();
    for (int i = threadIdx.x; i < wn * 16; i += kThreads)
      reinterpret_cast<uint4*>(kv)[i] = none;
    for (int i = threadIdx.x; i < wn; i += kThreads) masks[i] = 0u;
    // every rank's arrays are filled: arrive now, wait only before the
    // first store into another rank (the loads above land meanwhile)
    if (kLocal) __syncthreads();
    else cluster_arrive();

    // 2. each deposit's cell, sent to its owner (a deposit of another band
    // to none)
    bool waited = false;
#pragma unroll
    for (int s = 0; s < kMaxStage; ++s) {
      const int ch = c_lo + warp + s * kWarps;
      if (ch >= c_hi) break;                             // warp-uniform
      int owner = -1, cell = 0;
      if (id[s] >= 0 && id[s] < total) {
        const int d = id[s] / a.C;                       // δ + R
        const int row = id[s] - d * a.C;
        const int col = t + d - a.R;
        const int ls = col >= 0 ? col % a.P - lo : -1;   // slot in the band
        if (ls >= 0 && ls < a.band) {
          const int g = row >> 3;
          owner = g & (S - 1);
          cell = ls * a.rb + ((g >> a.log_s) << 3) + (row & 7);
        }
      }
      const unsigned peers = __match_any_sync(
          kFull, owner >= 0 ? (unsigned)owner << 16 | (unsigned)cell : kNone);
      const unsigned bit = owner >= 0 ? 1u << (cell & 15) : 0u;
      const int e = ((ch - c0) << 5) + lane;
      if (kLocal) {
        if (owner == rank)
          kv[e] = make_uint2(entry_word((unsigned)cell, peers, lane),
                             __float_as_uint(v[s]));
        const unsigned bits = __reduce_or_sync(kFull,
                                               owner == rank ? bit : 0u);
        if (lane == 0) masks[ch - c0] = bits;
        continue;
      }
      if (!waited) {
        cluster_wait();
        waited = true;
      }
      if (owner >= 0)
        *cluster.map_shared_rank(kv + e, owner) = make_uint2(
            entry_word((unsigned)cell, peers, lane), __float_as_uint(v[s]));
      // each owner the chunk holds: the mask of its warps (others keep 0)
      unsigned owners = __reduce_or_sync(kFull,
                                         owner >= 0 ? 1u << owner : 0u);
      while (owners != 0u) {
        const int o = __ffs(owners) - 1;
        owners &= owners - 1u;
        const unsigned bits = __reduce_or_sync(kFull, owner == o ? bit : 0u);
        if (lane == 0) *cluster.map_shared_rank(masks + (ch - c0), o) = bits;
      }
    }
    __pipeline_wait_prior(0);
    if (kLocal) {
      __syncthreads();                  // every entry and mask is in
    } else {
      if (!waited) cluster_wait();
      cluster.sync();                   // every entry and mask is in
    }

    // 3. the walk: each warp its chunks of the window in bin order, 128
    // chunks at a time (a lane's four masks at once)
    for (int b0 = 0; b0 < wn; b0 += 128) {
      unsigned nib = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = b0 + 4 * lane + q;
        nib |= (c < wn && ((masks[c] >> warp) & 1u)) ? 1u << q : 0u;
      }
      unsigned lanes_todo = __ballot_sync(kFull, nib != 0u);
      while (lanes_todo != 0u) {
        const int from = __ffs(lanes_todo) - 1;
        lanes_todo &= lanes_todo - 1u;
        unsigned todo = __shfl_sync(kFull, nib, from);
        while (todo != 0u) {
          const int base = (b0 + 4 * from + __ffs(todo) - 1) << 5;
          todo &= todo - 1u;
          walk_step(kv + base, tile, touched, lane, warp);
        }
      }
    }
  }
  __syncthreads();

  // 4. each touched cell back to the ring
  CellWalk out(a.rb);
  for (int i = threadIdx.x; i < cells; i += kThreads, out.next(a.rb))
    if (touched[padded(i)])
      a.ring[cell_offset(a, rank, lane_row, lo + out.slot, out.j)] =
          tile[padded(i)];
}

cudaLaunchConfig_t ring_config(const RingArgs& a, int smem, cudaStream_t st,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)a.lanes * a.bands << a.log_s));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1u << a.log_s;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The arguments and shared memory of a launch, or an error where the
// shape exceeds the kernel (ring_plan's limits): windows of W chunks,
// bands of B slots.
int ring_args(RingArgs* a, const int* ids, const float* vals, const int* t,
              float* ring, int lanes, int K, int P, int C, int S, bool local,
              int W, int B, int* smem) {
  if (lanes < 0 || K <= 0 || P <= 0 || (P & 1) == 0 || C <= 0 || S <= 0
      || S > kMaxCluster || (S & (S - 1)) != 0
      || (long long)P * C >= (1LL << 31) || W <= 0 || W > (K + 31) / 32
      || B <= 0 || B > P)
    return (int)cudaErrorInvalidValue;
  a->ids = ids, a->vals = vals, a->t = t, a->ring = ring;
  a->K = K, a->C = C, a->P = P, a->R = P / 2, a->lanes = lanes;
  a->log_s = 0;
  while ((1 << a->log_s) < S) ++a->log_s;
  a->rb = (C + 16 * S - 1) / (16 * S) * 16;
  a->chunks = (K + 31) / 32;
  a->window = W;
  a->share = local ? W : (W + S - 1) / S;
  a->band = B;
  a->bands = (P + B - 1) / B;
  const long long cells = (long long)B * a->rb;
  const long long bytes = 256LL * a->window
                          + 5 * ((cells + (cells >> 5) + 16) & ~15LL)
                          + 4LL * a->window;
  if (cells > 0xffff || a->share > kMaxStage * kWarps || bytes > kMaxSmem
      || ((long long)lanes * a->bands << a->log_s) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  *smem = (int)bytes;
  return 0;
}

cudaError_t allow(int S) {
  static const cudaError_t local = cudaFuncSetAttribute(
      ring_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  static const cudaError_t smem = cudaFuncSetAttribute(
      ring_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (local != cudaSuccess) return local;
  if (smem != cudaSuccess) return smem;
  if (S <= 8) return cudaSuccess;
  static const cudaError_t wide = cudaFuncSetAttribute(
      ring_kernel<false>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return wide;
}

}  // namespace

// The ring form: ids, vals (lanes, K) int32 / float32, B1's relative ids
// (δ + R)·C + row; t: the frame's 0-d int32 counter in device memory;
// ring (P, lanes, C) float32 with P = 2R + 1, added into in place on
// ``stream``; S CTAs a lane's band (the wrapper's ring_plan), a cluster,
// or with ``local`` S CTAs that each stage the whole hop; the hop staged
// in windows of ``window`` chunks of 32, a lane's ring in bands of
// ``band`` slots.
extern "C" int emspec_histogram_ring(const int* ids, const float* vals,
                                     const int* t, float* ring, int lanes,
                                     int K, int P, int C, int S, int local,
                                     int window, int band, void* stream) {
  RingArgs a;
  int smem = 0;
  const int bad = ring_args(&a, ids, vals, t, ring, lanes, K, P, C, S,
                            local != 0, window, band, &smem);
  if (bad) return bad;
  if (lanes == 0) return 0;
  const cudaError_t attr = allow(S);
  if (attr != cudaSuccess) return (int)attr;
  if (local) {
    ring_kernel<true><<<(unsigned)((long long)a.lanes * a.bands << a.log_s),
                        kThreads, (size_t)smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      ring_config(a, smem, (cudaStream_t)stream, &cluster);
  return (int)cudaLaunchKernelEx(&cfg, ring_kernel<false>, a);
}

// How many clusters of the ring form at this shape (its cluster form, not
// local; windows of ``window`` chunks, bands of ``band`` slots) the card
// holds at once (cudaOccupancyMaxActiveClusters) → *clusters; 0 where it
// holds none.
extern "C" int emspec_histogram_ring_occupancy(int lanes, int K, int P,
                                               int C, int S, int window,
                                               int band, int* clusters) {
  RingArgs a;
  int smem = 0;
  const int bad = ring_args(&a, nullptr, nullptr, nullptr, nullptr, lanes, K,
                            P, C, S, false, window, band, &smem);
  if (bad) return bad;
  const cudaError_t attr = allow(S);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = ring_config(a, smem, nullptr, &cluster);
  return (int)cudaOccupancyMaxActiveClusters(clusters, ring_kernel<false>,
                                              &cfg);
}
