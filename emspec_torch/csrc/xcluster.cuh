// Route cluster_large of kernels B1 and B6 (N = 65536 … 262144; B6 also
// 32768 above deposits.cu's 6,912 cells): one launch, a frame a
// thread-block cluster, its spectra and (B6) its histogram in the
// cluster's shared memory.  Included by deposits_large.cu (B1) and by
// deposits_hist_copies.cu and deposits_hist_bands.cu (B6, one design of
// its cells each), so that the three instantiations of xcluster_kernel
// compile in parallel.
//
// xcluster_kernel: a frame a thread-block cluster of C CTAs (8 at 65536,
// 16 at 131072 and 262144, the last two above the portable 8: the wrapper
// asks cudaOccupancyMaxActiveClusters first; B6 also 4 at 32768).  Each
// frame's two half-size spectra stay in the cluster's shared memory, 8·N/C bytes a CTA (64 KB
// in 512 threads, three CTAs an SM; 128 KB in 1024 threads at 262144,
// where 16 CTAs is the card's most and it holds 7 such clusters at
// once), from the read of its samples to the write of its deposits.
// (Holding one signal at a time at 262144, through a scratch for Y[k],
// fits two CTAs an SM and 8 frames in one wave, but each CTA then runs
// both transforms in 512 threads: it measured slower.)  With m = N/2 =
// n1·n2 (fourstep._FACTORS[m]) and z[i] = s[2i] + i·s[2i+1] (never
// packing the raw and the t·h signal together), the raw and the t·h
// sequence each a four-step FFT spread over the cluster:
//   1. load: rank r reads columns [r·W, (r + 1)·W) (W = n2/C) of the
//      (n1, n2) view of both z, 2W consecutive samples a row, straight
//      from the framing view (16-byte loads where address and strides
//      allow), the t·h window applied on the way, into two tiles of n1
//      rows at stride W' (row-major);
//   2. steps 1+2: n1-point column FFTs of B4's radix body
//      (radix_common.cuh) down the 2W columns, TW[k1, r·W + c] on the
//      last pass;
//   3. exchange (the four-step transpose across the cluster): afterwards
//      rank r holds the rows k1 in [r·A, (r + 1)·A) (A = n1/C) of every
//      column, column-major at stride Q.  In round j rank r reads its
//      rows of the columns of rank p = r xor j from p's tile through
//      distributed shared memory — rows p·A … of p's tile, the block p
//      reads from r in the same round — so once the cluster syncs, that
//      block of r's tile is free and r stores what it read there,
//      transposed: row-major rows [p·A, (p + 1)·A) at stride W' and
//      column-major columns [p·W, (p + 1)·W) at stride Q fill the same
//      A·W' = W·Q values (W', Q chosen so).  A cluster sync before the
//      first read (every rank's column FFTs done); the C rounds go in two
//      groups of C/2, 8 values a thread in registers, one cluster sync
//      between a group's reads and its stores: no staging buffer;
//   4. step 3: n2-point row FFTs along the 2A rows, in place (both
//      layouts keep consecutive lines at consecutive addresses, and the
//      transposed stores run at the odd stride Q: no bank conflicts);
//   5. a cluster sync, then one thread a pair of bins: rank r takes the
//      j = k1 + n1·k2 < m/2 of its rows (runs of A consecutive j) and,
//      for each, the bins j and m − j, whose X and Y one unpack of the
//      pair Z[j], Z[m − j] gives (Z[j] from its own tile, Z[m − j] from
//      the rank that holds row (m − j) mod n1, through distributed
//      shared memory); X[j ∓ 1] and X[m − j ± 1] come from the
//      neighbouring lanes (the lanes at a run's ends unpack the pair
//      beyond it; the Hermitian conjugates at k = 0 and N/2; rank 0 also
//      takes the bin m/2), then the shared epilogue; a last cluster sync
//      keeps every tile alive until no peer reads it.
// B6 (xcluster_kernel<kCopies> or <kBands>, the whole spectrum): the
// frame's relative histogram of S = (2R + 1)·rows cells lives in the
// cluster's shared memory after each CTA's two tiles, zeroed before the
// first cluster sync, and step 5 adds each lane's deposits (the mask
// id >= min_id applied, ids outside [0, S) dropped) through
// histogram_common.cuh's warp merge (the lanes of one cell summed by B2's
// peer tree, the group's lowest lane adding the sum), merging every warp
// step as deposits.cu's B6 routes do.  Two designs, by shape (the
// wrapper's cluster_large_bands):
//   * kCopies: each CTA a private copy of all S cells; no add crosses the
//     cluster.  The sync after step 5 then also says every copy is
//     complete: rank r stores cells [r·S/C, (r + 1)·S/C) of the frame's
//     row, each the sum of the C copies in rank order (C − 1 of them read
//     through distributed shared memory), and a sixth cluster sync keeps
//     every copy alive until no peer reads it;
//   * kBands: rank r holds only the band [r·S/C, (r + 1)·S/C), and a
//     group's sum goes to the band's owner, through distributed shared
//     memory where that is another rank (an atomicAdd on the mapped
//     address); after the sync that ends step 5 each rank stores its own
//     band, and no sixth sync is needed.  A rank's bins j = k1 + n1·k2
//     run over the whole spectrum, so their rows cover the whole raster
//     and C − 1 of C adds cross the cluster: no band is local.
// Copies cost shared memory (S cells a CTA), bands remote atomics.  On
// the H100 (PERF.md §6) copies run faster wherever they leave a CTA the
// SM share it had without them, and bands where the copies would cut two
// CTAs an SM to one (at 32768 above 11,008 cells: 0.687 against 1.208 ms
// at 920 frames × 20,992 cells, the north star at hop 800).  At 32768 the
// plan is four CTAs of 8192 points, (n1, n2) = (128, 128), 70 KB of
// tiles.  Cells: up to (232,448 − the tiles' bytes)/4 a CTA, so copies
// hold 40,192 at 32768, 39,680 at 65536 and 131072, 22,272 at 262144,
// and bands C times as many — more than the three-launch route's 58,112
// at every size.
// The FFT's passes are B4's and the factors the three-launch route's, so
// the spectra take the same arithmetic.  What bounds it on the H100:
// device memory moves 4·N bytes in and 8·(N/2 + 1) out a frame, far
// below what the card takes; the pace is set on chip by the FFT's
// shared-memory passes, the 8·N bytes a frame crossing between the CTAs
// (the exchange and the epilogue's peer reads) and the 5 cluster syncs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "deposits_common.cuh"
#include "histogram_common.cuh"
#include "radix_common.cuh"

namespace {

namespace cg = cooperative_groups;
using emspec::radix::kTable;
using emspec::radix::Lines;
using emspec::radix::Step2;

constexpr int kXMaxThreads = 1024;
constexpr int kXP = 16;                   // FFT points a thread: threads·16 = N/C
constexpr int kXHeld = 8;                 // exchange values a thread holds
constexpr int kXBatch = 4;                // frame loads in flight a thread
constexpr int kMaxSmem = 232448;          // a block's most on the H100

// Everything a launch reads and writes; frame f of the batch starts at
// x + (f div frames_per_lead)·lead_stride + (f mod frames_per_lead)·frame_stride.
struct XArgs {
  const float* x;
  long long frames_per_lead, lead_stride, frame_stride;
  int vec;                       // 1: 16-byte frame loads
  const float* th;               // the t·h window, N floats
  const float2* w512;            // B4's W_512^t table
  const float2* tw4;             // B4's step-2 TW, (n1, n2)
  const float2* tw;              // unpack: e^{−2πij/N}, j < N/2
  const float *logmap_a, *logmap_b, *power_floor;
  int* ids;                      // B1: (frames, k_hi − k_lo)
  float* contrib;                // B1: contrib; B6: (frames, num_bins)
  int n, log2n1, log2n2, log2c, hop;
  int wp, q;                     // tile strides: W' before, Q after the exchange
  float c_dh, bin_scale, hz_per_bin, inv_n2;
  int rows, reach, k_lo, k_hi;
  const float* band;             // (k_hi − k_lo) band weights, or null (1)
  int min_id, num_bins;          // B6: the mask and the histogram's cells
};

// Complex points a CTA holds (both signals): 8192 up to 131072 points,
// so that a CTA's tiles take 72 KB and three share an SM; 16384 at
// 262144, where a cluster of 16 CTAs (the most the card takes) needs them.
int xpoints(int n) { return n <= 131072 ? 8192 : 16384; }

// The cluster plan of N (n1·n2 = N/2): C = N/xpoints(N) CTAs a cluster
// (4 at 32768, B6 only; 8, 16, 16), W' and Q with A·W' = W·Q (W = n2/C
// columns before, A = n1/C rows after the exchange) and both strides
// padded past W and A.  False where N does not take the route.
bool xplan(int n, int n1, int n2, int* log2c, int* wp, int* q) {
  const int c = n / xpoints(n);
  if (n % xpoints(n) != 0 || (c != 4 && c != 8 && c != 16)
      || n1 * n2 * 2 != n || n1 % c != 0 || n2 % c != 0 || n1 / c < 16
      || n2 / c < 16)
    return false;
  const int w = n2 / c, a = n1 / c;
  *log2c = c == 4 ? 2 : c == 8 ? 3 : 4;
  if (w % a == 0) {
    *q = a + 1;
    *wp = w + w / a;
  } else {
    *wp = w + 1;
    *q = a + a / w;
  }
  return true;
}

// Rank r's columns [r·W, (r + 1)·W) of both signals of frame f → the raw
// tile and, fs further, the t·h tile, row-major at stride W'.  16-byte
// loads give z[i], z[i + 1] of one row (W is even); kXBatch loads go out
// before any is stored.
__device__ __forceinline__ void xload(float2* tile, int fs, const XArgs& a,
                                      long long f, int rank) {
  const float* fr = a.x + (f / a.frames_per_lead) * a.lead_stride
                        + (f % a.frames_per_lead) * a.frame_stride;
  const int lw = a.log2n2 - a.log2c;
  const int col0 = rank << lw;
  const int total = 1 << (lw + a.log2n1);       // complex points a signal
  const int T = blockDim.x;
  if (a.vec) {
    for (int g0 = threadIdx.x; g0 < total >> 1; g0 += kXBatch * T) {
      float4 s[kXBatch], t[kXBatch];
#pragma unroll
      for (int j = 0; j < kXBatch; ++j) {
        const int g = g0 + j * T;
        if (g < total >> 1) {
          const int i = ((g >> (lw - 1)) << a.log2n2) + col0
                        + ((g & ((1 << (lw - 1)) - 1)) << 1);
          s[j] = __ldg(reinterpret_cast<const float4*>(fr + 2 * i));
          t[j] = __ldg(reinterpret_cast<const float4*>(a.th + 2 * i));
        }
      }
#pragma unroll
      for (int j = 0; j < kXBatch; ++j) {
        const int g = g0 + j * T;
        if (g >= total >> 1) break;
        const int at = (g >> (lw - 1)) * a.wp
                       + ((g & ((1 << (lw - 1)) - 1)) << 1);
        tile[at] = make_float2(s[j].x, s[j].y);
        tile[at + 1] = make_float2(s[j].z, s[j].w);
        tile[fs + at] = make_float2(s[j].x * t[j].x, s[j].y * t[j].y);
        tile[fs + at + 1] = make_float2(s[j].z * t[j].z, s[j].w * t[j].w);
      }
    }
  } else {
    for (int e0 = threadIdx.x; e0 < total; e0 += kXBatch * T) {
      float2 s[kXBatch];
#pragma unroll
      for (int j = 0; j < kXBatch; ++j) {
        const int e = e0 + j * T;
        if (e < total) {
          const int i = ((e >> lw) << a.log2n2) + col0 + (e & ((1 << lw) - 1));
          s[j] = make_float2(__ldg(fr + 2 * i), __ldg(fr + 2 * i + 1));
        }
      }
#pragma unroll
      for (int j = 0; j < kXBatch; ++j) {
        const int e = e0 + j * T;
        if (e >= total) break;
        const int i = ((e >> lw) << a.log2n2) + col0 + (e & ((1 << lw) - 1));
        const int at = (e >> lw) * a.wp + (e & ((1 << lw) - 1));
        tile[at] = s[j];
        tile[fs + at] = make_float2(s[j].x * __ldg(a.th + 2 * i),
                                    s[j].y * __ldg(a.th + 2 * i + 1));
      }
    }
  }
}

// Element e of an exchange group (kXHeld·threads = C·A·W of them): round ri
// of the group, signal sig, local row aa of the reader's rows, column jj
// of the owner's columns.
struct XElem {
  int ri, sig, aa, jj;
};
__device__ __forceinline__ XElem xelem(int e, int la, int lw) {
  return XElem{e >> (la + lw + 1), (e >> (la + lw)) & 1,
               (e >> lw) & ((1 << la) - 1), e & ((1 << lw) - 1)};
}

// What the kernel makes of the deposits: B1's ids and contrib of the
// window's bins, or B6's relative histogram, its cells either in a full
// private copy in each CTA (kCopies) or in bands, one a CTA (kBands).
enum XHist : int { kB1 = 0, kCopies = 1, kBands = 2 };

// The first cell of rank r's band of S cells (C = 2^lc ranks), and the
// rank whose band holds cell id: the largest r with band_start(r) <= id.
__device__ __forceinline__ int band_start(int S, int r, int lc) {
  return (int)(((long long)S * r) >> lc);
}
__device__ __forceinline__ int band_of(int S, int id, int lc) {
  return (int)((((long long)id + 1 << lc) - 1) / S);
}

template <int kHist>
__global__ void __launch_bounds__(kXMaxThreads, 1) xcluster_kernel(
    const XArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  extern __shared__ float2 sm[];
  float2* w = sm;
  float2* tile = sm + kTable;                 // raw, then t·h at fs
  const int l1 = a.log2n1, l2 = a.log2n2, lc = a.log2c;
  const int lw = l2 - lc, la = l1 - lc;
  const int fs = a.wp << l1;
  float* hist = reinterpret_cast<float*>(tile + 2 * fs);     // B6 only
  const long long f = blockIdx.x >> lc;
  emspec::radix::load_table(w, a.w512);
  xload(tile, fs, a, f, rank);
  const int S = a.num_bins;
  const int held = kHist == kCopies ? S                        // B6's cells
                   : band_start(S, rank + 1, lc) - band_start(S, rank, lc);
  if constexpr (kHist != kB1)
    for (int i = threadIdx.x; i < held; i += blockDim.x) hist[i] = 0.0f;
  __syncthreads();
  // steps 1+2: n1-point FFTs down the 2W columns, TW on the last pass
  emspec::radix::line_fft<kXP>(tile, w, Lines{1 + lw, lw, fs, 1, a.wp}, l1,
                               Step2{a.tw4, l2, rank << lw});
  cluster.sync();                             // every column FFT done
  // the exchange, two groups of C/2 rounds
  for (int grp = 0; grp < 2; ++grp) {
    float2 v[kXHeld];
#pragma unroll
    for (int i = 0; i < kXHeld; ++i) {
      const XElem e = xelem(threadIdx.x + i * blockDim.x, la, lw);
      const int p = rank ^ ((grp << (lc - 1)) + e.ri);
      const float2* src = cluster.map_shared_rank(tile, p);
      v[i] = src[e.sig * fs + ((rank << la) + e.aa) * a.wp + e.jj];
    }
    cluster.sync();                           // every read of the group done
#pragma unroll
    for (int i = 0; i < kXHeld; ++i) {
      const XElem e = xelem(threadIdx.x + i * blockDim.x, la, lw);
      const int p = rank ^ ((grp << (lc - 1)) + e.ri);
      tile[e.sig * fs + ((p << lw) + e.jj) * a.q + e.aa] = v[i];
    }
  }
  __syncthreads();
  // step 3: n2-point FFTs along the 2A rows
  emspec::radix::line_fft<kXP>(tile, w, Lines{1 + la, la, fs, 1, a.q}, l2,
                               Step2{nullptr, 0, 0});
  cluster.sync();                             // every spectrum transformed
  const int m = 1 << (l1 + l2);
  // &Z[j] (0 <= j < m) of the raw signal (the t·h one fs further): row
  // j mod n1 on rank row div A, its own tile or a peer's
  auto z_ptr = [&](int j) {
    const int row = j & ((1 << l1) - 1);
    const int owner = row >> la;
    const float2* t = owner == rank ? tile : cluster.map_shared_rank(tile, owner);
    return t + (j >> l1) * a.q + (row & ((1 << la) - 1));
  };
  // X[j] and X[m − j] (and Y[j], Y[m − j] where wanted), 0 <= j <= m,
  // from one unpack of the pair (j', m − j'), j' = min(j, m − j); X[m/2]
  // is the pair's first value either way
  auto pair_at = [&](int j, float2* lo, float2* hi, float2* ylo,
                     float2* yhi) {
    const bool upper = j > (m >> 1);
    const int jl = upper ? m - j : j;
    const int jm = jl == 0 ? 0 : m - jl;
    const float2* zl = z_ptr(jl);
    const float2* zm = z_ptr(jm);
    const float2 w = __ldg(a.tw + jl);
    float2 a0, a1;
    emspec::unpack_pair(zl[0], zm[0], w, &a0, &a1);
    if (jl == (m >> 1)) a1 = a0;
    *lo = upper ? a1 : a0;
    *hi = upper ? a0 : a1;
    if (ylo != nullptr) {
      emspec::unpack_pair(zl[fs], zm[fs], w, &a0, &a1);
      if (jl == (m >> 1)) a1 = a0;
      *ylo = upper ? a1 : a0;
      *yhi = upper ? a0 : a1;
    }
  };
  const emspec::EpilogueConsts c{*a.logmap_a, *a.logmap_b, *a.power_floor,
                                 a.c_dh, a.bin_scale, a.hz_per_bin, a.inv_n2,
                                 a.n, a.hop, a.rows, a.reach};
  const long long out0 = f * (long long)(a.k_hi - a.k_lo) - a.k_lo;
  const int lane = threadIdx.x & 31;
  auto deposit = [&](int k, float2 X, float2 Am1, float2 Ap1, float2 Y) {
    int id;
    float contrib;
    emspec::deposit_at(k, X, Am1, Ap1, Y,
                       a.band == nullptr ? 1.0f : __ldg(a.band + k - a.k_lo),
                       c, &id, &contrib);
    a.ids[out0 + k] = id;
    a.contrib[out0 + k] = contrib;
  };
  // B6: cell id's address, in this CTA or (kBands) in its owner's band
  auto cell = [&](int id) {
    if constexpr (kHist == kCopies) return hist + id;
    const int owner = band_of(S, id, lc);
    float* base = owner == rank ? hist : cluster.map_shared_rank(hist, owner);
    return base + id - band_start(S, owner, lc);
  };
  // B6: bin k's deposit (where ``in``) into its cell; all 32 lanes call it
  // (the merge is warp-collective), a lane without a deposit that lands
  // offering the dropped key ~lane.  B2's warp_add (histogram_common.cuh):
  // the lanes of one cell summed by its peer tree, the group's lowest lane
  // adding the sum
  auto hist_add = [&](bool in, int k, float2 X, float2 Am1, float2 Ap1,
                      float2 Y) {
    int id = -1;
    float contrib = 0.0f;
    if (in) emspec::deposit_at(k, X, Am1, Ap1, Y, 1.0f, c, &id, &contrib);
    const bool ok = in && emspec::lands(id, a.min_id, S);
    if constexpr (kHist == kCopies) {
      emspec::hist::warp_add<false, unsigned>(
          hist, ok ? (unsigned)id : ~(unsigned)lane, ok, contrib);
    } else {
      if (!__any_sync(0xffffffffu, ok)) return;
      const unsigned peers =
          __match_any_sync(0xffffffffu, ok ? (unsigned)id : ~(unsigned)lane);
      if (emspec::hist::reduce_peers(peers, contrib) && ok)
        atomicAdd(cell(id), contrib);
    }
  };
  auto shfl = [](float2 v, bool up) {
    return up ? make_float2(__shfl_up_sync(0xffffffffu, v.x, 1),
                            __shfl_up_sync(0xffffffffu, v.y, 1))
              : make_float2(__shfl_down_sync(0xffffffffu, v.x, 1),
                            __shfl_down_sync(0xffffffffu, v.y, 1));
  };
  auto conj = [](float2 v) { return make_float2(v.x, -v.y); };
  // Rank r's pairs: qq = (k2 << la) + ℓ, k2 < n2/2 → j = r·A + ℓ + n1·k2
  // < m/2, runs of A consecutive j; a lane takes the bins j and m − j
  // (0 and N/2 for j = 0) from one unpack of each spectrum, and rank 0
  // the bin m/2 besides.  A warp step takes 32 consecutive qq (one run
  // or two); X[j ∓ 1] and X[m − j ± 1] come from the neighbouring lanes
  // by shuffle, and the first and last lane of a run unpack the pair
  // beyond it (the Hermitian conjugates of X[1], X[m − 1] at 0 and N/2).
  const int run = 1 << la;
  for (int q0 = threadIdx.x & ~31; q0 < 1 << (la + l2 - 1);
       q0 += blockDim.x) {
    const int qq = q0 + lane;
    const int ell = qq & (run - 1);
    const int j = (rank << la) + ell + ((qq >> la) << l1);
    const bool in_lo = j >= a.k_lo && j < a.k_hi;
    const bool in_hi = m - j >= a.k_lo && m - j < a.k_hi;
    if (!__any_sync(0xffffffffu, in_lo || in_hi)) continue;
    float2 X, Xm, Y, Ym;                      // X[j], X[m − j], Y[j], Y[m − j]
    pair_at(j, &X, &Xm, &Y, &Ym);
    const float2 xm = shfl(X, true), xp = shfl(X, false);      // X[j ∓ 1]
    const float2 hm = shfl(Xm, true), hp = shfl(Xm, false);    // X[m − j ± 1]
    float2 e = X, em = Xm;                    // the pair beyond the run's end
    if ((ell == 0 && j != 0) || ell == run - 1)
      pair_at(ell == 0 ? j - 1 : j + 1, &e, &em, nullptr, nullptr);
    if constexpr (kHist != kB1) {
      hist_add(in_lo, j, X, ell == 0 ? (j == 0 ? conj(xp) : e) : xm,
               ell == run - 1 ? e : xp, Y);
      hist_add(in_hi, m - j, Xm, ell == run - 1 ? em : hp,
               ell == 0 ? (j == 0 ? conj(hp) : em) : hm, Ym);
    } else {
      if (in_lo)
        deposit(j, X, ell == 0 ? (j == 0 ? conj(xp) : e) : xm,
                ell == run - 1 ? e : xp, Y);
      if (in_hi)
        deposit(m - j, Xm, ell == run - 1 ? em : hp,
                ell == 0 ? (j == 0 ? conj(hp) : em) : hm, Ym);
    }
  }
  if (rank == 0 && threadIdx.x == 0 && (m >> 1) >= a.k_lo
      && (m >> 1) < a.k_hi) {                 // bin m/2
    float2 X, Xm, Y, Ym, b0, b1;
    pair_at(m >> 1, &X, &Xm, &Y, &Ym);
    pair_at((m >> 1) - 1, &b0, &b1, nullptr, nullptr);   // X[m/2 ∓ 1]
    if constexpr (kHist != kB1) {
      int id;
      float contrib;
      emspec::deposit_at(m >> 1, X, b0, b1, Y, 1.0f, c, &id, &contrib);
      if (emspec::lands(id, a.min_id, S)) atomicAdd(cell(id), contrib);
    } else {
      deposit(m >> 1, X, b0, b1, Y);
    }
  }
  cluster.sync();                             // no peer reads this tile any
                                              // more; B6: every add done
  float* row = a.contrib + f * (long long)S;
  if constexpr (kHist == kBands)              // rank r's band, its own
    for (int i = threadIdx.x; i < held; i += blockDim.x)
      row[band_start(S, rank, lc) + i] = hist[i];
  if constexpr (kHist == kCopies) {
    // rank r's cells of the frame's row: the C copies summed in rank order
    const int c0 = band_start(S, rank, lc), c1 = band_start(S, rank + 1, lc);
    for (int i = c0 + threadIdx.x; i < c1; i += blockDim.x) {
      float v[16];
#pragma unroll
      for (int p = 0; p < 16; ++p)
        if (p < 1 << lc)
          v[p] = p == rank ? hist[i] : *cluster.map_shared_rank(hist + i, p);
      float s = v[0];
#pragma unroll
      for (int p = 1; p < 16; ++p)
        if (p < 1 << lc) s += v[p];
      row[i] = s;
    }
    cluster.sync();                           // no peer reads this copy any more
  }
}

int xlog2(int v) {
  int l = 0;
  while (l < 30 && (1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

// The launch of frames clusters of 2^log2c CTAs (smem bytes each).
cudaLaunchConfig_t xconfig(long long frames, int log2c, int threads,
                           int smem, cudaStream_t st,
                           cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(frames << log2c));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1u << log2c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// A CTA's shared memory: B4's table, both tiles and (B6) its cells.
int xsmem(int n1, int wp, int cells = 0) {
  return (int)sizeof(float2) * (kTable + 2 * n1 * wp)
         + (int)sizeof(float) * cells;
}

// B6's cells a CTA holds: all S (kCopies), its band of at most ceil(S/C)
// (kBands).
int xcells(int kind, int num_bins, int log2c) {
  return kind == kB1 ? 0 : kind == kCopies
      ? num_bins : (num_bins + (1 << log2c) - 1) >> log2c;
}

// The kernel's attributes: its shared memory, clusters above 8 CTAs.
template <int kHist>
cudaError_t xattributes() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        xcluster_kernel<kHist>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        xcluster_kernel<kHist>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return err;
}

// The C entry points' arguments → XArgs, the plan's strides included.
// False on a shape the route does not take.
bool xargs(XArgs* a, const float* x, long long frames_per_lead,
           long long lead_stride, long long frame_stride, const float* th,
           const void* w512, const void* tw4, const void* tw,
           const float* logmap_a, const float* logmap_b,
           const float* power_floor, int* ids, float* out, int n, int n1,
           int n2, int hop, float c_dh, float bin_scale, float hz_per_bin,
           float inv_n2, int rows, int reach, int k_lo, int k_hi,
           const float* band, int min_id, int num_bins) {
  int lc, wp, q;
  const int l1 = xlog2(n1), l2 = xlog2(n2);
  if (l1 < 4 || l2 < 4 || l1 > emspec::radix::kLog2Table
      || l2 > emspec::radix::kLog2Table || !xplan(n, n1, n2, &lc, &wp, &q)
      || k_lo < 0 || k_lo >= k_hi || k_hi > n / 2 + 1)
    return false;
  *a = XArgs{x, frames_per_lead, lead_stride, frame_stride,
             (reinterpret_cast<std::uintptr_t>(x) % 16 == 0
              && lead_stride % 4 == 0 && frame_stride % 4 == 0) ? 1 : 0,
             th, static_cast<const float2*>(w512),
             static_cast<const float2*>(tw4), static_cast<const float2*>(tw),
             logmap_a, logmap_b, power_floor, ids, out, n, l1, l2, lc, hop,
             wp, q, c_dh, bin_scale, hz_per_bin, inv_n2, rows, reach, k_lo,
             k_hi, band, min_id, num_bins};
  return true;
}

// One launch of ``frames`` clusters.
template <int kHist>
int xlaunch(const XArgs& a, long long frames, int n1, cudaStream_t st) {
  const cudaError_t attr = xattributes<kHist>();
  if (attr != cudaSuccess) return (int)attr;
  if (frames == 0) return 0;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      xconfig(frames, a.log2c, xpoints(a.n) / kXP,
              xsmem(n1, a.wp, xcells(kHist, a.num_bins, a.log2c)), st,
              &cluster);
  return (int)cudaLaunchKernelEx(&cfg, xcluster_kernel<kHist>, a);
}

// How many clusters of route cluster_large at N (n1·n2 = N/2) the card
// holds at once (cudaOccupancyMaxActiveClusters) → *clusters; 0 where it
// holds none (a cluster size the card refuses): B1's kernel (num_bins
// 0) or B6's with its cells in each CTA.
template <int kHist>
int xoccupancy(int n, int n1, int n2, int num_bins, int* clusters) {
  int lc, wp, q;
  if (!xplan(n, n1, n2, &lc, &wp, &q)) return (int)cudaErrorInvalidValue;
  const int smem = xsmem(n1, wp, xcells(kHist, num_bins, lc));
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t attr = xattributes<kHist>();
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      xconfig(64, lc, xpoints(n) / kXP, smem, nullptr, &cluster);
  return (int)cudaOccupancyMaxActiveClusters(clusters,
                                              xcluster_kernel<kHist>, &cfg);
}

}  // namespace
