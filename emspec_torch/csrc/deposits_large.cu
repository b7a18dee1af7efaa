// Kernel B1, large-frame routes: frames → reassigned deposits (ids,
// contrib) for N = 65536 … 262144, where a frame's two spectra no longer
// fit one block or B1's two-CTA cluster (deposits.cu).  Also kernel B6
// (the fused histogram) above 16384 points.
//
// Replaces emspec/dsp/pallas/fft4.py::fft4_deposits (_deposits_kernel,
// _frame_quantized with its half-spectrum route, _iota_grids) above 16384
// points.  Both routes compute what deposits.cu computes at N <= 32768,
// in natural bin order, id −1 and contrib 0 for every invalid deposit,
// for the bins of a window [k_lo, k_hi) with an optional band weight,
// through deposits_common.cuh's unpack_pair and deposit_at.
//
// Route "cluster_large" (xcluster_kernel): one launch, a frame a
// thread-block cluster of C CTAs (8 at 65536, 16 at 131072 and 262144,
// the last two above the portable 8: the wrapper asks
// cudaOccupancyMaxActiveClusters first).  Each frame's two half-size
// spectra stay in the cluster's shared memory, 8·N/C bytes a CTA (64 KB
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
// The FFT's passes are B4's and the factors the three-launch route's, so
// the spectra take the same arithmetic.  What bounds it on the H100:
// device memory moves 4·N bytes in and 8·(N/2 + 1) out a frame, far
// below what the card takes; the pace is set on chip by the FFT's
// shared-memory passes, the 8·N bytes a frame crossing between the CTAs
// (the exchange and the epilogue's peer reads) and the 5 cluster syncs.
//
// Route "large" (three launches; what the sizes took before the cluster
// route, and what B6 takes above 32768):
//   1. pack (this file): each frame read once through its stride (the
//      framing unfold view goes in uncopied), the t·h window applied, the
//      raw and the t·h signal each even/odd-packed into an N/2-point
//      complex sequence z[i] = s[2i] + i·s[2i+1] — never packed together
//      (their spectra differ by ~10³ in magnitude) — as 2·b contiguous
//      (n1, n2) planes, sequence 2f the raw and 2f+1 the t·h of frame f;
//   2. kernel B4 (fourstep.cu, steps 1–3 as radix FFTs in shared memory:
//      one launch at 128×128, two through a scratch above) on those 2·b
//      sequences at fourstep._FACTORS[N/2] (128×128 … 256×512, b = 1
//      included);
//   3. finish (this file): one thread a bin.  It reads the B4 output
//      through the step-4 map — Z[j] lies at (j mod n1)·n2 + j div n1 —
//      unpacks X[k−1], X[k], X[k+1] and Y[k] with deposits_common.cuh's
//      unpack_pair (the Hermitian conjugates of X[1] and X[N/2−1] at
//      k = 0 and N/2, as in deposits.cu) and runs the shared epilogue.
//      Thread q of a frame takes bin k = q div n2 + n1·(q mod n2), so a
//      warp reads consecutive addresses of Z (and of its mirror
//      Z[m−j], in reverse); the bin k = N/2 is the extra thread q = m.
//      The writes of ids and contrib are strided by n1 and merge in L2.
//      B6 (hist = 1): each block histograms its bins in shared memory
//      (the streaming mask id >= min_id applied) and adds the nonzero
//      cells atomically into the zeroed output row.
//   What bounds it on the H100: device-memory bytes — pack reads ~4·N and
//   writes 8·N bytes a frame, B4 reads and writes the planes (16·N bytes
//   a frame, twice that above 16384 points where it goes through its
//   scratch), finish reads them and writes ids and contrib: ~50·N bytes a
//   frame against the 4·N in and 8·(N/2 + 1) out the function needs.  The
//   scratch planes (2·b·N/2 complex, 180 MB at 688 × 32768) come from the
//   wrapper's torch.empty, so PyTorch's caching allocator serves them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "deposits_common.cuh"
#include "radix_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHistBinsPerBlock = 4096;   // B6: bins one block histograms

__global__ void __launch_bounds__(kThreads) pack_kernel(
    const float* __restrict__ x, long long frames_per_lead,
    long long lead_stride, long long frame_stride,
    const float* __restrict__ th, float* __restrict__ zr,
    float* __restrict__ zi, int m, int chunks) {
  const long long f = blockIdx.x / chunks;
  const int i = (blockIdx.x % chunks) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float* fr = x + (f / frames_per_lead) * lead_stride
                      + (f % frames_per_lead) * frame_stride;
  const float a0 = fr[2 * i], a1 = fr[2 * i + 1];
  const long long raw = 2 * f * (long long)m + i;
  const long long thw = raw + m;
  zr[raw] = a0;
  zi[raw] = a1;
  zr[thw] = a0 * th[2 * i];
  zi[thw] = a1 * th[2 * i + 1];
}

// X[j], 0 <= j <= m, of one real frame from Z (its B4 planes, (k1, k2)
// layout): the pair (j', m − j') with j' = min(j, m − j) unpacked as in
// deposits.cu.
__device__ __forceinline__ float2 spectrum_at(
    const float* __restrict__ zr, const float* __restrict__ zi,
    const float2* __restrict__ tw, int j, int m, int n1, int n2) {
  const bool upper = j > (m >> 1);
  const int jl = upper ? m - j : j;
  const int jm = jl == 0 ? 0 : m - jl;
  const int a0 = (jl % n1) * n2 + jl / n1;
  const int a1 = (jm % n1) * n2 + jm / n1;
  float2 lo, hi;
  emspec::unpack_pair(make_float2(zr[a0], zi[a0]), make_float2(zr[a1], zi[a1]),
                      tw[jl], &lo, &hi);
  return upper ? hi : lo;
}

template <bool kHist>
__global__ void __launch_bounds__(kThreads) finish_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const float2* __restrict__ tw, const float* __restrict__ logmap_a,
    const float* __restrict__ logmap_b, const float* __restrict__ power_floor,
    int* __restrict__ ids, float* __restrict__ out, int chunks, int per_block,
    int n, int n1, int n2, int hop, float c_dh, float bin_scale,
    float hz_per_bin, float inv_n2, int rows, int reach, int min_id,
    int num_bins, int k_lo, int k_hi, const float* __restrict__ band) {
  extern __shared__ float hist[];                 // B6 only
  const int m = n >> 1;
  const long long f = blockIdx.x / chunks;
  const int q0 = (blockIdx.x % chunks) * per_block;
  const int q1 = min(q0 + per_block, m + 1);
  const float* raw_r = xr + 2 * f * (long long)m;
  const float* raw_i = xi + 2 * f * (long long)m;
  const float* th_r = raw_r + m;
  const float* th_i = raw_i + m;
  const emspec::EpilogueConsts c{*logmap_a, *logmap_b, *power_floor, c_dh,
                                 bin_scale, hz_per_bin, inv_n2, n, hop, rows,
                                 reach};
  if (kHist) {
    for (int i = threadIdx.x; i < num_bins; i += blockDim.x) hist[i] = 0.0f;
    __syncthreads();
  }
  for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x) {
    const int k = q == m ? m : q / n2 + n1 * (q % n2);
    if (k < k_lo || k >= k_hi) continue;
    const float2 A = spectrum_at(raw_r, raw_i, tw, k, m, n1, n2);
    float2 Am1, Ap1;
    if (k == 0) {
      const float2 x1 = spectrum_at(raw_r, raw_i, tw, 1, m, n1, n2);
      Am1 = make_float2(x1.x, -x1.y);
    } else {
      Am1 = spectrum_at(raw_r, raw_i, tw, k - 1, m, n1, n2);
    }
    if (k == m) {
      const float2 x1 = spectrum_at(raw_r, raw_i, tw, m - 1, m, n1, n2);
      Ap1 = make_float2(x1.x, -x1.y);
    } else {
      Ap1 = spectrum_at(raw_r, raw_i, tw, k + 1, m, n1, n2);
    }
    const float2 B = spectrum_at(th_r, th_i, tw, k, m, n1, n2);
    int id;
    float contrib;
    emspec::deposit_at(k, A, Am1, Ap1, B,
                       band == nullptr ? 1.0f : band[k - k_lo], c, &id,
                       &contrib);
    if (kHist) {
      if (emspec::lands(id, min_id, num_bins)) atomicAdd(&hist[id], contrib);
    } else {
      const long long at = f * (long long)(k_hi - k_lo) + k - k_lo;
      ids[at] = id;
      out[at] = contrib;
    }
  }
  if (kHist) {
    __syncthreads();
    float* row = out + f * (long long)num_bins;
    for (int i = threadIdx.x; i < num_bins; i += blockDim.x)
      if (hist[i] != 0.0f) atomicAdd(&row[i], hist[i]);
  }
}

template <bool kHist>
int launch_finish(const float* xr, const float* xi, const void* tw,
                  const float* logmap_a, const float* logmap_b,
                  const float* power_floor, int* ids, float* out,
                  long long frames, int n, int n1, int n2, int hop,
                  float c_dh, float bin_scale, float hz_per_bin,
                  float inv_n2, int rows, int reach, int min_id, int num_bins,
                  int k_lo, int k_hi, const float* band, cudaStream_t st) {
  const int m = n >> 1;
  const int per_block = kHist ? kHistBinsPerBlock : kThreads;
  const int chunks = (m + 1 + per_block - 1) / per_block;
  const int smem = kHist ? (int)sizeof(float) * num_bins : 0;
  cudaError_t err = cudaFuncSetAttribute(
      finish_kernel<kHist>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  finish_kernel<kHist><<<(unsigned)(frames * chunks), kThreads, smem, st>>>(
      xr, xi, static_cast<const float2*>(tw), logmap_a, logmap_b,
      power_floor, ids, out, chunks, per_block, n, n1, n2, hop, c_dh,
      bin_scale, hz_per_bin, inv_n2, rows, reach, min_id, num_bins, k_lo,
      k_hi, band);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------- route cluster_large
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
  int* ids;                      // (frames, k_hi − k_lo)
  float* contrib;
  int n, log2n1, log2n2, log2c, hop;
  int wp, q;                     // tile strides: W' before, Q after the exchange
  float c_dh, bin_scale, hz_per_bin, inv_n2;
  int rows, reach, k_lo, k_hi;
  const float* band;             // (k_hi − k_lo) band weights, or null (1)
};

// Complex points a CTA holds (both signals): 8192 up to 131072 points,
// so that a CTA's tiles take 72 KB and three share an SM; 16384 at
// 262144, where a cluster of 16 CTAs (the most the card takes) needs them.
int xpoints(int n) { return n <= 131072 ? 8192 : 16384; }

// The cluster plan of N (n1·n2 = N/2): C = N/xpoints(N) CTAs a cluster
// (8, 16, 16), W' and Q with A·W' = W·Q (W = n2/C columns before, A =
// n1/C rows after the exchange) and both strides padded past W and A.
// False where N does not take the route.
bool xplan(int n, int n1, int n2, int* log2c, int* wp, int* q) {
  const int c = n / xpoints(n);
  if (n % xpoints(n) != 0 || (c != 8 && c != 16) || n1 * n2 * 2 != n
      || n1 % c != 0 || n2 % c != 0 || n1 / c < 16 || n2 / c < 16)
    return false;
  const int w = n2 / c, a = n1 / c;
  *log2c = c == 8 ? 3 : 4;
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
  const long long f = blockIdx.x >> lc;
  emspec::radix::load_table(w, a.w512);
  xload(tile, fs, a, f, rank);
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
  auto deposit = [&](int k, float2 X, float2 Am1, float2 Ap1, float2 Y) {
    int id;
    float contrib;
    emspec::deposit_at(k, X, Am1, Ap1, Y,
                       a.band == nullptr ? 1.0f : __ldg(a.band + k - a.k_lo),
                       c, &id, &contrib);
    a.ids[out0 + k] = id;
    a.contrib[out0 + k] = contrib;
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
  const int lane = threadIdx.x & 31;
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
    if (in_lo)
      deposit(j, X, ell == 0 ? (j == 0 ? conj(xp) : e) : xm,
              ell == run - 1 ? e : xp, Y);
    if (in_hi)
      deposit(m - j, Xm, ell == run - 1 ? em : hp,
              ell == 0 ? (j == 0 ? conj(hp) : em) : hm, Ym);
  }
  if (rank == 0 && threadIdx.x == 0 && (m >> 1) >= a.k_lo
      && (m >> 1) < a.k_hi) {                 // bin m/2
    float2 X, Xm, Y, Ym, b0, b1;
    pair_at(m >> 1, &X, &Xm, &Y, &Ym);
    pair_at((m >> 1) - 1, &b0, &b1, nullptr, nullptr);   // X[m/2 ∓ 1]
    deposit(m >> 1, X, b0, b1, Y);
  }
  cluster.sync();                             // no peer reads this tile any more
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

int xsmem(int n1, int wp) { return (int)sizeof(float2) * (kTable + 2 * n1 * wp); }

// The kernel's attributes: its shared memory, clusters above 8 CTAs.
cudaError_t xattributes() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        xcluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        xcluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return err;
}

}  // namespace

// B1, route cluster_large (N = 65536, 131072, 262144): the arguments of
// emspec_deposits (deposits.cu).  ids, contrib (frames, k_hi − k_lo).
extern "C" int emspec_deposits_cluster_large(
    const float* x, long long num_lead, long long frames_per_lead,
    long long lead_stride, long long frame_stride, const float* th,
    const void* w512, const void* tw4, const void* tw,
    const float* logmap_a, const float* logmap_b, const float* power_floor,
    int* ids, float* contrib, int n, int n1, int n2, int hop, float c_dh,
    float bin_scale, float hz_per_bin, float inv_n2, int rows, int reach,
    int k_lo, int k_hi, const float* band, void* stream) {
  int lc, wp, q;
  const int l1 = xlog2(n1), l2 = xlog2(n2);
  if (l1 < 4 || l2 < 4 || l1 > emspec::radix::kLog2Table
      || l2 > emspec::radix::kLog2Table || !xplan(n, n1, n2, &lc, &wp, &q)
      || k_lo < 0 || k_lo >= k_hi || k_hi > n / 2 + 1)
    return (int)cudaErrorInvalidValue;
  const XArgs a{x, frames_per_lead, lead_stride, frame_stride,
                (reinterpret_cast<std::uintptr_t>(x) % 16 == 0
                 && lead_stride % 4 == 0 && frame_stride % 4 == 0) ? 1 : 0,
                th, static_cast<const float2*>(w512),
                static_cast<const float2*>(tw4), static_cast<const float2*>(tw),
                logmap_a, logmap_b, power_floor, ids, contrib, n, l1, l2, lc,
                hop, wp, q, c_dh, bin_scale, hz_per_bin, inv_n2, rows, reach,
                k_lo, k_hi, band};
  const cudaError_t attr = xattributes();
  if (attr != cudaSuccess) return (int)attr;
  const long long frames = num_lead * frames_per_lead;
  if (frames == 0) return 0;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      xconfig(frames, lc, xpoints(n) / kXP, xsmem(n1, wp),
              (cudaStream_t)stream, &cluster);
  return (int)cudaLaunchKernelEx(&cfg, xcluster_kernel, a);
}

// How many clusters of route cluster_large at N (n1·n2 = N/2) the card
// holds at once (cudaOccupancyMaxActiveClusters) → *clusters; 0 where it
// holds none (a cluster size the card refuses).
extern "C" int emspec_deposits_cluster_large_occupancy(int n, int n1, int n2,
                                                       int* clusters) {
  int lc, wp, q;
  if (!xplan(n, n1, n2, &lc, &wp, &q)) return (int)cudaErrorInvalidValue;
  const cudaError_t attr = xattributes();
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      xconfig(64, lc, xpoints(n) / kXP, xsmem(n1, wp), nullptr, &cluster);
  return (int)cudaOccupancyMaxActiveClusters(clusters, xcluster_kernel, &cfg);
}

// Stage 1.  zr, zi: (2·frames, N/2) float32 planes, written whole.
extern "C" int emspec_deposits_pack(
    const float* x, long long num_lead, long long frames_per_lead,
    long long lead_stride, long long frame_stride, const float* th,
    float* zr, float* zi, int n, void* stream) {
  const long long frames = num_lead * frames_per_lead;
  if (frames == 0) return 0;
  const int m = n >> 1;
  const int chunks = (m + kThreads - 1) / kThreads;
  pack_kernel<<<(unsigned)(frames * chunks), kThreads, 0,
                (cudaStream_t)stream>>>(x, frames_per_lead, lead_stride,
                                        frame_stride, th, zr, zi, m, chunks);
  return (int)cudaGetLastError();
}

// Stage 3.  xr, xi: B4's output for the packed planes, (2·frames, n1, n2)
// with n1·n2 = N/2.  hist = 0: ids, contrib (frames, k_hi − k_lo), bins
// k_lo … k_hi − 1 in natural order, band: k_hi − k_lo weights or null.
// hist = 1 (B6): out (frames, num_bins), zeroed by the caller; ids unused,
// the window the whole spectrum.
extern "C" int emspec_deposits_finish(
    const float* xr, const float* xi, const void* tw, const float* logmap_a,
    const float* logmap_b, const float* power_floor, int* ids, float* out,
    long long frames, int n, int n1, int n2, int hop, float c_dh,
    float bin_scale, float hz_per_bin, float inv_n2, int rows, int reach,
    int min_id, int num_bins, int hist, int k_lo, int k_hi,
    const float* band, void* stream) {
  if (n1 * n2 != n / 2 || k_lo < 0 || k_lo >= k_hi || k_hi > n / 2 + 1
      || (hist && (k_lo != 0 || k_hi != n / 2 + 1 || band != nullptr)))
    return (int)cudaErrorInvalidValue;
  if (frames == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return hist ? launch_finish<true>(xr, xi, tw, logmap_a, logmap_b,
                                    power_floor, ids, out, frames, n, n1, n2,
                                    hop, c_dh, bin_scale, hz_per_bin, inv_n2,
                                    rows, reach, min_id, num_bins, k_lo, k_hi,
                                    band, st)
              : launch_finish<false>(xr, xi, tw, logmap_a, logmap_b,
                                     power_floor, ids, out, frames, n, n1,
                                     n2, hop, c_dh, bin_scale, hz_per_bin,
                                     inv_n2, rows, reach, min_id, num_bins,
                                     k_lo, k_hi, band, st);
}
