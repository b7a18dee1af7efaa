// The port's real FFT, route "cluster": float32 frames (..., N) → the
// real DFT's bins 0 … N/2 (complex64, or float32 power with the scrub)
// for N = 16384 … 262144, one launch, a frame a thread-block cluster.
// Replaces no Pallas kernel (rfft.cu says where it stands); it replaces
// this kernel's own three-launch route "large" (pack → B4 → unpack,
// ~40·N bytes a frame through two planes and B4's scratch) and, where the
// wrapper routes N here, the block route's one CTA a frame.
//
// With m = N/2 = n1·n2 (dsp/fourstep.py _FACTORS[m], the factors every
// route uses) and z[i] = s[2i] + i·s[2i+1], a frame's m-point transform
// is spread over a cluster of C CTAs (C by N alone, the wrapper's
// cluster_plan; the plan is B1's route cluster_large, xcluster.cuh, with
// one signal where B1 has two, so a CTA holds m/C points):
//   1. load: rank r reads columns [r·W, (r + 1)·W) (W = n2/C) of the
//      (n1, n2) view of z, 2W consecutive samples a row, straight from the
//      framing view through its strides, the window multiplied in on the
//      way (16-byte loads where address and strides allow, every load of
//      a thread started before any is waited for: rfft_common.cuh), into a
//      tile of n1 rows at stride W';
//   2. steps 1+2: n1-point column FFTs of B4's radix body
//      (radix_common.cuh, unchanged) down the W columns, TW[k1, r·W + c]
//      on the last pass — the lines B4's large route runs in its first
//      launch;
//   3. the four-step transpose across the cluster, over distributed shared
//      memory (xcluster.cuh's exchange with one signal): afterwards rank r
//      holds rows k1 in [r·A, (r + 1)·A) (A = n1/C) of every column,
//      column-major at stride Q (A·W' = W·Q).  In round j rank r reads its
//      rows of the columns of rank p = r xor j from p's tile — the block
//      of r's own tile that p reads in the same round — so after a cluster
//      sync r stores what it read there, transposed.  C rounds in two
//      groups of C/2, 8 values a thread in registers, one cluster sync
//      between a group's reads and its stores: no staging buffer;
//   4. step 3: n2-point row FFTs along the A rows, in place — the lines of
//      B4's second launch;
//   5. a cluster sync, then the one-signal unpack: rank r takes the
//      j = k1 + n1·k2 < m/2 of its rows (runs of A consecutive j, 8 a
//      thread, their twiddle loads started together) and, for each, the
//      bins j and m − j from one unpack of the pair Z[j], Z[m − j] (Z[j]
//      from its own tile, Z[m − j] from the rank that holds row
//      (m − j) mod n1, through distributed shared memory); rank 0 also the
//      bin m/2.  Spectrum or power (rfft_common.cuh's store_bin: the
//      scrub, no FMA) stored in natural order.  A last cluster sync keeps
//      every tile alive until no peer reads it.
// The lines run through the same passes, tables and unpack as on the
// block and large routes, so a frame's bits are the same on every route
// (the card tests hold them equal) and depend on N alone.
//
// Shared memory a CTA: B4's W_512 table and one tile of m/C points plus
// padding (39 KB at 65536 in 8 CTAs of 256 threads; 74 KB at 262144 in
// 16 CTAs of 512).  Clusters above 8 CTAs are non-portable: the wrapper
// asks cudaOccupancyMaxActiveClusters (emspec_rfft_cluster_occupancy)
// before its first launch and refuses a size the card cannot hold.
// What bounds it on the H100: device memory moves 4·N bytes in and
// 8·(N/2 + 1) out a frame; at b = 1 the pace is set by the latency of
// the passes, the exchange's two rounds and the cluster syncs; at large
// b by the shared-memory passes and the exchange's DSMEM traffic (8·N
// bytes a frame across the cluster).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "rfft_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCMaxThreads = 1024;
constexpr int kCP = 16;                   // FFT points a thread
constexpr int kCHeld = 8;                 // exchange values a thread holds
constexpr int kCPairs = 8;                // unpacked pairs a thread
constexpr int kCMaxSmem = 232448;         // a block's most on the H100

struct CArgs {
  Frames fr;
  const float2* w512;            // B4's W_512^t table
  const float2* tw4;             // B4's step-2 TW, (n1, n2)
  const float2* tw;              // unpack: e^{−2πij/N}, j < N/2
  float2* spec;                  // (frames, N/2 + 1), or null
  float* power;                  // (frames, N/2 + 1), or null
  int log2n1, log2n2, log2c;
  int wp, q;                     // tile strides: W' before, Q after the exchange
};

// The cluster plan of (n1, n2) at C = 2^log2c: W' and Q with A·W' = W·Q
// (W = n2/C, A = n1/C, both >= 16), both padded past W and A; threads
// m/(16·C) in [128, 1024]; shared bytes.  False where it does not hold.
bool cplan(int n1, int n2, int log2c, int* wp, int* q, int* threads,
           int* smem) {
  const int c = 1 << log2c;
  if (log2c < 1 || log2c > 4 || n1 % c != 0 || n2 % c != 0 || n1 / c < 16
      || n2 / c < 16)
    return false;
  const int w = n2 / c, a = n1 / c;
  if (w % a == 0) {
    *q = a + 1;
    *wp = w + w / a;
  } else {
    *wp = w + 1;
    *q = a + a / w;
  }
  *threads = n1 * n2 / c / kCP;
  *smem = (int)sizeof(float2) * (kTable + n1 * *wp);
  return *threads >= kMinThreads && *threads <= kCMaxThreads
         && *smem <= kCMaxSmem;
}

// Step 1: B4's table and rank r's columns [r·W, (r + 1)·W) of frame
// f's z: group g (4 samples: z[i], z[i + 1]) → row g div (W/2), columns
// r·W + c, c + 1 with c = 2·(g mod W/2), 8 groups a thread.  Not inlined,
// so that its loads in flight take registers apart from the passes'.
__device__ __noinline__ void cluster_load(float2* w, float2* tile,
                                          const Frames a,
                                          const float2* __restrict__ w512,
                                          long long f, int rank, int l2,
                                          int lw, int wp) {
  float2 tv[kTableLoads];
  table_fetch(tv, w512);
  const float* fr = frame_at(a, f);
  load_groups(tile, a, kCP / 2, true,
              [=](int g, const float** p, int* off) {
                const int row = g >> (lw - 1);
                const int c = (g & ((1 << (lw - 1)) - 1)) << 1;
                *p = fr;
                *off = ((row << l2) + (rank << lw) + c) << 1;
                return row * wp + c;
              });
  table_put(w, tv);
}

// Step 5: rank r's pairs qq = (k2 << la) + ℓ → j = r·A + ℓ + n1·k2 < m/2
// (8 a thread, their twiddle loads started together), bins j and m − j
// from one unpack of Z[j] (own tile) and Z[m − j] (its row's rank); rank
// 0 also bin m/2 (row 0, column n2/2).  Z[j] lies on rank
// (j mod n1) div A at (j div n1)·Q + j mod A.  Not inlined.
template <bool kPower>
__device__ __noinline__ void cluster_store(const CArgs a, const float2* tile,
                                           long long f, int rank) {
  cg::cluster_group cluster = cg::this_cluster();
  const int l1 = a.log2n1, l2 = a.log2n2, la = a.log2n1 - a.log2c;
  const int q = a.q, m = 1 << (l1 + l2);
  const long long out0 = f * (long long)(m + 1);
  float2 wv[kCPairs];
#pragma unroll
  for (int i = 0; i < kCPairs; ++i) {
    const int qq = threadIdx.x + i * blockDim.x;
    wv[i] = __ldg(a.tw + (rank << la) + (qq & ((1 << la) - 1))
                  + ((qq >> la) << l1));
  }
#pragma unroll
  for (int i = 0; i < kCPairs; ++i) {
    const int qq = threadIdx.x + i * blockDim.x;
    const int ell = qq & ((1 << la) - 1);
    const int j = (rank << la) + ell + ((qq >> la) << l1);
    const int jm = j == 0 ? 0 : m - j;
    const int row = jm & ((1 << l1) - 1);
    const int owner = row >> la;
    const float2* t =
        owner == rank ? tile : cluster.map_shared_rank(tile, owner);
    float2 lo, hi;
    emspec::unpack_pair(tile[(qq >> la) * q + ell],
                        t[(jm >> l1) * q + (row & ((1 << la) - 1))], wv[i],
                        &lo, &hi);
    store_bin<kPower>(lo, a.spec, a.power, out0 + j);
    store_bin<kPower>(hi, a.spec, a.power, out0 + m - j);
  }
  if (rank == 0 && threadIdx.x == 0) {
    const float2 z = tile[(1 << (l2 - 1)) * q];
    store_bin<kPower>(unpack_at(m >> 1, m, z, z, __ldg(a.tw + (m >> 1))),
                      a.spec, a.power, out0 + (m >> 1));
  }
}

template <bool kPower>
__global__ void __launch_bounds__(kCMaxThreads)
    real_dft_cluster_kernel(const CArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  extern __shared__ float2 sm[];
  float2* w = sm;
  float2* tile = sm + kTable;
  const int l1 = a.log2n1, l2 = a.log2n2, lc = a.log2c;
  const int lw = l2 - lc, la = l1 - lc;
  const int wp = a.wp, q = a.q;
  const long long f = blockIdx.x >> lc;
  int slot = 0;
  RFFT_STAMP(slot++);
  cluster_load(w, tile, a.fr, a.w512, f, rank, l2, lw, wp);
  __syncthreads();
  RFFT_STAMP(slot++);
  // 2. steps 1+2: n1-point FFTs down the W columns, TW on the last pass
  lines_fft<kCP>(tile, w, Lines{lw, lw, 0, 1, wp}, l1,
                 Step2{a.tw4, l2, rank << lw}, &slot);
  cluster.sync();                             // every column FFT done
  // 3. the exchange, two groups of C/2 rounds: element e of a group is
  // round e >> (la + lw), local row (e >> lw) mod A, column e mod W
  for (int grp = 0; grp < 2; ++grp) {
    float2 v[kCHeld];
#pragma unroll
    for (int i = 0; i < kCHeld; ++i) {
      const int e = threadIdx.x + i * blockDim.x;
      const int p = rank ^ ((grp << (lc - 1)) + (e >> (la + lw)));
      const float2* src = cluster.map_shared_rank(tile, p);
      v[i] = src[((rank << la) + ((e >> lw) & ((1 << la) - 1))) * wp
                 + (e & ((1 << lw) - 1))];
    }
    cluster.sync();                           // every read of the group done
#pragma unroll
    for (int i = 0; i < kCHeld; ++i) {
      const int e = threadIdx.x + i * blockDim.x;
      const int p = rank ^ ((grp << (lc - 1)) + (e >> (la + lw)));
      tile[((p << lw) + (e & ((1 << lw) - 1))) * q
           + ((e >> lw) & ((1 << la) - 1))] = v[i];
    }
  }
  __syncthreads();
  RFFT_STAMP(slot++);
  // 4. step 3: n2-point FFTs along the A rows
  lines_fft<kCP>(tile, w, Lines{la, la, 0, 1, q}, l2, Step2{nullptr, 0, 0},
                 &slot);
  cluster.sync();                             // every spectrum transformed
  // 5. the unpack and the store
  cluster_store<kPower>(a, tile, f, rank);
  RFFT_STAMP(slot++);
  cluster.sync();                             // no peer reads this tile any more
}

// The kernel's attributes, once: its shared memory, clusters above 8.
template <bool kPower>
cudaError_t cattributes() {
  static const cudaError_t err = [] {
    cudaError_t e = allow_smem(real_dft_cluster_kernel<kPower>, kCMaxSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(real_dft_cluster_kernel<kPower>,
                                cudaFuncAttributeNonPortableClusterSizeAllowed,
                                1);
  }();
  return err;
}

// The launch of `frames` clusters of 2^log2c CTAs.
cudaLaunchConfig_t cconfig(long long frames, int log2c, int threads,
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

}  // namespace

// Route "cluster": frames read through (num_lead, frames_per_lead,
// lead_stride, frame_stride), window N floats or null; w512, tw4: B4's
// tables for (n1, n2), n1·n2 = N/2; tw: e^{−2πij/N}, j < N/2; clusters
// of 2^log2c CTAs.  Exactly one of spec (complex64, (frames, N/2 + 1))
// and power (float32, the same shape) is given.
extern "C" int emspec_rfft_cluster(
    const float* x, long long num_lead, long long frames_per_lead,
    long long lead_stride, long long frame_stride, const float* window,
    const void* w512, const void* tw4, const void* tw, void* spec,
    float* power, int n, int n1, int n2, int log2c, void* stream) {
  const int l1 = log2_of(n1), l2 = log2_of(n2);
  int wp, q, threads, smem;
  if (l1 < 4 || l2 < 4 || l1 > kLog2Table || l2 > kLog2Table
      || (long long)n1 * n2 * 2 != n
      || !cplan(n1, n2, log2c, &wp, &q, &threads, &smem)
      || (spec == nullptr) == (power == nullptr) || frames_per_lead <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t attr = power != nullptr ? cattributes<true>()
                                            : cattributes<false>();
  if (attr != cudaSuccess) return (int)attr;
  const long long b = num_lead * frames_per_lead;
  if (b == 0) return 0;
  const CArgs a{Frames{x, frames_per_lead, lead_stride, frame_stride, window,
                       load_width(x, num_lead, frames_per_lead, lead_stride,
                                  frame_stride, window)},
                static_cast<const float2*>(w512),
                static_cast<const float2*>(tw4),
                static_cast<const float2*>(tw), static_cast<float2*>(spec),
                power, l1, l2, log2c, wp, q};
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      cconfig(b, log2c, threads, smem, (cudaStream_t)stream, &cluster);
  return (int)(power != nullptr
                   ? cudaLaunchKernelEx(&cfg, real_dft_cluster_kernel<true>, a)
                   : cudaLaunchKernelEx(&cfg, real_dft_cluster_kernel<false>,
                                        a));
}

// How many clusters of the plan (n1, n2, 2^log2c) the card holds at once
// → *clusters (0: a cluster size it refuses).
extern "C" int emspec_rfft_cluster_occupancy(int n1, int n2, int log2c,
                                             int* clusters) {
  int wp, q, threads, smem;
  if (log2_of(n1) < 4 || log2_of(n2) < 4
      || !cplan(n1, n2, log2c, &wp, &q, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  const cudaError_t attr = cattributes<false>();
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      cconfig(64, log2c, threads, smem, nullptr, &cluster);
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, real_dft_cluster_kernel<false>, &cfg);
}

#ifdef EMSPEC_RFFT_STAMPS
// The stamped build's stamp rows of the cluster kernel: (CTAs,
// kStampSlots) int64, or null.
extern "C" int emspec_rfft_cluster_stamps(void* rows) {
  return (int)cudaMemcpyToSymbol(g_stamps, &rows, sizeof(rows));
}
#endif
