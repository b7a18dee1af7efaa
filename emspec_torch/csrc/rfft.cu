// The port's real FFT: float32 frames (..., N) → the real DFT's bins
// k = 0 … N/2 as complex64 (..., N/2 + 1), or their power |X|² as float32
// with non-finite power zeroed, for every power of two N = 256 … 262144,
// with an optional float32 window multiplied in as each sample loads.
//
// Replaces no Pallas kernel: it stands where the JAX package calls XLA's
// jnp.fft.rfft (emspec/pipeline.py:311 natural _bank_power, :402 the
// direct method's spectra; emspec/dsp/stft.py:29 stft, :214 the stencil
// pair's "xla" branch).  The JAX package resolves natural mode and
// multires to that rfft because it is bitwise batch-shape-stable, which
// makes streaming ≡ batch bit-exact (emspec/pipeline.py:203-207).  On the
// H100 cuFFT is not: a frame gets other bits by the number of frames in
// its batch (4096, 32768 and 65536 points), so a live hop (a batch of
// lanes) and the batch (t × lanes) disagree in the last bits.  Here a
// frame's arithmetic depends on N alone, never on the batch or on the
// frame's place in it, so b = 1 gives frame f of any batch bit for bit.
//
// Each real spectrum is an m = N/2-point complex FFT of the frame's
// even/odd-packed samples z[i] = s[2i] + i·s[2i+1] and the one-signal
// real-input unpack X[k] = E[k] + W_N^k·O[k] (deposits_common.cuh's
// unpack_pair, as kernel B1 computes each of its two spectra; two signals
// are never packed into one transform).  The FFT body is kernel B4's
// (radix_common.cuh): with (n1, n2) = dsp/fourstep.py _FACTORS[m], z lies
// in a shared tile of n1 rows padded to n2 + 1 in B4's step-1 layout,
// line_fft runs steps 1–3 as B4's small_kernel does, and Z[k] is read at
// the step-4 address (k mod n1)·(n2 + 1) + k div n1.  Twiddles: B4's
// W_512 and step-2 tables and the unpack's e^{−2πij/N}, each built in
// float64 on the host and rounded once (dsp/kernels/rfft.py).
//
// Routes, by N alone (dsp/kernels/rfft.py route_of; the wrapper forces
// another for timing and comparison only, route=):
//   * "full", N = 256: m = 128 has no B4 factorization, so the block runs
//     the 256-point complex transform of x + 0i at 16 × 16 and reads the
//     bins 0 … 128 as they are (dsp/fourstep.py rfft_fourstep does the
//     same);
//   * "block", N = 512 … 8192 (this file; 16384 and 32768 forced only,
//     the route there before the cluster's): F frames a block (F·m >=
//     2048, so >= 128 threads), each frame's tile loaded straight from the
//     frame through its strides (the framing unfold view and the stream's
//     window slices go in uncopied), steps 1–3 in shared memory, then each
//     bin unpacked from Z[k] and Z[m − k] and stored in natural order: one
//     launch, no scratch.  One tile is 132 KB at m = 16384, inside a
//     block's 227 KB;
//   * "cluster", N = 16384 … 262144 (rfft_cluster.cu): a frame a
//     thread-block cluster, its four-step transform across the cluster's
//     shared memory, one launch;
//   * "large", N = 65536 … 262144: three launches (kernel B1's route
//     "large" with one signal): pack (this file: each frame read once
//     through its strides into two contiguous (b, m) planes), B4's large
//     route on the planes (two launches through its scratch; the wrapper
//     calls it), unpack (this file: thread q reads Z at address q, so a
//     warp reads consecutive addresses of Z and of its mirror Z[m − k] in
//     reverse, and stores bin k = q div n2 + n1·(q mod n2); the bin N/2 is
//     the extra thread q = m).  Scratch comes from the wrapper's
//     torch.empty.  The route before the cluster's, kept for timing and
//     comparison.
// Every route runs the same lines through the same passes (a line's
// arithmetic depends on its length, the radix sequence and the two
// tables, not on who runs it) and the same unpack, so a frame gets the
// same bits on each (tests/test_torch_cuda.py holds them equal).
//
// The block route's load: each thread starts all of its frames' sample
// loads, 16 bytes at a time where the frames' address and strides allow
// (8, else 4; rfft_common.cuh's load_groups), with B4's table loads in
// flight beside them, before it waits for any; its unpack starts a batch
// of twiddle loads before it unpacks any bin, and finds frame and bin by
// shift and mask.
//
// The power form stores fl(fl(Re²) + fl(Im²)) with __fmul_rn/__fadd_rn, so
// nvcc does not contract it into an FMA: the kernel's power is bit for
// bit what plain PyTorch computes from the kernel's spectrum (X.real²
// + X.imag², two roundings).  Non-finite power (a NaN or ±Inf sample
// poisons its frame's whole spectrum) stores 0, as
// torch.where(isfinite(power), power, 0).  The window multiply is
// __fmul_rn too: one rounding, as frames * window rounds.
//
// What bounds it on the H100: device memory moves 4·N bytes in a frame
// (fewer where frames overlap) and 8·(N/2 + 1) out (4·(N/2 + 1) as
// power); an FFT's 5·(N/2)·log2(N/2) operations a frame are far below the
// float32 rate at that traffic.  On the block route the pace is set on
// chip by the shared-memory passes (one or two blocks an SM, whose load,
// passes and unpack run one after another) and, at b = 1, by the latency
// of one block's passes; the large route moves ~40·N bytes a frame
// through its planes and B4's scratch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cuda_runtime.h>

#include "rfft_common.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kLog2BlockPoints = 11;       // block route: F·m >= 2048
constexpr int kBlockMaxLog2M = 14;         // block route: m <= 16384
constexpr int kFullN = 256;                // route "full": 16 × 16
constexpr int kLargeThreads = 256;
constexpr int kBinBatch = 4;               // twiddle loads in flight a thread
constexpr int kBlockSmem =                 // the table and a 128 × 129 tile
    (int)sizeof(float2) * (kTable + 128 * 129);

// The block route's load: B4's table and the block's F frames' samples
// (group g of 4 samples: frame g >> lg, samples 4·(g mod 2^lg) on, the
// points (g mod 2^lg)·2 (packed) or ·4 on), `groups` a thread, only the
// block's frames' walked.  A ragged last block (or a batch of fewer than
// F frames) leaves its missing frames' tiles unread: their lines run on
// whatever the shared memory holds and are never stored.  Not inlined,
// so that its loads in flight take registers apart from the passes'.
__device__ __noinline__ void block_load(float2* w, float2* tile,
                                        const Frames a,
                                        const float2* __restrict__ w512,
                                        long long f0, int frames, int groups,
                                        int lg, int log2n2, int fs,
                                        int packed) {
  float2 tv[kTableLoads];
  table_fetch(tv, w512);
  const float* fr0 = frame_at(a, f0);
  const int n2 = 1 << log2n2;
  const int live = ((frames << lg) + blockDim.x - 1) / blockDim.x;
  load_groups(tile, a, live < groups ? live : groups, packed,
              [=](int g, const float** fr, int* off) {
                const int j = g >> lg, e = g & ((1 << lg) - 1);
                if (j >= frames) return -1;
                *fr = j == 0 ? fr0 : frame_at(a, f0 + j);
                *off = e << 2;
                const int i = packed ? e << 1 : e << 2;
                return j * fs + (i >> log2n2) * (n2 + 1) + (i & (n2 - 1));
              });
  table_put(w, tv);
}

// The block route's bins: bins 0 … 2^lb − 1 of each frame, `per` a
// thread at g = t + q·T (frame g >> lb; only the block's frames'
// slots walked), kBinBatch twiddle loads started before any bin is
// unpacked; then the last bin 2^lb of each frame.  Z[k] at
// (k mod n1)·(n2 + 1) + k div n1.
template <bool kPower>
__device__ __forceinline__ void block_store(const float2* tile,
                                         const float2* __restrict__ tw,
                                         float2* __restrict__ spec,
                                         float* __restrict__ power,
                                         long long f0, int frames, int per,
                                         int log2n1, int log2n2, int packed) {
  const int log2m = log2n1 + log2n2;
  const int m = 1 << log2m, n1 = 1 << log2n1, n2 = 1 << log2n2;
  const int fs = n1 * (n2 + 1);
  const int lb = packed ? log2m : log2m - 1;
  const long long bins = (1LL << lb) + 1;
  auto bin = [&](int j, int k, float2 wk) {
    const float2* Z = tile + j * fs;
    float2 X;
    if (packed) {
      const int kl = k > (m >> 1) ? m - k : k;
      const int km = kl == 0 ? 0 : m - kl;
      X = unpack_at(k, m, Z[(kl & (n1 - 1)) * (n2 + 1) + (kl >> log2n1)],
                    Z[(km & (n1 - 1)) * (n2 + 1) + (km >> log2n1)], wk);
    } else {
      X = Z[(k & (n1 - 1)) * (n2 + 1) + (k >> log2n1)];
    }
    store_bin<kPower>(X, spec, power, (f0 + j) * bins + k);
  };
  const int live = (int)((((long long)frames << lb) + blockDim.x - 1)
                         / blockDim.x);
  if (live < per) per = live;
  for (int q0 = 0; q0 < per; q0 += kBinBatch) {
    float2 wv[kBinBatch] = {};
#pragma unroll
    for (int q = 0; q < kBinBatch; ++q) {
      const int g = threadIdx.x + (q0 + q) * blockDim.x;
      const int k = g & ((1 << lb) - 1);
      if (packed && (g >> lb) < frames)
        wv[q] = __ldg(tw + (k > (m >> 1) ? m - k : k));
    }
#pragma unroll
    for (int q = 0; q < kBinBatch; ++q) {
      const int g = threadIdx.x + (q0 + q) * blockDim.x;
      if ((g >> lb) < frames) bin(g >> lb, g & ((1 << lb) - 1), wv[q]);
    }
  }
  for (int j = threadIdx.x; j < frames; j += blockDim.x)
    bin(j, 1 << lb, packed ? __ldg(tw) : make_float2(0.0f, 0.0f));
}

// Routes "full" and "block": F = 2^log2f frames a block, T = F·m'/P
// threads (m' = n1·n2, the transform's points).  packed: m' = N/2 and
// the bins are unpacked; else (N = 256) m' = N and bins 0 … N/2 are read
// as they are.  P = 16 asks for two blocks an SM, as B4's small_kernel.
template <int P, bool kPower>
__global__ void __launch_bounds__(kMaxThreads, P == 16 ? 2 : 1)
    real_dft_block_kernel(const Frames a, long long b,
                          const float2* __restrict__ w512,
                          const float2* __restrict__ tw4,
                          const float2* __restrict__ tw,
                          float2* __restrict__ spec,
                          float* __restrict__ power, int log2n1, int log2n2,
                          int log2f, int packed) {
  extern __shared__ float2 sm[];
  float2* w = sm;
  float2* tile = sm + kTable;                 // F tiles of (n1, n2 + 1)
  const int log2m = log2n1 + log2n2;
  const int fs = (1 << log2n1) * ((1 << log2n2) + 1);
  const long long f0 = (long long)blockIdx.x << log2f;
  const int frames = b - f0 < (1 << log2f) ? (int)(b - f0) : 1 << log2f;
  int slot = 0;
  RFFT_STAMP(slot++);
  block_load(w, tile, a, w512, f0, frames, packed ? P / 2 : P / 4,
             packed ? log2m - 1 : log2m - 2, log2n2, fs, packed);
  __syncthreads();
  RFFT_STAMP(slot++);
  // steps 1+2: n1-point FFTs down the F·n2 columns, TW on the last pass
  lines_fft<P>(tile, w, Lines{log2f + log2n2, log2n2, fs, 1,
                              (1 << log2n2) + 1},
               log2n1, Step2{tw4, log2n2, 0}, &slot);
  // step 3: n2-point FFTs along the F·n1 rows
  lines_fft<P>(tile, w, Lines{log2f + log2n1, 0, (1 << log2n2) + 1, 0, 1},
               log2n2, Step2{nullptr, 0, 0}, &slot);
  block_store<kPower>(tile, tw, spec, power, f0, frames, packed ? P : P / 2,
                      log2n1, log2n2, packed);
  RFFT_STAMP(slot++);
}

// Route "large", launch 1: frame f's packed z into the planes zr, zi at
// f·m + i, one thread a sample pair.
__global__ void __launch_bounds__(kLargeThreads) real_dft_pack_kernel(
    const Frames a, float* __restrict__ zr, float* __restrict__ zi,
    int log2m, int chunks) {
  const long long f = blockIdx.x / chunks;
  const int i = (blockIdx.x % chunks) * blockDim.x + threadIdx.x;
  if (i >= 1 << log2m) return;
  const float* fr = frame_at(a, f);
  const long long at = (f << log2m) + i;
  zr[at] = sample(a, fr, 2 * i);
  zi[at] = sample(a, fr, 2 * i + 1);
}

// Route "large", launch 3: B4's output planes X[k1, k2] (Z[j] at
// (j mod n1)·n2 + j div n1, frame f's at f·m) → bins 0 … m.  Thread q
// reads Z at address q, which holds Z[k] for k = q div n2 + n1·(q mod n2),
// and its mirror Z[m − k]; the extra thread q = m stores the bin m.
template <bool kPower>
__global__ void __launch_bounds__(kLargeThreads) real_dft_unpack_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const float2* __restrict__ tw, float2* __restrict__ spec,
    float* __restrict__ power, int log2n1, int log2n2, int chunks) {
  const int log2m = log2n1 + log2n2;
  const int m = 1 << log2m;
  const long long f = blockIdx.x / chunks;
  const int q = (blockIdx.x % chunks) * blockDim.x + threadIdx.x;
  if (q > m) return;
  const int k = q == m ? m
                       : (q >> log2n2) + ((q & ((1 << log2n2) - 1)) << log2n1);
  const int kl = k > (m >> 1) ? m - k : k;
  const int km = kl == 0 ? 0 : m - kl;
  const long long base = f << log2m;
  const long long a0 = base + ((long long)(kl & ((1 << log2n1) - 1)) << log2n2)
                       + (kl >> log2n1);
  const long long a1 = base + ((long long)(km & ((1 << log2n1) - 1)) << log2n2)
                       + (km >> log2n1);
  const float2 X = unpack_at(k, m, make_float2(__ldg(xr + a0), __ldg(xi + a0)),
                             make_float2(__ldg(xr + a1), __ldg(xi + a1)),
                             __ldg(tw + kl));
  store_bin<kPower>(X, spec, power, f * (m + 1) + k);
}

template <bool kPower>
int launch_block(const Frames& a, long long b, const float2* w512,
                 const float2* tw4, const float2* tw, float2* spec,
                 float* power, int l1, int l2, int packed, cudaStream_t st) {
  static const cudaError_t attr16 =
      allow_smem(real_dft_block_kernel<16, kPower>, kBlockSmem);
  static const cudaError_t attr32 =
      allow_smem(real_dft_block_kernel<32, kPower>, kBlockSmem);
  if (attr16 != cudaSuccess) return (int)attr16;
  if (attr32 != cudaSuccess) return (int)attr32;
  const int log2m = l1 + l2;
  const int log2f = log2m < kLog2BlockPoints ? kLog2BlockPoints - log2m : 0;
  const int smem = (int)sizeof(float2)
                   * (kTable + ((1 << l1) << log2f) * ((1 << l2) + 1));
  const unsigned blocks = (unsigned)((b + (1 << log2f) - 1) >> log2f);
  if (log2m < kBlockMaxLog2M)
    real_dft_block_kernel<16, kPower>
        <<<blocks, (1 << (log2m + log2f)) / 16, smem, st>>>(
            a, b, w512, tw4, tw, spec, power, l1, l2, log2f, packed);
  else
    real_dft_block_kernel<32, kPower>
        <<<blocks, (1 << (log2m + log2f)) / 32, smem, st>>>(
            a, b, w512, tw4, tw, spec, power, l1, l2, log2f, packed);
  return (int)cudaGetLastError();
}

}  // namespace

// Routes "full" (N = 256, n1 = n2 = 16) and "block" (N = 512 … 32768,
// n1·n2 = N/2 = fourstep._FACTORS): frames read through
// (num_lead, frames_per_lead, lead_stride, frame_stride), window N floats
// or null; w512, tw4: B4's tables for (n1, n2); tw: e^{−2πij/N}, j < N/2.
// Exactly one of spec (complex64, (frames, N/2 + 1)) and power (float32,
// the same shape) is given.
extern "C" int emspec_rfft(
    const float* x, long long num_lead, long long frames_per_lead,
    long long lead_stride, long long frame_stride, const float* window,
    const void* w512, const void* tw4, const void* tw, void* spec,
    float* power, int n, int n1, int n2, void* stream) {
  const int l1 = log2_of(n1), l2 = log2_of(n2);
  const bool packed = (long long)n1 * n2 * 2 == n;
  if (l1 < 4 || l2 < 4 || l1 > kLog2Table || l2 > kLog2Table
      || l1 + l2 > kBlockMaxLog2M || (!packed && !(n == kFullN && n1 * n2 == n))
      || (spec == nullptr) == (power == nullptr) || frames_per_lead <= 0)
    return (int)cudaErrorInvalidValue;
  const long long b = num_lead * frames_per_lead;
  if (b == 0) return 0;
  const Frames a{x, frames_per_lead, lead_stride, frame_stride, window,
                 load_width(x, num_lead, frames_per_lead, lead_stride,
                            frame_stride, window)};
  const float2* w = static_cast<const float2*>(w512);
  const float2* t4 = static_cast<const float2*>(tw4);
  const float2* t = static_cast<const float2*>(tw);
  cudaStream_t st = (cudaStream_t)stream;
  return power != nullptr
             ? launch_block<true>(a, b, w, t4, t, nullptr, power, l1, l2,
                                  packed, st)
             : launch_block<false>(a, b, w, t4, t, static_cast<float2*>(spec),
                                   nullptr, l1, l2, packed, st);
}

#ifdef EMSPEC_RFFT_STAMPS
// The stamped build's stamp rows of this file's block kernel: (blocks,
// kStampSlots) int64, or null.
extern "C" int emspec_rfft_stamps(void* rows) {
  return (int)cudaMemcpyToSymbol(g_stamps, &rows, sizeof(rows));
}
#endif

// Route "large", launch 1: zr, zi (frames, N/2) float32 planes, written
// whole.
extern "C" int emspec_rfft_pack(
    const float* x, long long num_lead, long long frames_per_lead,
    long long lead_stride, long long frame_stride, const float* window,
    float* zr, float* zi, int n, void* stream) {
  const int log2m = log2_of(n) - 1;
  if (log2m < 1 || frames_per_lead <= 0) return (int)cudaErrorInvalidValue;
  const long long b = num_lead * frames_per_lead;
  if (b == 0) return 0;
  const int chunks = ((1 << log2m) + kLargeThreads - 1) / kLargeThreads;
  const Frames a{x, frames_per_lead, lead_stride, frame_stride, window, 1};
  real_dft_pack_kernel<<<(unsigned)(b * chunks), kLargeThreads, 0,
                (cudaStream_t)stream>>>(a, zr, zi, log2m, chunks);
  return (int)cudaGetLastError();
}

// Route "large", launch 3: xr, xi: B4's output for the planes, (frames,
// n1, n2) with n1·n2 = N/2; tw: e^{−2πij/N}, j < N/2.  Exactly one of
// spec (complex64) and power (float32), each (frames, N/2 + 1).
extern "C" int emspec_rfft_unpack(
    const float* xr, const float* xi, const void* tw, void* spec,
    float* power, long long frames, int n, int n1, int n2, void* stream) {
  const int l1 = log2_of(n1), l2 = log2_of(n2);
  if (l1 < 0 || l2 < 0 || (long long)n1 * n2 * 2 != n
      || (spec == nullptr) == (power == nullptr))
    return (int)cudaErrorInvalidValue;
  if (frames == 0) return 0;
  const int m = n >> 1;
  const int chunks = (m + 1 + kLargeThreads - 1) / kLargeThreads;
  const unsigned blocks = (unsigned)(frames * chunks);
  const float2* t = static_cast<const float2*>(tw);
  cudaStream_t st = (cudaStream_t)stream;
  if (power != nullptr)
    real_dft_unpack_kernel<true><<<blocks, kLargeThreads, 0, st>>>(
        xr, xi, t, nullptr, power, l1, l2, chunks);
  else
    real_dft_unpack_kernel<false><<<blocks, kLargeThreads, 0, st>>>(
        xr, xi, t, static_cast<float2*>(spec), nullptr, l1, l2, chunks);
  return (int)cudaGetLastError();
}
