// Kernel B4: four-step steps 1–3 of a complex DFT, per frame, as radix
// FFTs in shared memory.
//
// Replaces emspec/dsp/pallas/fft4.py::fft4_steps123 (_fft4_kernel,
// _fft4_frame).  With z reshaped row-major to (n1, n2):
//   step 1   A[k1, c]  = Σ_j z[j, c]·W_n1^{j·k1}     n2 column FFTs of n1 points
//   step 2   B = A ∘ TW,  TW[k1, c] = W_n^{k1·c}
//   step 3   X[k1, k2] = Σ_c B[k1, c]·W_n2^{c·k2}    n1 row FFTs of n2 points
// (W_m = e^{−2πi/m}).  The caller does the step-4 reindex (k = k1 + n1·k2),
// as on the TPU.  The TPU kernel evaluates steps 1 and 3 as dense DFT
// products on its MXU; here they are FFTs of the same function.
//
// Why FFTs and not dense products on the tensor cores: dense products do
// 8·n·(n1 + n2) flops a frame, 17× an FFT's 5·n·log2 n at 64 × 64.  Full
// float32 accuracy on the tensor cores needs a 3-pass TF32 split, and even
// at the ~165 TFLOP/s that split allows the products would take 0.15 ms at
// 5937 × 64 × 64 and 0.28 ms at 1376 × 128 × 128 — above the byte bounds
// of 0.116 and 0.108 ms.  A radix body's arithmetic takes ~0.02 ms at the
// float32 peak there, so only device-memory bytes bound it: 16·n bytes a
// frame (z in, X out) on the small route, twice that on the large one.
//
// Sub-FFTs: Stockham autosort passes of radix 16, the last pass of a line
// taking the remainder (2, 4 or 8): a line of m points takes
// ceil(log16 m) passes.  In a pass every thread holds P points (P/R
// butterflies) in registers: it loads them, the block syncs, it applies
// the inter-pass twiddles, runs its radix-R DFTs in registers, stores the
// results at their autosorted places in the same buffer, and the block
// syncs.  Thread t takes butterflies t + g·T (g < P/R, T threads); a
// butterfly is (line L, j) = (job mod lines, job div lines), so
// consecutive threads take consecutive lines.  Rows of a shared tile are
// padded by one complex value (row stride n2 + 1 float2): the column
// passes then read and write consecutive addresses and the row passes a
// stride of 2·n2 + 2 ≡ 2 (mod 32) words, neither with bank conflicts.
//
// Twiddles: the inter-pass W_{Ns·R}^{k·r} = W_512^{k·r·512/(Ns·R)} from a
// table of W_512^t (t < 512, staged in shared memory) and TW from an
// (n1, n2) table in device memory, both built in float64 on the host and
// cast to float32 (emspec_torch/dsp/kernels/fourstep.py::radix_tables).
// The radix-R DFTs' own W_16^t are float32 constants of the same values
// (W_16^4 = −i exactly).  No sincosf at run time.  A frame's arithmetic
// depends on (n1, n2) and the route only, never on b or on where the frame
// sits in the batch, so b = 1 gives frame 0 of a batch bit for bit.
//
// Routes (the wrapper picks by n1·n2 alone):
//   * small, n1·n2 <= 16384: one launch, no scratch.  A block takes F
//     frames (F·n >= 2048, so >= 128 threads): it loads their (n1, n2)
//     tiles with 16-byte loads (8·n1·(n2 + 1) bytes a frame, 132 KB at
//     128 × 128), runs steps 1–3 in shared memory (TW applied as the last
//     column pass stores) and writes X with 16-byte stores.
//   * large, for 128 × 256 … 512 × 512 (B1's large route): a frame's tile
//     is over a block's 227 KB, so two launches through a global scratch
//     B: strips of 16 columns of one frame (steps 1+2), then strips of 16
//     rows of the (b·n1, n2) matrix B (step 3), with the same pass code.
// The MaxDynamicSharedMemorySize attribute is set once per kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kLog2Table = 9;                 // the W_512^t table
constexpr int kTable = 1 << kLog2Table;
constexpr int kLog2Strip = 4;                 // large route: 16 columns / rows a block
constexpr int kStrip = 1 << kLog2Strip;
constexpr int kLog2BlockPoints = 11;          // small route: F·n >= 2048
constexpr int kSmallMaxLog2N = 14;            // small route: n <= 16384
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// v·W_16^t, 0 <= t < 8; t = 0 and t = 4 (−i) exactly
__device__ __forceinline__ float2 rot16(float2 v, int t) {
  switch (t) {
    case 0: return v;
    case 1: return cmul(v, make_float2(0.9238795f, -0.38268343f));
    case 2: return cmul(v, make_float2(0.70710677f, -0.70710677f));
    case 3: return cmul(v, make_float2(0.38268343f, -0.9238795f));
    case 4: return make_float2(v.y, -v.x);
    case 5: return cmul(v, make_float2(-0.38268343f, -0.9238795f));
    case 6: return cmul(v, make_float2(-0.70710677f, -0.70710677f));
    default: return cmul(v, make_float2(-0.9238795f, -0.38268343f));
  }
}

// i with its low `bits` (<= 4) bits reversed, in closed form so that it
// folds to a constant wherever i is one
__host__ __device__ constexpr int bitrev(int i, int bits) {
  return (((i & 1) << 3) | ((i & 2) << 1) | ((i & 4) >> 1) | ((i & 8) >> 3))
         >> (4 - bits);
}

// Radix-2 decimation-in-time stage S (half-width h = 2^S) of an R-point
// DFT in registers, then the stages after it; W_{2h}^j = W_16^{j·8/h}.
template <int L2R, int S>
struct Stages {
  static __device__ __forceinline__ void run(float2* v) {
    constexpr int R = 1 << L2R, h = 1 << S;
#pragma unroll
    for (int i0 = 0; i0 < R; i0 += 2 * h) {
#pragma unroll
      for (int j = 0; j < h; ++j) {
        const float2 u = v[i0 + j];
        const float2 t = rot16(v[i0 + j + h], j * (8 >> S));
        v[i0 + j] = make_float2(u.x + t.x, u.y + t.y);
        v[i0 + j + h] = make_float2(u.x - t.x, u.y - t.y);
      }
    }
    Stages<L2R, S + 1>::run(v);
  }
};

template <int L2R>
struct Stages<L2R, L2R> {
  static __device__ __forceinline__ void run(float2*) {}
};

// In-register DFT of R = 2^L2R <= 16 points, natural order in and out:
// a bit-reversal, then the radix-2 stages.  Every index is a
// compile-time constant, so v stays in registers.
template <int L2R>
__device__ __forceinline__ void dft(float2* v) {
  constexpr int R = 1 << L2R;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int j = bitrev(i, L2R);
    if (i < j) {
      const float2 t = v[i];
      v[i] = v[j];
      v[j] = t;
    }
  }
  Stages<L2R, 0>::run(v);
}

// The lines of a shared tile: 2^log2_lines of them; line L starts at
// (L >> ldiv)·hi + (L mod 2^ldiv)·lo and its element e lies e·es further.
struct Lines {
  int log2_lines, ldiv, hi, lo, es;
};

// Step 2, applied as the last column pass stores element k1 of line L:
// ·tw[k1·n2 + c0 + (L mod 2^ldiv)].  tw == nullptr: none.
struct Step2 {
  const float2* tw;
  int log2n2, c0;
};

// Butterfly g of this thread: job t + g·T → line L = job mod lines and
// j = job div lines; returns the line's start, sets j and L mod 2^ldiv.
__device__ __forceinline__ int butterfly(const Lines& ln, int g, int* j,
                                         int* col) {
  const int job = threadIdx.x + g * blockDim.x;
  const int L = job & ((1 << ln.log2_lines) - 1);
  *j = job >> ln.log2_lines;
  *col = L & ((1 << ln.ldiv) - 1);
  return (L >> ln.ldiv) * ln.hi + *col * ln.lo;
}

// One Stockham pass of radix R = 2^L2R over every line of m = 2^log2m
// points whose first log2ns radix digits are done (Ns = 2^log2ns).
// Butterfly j of a line reads elements j + r·m/R, multiplies element r by
// W_{Ns·R}^{k·r} (k = j mod Ns), takes the R-point DFT and writes element
// r at (j div Ns)·Ns·R + k + r·Ns.  Only the P points stay live across the
// sync; the indices are recomputed after it.
template <int P, int L2R>
__device__ __forceinline__ void pass(float2* buf, const float2* w,
                                     const Lines ln, int log2m, int log2ns,
                                     const Step2 s2) {
  constexpr int R = 1 << L2R;
  constexpr int G = P / R;
  const int log2q = log2m - L2R;
  float2 v[P];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    int j, col;
    const int base = butterfly(ln, g, &j, &col);
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[g * R + r] = buf[base + (j + (r << log2q)) * ln.es];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    int j, col;
    const int base = butterfly(ln, g, &j, &col);
    float2* x = v + g * R;
    const int k = j & ((1 << log2ns) - 1);
    if (log2ns > 0) {
      const int sh = kLog2Table - log2ns - L2R;
#pragma unroll
      for (int r = 1; r < R; ++r) x[r] = cmul(x[r], w[(k * r) << sh]);
    }
    dft<L2R>(x);
    const int d = ((j >> log2ns) << (log2ns + L2R)) + k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = d + (r << log2ns);
      float2 y = x[r];
      if (s2.tw != nullptr)
        y = cmul(y, __ldg(s2.tw + (e << s2.log2n2) + s2.c0 + col));
      buf[base + e * ln.es] = y;
    }
  }
  __syncthreads();
}

// An m-point FFT (m = 2^log2m, 16 … 512) of every line: radix-16 passes,
// the last one taking the remainder; s2 rides on the last pass.
template <int P>
__device__ __forceinline__ void line_fft(float2* buf, const float2* w,
                                         const Lines ln, int log2m,
                                         const Step2 s2) {
  for (int done = 0; done < log2m;) {
    const int l2r = log2m - done < 4 ? log2m - done : 4;
    const Step2 s = done + l2r == log2m ? s2 : Step2{nullptr, 0, 0};
    switch (l2r) {
      case 4: pass<P, 4>(buf, w, ln, log2m, done, s); break;
      case 3: pass<P, 3>(buf, w, ln, log2m, done, s); break;
      case 2: pass<P, 2>(buf, w, ln, log2m, done, s); break;
      default: pass<P, 1>(buf, w, ln, log2m, done, s); break;
    }
    done += l2r;
  }
}

// A shared tile of `rows` rows of 2^log2w complex values (row stride
// 2^log2w + 1) ↔ the re/im planes, tile row i at plane offset
// at + i·2^log2src, 16 bytes of re and of im a thread at a time.  A full
// tile holds T·P points, so each thread copies at most P/4 groups of 4,
// all issued before any is waited for.
template <int P>
__device__ __forceinline__ void load_tile(float2* tile,
                                          const float* __restrict__ re,
                                          const float* __restrict__ im,
                                          long long at, int rows, int log2w,
                                          int log2src) {
  const int per_row = log2w - 2;
#pragma unroll
  for (int q = 0; q < P / 4; ++q) {
    const int g = threadIdx.x + q * blockDim.x;
    if (g >= rows << per_row) break;
    const int row = g >> per_row, c = (g & ((1 << per_row) - 1)) << 2;
    const long long src = at + ((long long)row << log2src) + c;
    const float4 a = *reinterpret_cast<const float4*>(re + src);
    const float4 b = *reinterpret_cast<const float4*>(im + src);
    float2* t = tile + row * ((1 << log2w) + 1) + c;
    t[0] = make_float2(a.x, b.x);
    t[1] = make_float2(a.y, b.y);
    t[2] = make_float2(a.z, b.z);
    t[3] = make_float2(a.w, b.w);
  }
}

template <int P>
__device__ __forceinline__ void store_tile(const float2* tile,
                                           float* __restrict__ re,
                                           float* __restrict__ im,
                                           long long at, int rows, int log2w,
                                           int log2src) {
  const int per_row = log2w - 2;
#pragma unroll
  for (int q = 0; q < P / 4; ++q) {
    const int g = threadIdx.x + q * blockDim.x;
    if (g >= rows << per_row) break;
    const int row = g >> per_row, c = (g & ((1 << per_row) - 1)) << 2;
    const long long dst = at + ((long long)row << log2src) + c;
    const float2* t = tile + row * ((1 << log2w) + 1) + c;
    *reinterpret_cast<float4*>(re + dst) =
        make_float4(t[0].x, t[1].x, t[2].x, t[3].x);
    *reinterpret_cast<float4*>(im + dst) =
        make_float4(t[0].y, t[1].y, t[2].y, t[3].y);
  }
}

__device__ __forceinline__ void load_table(float2* w, const float2* w512) {
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) w[i] = w512[i];
}

// Small route: F = 2^log2f frames a block, steps 1–3 in shared memory.
// P = 16 asks for two blocks an SM (<= 64 registers, a few values spill):
// one block's tile load then overlaps another's passes, which beat one
// block at ~105 registers on the card.
template <int P>
__global__ void __launch_bounds__(kMaxThreads, P == 16 ? 2 : 1) small_kernel(
    const float* __restrict__ zr, const float* __restrict__ zi,
    const float2* __restrict__ w512, const float2* __restrict__ tw,
    float* __restrict__ xr, float* __restrict__ xi, long long b, int log2n1,
    int log2n2, int log2f) {
  extern __shared__ float2 sm[];
  float2* w = sm;
  float2* tile = sm + kTable;                   // F tiles of (n1, n2 + 1)
  const int log2n = log2n1 + log2n2;
  const int fs = (1 << log2n1) * ((1 << log2n2) + 1);
  const long long f0 = (long long)blockIdx.x << log2f;
  // the F tiles' rows follow each other at stride n2 + 1, as the frames'
  // rows do at n2: one copy of frames·n1 rows (a ragged last block leaves
  // its missing frames unread and unwritten)
  const int rows = (b - f0 < (1 << log2f) ? (int)(b - f0) : 1 << log2f)
                   << log2n1;
  load_table(w, w512);
  load_tile<P>(tile, zr, zi, f0 << log2n, rows, log2n2, log2n2);
  __syncthreads();
  // steps 1+2: n1-point FFTs down the F·n2 columns, TW on the last pass
  line_fft<P>(tile, w, Lines{log2f + log2n2, log2n2, fs, 1, (1 << log2n2) + 1},
              log2n1, Step2{tw, log2n2, 0});
  // step 3: n2-point FFTs along the F·n1 rows
  line_fft<P>(tile, w, Lines{log2f + log2n1, 0, (1 << log2n2) + 1, 0, 1},
              log2n2, Step2{nullptr, 0, 0});
  store_tile<P>(tile, xr, xi, f0 << log2n, rows, log2n2, log2n2);
}

// Large route, launch 1: 16 columns c0 … c0 + 15 of one frame, steps 1+2,
// written to the scratch B in place of z.
template <int P>
__global__ void __launch_bounds__(kMaxThreads) cols_kernel(
    const float* __restrict__ zr, const float* __restrict__ zi,
    const float2* __restrict__ w512, const float2* __restrict__ tw,
    float* __restrict__ br, float* __restrict__ bi, int log2n1, int log2n2) {
  extern __shared__ float2 sm[];
  float2* w = sm;
  float2* tile = sm + kTable;                   // (n1, 16 + 1)
  const int strips = log2n2 - kLog2Strip;
  const long long f = blockIdx.x >> strips;
  const int c0 = (blockIdx.x & ((1 << strips) - 1)) << kLog2Strip;
  const long long at = (f << (log2n1 + log2n2)) + c0;
  load_table(w, w512);
  load_tile<P>(tile, zr, zi, at, 1 << log2n1, kLog2Strip, log2n2);
  __syncthreads();
  line_fft<P>(tile, w, Lines{kLog2Strip, kLog2Strip, 0, 1, kStrip + 1},
              log2n1, Step2{tw, log2n2, c0});
  store_tile<P>(tile, br, bi, at, 1 << log2n1, kLog2Strip, log2n2);
}

// Large route, launch 2: 16 rows of the (b·n1, n2) matrix B, step 3.
template <int P>
__global__ void __launch_bounds__(kMaxThreads) rows_kernel(
    const float* __restrict__ br, const float* __restrict__ bi,
    const float2* __restrict__ w512, float* __restrict__ xr,
    float* __restrict__ xi, int log2n2) {
  extern __shared__ float2 sm[];
  float2* w = sm;
  float2* tile = sm + kTable;                   // (16, n2 + 1)
  const long long at = (long long)blockIdx.x << (kLog2Strip + log2n2);
  load_table(w, w512);
  load_tile<P>(tile, br, bi, at, kStrip, log2n2, log2n2);
  __syncthreads();
  line_fft<P>(tile, w, Lines{kLog2Strip, 0, (1 << log2n2) + 1, 0, 1}, log2n2,
              Step2{nullptr, 0, 0});
  store_tile<P>(tile, xr, xi, at, kStrip, log2n2, log2n2);
}

constexpr int smem_bytes(int tile_points) {
  return (int)sizeof(float2) * (kTable + tile_points);
}
// the most each kernel asks for: 128 × (128 + 1); 512 × (16 + 1); 16 × (512 + 1)
constexpr int kSmallSmem = smem_bytes(128 * 129);
constexpr int kColsSmem = smem_bytes(512 * (kStrip + 1));
constexpr int kRowsSmem = smem_bytes(kStrip * 513);

// Allow a kernel its dynamic shared memory, once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

int log2_of(int v) {
  int l = 0;
  while (l < 30 && (1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

}  // namespace

// zr, zi: (b, n1, n2) float32, contiguous, 16-byte aligned.  w512: the
// W_512^t table, tw: TW (n1·n2 float2).  large = 0: the one-launch route
// (n1·n2 <= 16384), br and bi unused; large = 1: two launches through the
// scratch br, bi of the input's shape.  xr, xi: X[k1, k2].  n1, n2: powers
// of two in [16, 512].
extern "C" int emspec_fourstep(
    const float* zr, const float* zi, const void* w512, const void* tw,
    float* br, float* bi, float* xr, float* xi, long long b, int n1, int n2,
    int large, void* stream) {
  const int l1 = log2_of(n1), l2 = log2_of(n2);
  if (l1 < 4 || l2 < 4 || l1 > kLog2Table || l2 > kLog2Table
      || (!large && l1 + l2 > kSmallMaxLog2N)
      || (large && (br == nullptr || bi == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float2* w = static_cast<const float2*>(w512);
  const float2* t = static_cast<const float2*>(tw);
  if (!large) {
    static const cudaError_t attr16 = allow_smem(small_kernel<16>, kSmallSmem);
    static const cudaError_t attr32 = allow_smem(small_kernel<32>, kSmallSmem);
    if (attr16 != cudaSuccess) return (int)attr16;
    if (attr32 != cudaSuccess) return (int)attr32;
    const int log2n = l1 + l2;
    const int log2f = log2n < kLog2BlockPoints ? kLog2BlockPoints - log2n : 0;
    const int points = 1 << (log2n + log2f);
    const int smem = smem_bytes((n1 << log2f) * (n2 + 1));
    const unsigned blocks = (unsigned)((b + (1 << log2f) - 1) >> log2f);
    if (log2n < kSmallMaxLog2N)
      small_kernel<16><<<blocks, points / 16, smem, st>>>(
          zr, zi, w, t, xr, xi, b, l1, l2, log2f);
    else
      small_kernel<32><<<blocks, points / 32, smem, st>>>(
          zr, zi, w, t, xr, xi, b, l1, l2, log2f);
    return (int)cudaGetLastError();
  }
  static const cudaError_t attr_c = allow_smem(cols_kernel<16>, kColsSmem);
  static const cudaError_t attr_r = allow_smem(rows_kernel<16>, kRowsSmem);
  if (attr_c != cudaSuccess) return (int)attr_c;
  if (attr_r != cudaSuccess) return (int)attr_r;
  // 16 columns of n1 points a block: n1·16 points, 16 a thread
  cols_kernel<16><<<(unsigned)(b << (l2 - kLog2Strip)), n1,
                    smem_bytes(n1 * (kStrip + 1)), st>>>(zr, zi, w, t, br, bi,
                                                         l1, l2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rows_kernel<16><<<(unsigned)(b << (l1 - kLog2Strip)), n2,
                    smem_bytes(kStrip * (n2 + 1)), st>>>(br, bi, w, xr, xi, l2);
  return (int)cudaGetLastError();
}
