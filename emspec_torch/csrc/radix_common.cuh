// The radix FFT body of kernel B4 (fourstep.cu), shared with kernel B1's
// on-chip routes (deposits.cu): in-register radix-R DFTs (R = 2^L2R <= 16),
// Stockham autosort passes over the lines of a shared tile, the m-point
// line FFT built from them, the 16-byte tile copies and the W_512 table
// load.  fourstep.cu describes the schedule (the pass, the padded tile
// rows, the twiddle tables); the code here is that file's, moved, so
// that both kernels run one FFT body.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#pragma once

#include <cuda_runtime.h>

namespace emspec::radix {

constexpr int kLog2Table = 9;                 // the W_512^t table
constexpr int kTable = 1 << kLog2Table;

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

}  // namespace emspec::radix
