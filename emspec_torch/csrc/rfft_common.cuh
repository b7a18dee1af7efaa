// Device code shared by the port's real FFT kernels: rfft.cu (routes
// "full", "block", and "large"'s pack and unpack) and rfft_cluster.cu
// (route "cluster").  The frames of a launch read through their strides,
// the sample loads (every load of a thread started before any is waited
// for, 16, 8 or 4 bytes wide as the frames' address and strides allow,
// the window multiplied in on the way), the one-signal unpack of a bin
// and its store, and the phase stamps of a stamped build.  One
// definition, so the routes cannot drift apart in their arithmetic.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "deposits_common.cuh"
#include "radix_common.cuh"

namespace {

using namespace emspec::radix;

// The frames of a launch: frame f starts at
// x + (f div frames_per_lead)·lead_stride
//   + (f mod frames_per_lead)·frame_stride.
struct Frames {
  const float* x;
  long long frames_per_lead, lead_stride, frame_stride;
  const float* window;            // N floats, or null (none)
  int vec;                        // floats a sample load: 4, 2 or 1
};

__device__ __forceinline__ const float* frame_at(const Frames& a,
                                                 long long f) {
  if (f <= INT32_MAX && a.frames_per_lead <= INT32_MAX) {   // 32-bit divide
    const unsigned q = (unsigned)f / (unsigned)a.frames_per_lead;
    return a.x + q * a.lead_stride
           + ((unsigned)f - q * (unsigned)a.frames_per_lead) * a.frame_stride;
  }
  return a.x + (f / a.frames_per_lead) * a.lead_stride
         + (f % a.frames_per_lead) * a.frame_stride;
}

// The widest sample load every frame and the window allow: 4 floats where
// each frame start and the window lie on 16 bytes, 2 on 8, else 1.  A
// stride along an axis of one frame never moves a frame.
inline int load_width(const float* x, long long num_lead,
                      long long frames_per_lead, long long lead_stride,
                      long long frame_stride, const float* window) {
  for (int v = 4; v > 1; v >>= 1)
    if (reinterpret_cast<std::uintptr_t>(x) % (4 * v) == 0
        && reinterpret_cast<std::uintptr_t>(window) % (4 * v) == 0
        && (num_lead == 1 || lead_stride % v == 0)
        && (frames_per_lead == 1 || frame_stride % v == 0))
      return v;
  return 1;
}

// Four consecutive floats at p, as kV-float loads (no wait on them here).
template <int kV>
__device__ __forceinline__ void load4(const float* p, float* v) {
  if constexpr (kV == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (kV == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    const float2 u = __ldg(reinterpret_cast<const float2*>(p + 2));
    v[0] = t.x; v[1] = t.y; v[2] = u.x; v[3] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __ldg(p + i);
  }
}

// This thread's sample groups q < groups (4 consecutive samples each, at
// group t + q·T of the launch's numbering): at(g, &frame, &off) gives
// group g's frame start and sample offset and returns its tile address
// (or −1: a frame past the batch's end, left unread).  kB groups' loads
// (and as many of the window's) are started before any is waited for;
// each sample times the window is one rounding (__fmul_rn), as frames ·
// window rounds.  packed: the 4 samples are z[i], z[i + 1] of the
// even/odd-packed sequence (two tile points); else 4 real points x + 0i.
template <int kV, int kB, bool kWin, typename At>
__device__ __forceinline__ void load_groups_as(float2* tile,
                                              const Frames& a, int groups,
                                              bool packed, At at) {
  for (int q0 = 0; q0 < groups; q0 += kB) {
    float s[kB][4], w[kWin ? kB : 1][4];
    int dst[kB];
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      dst[k] = -1;
      if (q0 + k < groups) {
        const float* fr;
        int off;
        dst[k] = at(threadIdx.x + (q0 + k) * blockDim.x, &fr, &off);
        if (dst[k] >= 0) {
          load4<kV>(fr + off, s[k]);
          if constexpr (kWin) load4<kV>(a.window + off, w[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      if (dst[k] < 0) continue;
      if constexpr (kWin) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[k][i] = __fmul_rn(s[k][i], w[k][i]);
      }
      if (packed) {
        tile[dst[k]] = make_float2(s[k][0], s[k][1]);
        tile[dst[k] + 1] = make_float2(s[k][2], s[k][3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tile[dst[k] + i] = make_float2(s[k][i], 0.0f);
      }
    }
  }
}

// load_groups_as at the launch's load width, 8 groups in flight a thread
// (4 with the window's beside them)
template <typename At>
__device__ __forceinline__ void load_groups(float2* tile, const Frames& a,
                                           int groups, bool packed, At at) {
  if (a.window != nullptr) {
    if (a.vec == 4) load_groups_as<4, 4, true>(tile, a, groups, packed, at);
    else if (a.vec == 2) load_groups_as<2, 4, true>(tile, a, groups, packed, at);
    else load_groups_as<1, 4, true>(tile, a, groups, packed, at);
  } else {
    if (a.vec == 4) load_groups_as<4, 8, false>(tile, a, groups, packed, at);
    else if (a.vec == 2) load_groups_as<2, 8, false>(tile, a, groups, packed, at);
    else load_groups_as<1, 8, false>(tile, a, groups, packed, at);
  }
}

// Sample i of a frame, the window multiplied in (route "large"'s pack).
__device__ __forceinline__ float sample(const Frames& a, const float* fr,
                                        int i) {
  const float s = __ldg(fr + i);
  return a.window == nullptr ? s : __fmul_rn(s, __ldg(a.window + i));
}

// Bin `at` of the output: the spectrum, or its power with the scrub.
template <bool kPower>
__device__ __forceinline__ void store_bin(float2 X, float2* __restrict__ spec,
                                          float* __restrict__ power,
                                          long long at) {
  if (kPower) {
    const float p = __fadd_rn(__fmul_rn(X.x, X.x), __fmul_rn(X.y, X.y));
    power[at] = p <= FLT_MAX ? p : 0.0f;        // NaN and +Inf: false
  } else {
    spec[at] = X;
  }
}

// X[k], 0 <= k <= m, of a real frame from its packed spectrum: the pair
// (k', m − k'), k' = min(k, m − k), unpacked with e^{−2πik'/N}; the upper
// half takes the pair's conjugate side (k = 0 and m: both from Z[0]).
// zk, zmk: Z[k'] and Z[(m − k') mod m]; w: e^{−2πik'/N}.
__device__ __forceinline__ float2 unpack_at(int k, int m, float2 zk,
                                            float2 zmk, float2 w) {
  const bool upper = k > (m >> 1);
  float2 lo, hi;
  emspec::unpack_pair(zk, zmk, w, &lo, &hi);
  return upper ? hi : lo;
}

#ifdef EMSPEC_RFFT_STAMPS
// Phase stamps, in a variant build only (probes/rfft_phases.py): thread 0
// of block i writes clock64() to slot k of row i once every thread of the
// block has ended phase k (a __syncthreads first).  Each file keeps its
// own row pointer, set through its own C entry point.
constexpr int kStampSlots = 16;
__device__ long long* g_stamps = nullptr;
#define RFFT_STAMP(k)                                                      \
  do {                                                                     \
    __syncthreads();                                                       \
    if (threadIdx.x == 0 && g_stamps != nullptr)                           \
      g_stamps[(long long)blockIdx.x * kStampSlots + (k)] = clock64();     \
  } while (0)
#else
#define RFFT_STAMP(k) \
  do {                \
  } while (0)
#endif

// line_fft, with a stamp after each pass in a stamped build (the same
// passes in the same order: the same arithmetic)
template <int P>
__device__ __forceinline__ void lines_fft(float2* buf, const float2* w,
                                          const Lines ln, int log2m,
                                          const Step2 s2, int* slot) {
#ifdef EMSPEC_RFFT_STAMPS
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
    RFFT_STAMP((*slot)++);
  }
#else
  line_fft<P>(buf, w, ln, log2m, s2);
#endif
}

// B4's W_512 table in two halves, so that its loads are in flight with
// the samples': fetch (kTable/T loads a thread, none waited for; T >= 128
// threads), then put into shared memory once the samples are loaded
// (radix_common.cuh's load_table waits on each load before the next)
constexpr int kMinThreads = 128;
constexpr int kTableLoads = kTable / kMinThreads;

__device__ __forceinline__ void table_fetch(float2* v, const float2* w512) {
#pragma unroll
  for (int q = 0; q < kTableLoads; ++q) {
    const int i = threadIdx.x + q * blockDim.x;
    if (i < kTable) v[q] = __ldg(w512 + i);
  }
}

__device__ __forceinline__ void table_put(float2* w, const float2* v) {
#pragma unroll
  for (int q = 0; q < kTableLoads; ++q) {
    const int i = threadIdx.x + q * blockDim.x;
    if (i < kTable) w[i] = v[q];
  }
}

int log2_of(long long v) {
  int l = 0;
  while (l < 40 && (1LL << l) < v) ++l;
  return (1LL << l) == v ? l : -1;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace
