// Device code shared by every route of kernel B1 (deposits.cu, one block
// a frame for N <= 16384 and a two-CTA cluster a frame at 32768;
// deposits_large.cu above) and by kernel B6 (the fused histogram, built on
// the block, the cluster and the large route): the real-input unpack of
// an even/odd-packed half-size spectrum and the per-bin epilogue
// (stencils, Auger–Flandrin corrections, quantization, id packing).  One
// definition, so the routes cannot drift apart.

#pragma once

#include <cuda_runtime.h>

namespace emspec {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Real-input unpack of one bin pair.  Z is the m-point DFT of the packed
// z[i] = s[2i] + i·s[2i+1] of a real 2m-point signal s; zk = Z[k],
// zmk = Z[(m − k) mod m], w = e^{−2πik/2m}, 0 <= k <= m/2.  Gives
//   X[k]     = Ze + W^k·Zo
//   X[m − k] = conj(Ze − W^k·Zo)
// (at k = m/2 both are the same bin; the first is the one to use).
__device__ __forceinline__ void unpack_pair(float2 zk, float2 zmk, float2 w,
                                            float2* lo, float2* hi) {
  const float2 ze = make_float2(0.5f * (zk.x + zmk.x), 0.5f * (zk.y - zmk.y));
  const float2 zo = make_float2(0.5f * (zk.y + zmk.y), -0.5f * (zk.x - zmk.x));
  const float2 t = cmul(w, zo);
  *lo = make_float2(ze.x + t.x, ze.y + t.y);
  *hi = make_float2(ze.x - t.x, t.y - ze.y);
}

// Constants of the epilogue: the three device scalars (read once a
// block) and the per-size host constants, all float32 as the plain
// version rounds them.
struct EpilogueConsts {
  float a, bsc, floor_p;          // logmap a, b; power floor
  float c_dh;                     // float32(π/2N): X_dh = −i·c·(A[k−1] − A[k+1])
  float bin_scale, hz_per_bin;    // N/2π, sr/N
  float inv_n2;                   // 1/N²
  int n, hop, rows, reach;
};

// Bin k of one frame: raw spectrum A[k] and its neighbours A[k∓1] (the
// Hermitian conjugates at k = 0 and N/2, chosen by the caller), t·h
// spectrum B[k], the bank's band weight at k (1 for one bank) → (id,
// contrib).  Periodic-Hann stencils, Δt, Δω, f̂, round-half-even
// quantization (rintf) with Δt/hop a true division, the validity mask,
// contrib = (|X_h|²·band)·(1/N²) in that order (band = 1 is exact); an
// invalid deposit carries id −1 and contrib 0.
__device__ __forceinline__ void deposit_at(int k, float2 A, float2 Am1,
                                           float2 Ap1, float2 B, float band,
                                           const EpilogueConsts& c, int* id,
                                           float* contrib) {
  const float xhr = 0.5f * A.x - 0.25f * (Am1.x + Ap1.x);
  const float xhi = 0.5f * A.y - 0.25f * (Am1.y + Ap1.y);
  const float xdr = c.c_dh * (Am1.y - Ap1.y);
  const float xdi = -c.c_dh * (Am1.x - Ap1.x);
  const float power = xhr * xhr + xhi * xhi;
  const float inv = 1.0f / (power > 1e-30f ? power : 1e-30f);
  const float dt = (B.x * xhr + B.y * xhi) * inv;
  const float dw = -(xdi * xhr - xdr * xhi) * inv;
  const float f_hat = ((float)k + dw * c.bin_scale) * c.hz_per_bin;
  const float dq = rintf(dt / (float)c.hop);
  const float rq = rintf((log2f(f_hat > 1e-6f ? f_hat : 1e-6f) - c.a) * c.bsc);
  const bool valid = power > c.floor_p && rq >= 0.0f && rq < (float)c.rows
                     && f_hat > 0.0f && fabsf(dt) <= 0.5f * (float)c.n;
  *id = valid ? ((int)dq + c.reach) * c.rows + (int)rq : -1;
  *contrib = valid ? (power * band) * c.inv_n2 : 0.0f;
}

// B6's mask and range test: a deposit lands in the relative histogram of
// num_bins cells when min_id <= id < num_bins and id >= 0 (id −1, the
// invalid deposit, never lands).
__device__ __forceinline__ bool lands(int id, int min_id, int num_bins) {
  return id >= min_id && id >= 0 && id < num_bins;
}

}  // namespace emspec
