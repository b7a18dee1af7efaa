// Device code of kernel B2 (histogram.cu) shared with kernel B6
// (deposits.cu) and the scatter-ablation probe (scatter_ablation.cu): the
// warp-level merge of equal ids (reduce_peers, bucket_bit, warp_add), the
// deposit sinks (Sink) and the 16-byte walk over a range of deposits
// (consume).  One copy, so the three kernels add the same way.
//
// ``kStage`` lets the probe take one stage out of this code, and defaults
// to B2 itself (kB2), which is all that histogram.cu and deposits.cu
// instantiate:
//   kNoMerge   warp_add without __match_any_sync and the peer tree: every
//              lane adds its own value;
//   kNoAtomic  the group's add becomes a plain store: a cell is set to 1
//              where a group whose sum is >= 0 lands (its sum decides, so
//              the merge is not dead code; storing the sum itself would
//              leave the cell holding whichever group stored last, which
//              the warps' schedule decides);
//   kIoOnly    the sink is the thread's register sum (``acc``) of the
//              values it is handed: the loads, the peel and the validity
//              mask without any shared or global write.
// (The probe's fourth variant, kNoZero, changes the row kernel only.)
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#pragma once

#include <cuda_runtime.h>

namespace emspec {
namespace hist {

constexpr int kRowThreads = 512;      // B2's row route
constexpr int kGlobalThreads = 256;   // B2's global route
constexpr unsigned kFull = 0xffffffffu;

enum Stage : int { kB2 = 0, kNoMerge = 1, kNoAtomic = 2, kNoZero = 3,
                   kIoOnly = 4 };

// The lanes whose key equals this lane's (``peers``, from
// __match_any_sync) sum their values by a tree over their ranks among the
// peers; true on the group's lowest lane, which then holds the group's
// total.  No round runs when every key of the warp is distinct.
__device__ __forceinline__ bool reduce_peers(unsigned peers, float& v) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  unsigned rank = __popc(peers & below);
  const bool leader = rank == 0u;
  unsigned above = peers & ~below & ~(1u << lane);
  while (__any_sync(kFull, above != 0u)) {
    const int next = __ffs(above);              // 1 + lane, 0 if none
    const float t = __shfl_sync(kFull, v, (next - 1) & 31);
    if (next != 0) v += t;
    above &= ~__ballot_sync(kFull, rank & 1u);  // odd ranks are done
    rank >>= 1;
  }
  return leader;
}

// One warp step: every lane offers (key, v) and the lanes of one key add
// their sum once into dst[key].  Warp-collective: all 32 lanes call it.
// __match_any_sync costs more the more distinct keys the warp holds and
// gains nothing where they are all distinct.  A global atomic is an L2
// operation, so the global route merges at every step (kHotOnly false).
// A shared float atomicAdd is a compare-and-swap loop (ATOMS.CAST.SPIN),
// whose lanes on one cell retry in turn, so the row route merges only
// hot steps: steps whose live keys fall in at most kHotBuckets of 32
// hash buckets (an OR-reduction of one bit a lane estimates the distinct
// keys).  Elsewhere each lane adds its own value.
constexpr int kHotBuckets = 6;

__device__ __forceinline__ unsigned bucket_bit(unsigned key) {
  return 1u << ((key * 0x9E3779B1u) >> 27);       // Fibonacci hashing
}
__device__ __forceinline__ unsigned bucket_bit(unsigned long long key) {
  return bucket_bit((unsigned)key ^ (unsigned)(key >> 32));
}

// The add of one lane or group into its cell (kNoAtomic: the store).
template <int kStage>
__device__ __forceinline__ void deposit(float* cell, float v) {
  if (kStage == kNoAtomic) {
    if (v >= 0.0f) *cell = 1.0f;
  } else {
    atomicAdd(cell, v);
  }
}

template <bool kHotOnly, typename Key, int kStage = kB2>
__device__ __forceinline__ void warp_add(float* dst, Key key, bool ok,
                                         float v) {
  if (kStage == kNoMerge) {
    if (ok) atomicAdd(dst + key, v);
    return;
  }
  if (!kHotOnly) {
    if (!__any_sync(kFull, ok)) return;
  } else {
    const unsigned seen = __reduce_or_sync(kFull,
                                           ok ? bucket_bit(key) : 0u);
    if (seen == 0u) return;
    if (__popc(seen) > kHotBuckets) {
      if (ok) deposit<kStage>(dst + key, v);
      return;
    }
  }
  const unsigned peers = __match_any_sync(kFull, key);
  if (reduce_peers(peers, v) && ok) deposit<kStage>(dst + key, v);
}

// Where the deposits of a range go.  Shared (row route): the block's row
// histogram, keyed by id.  Global: the output, keyed by
// row·num_bins + id, the row being the flat index div m.
template <bool kGlobal, typename Key, int kStage = kB2>
struct Sink {
  float* dst;
  long long m;
  int num_bins;
  mutable float acc = 0.0f;      // kIoOnly: the thread's register sum

  __device__ __forceinline__ void add(Key key, bool ok, float v) const {
    if (kStage == kIoOnly) {
      if (ok) acc += v;
    } else {
      warp_add<!kGlobal, Key, kStage>(dst, key, ok, v);
    }
  }

  // an element of ``row`` holding id → its key, or ~lane if dropped
  __device__ __forceinline__ Key key(long long row, int id, bool& ok) const {
    ok = id >= 0 && id < num_bins;
    const Key drop = ~(Key)(threadIdx.x & 31u);
    if (!kGlobal) return ok ? (Key)id : drop;
    return ok ? (Key)(row * num_bins + id) : drop;
  }
  __device__ __forceinline__ long long row_of(long long f) const {
    return kGlobal && f >= 0 ? f / m : 0;
  }
};

// Deposit the flat elements [f0, f1) into ``sink``.  The body runs in
// warp-uniform steps: step s of this thread covers vector (or element)
// ``first + s·stride`` of the range; ``edge`` picks the one warp that
// takes the head and the tail.  vec: ids and vals share their 16-byte
// alignment, whose element offset is a0 (address / 4 mod 4).
template <bool kGlobal, typename Key, int kStage = kB2>
__device__ __forceinline__ void consume(
    const int* __restrict__ ids, const float* __restrict__ vals,
    const Sink<kGlobal, Key, kStage>& sink, long long f0, long long f1,
    int a0, bool vec, long long first, long long stride, bool edge) {
  const long long n = f1 - f0;
  if (!vec) {
    for (long long base = first - (threadIdx.x & 31u); base < n;
         base += stride) {
      const long long j = base + (threadIdx.x & 31u);
      const bool in = j < n;
      const int id = in ? ids[f0 + j] : -1;
      bool ok;
      const Key key = sink.key(sink.row_of(f0 + j), id, ok);
      sink.add(key, ok, ok ? vals[f0 + j] : 0.0f);
    }
    return;
  }
  const int head = (int)min(n, (long long)((4 - ((a0 + f0) & 3)) & 3));
  const long long b0 = f0 + head;                 // 16-byte aligned
  const long long nv = (f1 - b0) >> 2;
  const long long t0 = b0 + 4 * nv;               // tail: [t0, f1)
  const int4* iv = reinterpret_cast<const int4*>(ids + b0);
  const float4* vv = reinterpret_cast<const float4*>(vals + b0);
  for (long long base = first - (threadIdx.x & 31u); base < nv;
       base += stride) {
    const long long j = base + (threadIdx.x & 31u);
    const bool in = j < nv;
    const int4 i4 = in ? __ldg(iv + j) : make_int4(-1, -1, -1, -1);
    const float4 v4 = in ? __ldg(vv + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    const int id[4] = {i4.x, i4.y, i4.z, i4.w};
    float v[4] = {v4.x, v4.y, v4.z, v4.w};
    Key key[4];
    bool ok[4];
    long long row = sink.row_of(b0 + 4 * j);      // one division a vector
    long long q = kGlobal ? b0 + 4 * j - row * sink.m : 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (kGlobal)
        for (; q >= sink.m; q -= sink.m) ++row;
      key[k] = sink.key(row, id[k], ok[k]);
      if (!ok[k]) v[k] = 0.0f;
      ++q;
    }
    // runs of equal ids among the thread's four elements: into the first
#pragma unroll
    for (int k = 3; k > 0; --k)
      if (ok[k] && ok[k - 1] && key[k] == key[k - 1]) {
        v[k - 1] += v[k];
        ok[k] = false;
        key[k] = ~(Key)(threadIdx.x & 31u);
      }
#pragma unroll
    for (int k = 0; k < 4; ++k) sink.add(key[k], ok[k], v[k]);
  }
  if (edge) {                    // lanes 0–2: the head, lanes 4–6: the tail
    const int lane = threadIdx.x & 31;
    const long long f = lane < head ? f0 + lane
                        : (lane >= 4 && lane < 4 + (int)(f1 - t0))
                            ? t0 + lane - 4 : -1;
    const int id = f >= 0 ? ids[f] : -1;
    bool ok;
    const Key key = sink.key(sink.row_of(f), id, ok);
    sink.add(key, ok, ok ? vals[f] : 0.0f);
  }
}

}  // namespace hist
}  // namespace emspec
