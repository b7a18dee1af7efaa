// Kernel B2: per-row histogram (the reassignment scatter-add).
//
// Replaces emspec/dsp/pallas/scatter.py::histogram_matmul (_hist_kernel).
// The TPU kernel builds digit one-hots and contracts them on the MXU, a
// workaround for the TPU's lack of data-dependent writes; the GPU has
// them natively.  ids, vals (rows, m) → out (rows, num_bins): the sum of
// vals by id in each row.  An id outside [0, num_bins) adds nothing and
// its value never enters a sum, so a NaN or Inf behind a dropped id
// cannot reach the histogram.  ``passes`` (the TPU kernel's bf16 split
// count) has no counterpart: every add is a float32 add, exact to one
// rounding; only the order of the adds varies from run to run.  The
// global atomics flush subnormal values (red.global.add.f32 is .ftz);
// the pipeline's contributions lie far above that range.
//
// Two routes, chosen by the wrapper from (rows, m, num_bins) alone
// (emspec_torch/dsp/kernels/scatter.py route_of):
//   row     one block of 512 threads a row: a float32 histogram of
//           num_bins cells in shared memory, then one coalesced store of
//           the row (no zeroed output needed).  Taken where the rows
//           alone give every SM two blocks and four such blocks fit an
//           SM's shared memory;
//   global  no shared histogram: the blocks walk the flat rows·m stream
//           (the row of an element is its index div m) and add straight
//           into an output the wrapper has zeroed on the same stream,
//           with global atomics (red.global.add.f32).  Any number of
//           blocks a row, so few rows still spread over many SMs, and no
//           cap on num_bins: the route above a block's shared memory
//           (num_bins > 58,112).
// Common to both:
//   * 16-byte loads: ids and vals are read four at a time where the two
//     share their alignment; each range's head up to the next 16-byte
//     boundary and its tail (three elements at most each) take one warp
//     step of their own.  m is odd on every path (4097, 16385, 131073),
//     so each row starts at another alignment;
//   * hot cells: the ids of real audio cluster (the log raster folds many
//     high bins into its top rows; a steady tone keeps δ at 0), so lanes
//     of a warp often hit one cell and their atomics serialise.  Each
//     thread first merges runs of equal ids among its four elements, then
//     __match_any_sync finds the lanes of the warp that share an id, a
//     tree of shuffles over their ranks sums each group, and only the
//     group's lowest lane issues the atomic (warp_add says when).  A
//     dropped element gets a key of its own (~lane), so it never joins a
//     group.
// What bounds each route on this card: reading the inputs, 8 bytes a
// deposit, and writing the output, 4 bytes a cell; in practice the warp
// steps' match and atomics (row: compare-and-swap loops in shared
// memory, global: L2 atomics, one per group of equal ids a warp step
// holds) and, for global, the zero-fill of 4·rows·num_bins bytes.  Why
// no route splits a row over blocks that each flush a shared histogram
// with global atomics: on the card it lost to global at every path's
// shape (PERF.md §6).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 512;      // row route
constexpr int kGlobalThreads = 256;   // global route
constexpr int kMaxSmem = 232448;      // a block's shared memory (227 KB)
constexpr unsigned kFull = 0xffffffffu;

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

template <bool kHotOnly, typename Key>
__device__ __forceinline__ void warp_add(float* dst, Key key, bool ok,
                                         float v) {
  if (!kHotOnly) {
    if (!__any_sync(kFull, ok)) return;
  } else {
    const unsigned seen = __reduce_or_sync(kFull,
                                           ok ? bucket_bit(key) : 0u);
    if (seen == 0u) return;
    if (__popc(seen) > kHotBuckets) {
      if (ok) atomicAdd(dst + key, v);
      return;
    }
  }
  const unsigned peers = __match_any_sync(kFull, key);
  if (reduce_peers(peers, v) && ok) atomicAdd(dst + key, v);
}

// Where the deposits of a range go.  Shared (row route): the block's row
// histogram, keyed by id.  Global: the output, keyed by
// row·num_bins + id, the row being the flat index div m.
template <bool kGlobal, typename Key>
struct Sink {
  float* dst;
  long long m;
  int num_bins;

  __device__ __forceinline__ void add(Key key, bool ok, float v) const {
    warp_add<!kGlobal>(dst, key, ok, v);
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
template <bool kGlobal, typename Key>
__device__ __forceinline__ void consume(
    const int* __restrict__ ids, const float* __restrict__ vals,
    const Sink<kGlobal, Key>& sink, long long f0, long long f1, int a0,
    bool vec, long long first, long long stride, bool edge) {
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

// row route: one block a row
__global__ void __launch_bounds__(kRowThreads) row_kernel(
    const int* __restrict__ ids, const float* __restrict__ vals,
    float* __restrict__ out, long long m, int num_bins, int a0, int vec) {
  extern __shared__ __align__(16) float h[];
  const long long row = blockIdx.x;
  for (int i = threadIdx.x; i < num_bins; i += kRowThreads) h[i] = 0.0f;
  __syncthreads();
  consume<false, unsigned>(ids, vals, Sink<false, unsigned>{h, m, num_bins},
                           row * m, (row + 1) * m, a0, vec != 0, threadIdx.x,
                           kRowThreads, threadIdx.x < 32u);
  __syncthreads();
  float* orow = out + row * num_bins;
  for (int i = threadIdx.x; i < num_bins; i += kRowThreads) orow[i] = h[i];
}

template <typename Key>
__global__ void __launch_bounds__(kGlobalThreads) global_kernel(
    const int* __restrict__ ids, const float* __restrict__ vals,
    float* __restrict__ out, long long total, long long m, int num_bins,
    int a0, int vec) {
  consume<true, Key>(ids, vals, Sink<true, Key>{out, m, num_bins}, 0, total,
                     a0, vec != 0,
                     (long long)blockIdx.x * kGlobalThreads + threadIdx.x,
                     (long long)gridDim.x * kGlobalThreads,
                     blockIdx.x == 0 && threadIdx.x < 32u);
}

}  // namespace

// ids, vals: (rows, m) int32 / float32, contiguous; a0 = (ids address / 4)
// mod 4; vec = 1 when vals has the same 16-byte alignment.  route 0
// (row): out (rows, num_bins) is written whole; route 1 (global,
// ``blocks`` blocks) adds into an out the caller has zeroed on
// ``stream``.  No host synchronisation; returns the launch's cudaError_t.
extern "C" int emspec_histogram(const int* ids, const float* vals,
                                float* out, long long rows, long long m,
                                int num_bins, int route, int blocks, int a0,
                                int vec, void* stream) {
  if (num_bins <= 0 || blocks <= 0 || route < 0 || route > 1
      || (route == 0 && 4LL * num_bins > kMaxSmem))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 0) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
    row_kernel<<<(unsigned)rows, kRowThreads, 4 * num_bins, st>>>(
        ids, vals, out, m, num_bins, a0, vec);
    return (int)cudaGetLastError();
  }
  if (m == 0) return 0;
  if (rows * (long long)num_bins < (1LL << 31) - 32)
    global_kernel<unsigned><<<(unsigned)blocks, kGlobalThreads, 0, st>>>(
        ids, vals, out, rows * m, m, num_bins, a0, vec);
  else
    global_kernel<unsigned long long><<<(unsigned)blocks, kGlobalThreads, 0,
                                        st>>>(ids, vals, out, rows * m, m,
                                              num_bins, a0, vec);
  return (int)cudaGetLastError();
}
