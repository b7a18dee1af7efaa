// Kernel B6, route cluster_large, its cells as a private copy of all num_bins cells in each CTA
// (xcluster.cuh, where the route and both designs of its cells are
// described).  One instantiation of xcluster_kernel a file, so that the
// builds run in parallel.
//
// Replaces emspec/dsp/pallas/fft4.py::fft4_hist (_hist_kernel, _tile_hist)
// at N = 65536 … 262144, and at 32768 above deposits.cu's 6,912 cells.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math.

#include "xcluster.cuh"

// B6, route cluster_large (N = 32768 … 262144): the arguments of
// emspec_deposits_hist (deposits.cu); hist (frames, num_bins) float32,
// every cell stored once.
extern "C" int emspec_deposits_hist_cluster_large_copies(
    const float* x, long long num_lead, long long frames_per_lead,
    long long lead_stride, long long frame_stride, const float* th,
    const void* w512, const void* tw4, const void* tw,
    const float* logmap_a, const float* logmap_b, const float* power_floor,
    float* hist, int n, int n1, int n2, int hop, float c_dh, float bin_scale,
    float hz_per_bin, float inv_n2, int rows, int reach, int min_id,
    int num_bins, void* stream) {
  XArgs a;
  if (num_bins <= 0
      || !xargs(&a, x, frames_per_lead, lead_stride, frame_stride, th, w512,
                tw4, tw, logmap_a, logmap_b, power_floor, nullptr, hist, n,
                n1, n2, hop, c_dh, bin_scale, hz_per_bin, inv_n2, rows, reach,
                0, n / 2 + 1, nullptr, min_id, num_bins)
      || xsmem(n1, a.wp, xcells(kCopies, num_bins, a.log2c)) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return xlaunch<kCopies>(a, num_lead * frames_per_lead, n1,
                          (cudaStream_t)stream);
}

// Clusters of this design at N with num_bins cells the card holds at once.
extern "C" int emspec_deposits_hist_cluster_large_copies_occupancy(
    int n, int n1, int n2, int num_bins, int* clusters) {
  if (num_bins <= 0) return (int)cudaErrorInvalidValue;
  return xoccupancy<kCopies>(n, n1, n2, num_bins, clusters);
}
