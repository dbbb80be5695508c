// The device trainer's per-level histogram kernel for NVIDIA Hopper (sm_90a).
//
//   fog_histogram   replaces repro/kernels/histogram.py::_hist_kernel
//
// behind a plain C entry point that launches on the caller's stream and
// returns cudaGetLastError() (loaded with ctypes by
// repro_torch/kernels/_build.py, linked into the same library as
// fog_kernels.cu).  The wrapper (kernels/histogram.py) allocates and zeroes
// the output; the kernel allocates nothing.
//
// What it computes: out[t, node*C + y, f*n_bins + bin] += w[t, n] for every
// tree t, sample n and feature f, where node = node[t, n], y = y[n] and
// bin = bins[n, f] -- the weighted (node, class) x (feature, bin) counts
// from which the trainer reads every candidate split.  The TPU kernel
// builds two one-hot matrices in VMEM and multiplies them on the MXU; on
// Hopper the native form of the same sum is a scatter-add, so this kernel
// runs one thread per (tree, sample, feature) and adds its weight with one
// global atomicAdd.  A thread whose weight is 0 (out of the bootstrap
// sample, or padding) adds nothing and returns.  A node id, label or bin
// outside its range adds nothing either, as in the one-hot contraction.
//
// Exactness: every cell is a sum of integer-valued fp32 weights, exact
// below 2**24 per cell, so atomics in any order give the same bits as the
// one-hot contraction and the segment-sum twin.
//
// What bounds it: its global atomics, one per weighted (tree, sample,
// feature), the same count at every level.  The zeroed
// [T, nodes*C, F*n_bins] output (written once by the wrapper's fill) sets
// the bytes bound, which only approaches the kernel's time at the deepest
// level; on an H100 (700 W) the kernel's time is flat over the levels of a
// gate fit (PERF.md).  Neighbouring threads take neighbouring features of
// one sample, so the bins reads are coalesced and node/w/y are broadcast
// within a sample.  Privatizing a (node, class) row block in shared
// memory, or a tensor-core one-hot GEMM, would cut the atomics; that is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void histogram_kernel(const int* __restrict__ node,
                                 const int* __restrict__ y,
                                 const float* __restrict__ w,
                                 const uint8_t* __restrict__ bins,
                                 float* __restrict__ out, int T, int N, int F,
                                 int n_bins, int C, int n_nodes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)T * N * F) return;
  const int f = (int)(i % F);
  const long long tn = i / F;  // t * N + n
  const float wt = w[tn];
  if (wt == 0.0f) return;
  const int n = (int)(tn % N);
  const int t = (int)(tn / N);
  const int nd = node[tn];
  const int c = y[n];
  const int b = bins[(size_t)n * F + f];
  if (nd < 0 || nd >= n_nodes || c < 0 || c >= C || b >= n_bins) return;
  const size_t row = (size_t)t * n_nodes * C + (size_t)nd * C + c;
  atomicAdd(out + (row * F + f) * n_bins + b, wt);
}

}  // namespace

extern "C" {

int fog_histogram(const int* node, const int* y, const float* w,
                  const uint8_t* bins, float* out, int T, int N, int F,
                  int n_bins, int C, int n_nodes, int block, void* stream) {
  const long long total = (long long)T * N * F;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = (unsigned)((total + block - 1) / block);
  histogram_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      node, y, w, bins, out, T, N, F, n_bins, C, n_nodes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
