// The ring's grove walk for NVIDIA Hopper (sm_90a).
//
//   fog_tree_traverse   replaces repro/kernels/tree_traverse.py::_tree_traverse_kernel
//   fog_smem_optin      the per-block shared-memory limit a kernel may opt
//                       into (a query, not a kernel)
//
// behind plain C entry points (loaded with ctypes by
// repro_torch/kernels/_build.py, linked into the same library as
// fog_kernels.cu).  The launch goes on the caller's stream and returns
// cudaGetLastError(); the wrapper (kernels/tree_traverse.py) allocates the
// output, the kernel allocates nothing.
//
// What it computes: for each of S stacked ring shards s, each lane's mean
// leaf distribution over the t trees of shard s's grove,
//   out[s, i, :] = (sum over trees in order of leaf[s, tr, idx - N, :]) / t
// where idx walks d levels of idx = 2*idx + 1 + (x[s, i, f] > thr), values
// dequantized after the gather (fog_tables.cuh).  Tables are [S, t, N] and
// [S, t, L, C] at their packed dtype, scales [S, t], x [S, b, F], out
// [S, b, C] fp32.
//
// Design.  The grid is (ceil(b / block), S): each block serves one shard.
// The TPU kernel pins the grove's tables in VMEM; here each block first
// copies its shard's grove -- feature, scales, threshold, leaf, at the packed
// width -- into dynamic shared memory (24,576 B fp32, 13,316 B bf16, 7,686 B
// int8 for the bench grove of 2 trees of depth 8 over 10 classes), then one
// thread per lane walks the t trees from there, reading x[s, i, f] from
// global memory.  A bounds check after the barrier serves a ragged last
// tile, so no batch needs padding.  Each lane sums its trees' leaf rows
// into its own output row and divides by t at the end.  Above 48 KB the
// launch opts in with cudaFuncSetAttribute; the wrapper rejects a grove
// over the device's opt-in limit before launching.
//
// What bounds it: the dependent chain of each lane (per tree, d levels of
// shared-memory node load -> x gather -> compare, then the leaf row), not
// bytes: a block reads its grove once and each lane's x row and output row.
//
// Exact arithmetic: __fadd_rn, __fdiv_rn and (int8) __fmul_rn, built with
// -fmad=false, so the result equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fog_tables.cuh"

namespace {

template <class Tab>
__global__ void tree_traverse_kernel(
    const int* __restrict__ feature, const typename Tab::T* __restrict__ threshold,
    const typename Tab::T* __restrict__ leaf, const float* __restrict__ thr_scale,
    const float* __restrict__ leaf_scale, const float* __restrict__ x,
    float* __restrict__ out, int b, int F, int t, int depth, int C) {
  typedef typename Tab::T T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = (1 << depth) - 1;  // internal nodes per tree
  const int L = N + 1;             // leaves per tree
  const size_t s = blockIdx.y;
  const size_t n_nodes = (size_t)t * N;
  const size_t n_leaf = (size_t)t * L * C;

  // shared layout: feature int32 [t*N], thr_scale [t], leaf_scale [t],
  // threshold T [t*N], leaf T [t*L*C] (every offset stays T-aligned)
  int* s_feat = reinterpret_cast<int*>(smem);
  float* s_ts = reinterpret_cast<float*>(s_feat + n_nodes);
  float* s_ls = s_ts + t;
  T* s_thr = reinterpret_cast<T*>(s_ls + t);
  T* s_leaf = s_thr + n_nodes;
  for (size_t i = threadIdx.x; i < n_nodes; i += blockDim.x) {
    s_feat[i] = feature[s * n_nodes + i];
    s_thr[i] = threshold[s * n_nodes + i];
  }
  for (size_t i = threadIdx.x; i < n_leaf; i += blockDim.x)
    s_leaf[i] = leaf[s * n_leaf + i];
  for (int i = threadIdx.x; i < t; i += blockDim.x) {
    s_ts[i] = thr_scale[s * t + i];
    s_ls[i] = leaf_scale[s * t + i];
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= b) return;  // the ragged last tile
  const float* xb = x + (s * b + lane) * F;
  float* ob = out + (s * b + lane) * C;
  for (int tr = 0; tr < t; ++tr) {
    const int* fe = s_feat + (size_t)tr * N;
    const T* th = s_thr + (size_t)tr * N;
    const float ts = s_ts[tr];
    int idx = 0;
    for (int lvl = 0; lvl < depth; ++lvl) {
      const float v = Tab::thr(th[idx], ts);
      idx = 2 * idx + 1 + (xb[fe[idx]] > v ? 1 : 0);
    }
    const T* lf = s_leaf + ((size_t)tr * L + (idx - N)) * C;
    const float ls = s_ls[tr];
    for (int c = 0; c < C; ++c) {
      const float v = Tab::leaf(lf[c], ls);
      ob[c] = tr == 0 ? v : __fadd_rn(ob[c], v);  // trees in order
    }
  }
  const float tf = (float)t;
  for (int c = 0; c < C; ++c) ob[c] = __fdiv_rn(ob[c], tf);
}

template <class Tab>
int launch_traverse(const int* feature, const void* threshold,
                    const void* leaf, const float* thr_scale,
                    const float* leaf_scale, const float* x, float* out,
                    int S, int b, int F, int t, int depth, int C, int block,
                    int smem, cudaStream_t stream) {
  typedef typename Tab::T T;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tree_traverse_kernel<Tab>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((b + block - 1) / block, S);
  tree_traverse_kernel<Tab><<<grid, block, smem, stream>>>(
      feature, static_cast<const T*>(threshold), static_cast<const T*>(leaf),
      thr_scale, leaf_scale, x, out, b, F, t, depth, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// writes cudaDevAttrMaxSharedMemoryPerBlockOptin of `device` to *bytes
int fog_smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// dtype: 0 = fp32, 1 = bf16 (raw bits), 2 = int8
int fog_tree_traverse(int dtype, const int* feature, const void* threshold,
                      const void* leaf, const float* thr_scale,
                      const float* leaf_scale, const float* x, float* out,
                      int S, int b, int F, int t, int depth, int C, int block,
                      int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_traverse<fog::TabF32>(feature, threshold, leaf, thr_scale,
                                          leaf_scale, x, out, S, b, F, t,
                                          depth, C, block, smem, st);
    case 1:
      return launch_traverse<fog::TabBF16>(feature, threshold, leaf,
                                           thr_scale, leaf_scale, x, out, S,
                                           b, F, t, depth, C, block, smem, st);
    case 2:
      return launch_traverse<fog::TabI8>(feature, threshold, leaf, thr_scale,
                                         leaf_scale, x, out, S, b, F, t,
                                         depth, C, block, smem, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
