// The ring's grove walk for NVIDIA Hopper (sm_90a).
//
//   fog_tree_traverse_spread  replaces repro/kernels/tree_traverse.py::_tree_traverse_kernel
//                             (the spread kernel: lanes over many blocks,
//                             trees walked in parallel, the grove read
//                             through L1)
//   fog_tree_traverse         the first port's kernel (one thread per lane),
//                             kept as a declared route for comparison
//   fog_smem_optin            the per-block shared-memory limit a kernel may
//                             opt into (a query, not a kernel)
//
// behind plain C entry points (loaded with ctypes by
// repro_torch/kernels/_build.py, linked into the same library as
// fog_kernels.cu).  Each launch goes on the caller's stream and returns
// cudaGetLastError(); the wrapper (kernels/tree_traverse.py) allocates the
// output and computes the lane plan (tree_traverse.lane_plan), the kernels
// allocate nothing.
//
// What it computes: for each of S stacked ring shards s, each lane's mean
// leaf distribution over the t trees of shard s's grove,
//   out[s, i, :] = (sum over trees in order of leaf[s, tr, idx - N, :]) / t
// where idx walks d levels of idx = 2*idx + 1 + (x[s, i, f] > thr), values
// dequantized after the gather (fog_tables.cuh).  Tables are [S, t, N] and
// [S, t, L, C] at their packed dtype, scales [S, t], x [S, b, F], out
// [S, b, C] fp32.
//
// What bounds it on this card: the function needs one tree's walk per lane
// in a row -- 2d + 1 dependent loads (node, then x[feature], per level,
// then the leaf row) -- and a few KB of bytes; at the ring's B = 1000
// (8 shards of 125 lanes) there is little else, so latency and the number
// of SMs that carry it bound it.  The first kernel (one thread per lane,
// 128 lanes a block) ran 8 blocks on 8 of 132 SMs, copied the grove 4 bytes
// a thread, walked the t trees of a lane one after the other with x read
// from global memory at every level, and read and rewrote its output row
// in global memory for every tree.
//
// The spread design:
//   * lanes over many blocks: a block serves `lanes` lanes of one shard,
//     `lanes` chosen by the wrapper for ~16 blocks per SM (2 lanes a block,
//     504 blocks at B = 1000 on 132 SMs; tree_traverse.lane_plan);
//   * the grove is read in place through the read-only path, so a block of
//     a few lanes touches only the nodes its walks visit and starts walking
//     at once (a variant that first staged the grove in shared memory with
//     the bulk-copy engine measured slower at every lane count the plan
//     picks: each block waited for its copy; PERF.md);
//   * x: the block's rows are read once, coalesced, into shared memory when
//     they fit (lanes * F * 4 <= tree_traverse.X_STAGE_BYTES), else each
//     level gathers x[f] through __ldg;
//   * the trees in parallel: one thread per (lane, tree), tree-major, walks
//     one tree and leaves its leaf row's index in shared memory;
//   * one write per output entry: threads over (lane, class) sum the t leaf
//     values in tree order with __fadd_rn, divide by t with __fdiv_rn and
//     write the entry once, coalesced.
//
// Exact arithmetic: __fadd_rn, __fdiv_rn and (int8) __fmul_rn, built with
// -fmad=false, so the result equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fog_tables.cuh"

namespace {

// ------------------------------------------------------- the spread kernel
// grid (ceil(b / lanes), S); lanes <= blockDim.x is not required: every
// loop strides by blockDim.x.  Shared layout: the leaf rows int32
// [t][lanes], then (stage_x) x rows fp32 [lanes][F].
template <class Tab>
__global__ void __launch_bounds__(1024) tree_traverse_spread_kernel(
    const int* __restrict__ feature, const typename Tab::T* __restrict__ threshold,
    const typename Tab::T* __restrict__ leaf, const float* __restrict__ thr_scale,
    const float* __restrict__ leaf_scale, const float* __restrict__ x,
    float* __restrict__ out, int b, int F, int t, int depth, int C, int lanes,
    int stage_x) {
  typedef typename Tab::T T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = (1 << depth) - 1;  // internal nodes per tree
  const int L = N + 1;             // leaves per tree
  const size_t s = blockIdx.y;
  const int lane0 = blockIdx.x * lanes;
  const int nl = min(lanes, b - lane0);
  const size_t n_nodes = (size_t)t * N;
  const size_t n_leaf = (size_t)t * L * C;

  const int* fe = feature + s * n_nodes;
  const T* th = threshold + s * n_nodes;
  const T* lf = leaf + s * n_leaf;
  const float* ts = thr_scale + s * t;
  const float* ls = leaf_scale + s * t;
  int* s_row = reinterpret_cast<int*>(smem);
  float* s_x = reinterpret_cast<float*>(s_row + (size_t)t * lanes);
  const float* xg = x + (s * b + lane0) * F;
  if (stage_x)
    for (int i = threadIdx.x; i < nl * F; i += blockDim.x) s_x[i] = xg[i];
  __syncthreads();

  // one thread per (lane, tree), tree-major: neighbouring threads walk one
  // tree for neighbouring lanes
  for (int q = threadIdx.x; q < nl * t; q += blockDim.x) {
    const int tr = q / nl, l = q - tr * nl;
    const int* f = fe + (size_t)tr * N;
    const T* h = th + (size_t)tr * N;
    const float sc = ts[tr];
    int idx = 0;
    if (stage_x) {
      const float* xb = s_x + (size_t)l * F;
      for (int lvl = 0; lvl < depth; ++lvl) {
        const float v = Tab::thr(h[idx], sc);
        idx = 2 * idx + 1 + (xb[f[idx]] > v ? 1 : 0);
      }
    } else {
      const float* xb = xg + (size_t)l * F;
      for (int lvl = 0; lvl < depth; ++lvl) {
        const float v = Tab::thr(h[idx], sc);
        idx = 2 * idx + 1 + (__ldg(xb + f[idx]) > v ? 1 : 0);
      }
    }
    s_row[tr * lanes + l] = idx - N;
  }
  __syncthreads();

  // one thread per (lane, class): the trees in order, then / t, one write
  const float tf = (float)t;
  float* ob = out + (s * b + lane0) * C;
  for (int q = threadIdx.x; q < nl * C; q += blockDim.x) {
    const int l = q / C, c = q - l * C;
    float v = Tab::leaf(lf[(size_t)s_row[l] * C + c], ls[0]);
    for (int tr = 1; tr < t; ++tr)
      v = __fadd_rn(v, Tab::leaf(lf[((size_t)tr * L + s_row[tr * lanes + l])
                                    * C + c], ls[tr]));
    ob[q] = __fdiv_rn(v, tf);
  }
}

template <class Tab>
int launch_spread(const int* feature, const void* threshold, const void* leaf,
                  const float* thr_scale, const float* leaf_scale,
                  const float* x, float* out, int S, int b, int F, int t,
                  int depth, int C, int lanes, int threads, int stage_x,
                  int smem, cudaStream_t stream) {
  typedef typename Tab::T T;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tree_traverse_spread_kernel<Tab>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((b + lanes - 1) / lanes, S);
  tree_traverse_spread_kernel<Tab><<<grid, threads, smem, stream>>>(
      feature, static_cast<const T*>(threshold), static_cast<const T*>(leaf),
      thr_scale, leaf_scale, x, out, b, F, t, depth, C, lanes, stage_x);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------- the first port's kernel (a route)
// One thread per lane, block_b lanes a block, grid (ceil(b / block), S):
// each block copies its shard's grove into shared memory one element a
// thread, then each thread walks the t trees in turn, x from global memory,
// summing into its output row.
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

// The spread kernel (dtype as below): `lanes` lanes of one shard a block,
// `threads` threads a block (a multiple of 32), x staged when stage_x,
// `smem` bytes of dynamic shared memory (tree_traverse.lane_plan).
int fog_tree_traverse_spread(int dtype, const int* feature,
                             const void* threshold, const void* leaf,
                             const float* thr_scale, const float* leaf_scale,
                             const float* x, float* out, int S, int b, int F,
                             int t, int depth, int C, int lanes, int threads,
                             int stage_x, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes < 1 || threads < 32 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch_spread<fog::TabF32>(
          feature, threshold, leaf, thr_scale, leaf_scale, x, out, S, b, F, t,
          depth, C, lanes, threads, stage_x, smem, st);
    case 1:
      return launch_spread<fog::TabBF16>(
          feature, threshold, leaf, thr_scale, leaf_scale, x, out, S, b, F, t,
          depth, C, lanes, threads, stage_x, smem, st);
    case 2:
      return launch_spread<fog::TabI8>(
          feature, threshold, leaf, thr_scale, leaf_scale, x, out, S, b, F, t,
          depth, C, lanes, threads, stage_x, smem, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The first port's kernel: dtype 0 = fp32, 1 = bf16 (raw bits), 2 = int8
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
