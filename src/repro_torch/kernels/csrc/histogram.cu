// The device trainer's per-level histogram kernel for NVIDIA Hopper (sm_90a).
//
//   fog_histogram   replaces repro/kernels/histogram.py::_hist_kernel
//
// behind a plain C entry point that launches on the caller's stream and
// returns a CUDA error code (loaded with ctypes by
// repro_torch/kernels/_build.py, linked into the same library as
// fog_kernels.cu).  The wrapper (kernels/histogram.py) allocates the output
// with torch.empty (the kernel writes every cell) and chooses the tile plan
// (kernels/histogram.py::tile_plan); the kernel allocates nothing.
//
// What it computes: out[t, node*C + y, f*n_bins + bin] = the sum of w[t, n]
// over the samples n with node[t, n] = node, y[n] = y and bins[n, f] = bin,
// for every tree t and feature f -- the weighted (node, class) x (feature,
// bin) counts from which the trainer reads every candidate split.  A zero
// weight (out of the bootstrap sample, or padding) adds nothing; a node id,
// label or bin outside its range adds nothing either, as in the one-hot
// contraction of the TPU kernel (which builds two one-hot matrices in VMEM
// and multiplies them on the MXU).
//
// Design: a per-block shared-memory histogram that writes each cell once.
// One tile is the rows of (tree t, a group of nodes_per_block nodes) and
// the columns of a group of features_per_block features: at the gate
// config (C = 10, F = 16, 17 bins) all 16 features and 4 nodes, 43.5 KB.
// The rows of a node group are contiguous in the output, so a tile with
// every feature is one contiguous run of it.  A cluster of `cluster`
// blocks (1..8, gridDim.x) owns one tile.  Block r
//   * zeroes its own copy of the tile in shared memory;
//   * scans its share of the tree's samples (a contiguous 1/cluster of
//     them) in rounds of 4 a thread: it lists the samples of its node group
//     (their node ids and weights loaded together, one shared atomic per
//     warp to place them) with their tile rows and weights, then adds each
//     listed sample's weight to its row at each feature's bin with
//     shared-memory atomics, one feature per warp and one sample per lane.
//     fp32 atomicAdd on shared memory is a compare-and-swap loop on Hopper,
//     and at a deep level of a real fit one pure node can hold a thousand
//     samples of one class, so no two warps add into one cell;
//   * after a cluster barrier, sums the cluster's copies of its 1/cluster
//     slice of the tile through distributed shared memory in rank order
//     (every rank's load in flight before the sums, 16 bytes at a time
//     where the tile is a 16-byte aligned run of the output, from its own
//     memory when the cluster is one block) and writes that slice to device
//     memory.
// So no cell is written twice, no global atomic is issued, and no fill
// kernel runs.  The plan gives shallow levels, which have few tiles (32 at
// level 0 of a 32-tree fit), clusters of up to 8 blocks so that the card
// has a block per SM to run; deep levels run one block per tile.
//
// Exactness: every cell is a sum of integer-valued fp32 weights, exact
// below 2**24 per cell, so atomics and the cluster's merge in any order
// give the same bits as the one-hot contraction and the segment-sum twin.
//
// What bounds it: the least time is writing the [T, nodes*C, F*n_bins]
// output once (44.6 MB at level 7 of the gate fit, 0.0133 ms at 3.35 TB/s).
// This design is held back at the deep levels by its scan: each of a
// tree's node-group blocks reads all of the tree's node ids and weights
// (32 blocks x 32 KB a tree at level 7) in rounds whose loads, list and
// atomics wait on each other, and a real fit's node groups are skewed (a
// few hold most of a tree's samples).  Zeroing and writing the tiles
// alone take about as long as the write bound.  Routing each sample to the block that
// owns its node, within a cluster, would read each once (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CLUSTER = 8;
constexpr int SCAN_PER_THREAD = 4;   // samples a thread checks per round

// the address of `p` (in this block's shared memory) in the shared memory
// of block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))),
                 "r"(rank));
  return out;
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// the tile of (node group, feature group) blockIdx.y, tree blockIdx.z, in
// a cluster of gridDim.x blocks
__global__ void histogram_kernel(const int* __restrict__ node,
                                 const int* __restrict__ y,
                                 const float* __restrict__ w,
                                 const uint8_t* __restrict__ bins,
                                 float* __restrict__ out, int N, int F,
                                 int n_bins, int C, int n_nodes,
                                 int nodes_per_block, int features_per_block,
                                 int n_fgroups) {
  extern __shared__ float4 tile4[];
  float* tile = reinterpret_cast<float*>(tile4);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int nd0 = (blockIdx.y / n_fgroups) * nodes_per_block;
  const int f0 = (blockIdx.y % n_fgroups) * features_per_block;
  const int t = blockIdx.z;
  const int ng = min(nodes_per_block, n_nodes - nd0);
  const int fg = min(features_per_block, F - f0);
  const int width = fg * n_bins;             // one tile row
  const int cells = ng * C * width;
  const int tile4_len = (nodes_per_block * C * features_per_block * n_bins +
                         3) / 4;
  // after the tile, one round's list: the block's own samples, their tile
  // rows (-1 for a label out of range) and weights, and its length
  const int list_cap = blockDim.x * SCAN_PER_THREAD;
  int* list = reinterpret_cast<int*>(tile4 + tile4_len);
  int* rows = list + list_cap;
  float* wgt = reinterpret_cast<float*>(rows + list_cap);
  int* count = reinterpret_cast<int*>(wgt + list_cap);
  const int out_row = F * n_bins;
  // the tile is one run of the output (every feature) that 16-byte
  // stores can write
  const bool whole = fg == F && out_row % 4 == 0;
  for (int k = threadIdx.x; k < (cells + 3) / 4; k += blockDim.x)
    tile4[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  const int per = (N + cs - 1) / cs;
  const int n_end = min(N, (rank + 1) * per);
  const int* node_t = node + (size_t)t * N;
  const float* w_t = w + (size_t)t * N;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  // warps per feature when there are fewer features than warps
  const int splits = max(1, warps / fg);
  for (int base = rank * per; base < n_end; base += list_cap) {
    if (threadIdx.x == 0) *count = 0;
    __syncthreads();   // the tile zeroed, the length reset
    // find the block's own samples of this round (weighted, in its node
    // group), SCAN_PER_THREAD a thread with their loads in flight together,
    // and list them: one shared atomic per warp and sample slot
    bool own[SCAN_PER_THREAD];
#pragma unroll
    for (int u = 0; u < SCAN_PER_THREAD; ++u) {
      const int n = base + u * blockDim.x + threadIdx.x;
      own[u] = false;
      if (n < n_end) {
        const int nd = node_t[n] - nd0;
        // nd0 + ng <= n_nodes, so this also drops node ids out of range
        own[u] = w_t[n] != 0.0f && nd >= 0 && nd < ng;
      }
    }
#pragma unroll
    for (int u = 0; u < SCAN_PER_THREAD; ++u) {
      const unsigned mask = __ballot_sync(0xffffffffu, own[u]);
      int first = 0;
      if (lane == 0 && mask) first = atomicAdd(count, __popc(mask));
      first = __shfl_sync(0xffffffffu, first, 0);
      if (own[u])
        list[first + __popc(mask & ((1u << lane) - 1u))] =
            base + u * blockDim.x + threadIdx.x;
    }
    __syncthreads();
    const int m = *count;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const int n = list[i];
      const int c = y[n];
      rows[i] = c >= 0 && c < C ? (node_t[n] - nd0) * C + c : -1;
      wgt[i] = w_t[n];
    }
    __syncthreads();
    // add each listed sample's weight at its bin of every feature, one
    // feature per warp and one sample per lane: no two warps add into one
    // cell (unless features are fewer than warps), so the shared atomics,
    // compare-and-swap loops for fp32 on Hopper, only settle collisions
    // within a warp
    for (int job = warp; job < fg * splits; job += warps) {
      const int f = job % fg;
#pragma unroll 4
      for (int i = (job / fg) * 32 + lane; i < m; i += 32 * splits) {
        const int row = rows[i];
        const int b = bins[(size_t)list[i] * F + f0 + f];
        if (row >= 0 && b < n_bins)
          atomicAdd(tile + row * width + f * n_bins + b, wgt[i]);
      }
    }
    __syncthreads();   // the list consumed before the next round's
  }
  cluster.sync();   // every copy complete and visible to the cluster

  // this block's slice of the tile, the cluster's copies summed in rank
  // order: every rank's load is issued before the sums
  float* out_t = out + ((size_t)t * n_nodes + nd0) * C * out_row +
                 (size_t)f0 * n_bins;
  uint32_t src[MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q)
    src[q] = q < cs ? map_rank(tile, q) : 0u;
  if (whole) {
    const int n4 = cells / 4;
    const int lo = static_cast<int>((long long)n4 * rank / cs);
    const int hi = static_cast<int>((long long)n4 * (rank + 1) / cs);
    float4* dst = reinterpret_cast<float4*>(out_t);
    for (int k = lo + threadIdx.x; k < hi; k += blockDim.x) {
      if (cs == 1) {
        dst[k] = tile4[k];
        continue;
      }
      float4 v[MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < cs) v[q] = ld_cluster4(src[q] + 16u * k);
      float4 sum = v[0];
#pragma unroll
      for (int q = 1; q < MAX_CLUSTER; ++q)
        if (q < cs) sum = add4(sum, v[q]);
      dst[k] = sum;
    }
  } else {
    const int lo = static_cast<int>((long long)cells * rank / cs);
    const int hi = static_cast<int>((long long)cells * (rank + 1) / cs);
    for (int k = lo + threadIdx.x; k < hi; k += blockDim.x) {
      float v[MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < cs) v[q] = ld_cluster(src[q] + 4u * k);
      float sum = v[0];
#pragma unroll
      for (int q = 1; q < MAX_CLUSTER; ++q)
        if (q < cs) sum = __fadd_rn(sum, v[q]);
      out_t[(size_t)(k / width) * out_row + k % width] = sum;
    }
  }
  cluster.sync();   // no block leaves while another reads its copy
}

}  // namespace

extern "C" {

// node [T, N] int32, y [N] int32, w [T, N] fp32, bins [N, F] uint8 ->
// out [T, n_nodes * C, F * n_bins] fp32, every cell written.  The tile
// plan (nodes_per_block, features_per_block, cluster) and the threads per
// block come from the wrapper (kernels/histogram.py::tile_plan).
int fog_histogram(const int* node, const int* y, const float* w,
                  const uint8_t* bins, float* out, int T, int N, int F,
                  int n_bins, int C, int n_nodes, int nodes_per_block,
                  int features_per_block, int cluster, int block,
                  void* stream) {
  if (T < 1 || N < 0 || F < 1 || n_bins < 1 || C < 1 || n_nodes < 1 ||
      nodes_per_block < 1 || features_per_block < 1 || cluster < 1 ||
      cluster > MAX_CLUSTER || T > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_groups = (n_nodes + nodes_per_block - 1) / nodes_per_block;
  const int n_fgroups = (F + features_per_block - 1) / features_per_block;
  if ((long long)n_groups * n_fgroups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the tile in whole 16-byte units, then a round's list (samples, rows,
  // weights) and its length
  const size_t smem =
      ((size_t)nodes_per_block * C * features_per_block * n_bins + 3) / 4 *
          16 +
      (size_t)block * SCAN_PER_THREAD * 12 + 16;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, n_groups * n_fgroups, T);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, histogram_kernel, node, y, w, bins, out, N, F, n_bins, C,
      n_nodes, nodes_per_block, features_per_block, n_fgroups);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
