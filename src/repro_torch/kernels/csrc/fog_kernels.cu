// Field of Groves inference kernels for NVIDIA Hopper (sm_90a).
//
// The inference kernels, each behind a plain C entry point that launches on the
// caller's stream and returns cudaGetLastError() (loaded with ctypes by
// repro_torch/kernels/_build.py; the wrappers allocate every output and
// scratch buffer, the kernels allocate nothing):
//
//   fog_top2_confidence   replaces repro/kernels/top2_confidence.py::_top2_kernel
//                         (one thread per short row, or blocks that share
//                         a long row and a merge pass)
//   fog_grove_aggregate_tile  replace repro/kernels/grove_aggregate.py::_aggregate_kernel
//   fog_grove_aggregate   (the tile kernel: warp tiles read and written
//                         coalesced, rows walked in shared memory; the
//                         first port's kernel, one thread per lane reading
//                         its row in place, for C above the tile's limit
//                         and as the comparison)
//   fog_fused_fog_smem    replace repro/kernels/fused_fog.py::_fused_fog_kernel
//   fog_fused_fog_l1      (the group kernel: a group of threads per lane,
//                         lane state in registers; tables staged in shared
//                         memory, or read through L1)
//   fog_fused_fog         the first port's kernel (one thread per lane), a
//                         declared route for what the group kernel does not
//                         take and the comparison
//
// plus fog_chase, a one-thread pointer chase that only measures the
// latency of a dependent load, and fog_empty, a kernel that does nothing
// (the device time of a launch); neither is on the inference path.
//
// Exact arithmetic: the results must equal the plain PyTorch versions bit
// for bit, so every float operation on the path is an explicitly rounded
// intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn), which nvcc never contracts
// into an FMA; the build also passes -fmad=false.  Means divide by t and
// normalisations divide by max(hops, 1): no reciprocal multiplies.
//
// Design:
//   * top2: one thread per row, block_b threads per block, except for
//     long rows (below), where blocks share a row;
//   * aggregate: not bound by bytes.  At the forest's [B, C <= 26] a call
//     moves 0.1-9 MB (0.00003-0.003 ms at the H100's memory rate), and
//     what sets its time is the launch (an empty kernel ~0.0009 ms) and
//     each lane's chain of dependent steps.  The first kernel (the lane
//     route) loads a row's C entries one after another, 4C bytes apart
//     across a warp, and divides all C: 0.0055-0.0066 ms up to B = 16k,
//     0.012 at 65,536 (PERF.md, row 2).  The tile kernel spreads the lanes
//     over tens of blocks (grove_aggregate.py::plan), reads a warp's rows
//     as one contiguous run, walks each row in shared memory and divides
//     two entries: 0.0025-0.0029 up to 16k, 0.0032-0.0034 at 65,536 (1.2-
//     1.7x the bytes bound);
//   * fused_fog (the group kernel below): what bounds it on this card is
//     the chain a lane needs -- one tree's walk, 2d + 1 dependent loads, then
//     the gate's in-order arithmetic hop by hop -- not bytes (the bench
//     field is 192 KiB).  The first port's kernel (one thread per lane, the
//     [O, C] accumulators in a global scratch buffer, the tables read from
//     L2 inside the chain) walked max_hops x O x t trees in a row per lane
//     and ran 8 blocks on 8 SMs at B = 1000; it stays as the "lane" route
//     (fused_fog_kernel) for fields whose lane state does not fit the group
//     kernel's registers, and as the comparison.  The group kernel gives a
//     lane a group of threads that walks the trees of K hops at once, keeps
//     the lane state in registers split by class over the group, and reads
//     the tables from shared memory (the "smem" route: staged once per
//     block by the bulk-copy engine, fog_stage.cuh, with a grid of at most
//     the blocks the SMs hold at once looping over the lanes) or in place
//     through L1 (the "l1" route); kernels/fused_fog.py::route picks one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <limits.h>
#include <stdint.h>

#include "fog_stage.cuh"
#include "fog_tables.cuh"

namespace {

using fog::TabBF16;
using fog::TabF32;
using fog::TabI8;

// ---------------------------------------------------------------- MaxDiff
// |max - second max| of a row whose elements sit `stride` floats apart,
// with only the FIRST maximal element masked (a tie gives 0).
__device__ __forceinline__ float maxdiff_row(const float* p, int stride, int C) {
  float m1 = p[0];
  int i1 = 0;
  for (int c = 1; c < C; ++c) {
    const float v = p[(size_t)c * stride];
    if (v > m1) { m1 = v; i1 = c; }
  }
  float m2 = -CUDART_INF_F;
  for (int c = 0; c < C; ++c) {
    if (c == i1) continue;
    const float v = p[(size_t)c * stride];
    if (v > m2) m2 = v;
  }
  return fabsf(__fsub_rn(m1, m2));
}

// One thread per row: short rows (the forest's [B, C <= 26] margins).
__global__ void top2_confidence_kernel(const float* __restrict__ prob,
                                       float* __restrict__ out, int B, int C) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  out[b] = maxdiff_row(prob + (size_t)b * C, 1, C);
}

// Long rows (the LM gate's [B, V], V = 32,000-50,280, at B = 4): blocks
// share a row.  Each thread keeps the top two of its stride of the row
// (the first index of its maximum; a repeat of the maximum becomes the
// second), then warp shuffles, then the block's 8 warps in shared memory,
// then, where a row has several blocks, a second small kernel over their
// [B, nblk] partials.  A second launch rather than a cluster: it needs no
// cluster launch attributes and costs ~2 us, while a cluster caps a row at
// 8 blocks (16 portably) of one GPC.  Merging takes the larger maximum
// (the lower index on a tie) and the larger of the winner's second and the
// loser's maximum, so only the first maximal entry is masked, in any
// order; nothing is rounded, so the result equals the one-thread walk.
constexpr int TOP2_THREADS = 256;

struct Top2 {
  float m1, m2;  // the maximum and the largest other entry
  int i1;        // the maximum's first index (INT_MAX: none seen)
};

__device__ __forceinline__ Top2 top2_merge(Top2 a, Top2 b) {
  const bool a_wins = a.m1 > b.m1 || (a.m1 == b.m1 && a.i1 < b.i1);
  Top2 w = a_wins ? a : b;
  const float other = a_wins ? b.m1 : a.m1;
  if (other > w.m2) w.m2 = other;
  return w;
}

__device__ __forceinline__ Top2 top2_warp(Top2 t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top2 o;
    o.m1 = __shfl_xor_sync(0xffffffffu, t.m1, off);
    o.m2 = __shfl_xor_sync(0xffffffffu, t.m2, off);
    o.i1 = __shfl_xor_sync(0xffffffffu, t.i1, off);
    t = top2_merge(t, o);
  }
  return t;
}

// row blockIdx.x, columns [blockIdx.y * cols, (blockIdx.y + 1) * cols);
// with one block per row it writes the margin, else its partial
__global__ void __launch_bounds__(TOP2_THREADS) top2_confidence_kernel_rows(
    const float* __restrict__ prob, float* __restrict__ out,
    float* __restrict__ part_m1, float* __restrict__ part_m2,
    int* __restrict__ part_i1, int C, int cols) {
  __shared__ Top2 warps[TOP2_THREADS / 32];
  const int b = blockIdx.x, blk = blockIdx.y, nblk = gridDim.y;
  const int c0 = blk * cols, c1 = min(C, c0 + cols);
  const float* row = prob + (size_t)b * C;
  Top2 t = {-CUDART_INF_F, -CUDART_INF_F, INT_MAX};
  for (int c = c0 + threadIdx.x; c < c1; c += TOP2_THREADS) {
    const float v = row[c];
    if (v > t.m1) {
      t.m2 = t.m1;
      t.m1 = v;
      t.i1 = c;
    } else if (v > t.m2) {
      t.m2 = v;
    }
  }
  t = top2_warp(t);
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = t;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < TOP2_THREADS / 32; ++w) t = top2_merge(t, warps[w]);
  if (nblk == 1) {
    out[b] = fabsf(__fsub_rn(t.m1, t.m2));
  } else {
    const size_t k = (size_t)b * nblk + blk;
    part_m1[k] = t.m1;
    part_m2[k] = t.m2;
    part_i1[k] = t.i1;
  }
}

// one warp per row over its nblk partials
__global__ void top2_confidence_kernel_merge(
    const float* __restrict__ part_m1, const float* __restrict__ part_m2,
    const int* __restrict__ part_i1, float* __restrict__ out, int nblk) {
  const int b = blockIdx.x;
  Top2 t = {-CUDART_INF_F, -CUDART_INF_F, INT_MAX};
  for (int j = threadIdx.x; j < nblk; j += 32) {
    const size_t k = (size_t)b * nblk + j;
    t = top2_merge(t, Top2{part_m1[k], part_m2[k], part_i1[k]});
  }
  t = top2_warp(t);
  if (threadIdx.x == 0) out[b] = fabsf(__fsub_rn(t.m1, t.m2));
}

// ------------------------------------------------------- one hop update
// prob += contrib * live; hops += live; margin = MaxDiff(prob / max(hops,1));
// live &= margin < thresh.
//
// The first port's kernel, the lane route: one thread per lane, block_b
// lanes a block, each thread reading its row in place (a warp's loads of
// one column lie 4C bytes apart) and reading back the row it wrote for
// the second maximum.
__global__ void grove_aggregate_kernel(
    const float* __restrict__ prob, const float* __restrict__ contrib,
    const uint8_t* __restrict__ live, const int* __restrict__ hops,
    const float* __restrict__ thresh, float* __restrict__ prob_out,
    int* __restrict__ hops_out, uint8_t* __restrict__ live_out,
    float* __restrict__ margin_out, int B, int C) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const bool lv = live[b] != 0;
  const int h = hops[b] + (lv ? 1 : 0);
  const float denom = (float)max(h, 1);
  const float* p = prob + (size_t)b * C;
  const float* q = contrib + (size_t)b * C;
  float* po = prob_out + (size_t)b * C;
  float m1 = 0.f;
  int i1 = 0;
  for (int c = 0; c < C; ++c) {
    const float a = __fadd_rn(p[c], lv ? q[c] : 0.0f);
    po[c] = a;
    const float v = __fdiv_rn(a, denom);
    if (c == 0 || v > m1) { m1 = v; i1 = c; }
  }
  float m2 = -CUDART_INF_F;
  for (int c = 0; c < C; ++c) {
    if (c == i1) continue;
    const float v = __fdiv_rn(po[c], denom);
    if (v > m2) m2 = v;
  }
  const float margin = fabsf(__fsub_rn(m1, m2));
  hops_out[b] = h;
  live_out[b] = (lv && margin < thresh[b]) ? 1 : 0;
  margin_out[b] = margin;
}

// The tile route (kernels/grove_aggregate.py::plan): blockDim.x lanes a
// block, each warp its own 32 lanes, no block-wide barrier.  A warp's rows
// of prob and contrib are one contiguous run of 32 x C floats, read as such
// (16-byte vectors when `vec` -- the three [B, C] pointers 16-byte aligned
// -- and the warp full; scalar otherwise: a ragged last warp, a row-offset
// view); contrib is loaded only for the elements (vectors) of live lanes,
// so a warp whose lanes are all dead loads none.  The sums go to prob_out
// from the same registers and into the warp's tile [32, S] in shared
// memory, S = C | 1 (odd, so the row walk below touches 32 banks).  Then
// each thread walks its own row in the tile for its top two and divides
// those two by max(hops, 1) (below: the same margin as C divisions), and
// writes its lane's hops, live and margin.  A dead lane's row is still
// p + 0.0f (the plain version adds a zero: -0.0 becomes +0.0) and its
// margin still computed (the two-head path reads it).
__global__ void __launch_bounds__(1024) grove_aggregate_tile_kernel(
    const float* __restrict__ prob, const float* __restrict__ contrib,
    const uint8_t* __restrict__ live, const int* __restrict__ hops,
    const float* __restrict__ thresh, float* __restrict__ prob_out,
    int* __restrict__ hops_out, uint8_t* __restrict__ live_out,
    float* __restrict__ margin_out, int B, int C, int vec) {
  extern __shared__ float agg_tile[];
  const int lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * blockDim.x + (threadIdx.x & ~31);
  if (b0 >= B) return;  // the whole warp
  const int S = C | 1;
  float* tile = agg_tile + (size_t)(threadIdx.x >> 5) * 32 * S;
  const int n = min(32, B - b0);  // lanes of this warp
  const int b = b0 + lane;
  const bool in = lane < n;
  const bool lv = in && live[b] != 0;
  const int h = in ? hops[b] + (lv ? 1 : 0) : 0;
  const float th = in ? thresh[b] : 0.f;
  const unsigned lm = __ballot_sync(0xffffffffu, lv);
  const size_t base = (size_t)b0 * C;
  if (vec && n == 32) {
    // 8 x C vectors; vector i holds elements 4i .. 4i + 3, element e at
    // row e / C, column e % C
    const float4* p4 = reinterpret_cast<const float4*>(prob + base);
    const float4* q4 = reinterpret_cast<const float4*>(contrib + base);
    float4* o4 = reinterpret_cast<float4*>(prob_out + base);
    for (int i = lane; i < 8 * C; i += 32) {
      int r[4], c[4];
      r[0] = 4 * i / C;
      c[0] = 4 * i - r[0] * C;
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        c[k] = c[k - 1] + 1;
        r[k] = r[k - 1];
        if (c[k] == C) { c[k] = 0; ++r[k]; }
      }
      bool l[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) l[k] = (lm >> r[k]) & 1u;
      const float4 pv = p4[i];
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (l[0] || l[1] || l[2] || l[3]) qv = q4[i];
      float4 a;
      a.x = __fadd_rn(pv.x, l[0] ? qv.x : 0.0f);
      a.y = __fadd_rn(pv.y, l[1] ? qv.y : 0.0f);
      a.z = __fadd_rn(pv.z, l[2] ? qv.z : 0.0f);
      a.w = __fadd_rn(pv.w, l[3] ? qv.w : 0.0f);
      o4[i] = a;
      tile[r[0] * S + c[0]] = a.x;
      tile[r[1] * S + c[1]] = a.y;
      tile[r[2] * S + c[2]] = a.z;
      tile[r[3] * S + c[3]] = a.w;
    }
  } else {
    const float* p = prob + base;
    const float* q = contrib + base;
    float* po = prob_out + base;
    for (int e = lane; e < n * C; e += 32) {
      const int r = e / C, c = e - r * C;
      float qv = 0.0f;
      if ((lm >> r) & 1u) qv = q[e];
      const float a = __fadd_rn(p[e], qv);
      po[e] = a;
      tile[r * S + c] = a;
    }
  }
  __syncwarp();
  if (!in) return;
  // The row's first maximum m1 and the largest other entry m2, taken on
  // the sums (a tie leaves m2 == m1), then divided: a correctly rounded
  // division by the same d > 0 never reverses an order, so the first
  // maximum of the sums is a maximum of the quotients and the largest
  // other quotient is m2 / d -- the margin the plain version computes
  // from C quotients, from two.
  const float* row = tile + lane * S;
  float m1 = row[0], m2 = -CUDART_INF_F;
#pragma unroll 4
  for (int c = 1; c < C; ++c) {
    const float v = row[c];
    if (v > m1) {
      m2 = m1;
      m1 = v;
    } else if (v > m2) {
      m2 = v;
    }
  }
  const float denom = (float)max(h, 1);
  const float margin =
      fabsf(__fsub_rn(__fdiv_rn(m1, denom), __fdiv_rn(m2, denom)));
  hops_out[b] = h;
  live_out[b] = (lv && margin < th) ? 1 : 0;
  margin_out[b] = margin;
}

// A kernel that does nothing: chip_smoke.py times it as the device time of
// a launch, the floor under every kernel's time.  Not on the inference path.
__global__ void empty_kernel() {}

// ------------------------- the whole Algorithm 2, one thread per lane
// The first port's kernel, the lane route (kernels/fused_fog.py::route):
// one thread per lane, block_b lanes a block, tables read in place, the
// trees of each hop walked in turn.  Lane state that is indexed by class
// lives in `scratch`, laid out lane-minor so a warp's accesses coalesce:
//   acc[o][c][b] = scratch[(o * C + c) * B + b]       (O * C * B floats)
//   con[c][b]    = scratch[(O * C + c) * B + b]       (C * B floats)
template <class Tab>
__global__ void fused_fog_kernel(
    const int* __restrict__ feature, const typename Tab::T* __restrict__ threshold,
    const typename Tab::T* __restrict__ leaf, const float* __restrict__ thr_scale,
    const float* __restrict__ leaf_scale, const float* __restrict__ x,
    const int* __restrict__ start, const float* __restrict__ thresh,
    const int* __restrict__ budget, float* __restrict__ proba,
    int* __restrict__ hops_out, float* __restrict__ scratch, int B, int F,
    int O, int G, int t, int depth, int C, int max_hops) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;  // the dead-lane padding of the TPU kernel
  const int N = (1 << depth) - 1;  // internal nodes per tree
  const int L = N + 1;             // leaves per tree
  float* acc = scratch;
  float* con = scratch + (size_t)O * C * B;
  for (int k = 0; k < O * C; ++k) acc[(size_t)k * B + b] = 0.f;

  const float* xb = x + (size_t)b * F;
  const int s = start[b];
  const float th = thresh[b];
  const int bud = budget[b];
  const float tf = (float)t;
  int hops = 0;
  bool live = true;
  for (int j = 0; j < max_hops && live; ++j) {
    const int g = ((s + j) % G + G) % G;  // floor modulo, as jnp's %
    ++hops;
    const float denom = (float)hops;
    float margin = CUDART_INF_F;
    for (int o = 0; o < O; ++o) {
      for (int c = 0; c < C; ++c) con[(size_t)c * B + b] = 0.f;
      for (int tr = 0; tr < t; ++tr) {
        const size_t tree = ((size_t)o * G + g) * t + tr;
        const int* fe = feature + tree * N;
        const typename Tab::T* thr = threshold + tree * N;
        const float ts = thr_scale[tree];
        int idx = 0;
        for (int lvl = 0; lvl < depth; ++lvl) {
          const float v = Tab::thr(thr[idx], ts);
          idx = 2 * idx + 1 + (xb[fe[idx]] > v ? 1 : 0);
        }
        const typename Tab::T* lf = leaf + (tree * L + (idx - N)) * C;
        const float ls = leaf_scale[tree];
        for (int c = 0; c < C; ++c) {
          float* cc = con + (size_t)c * B + b;
          *cc = __fadd_rn(*cc, Tab::leaf(lf[c], ls));
        }
      }
      // mean over trees, accumulate, normalise, first-max MaxDiff
      float* ao = acc + (size_t)o * C * B + b;
      float m1 = 0.f;
      int i1 = 0;
      for (int c = 0; c < C; ++c) {
        const float a = __fadd_rn(ao[(size_t)c * B],
                                  __fdiv_rn(con[(size_t)c * B + b], tf));
        ao[(size_t)c * B] = a;
        const float v = __fdiv_rn(a, denom);
        if (c == 0 || v > m1) { m1 = v; i1 = c; }
      }
      float m2 = -CUDART_INF_F;
      for (int c = 0; c < C; ++c) {
        if (c == i1) continue;
        const float v = __fdiv_rn(ao[(size_t)c * B], denom);
        if (v > m2) m2 = v;
      }
      margin = fminf(margin, fabsf(__fsub_rn(m1, m2)));  // min over heads
    }
    live = (margin < th) && (hops < bud);
  }
  const float denom = (float)max(hops, 1);
  for (int o = 0; o < O; ++o)
    for (int c = 0; c < C; ++c)
      proba[((size_t)b * O + o) * C + c] =
          __fdiv_rn(acc[((size_t)o * C + c) * B + b], denom);
  hops_out[b] = hops;
}

// ------------------------------------ the whole Algorithm 2, lane groups
// A group of `group` threads (a power of two <= 32, within one warp) serves
// one lane at a time; a block holds blockDim.x / group groups, and group g
// of block k serves lanes k * gpb + g, then that plus gridDim.x * gpb, ...
// (the smem route's grid is at most the blocks the SMs hold at once; the l1
// route's covers the batch, one lane a group).
//
// Per lane: its grove sequence (start + j) mod G does not depend on the
// gate, so the group walks the K x O x t trees of the next K hops at once
// (walk slot w = (jj * O + o) * t + tr, thread r takes w = r, r + group,
// ...) and leaves each leaf row's index in shared memory; then the gate
// runs hop by hop over those rows in order -- per (head, class), owned by
// thread c % group: trees summed in order, / t, added to the accumulator
// (a register), / hops -- and the first-max MaxDiff of each head is merged
// over the group by xor shuffles (the larger maximum, the lower index on a
// tie, the larger of the winner's second and the loser's maximum: only the
// first maximal entry is masked, in any merge order, with nothing rounded),
// the minimum over heads against the lane's threshold and hop budget.
// Every thread of a group gets the same margin, so the group stays in step.
// A lane that exits inside a batch leaves the batch's later walks unused.
//
// Lane state: thread r owns classes r, r + group, ... of every head, NACC
// registers (O * ceil(C / group) rounded up to 1, 2, 4 or FUSED_ACC = 8,
// an instance each; the wrapper routes anything larger to the lane route).
// Shared layout: the mbarrier, then (STAGE) the field's five tables at
// region_bytes each, then per group the leaf rows int32 [K * O * t] and
// (stage_x) the lane's x row fp32 [F].
constexpr int FUSED_ACC = 8;
// threads a block runs at most: 512, so that a thread may hold 128
// registers and no instance spills
constexpr int GROUP_THREADS = 512;

__device__ __forceinline__ int floor_mod(int a, int m) {
  return ((a % m) + m) % m;  // jnp's % for a positive modulus
}

__device__ __forceinline__ Top2 top2_group(Top2 t, unsigned mask, int group) {
  for (int off = group / 2; off > 0; off >>= 1) {
    Top2 o;
    o.m1 = __shfl_xor_sync(mask, t.m1, off, group);
    o.m2 = __shfl_xor_sync(mask, t.m2, off, group);
    o.i1 = __shfl_xor_sync(mask, t.i1, off, group);
    t = top2_merge(t, o);
  }
  return t;
}

template <class Tab, bool STAGE, int NACC>
__global__ void __launch_bounds__(GROUP_THREADS, 1) fused_fog_group_kernel(
    const int* __restrict__ feature, const typename Tab::T* __restrict__ threshold,
    const typename Tab::T* __restrict__ leaf, const float* __restrict__ thr_scale,
    const float* __restrict__ leaf_scale, const float* __restrict__ x,
    const int* __restrict__ start, const float* __restrict__ thresh,
    const int* __restrict__ budget, float* __restrict__ proba,
    int* __restrict__ hops_out, int B, int F, int O, int G, int t, int depth,
    int C, int max_hops, int K, int group, int stage_x) {
  typedef typename Tab::T T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = (1 << depth) - 1;  // internal nodes per tree
  const int L = N + 1;             // leaves per tree
  const int n_trees = O * G * t;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* p = smem + 16;
  const int* fe = feature;
  const T* th = threshold;
  const T* lf = leaf;
  const float* ts = thr_scale;
  const float* ls = leaf_scale;
  if (STAGE) {
    p = fog::stage_grove(p, bar, fe, th, lf, ts, ls, (size_t)n_trees * N,
                         (size_t)n_trees * L * C, (size_t)n_trees);
    __syncthreads();
    mbar_wait(bar, 0);
  }
  const int W = K * O * t;  // walk slots of one batch of K hops
  const int gpb = blockDim.x / group;
  const int gi = threadIdx.x / group, r = threadIdx.x - gi * group;
  int* row = reinterpret_cast<int*>(p) + (size_t)gi * W;
  float* xs = reinterpret_cast<float*>(reinterpret_cast<int*>(p) +
                                       (size_t)gpb * W) + (size_t)gi * F;
  const unsigned wl = threadIdx.x & 31;
  const unsigned mask =
      group == 32 ? 0xffffffffu
                  : ((1u << group) - 1u) << (wl & ~(unsigned)(group - 1));
  const int cpt = (C + group - 1) / group;  // classes a thread owns per head
  const int nacc = O * cpt;
  const int OT = O * t;
  const float tf = (float)t;

  for (int b = blockIdx.x * gpb + gi; b < B; b += gridDim.x * gpb) {
    __syncwarp(mask);  // the group's previous lane is done with row and xs
    const float* xb = x + (size_t)b * F;
    if (stage_x) {
      for (int f = r; f < F; f += group) xs[f] = xb[f];
      __syncwarp(mask);
      xb = xs;
    }
    const int s0 = start[b];
    const float lane_thresh = thresh[b];
    const int bud = budget[b];
    float acc[NACC];
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
    int hops = 0;
    bool live = true;
    for (int j0 = 0; j0 < max_hops && live; j0 += K) {
      const int nk = min(K, max_hops - j0);
      for (int w = r; w < nk * OT; w += group) {
        const int jj = w / OT, rem = w - jj * OT;
        const int o = rem / t, tr = rem - o * t;
        const int g = floor_mod(s0 + j0 + jj, G);
        const int tree = (o * G + g) * t + tr;
        const int* f = fe + tree * N;
        const T* h = th + tree * N;
        const float sc = ts[tree];
        int idx = 0;
        for (int lvl = 0; lvl < depth; ++lvl) {
          const float v = Tab::thr(h[idx], sc);
          idx = 2 * idx + 1 + (xb[f[idx]] > v ? 1 : 0);
        }
        row[w] = tree * L + idx - N;
      }
      __syncwarp(mask);
      for (int jj = 0; jj < nk && live; ++jj) {
        const int g = floor_mod(s0 + j0 + jj, G);
        ++hops;
        const float denom = (float)hops;
        float margin = CUDART_INF_F;
        for (int o = 0; o < O; ++o) {
          const int* rw = row + (jj * O + o) * t;
          const int tree0 = (o * G + g) * t;
          Top2 tp = {-CUDART_INF_F, -CUDART_INF_F, INT_MAX};
          // one class at a time (one copy of the divisions, few live
          // registers); its accumulator read and written by a select over
          // the unrolled slots, so it stays in a register
#pragma unroll 1
          for (int i = 0; i < cpt; ++i) {
            const int c = r + group * i;
            if (c >= C) break;
            const int k = o * cpt + i;
            float con = Tab::leaf(lf[(size_t)rw[0] * C + c], ls[tree0]);
            for (int tr = 1; tr < t; ++tr)
              con = __fadd_rn(con, Tab::leaf(lf[(size_t)rw[tr] * C + c],
                                             ls[tree0 + tr]));
            float a = 0.f;
#pragma unroll
            for (int j = 0; j < NACC; ++j)
              if (j == k) a = acc[j];
            a = __fadd_rn(a, __fdiv_rn(con, tf));
#pragma unroll
            for (int j = 0; j < NACC; ++j)
              if (j == k) acc[j] = a;
            const float v = __fdiv_rn(a, denom);
            if (v > tp.m1) {
              tp.m2 = tp.m1;
              tp.m1 = v;
              tp.i1 = c;
            } else if (v > tp.m2) {
              tp.m2 = v;
            }
          }
          tp = top2_group(tp, mask, group);
          margin = fminf(margin, fabsf(__fsub_rn(tp.m1, tp.m2)));
        }
        live = (margin < lane_thresh) && (hops < bud);
      }
      __syncwarp(mask);  // every thread read the batch's rows
    }
    const float denom = (float)max(hops, 1);
#pragma unroll 1
    for (int k = 0; k < nacc; ++k) {
      const int o = k / cpt, c = r + group * (k - o * cpt);
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < NACC; ++j)
        if (j == k) a = acc[j];
      if (c < C) proba[((size_t)b * O + o) * C + c] = __fdiv_rn(a, denom);
    }
    if (r == 0) hops_out[b] = hops;
  }
}

template <class Tab, bool STAGE, int NACC>
int launch_group(const int* feature, const void* threshold, const void* leaf,
                 const float* thr_scale, const float* leaf_scale,
                 const float* x, const int* start, const float* thresh,
                 const int* budget, float* proba, int* hops, int B, int F,
                 int O, int G, int t, int depth, int C, int max_hops, int K,
                 int group, int grid, int threads, int stage_x, int smem,
                 cudaStream_t stream) {
  typedef typename Tab::T T;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_fog_group_kernel<Tab, STAGE, NACC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_fog_group_kernel<Tab, STAGE, NACC><<<grid, threads, smem, stream>>>(
      feature, static_cast<const T*>(threshold), static_cast<const T*>(leaf),
      thr_scale, leaf_scale, x, start, thresh, budget, proba, hops, B, F, O,
      G, t, depth, C, max_hops, K, group, stage_x);
  return static_cast<int>(cudaGetLastError());
}

// the instance that holds `nacc` accumulators a thread
template <class Tab, bool STAGE>
int launch_nacc(int nacc, const int* feature, const void* threshold,
                const void* leaf, const float* thr_scale,
                const float* leaf_scale, const float* x, const int* start,
                const float* thresh, const int* budget, float* proba,
                int* hops, int B, int F, int O, int G, int t, int depth, int C,
                int max_hops, int K, int group, int grid, int threads,
                int stage_x, int smem, cudaStream_t s) {
#define FOG_GROUP(n)                                                        \
  launch_group<Tab, STAGE, n>(feature, threshold, leaf, thr_scale,          \
                              leaf_scale, x, start, thresh, budget, proba,  \
                              hops, B, F, O, G, t, depth, C, max_hops, K,   \
                              group, grid, threads, stage_x, smem, s)
  if (nacc <= 1) return FOG_GROUP(1);
  if (nacc <= 2) return FOG_GROUP(2);
  if (nacc <= 4) return FOG_GROUP(4);
  return FOG_GROUP(FUSED_ACC);
#undef FOG_GROUP
}

template <bool STAGE>
int fused_group(int dtype, const int* feature, const void* threshold,
                const void* leaf, const float* thr_scale,
                const float* leaf_scale, const float* x, const int* start,
                const float* thresh, const int* budget, float* proba,
                int* hops, int B, int F, int O, int G, int t, int depth, int C,
                int max_hops, int K, int group, int grid, int threads,
                int stage_x, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nacc = O * ((C + group - 1) / group);
  if (group < 1 || group > 32 || (group & (group - 1)) || K < 1 ||
      threads < 32 || threads > GROUP_THREADS || threads % 32 || grid < 1 ||
      nacc > FUSED_ACC)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch_nacc<TabF32, STAGE>(
          nacc, feature, threshold, leaf, thr_scale, leaf_scale, x, start,
          thresh, budget, proba, hops, B, F, O, G, t, depth, C, max_hops, K,
          group, grid, threads, stage_x, smem, s);
    case 1:
      return launch_nacc<TabBF16, STAGE>(
          nacc, feature, threshold, leaf, thr_scale, leaf_scale, x, start,
          thresh, budget, proba, hops, B, F, O, G, t, depth, C, max_hops, K,
          group, grid, threads, stage_x, smem, s);
    case 2:
      return launch_nacc<TabI8, STAGE>(
          nacc, feature, threshold, leaf, thr_scale, leaf_scale, x, start,
          thresh, budget, proba, hops, B, F, O, G, t, depth, C, max_hops, K,
          group, grid, threads, stage_x, smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// --------------------------------------- measurement: dependent-load latency
// Not on the inference path.  One thread follows the chain next[i] `steps`
// times; every load waits for the one before, so the time per step is the
// latency of one dependent global load over a working set of next[]'s size,
// read through the same const __restrict__ path as fused_fog's gathers.
// chip_smoke.py times it to turn fused_fog's dependent-gather chain into a
// latency bound in milliseconds.
__global__ void chase_kernel(const int* __restrict__ next, int steps,
                             int* __restrict__ out) {
  int i = 0;
  for (int s = 0; s < steps; ++s) i = next[i];
  *out = i;
}

inline int grid_for(int B, int block) { return (B + block - 1) / block; }

template <class Tab>
void launch_fused(const int* feature, const void* threshold, const void* leaf,
                  const float* thr_scale, const float* leaf_scale,
                  const float* x, const int* start, const float* thresh,
                  const int* budget, float* proba, int* hops, float* scratch,
                  int B, int F, int O, int G, int t, int depth, int C,
                  int max_hops, int block, cudaStream_t stream) {
  typedef typename Tab::T T;
  fused_fog_kernel<Tab><<<grid_for(B, block), block, 0, stream>>>(
      feature, static_cast<const T*>(threshold), static_cast<const T*>(leaf),
      thr_scale, leaf_scale, x, start, thresh, budget, proba, hops, scratch,
      B, F, O, G, t, depth, C, max_hops);
}

}  // namespace

extern "C" {

const char* fog_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// nblk == 0: one thread per row, `block` threads per block.  nblk >= 1:
// nblk blocks of TOP2_THREADS share each row; with nblk > 1 the partials go
// to scratch (3 * B * nblk words) and a second kernel merges them.
int fog_top2_confidence(const float* prob, float* out, float* scratch, int B,
                        int C, int block, int nblk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || C < 1 || nblk < 0 || nblk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblk == 0) {
    top2_confidence_kernel<<<grid_for(B, block), block, 0, s>>>(prob, out, B,
                                                                C);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t n = (size_t)B * nblk;
  float* m1 = scratch;
  float* m2 = scratch + n;
  int* i1 = reinterpret_cast<int*>(scratch + 2 * n);
  const int cols = (C + nblk - 1) / nblk;
  top2_confidence_kernel_rows<<<dim3(B, nblk), TOP2_THREADS, 0, s>>>(
      prob, out, m1, m2, i1, C, cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nblk == 1) return static_cast<int>(err);
  top2_confidence_kernel_merge<<<B, 32, 0, s>>>(m1, m2, i1, out, nblk);
  return static_cast<int>(cudaGetLastError());
}

int fog_grove_aggregate(const float* prob, const float* contrib,
                        const uint8_t* live, const int* hops,
                        const float* thresh, float* prob_out, int* hops_out,
                        uint8_t* live_out, float* margin_out, int B, int C,
                        int block, void* stream) {
  grove_aggregate_kernel<<<grid_for(B, block), block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      prob, contrib, live, hops, thresh, prob_out, hops_out, live_out,
      margin_out, B, C);
  return static_cast<int>(cudaGetLastError());
}

// lanes a block (a multiple of 32), smem >= lanes * (C | 1) floats of
// dynamic shared memory (grove_aggregate.py::plan); vec != 0 only where
// prob, contrib and prob_out start on 16-byte boundaries
int fog_grove_aggregate_tile(const float* prob, const float* contrib,
                             const uint8_t* live, const int* hops,
                             const float* thresh, float* prob_out,
                             int* hops_out, uint8_t* live_out,
                             float* margin_out, int B, int C, int lanes,
                             int vec, int smem, void* stream) {
  if (B < 1 || C < 1 || lanes < 32 || lanes > 1024 || lanes % 32 ||
      (size_t)smem < (size_t)lanes * (C | 1) * sizeof(float))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        grove_aggregate_tile_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  grove_aggregate_tile_kernel<<<grid_for(B, lanes), lanes, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      prob, contrib, live, hops, thresh, prob_out, hops_out, live_out,
      margin_out, B, C, vec);
  return static_cast<int>(cudaGetLastError());
}

int fog_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

int fog_chase(const int* next, int steps, int* out, void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(next, steps,
                                                               out);
  return static_cast<int>(cudaGetLastError());
}

// The group kernel (dtype as below): `group` threads per lane walking K
// hops' trees at once, `threads` threads and `grid` blocks, x staged when
// stage_x, `smem` bytes of dynamic shared memory (fused_fog.plan).  _smem
// stages the field in shared memory, _l1 reads it in place.
int fog_fused_fog_smem(int dtype, const int* feature, const void* threshold,
                       const void* leaf, const float* thr_scale,
                       const float* leaf_scale, const float* x,
                       const int* start, const float* thresh,
                       const int* budget, float* proba, int* hops, int B,
                       int F, int O, int G, int t, int depth, int C,
                       int max_hops, int K, int group, int grid, int threads,
                       int stage_x, int smem, void* stream) {
  return fused_group<true>(dtype, feature, threshold, leaf, thr_scale,
                           leaf_scale, x, start, thresh, budget, proba, hops,
                           B, F, O, G, t, depth, C, max_hops, K, group, grid,
                           threads, stage_x, smem, stream);
}

int fog_fused_fog_l1(int dtype, const int* feature, const void* threshold,
                     const void* leaf, const float* thr_scale,
                     const float* leaf_scale, const float* x,
                     const int* start, const float* thresh, const int* budget,
                     float* proba, int* hops, int B, int F, int O, int G,
                     int t, int depth, int C, int max_hops, int K, int group,
                     int grid, int threads, int stage_x, int smem,
                     void* stream) {
  return fused_group<false>(dtype, feature, threshold, leaf, thr_scale,
                            leaf_scale, x, start, thresh, budget, proba, hops,
                            B, F, O, G, t, depth, C, max_hops, K, group, grid,
                            threads, stage_x, smem, stream);
}

// The first port's kernel (the lane route): dtype 0 = fp32, 1 = bf16 (raw
// bits), 2 = int8
int fog_fused_fog(int dtype, const int* feature, const void* threshold,
                  const void* leaf, const float* thr_scale,
                  const float* leaf_scale, const float* x, const int* start,
                  const float* thresh, const int* budget, float* proba,
                  int* hops, float* scratch, int B, int F, int O, int G, int t,
                  int depth, int C, int max_hops, int block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch_fused<TabF32>(feature, threshold, leaf, thr_scale, leaf_scale, x,
                           start, thresh, budget, proba, hops, scratch, B, F,
                           O, G, t, depth, C, max_hops, block, s);
      break;
    case 1:
      launch_fused<TabBF16>(feature, threshold, leaf, thr_scale, leaf_scale, x,
                            start, thresh, budget, proba, hops, scratch, B, F,
                            O, G, t, depth, C, max_hops, block, s);
      break;
    case 2:
      launch_fused<TabI8>(feature, threshold, leaf, thr_scale, leaf_scale, x,
                          start, thresh, budget, proba, hops, scratch, B, F,
                          O, G, t, depth, C, max_hops, block, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
