// Staging packed grove tables into shared memory with the bulk-copy engine
// (cp.async.bulk, sm_90), for fog_kernels.cu's fused_fog shared-memory
// route.
//
// One thread issues a bulk copy per 16-byte aligned body of each table and
// the block's threads copy the unaligned head and tail bytes themselves, so
// a table that starts or ends off a 16-byte boundary (a shard's slice of an
// odd-sized table) stages as well.  A table of `n` bytes takes
// region_bytes(n) of shared memory: its bytes land at the region's start
// plus (source address % 16), which keeps the body's source and
// destination congruent mod 16 as the copy engine requires.  Completion is
// counted in bytes on one mbarrier (sm90_common.cuh's helpers; its wait
// traps after 2^25 polls, so a stalled copy ends the launch with an error
// instead of hanging the card).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace fog {

// shared memory one staged table of `n` bytes occupies
__host__ __device__ constexpr size_t region_bytes(size_t n) {
  return (n + 31) / 16 * 16;
}

__device__ __forceinline__ size_t body_begin(const void* src, size_t n) {
  const size_t head = (16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15;
  return head < n ? head : n;
}

__device__ __forceinline__ size_t body_bytes(const void* src, size_t n) {
  const size_t h = body_begin(src, n);
  return (n - h) / 16 * 16;
}

// Stage `n` bytes at `src` into the region at `region`; returns where the
// bytes land.  Every thread of the block calls it with the same arguments:
// thread 0 issues the bulk copies of the aligned body (after the barrier
// was told the bodies of every table), every thread copies its share of
// the head and tail bytes.
__device__ __forceinline__ unsigned char* stage_table(
    unsigned char* region, const void* src, size_t n, uint64_t* bar) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  unsigned char* dst = region + (reinterpret_cast<uintptr_t>(src) & 15);
  const size_t h = body_begin(src, n);
  const size_t body = body_bytes(src, n);
  if (threadIdx.x == 0) {
    constexpr size_t PIECE = 32768;   // bytes per bulk-copy instruction
    for (size_t off = 0; off < body; off += PIECE) {
      const uint32_t len =
          static_cast<uint32_t>(body - off < PIECE ? body - off : PIECE);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst + h + off)),
          "l"(s + h + off), "r"(len), "r"(smem_u32(bar))
          : "memory");
    }
  }
  for (size_t i = threadIdx.x; i < n - body; i += blockDim.x) {
    const size_t k = i < h ? i : i + body;   // head, then tail
    dst[k] = s[k];
  }
  return dst;
}

// Stage a grove's (or a field's) five tables -- int32 features and
// thresholds [n_nodes], leaves [n_leaf] at the packed width, fp32 threshold
// and leaf scales [n_trees] -- from the pointers given into consecutive
// regions from `p`, point the pointers at the staged copies and return the
// end of the regions.  Every thread calls it; it initialises `bar` and
// synchronises once; the caller then synchronises (ordering the head and
// tail bytes) and waits with mbar_wait(bar, 0) before reading the tables.
template <class T>
__device__ __forceinline__ unsigned char* stage_grove(
    unsigned char* p, uint64_t* bar, const int*& fe, const T*& th,
    const T*& lf, const float*& ts, const float*& ls, size_t n_nodes,
    size_t n_leaf, size_t n_trees) {
  const size_t b_fe = n_nodes * 4, b_th = n_nodes * sizeof(T);
  const size_t b_lf = n_leaf * sizeof(T), b_sc = n_trees * 4;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, static_cast<uint32_t>(
                            body_bytes(fe, b_fe) + body_bytes(th, b_th) +
                            body_bytes(lf, b_lf) + body_bytes(ts, b_sc) +
                            body_bytes(ls, b_sc)));
  }
  __syncthreads();  // the barrier is initialised before any copy lands
  fe = reinterpret_cast<const int*>(stage_table(p, fe, b_fe, bar));
  p += region_bytes(b_fe);
  th = reinterpret_cast<const T*>(stage_table(p, th, b_th, bar));
  p += region_bytes(b_th);
  lf = reinterpret_cast<const T*>(stage_table(p, lf, b_lf, bar));
  p += region_bytes(b_lf);
  ts = reinterpret_cast<const float*>(stage_table(p, ts, b_sc, bar));
  p += region_bytes(b_sc);
  ls = reinterpret_cast<const float*>(stage_table(p, ls, b_sc, bar));
  return p + region_bytes(b_sc);
}

}  // namespace fog
