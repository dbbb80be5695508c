// Causal or non-causal GQA/MQA attention for NVIDIA Hopper (sm_90a) on the
// tensor cores: bf16 q, k, v with head sizes D, Dv in {64, 128}.
//
//   fog_flash_attention_sm90   replaces repro/kernels/flash_attention.py::_flash_kernel
//                              for bf16 at D, Dv in {64, 128}
//   fog_wgmma_probe            one wgmma tile product of each form the
//                              kernel issues, for the tests (not counted)
//
// behind plain C entry points that launch on the caller's stream and
// return a CUDA error code (loaded with ctypes by
// repro_torch/kernels/_build.py, linked into the same library as the other
// kernels).  The wrapper (kernels/flash_attention.py) routes bf16 at these
// head sizes here and everything else (fp32, other head sizes) to
// csrc/flash_attention.cu, allocates the output and checks the pointers'
// 16-byte alignment; the kernel allocates nothing.
//
// What it computes (the TPU kernel's arithmetic), with q [B, Sq, H, D],
// k [B, Sk, K, D], v [B, Sk, K, Dv], H % K == 0, G = H / K:
//
//   s[i, j]   = (q[b, i, h] . k[b, j, h / G]) * scale   bf16 products, fp32 sums
//   live(i,j) = j < Sk and (not causal or i >= j)       (both counted from 0)
//   m, l      = running max and sum of p = exp(s - m) over the live j, fp32
//   acc       = sum_j bf16(p[i, j]) v[b, j, h / G]      fp32 sums
//   out[b, i, h] = bf16(acc / max(l, 1e-30))
//
// Scores are kept as s * scale * log2(e), so p = exp2(s' - m') (one
// multiply and an exp2f per score); a score that is not live is -inf and
// its p is 0, and a row that has seen no live key keeps m = -inf, l = 0,
// acc = 0 (no exp(-inf - -inf)) and would write 0.
//
// Design.  One block of 288 threads owns (128-row q tile, query head,
// batch): two consumer warpgroups of 64 q rows each and one producer warp.
// The producer's one thread loads the q tile once and then each K and V
// tile of BK keys by TMA into a ring of STAGES stages in shared memory,
// under a full and an empty mbarrier per stage.  K/V are read in place at
// KV head h / G (never repeated), with 4-D tensor maps over [B, S, heads,
// 64-column chunk] and the 128-byte swizzle (a 64-wide bf16 row is 128 B):
// out-of-range rows of a ragged tile arrive as zeros and are masked.  Per
// tile, each consumer warpgroup
//   * computes S = Q K^T with wgmma m64nBKk16 (A = Q, B = K, both K-major
//     in shared memory), the scores in registers;
//   * masks only tiles that cross its diagonal or the edge Sk, skips tiles
//     wholly above its diagonal (key tiles past the block's diagonal are
//     never loaded), and does the online softmax in registers: a row lives
//     on the 4 threads of a quad, so its max and sum are two xor shuffles;
//   * converts p to bf16 in the accumulator's own layout, which is the
//     register layout of wgmma's A operand, and computes O += P V with
//     wgmma m64nDvk16 (A from registers, B = V from shared memory,
//     MN-major: the transpose bit is set);
// then releases the stage.  The epilogue divides by max(l, 1e-30) and
// stores rows i < Sq as bf16.  Q tiles run longest-first, so the short
// causal ones fill the tail.
//
// BK is 128 keys at D = Dv = 64 and 64 otherwise (keys_per_tile).  Shared
// memory: the q tile 128 D 2 B, and per stage a K tile BK D 2 B and a V
// tile BK Dv 2 B, each 64-column chunk 1024-byte aligned; at D = Dv = 64:
// 16 + 2 (16 + 16) KB = 80 KB, at D = Dv = 128: 32 + 2 (16 + 16) KB = 96 KB
// (the wrapper's smem_bytes_sm90 gives the exact figures).
//
// What bounds it: at the tinyllama prefill (B=4, S=2048, H=32, K=4, D =
// Dv = 64, causal) 68.75 GFLOP of products on the bf16 tensor cores,
// 0.0695 ms at 989 TFLOP/s, against 75.5 MB of q, k, v and out, 0.0225 ms
// at 3.35 TB/s: operations bound it.  This first tensor-core design does
// not overlap one warpgroup's softmax with its own next product (each
// tile's two products and its softmax run in turn within a warpgroup; the
// two warpgroups and the TMA ring overlap each other), so it runs below
// that bound (PERF.md gives the measured time).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;              // q rows of one block
constexpr int STAGES = 2;            // K/V tiles in flight
constexpr int CONSUMER_THREADS = 256;
constexpr int THREADS = CONSUMER_THREADS + 32;
constexpr int CHUNK = 64;            // bf16 columns of one 128-byte row
constexpr int CHUNK_ROW_BYTES = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// spin until the barrier's phase of parity `parity` has completed; a wait
// that outlasts 2^25 polls (far beyond any tile's load) traps, so a fault
// in the pipeline ends the launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (n == (1u << 25)) __trap();
  }
}

// ---------------------------------------------------------------- TMA
// one box of a 4-D tensor map at coordinates (c0 innermost .. c3) into
// shared memory, completing `bytes` on the barrier
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------- wgmma
// a shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
// K-major tiles of 128-byte rows: 8-row groups 1024 B apart (the leading
// offset is unused by a swizzled K-major operand)
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  return smem_desc(p, 16, 8 * CHUNK_ROW_BYTES);
}
// MN-major tiles: K rows of 128 B, 8-row groups 1024 B apart, 64-column
// chunks `chunk_bytes` apart along N
__device__ __forceinline__ uint64_t mnmajor_desc(const void* p,
                                                 uint32_t chunk_bytes) {
  return smem_desc(p, chunk_bytes, 8 * CHUNK_ROW_BYTES);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A . B (+ d when accumulate), A [64 x 16] and B [64 x 16] from
// shared memory, both K-major with the 128-byte swizzle
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A . B (+ d when accumulate), A [64 x 16] and B [128 x 16] from
// shared memory, both K-major with the 128-byte swizzle
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A . B (+ d when accumulate), A [64 x 16] bf16 from registers (the
// accumulator's own layout), B [16 x 64] from shared memory, MN-major (N
// contiguous) with the 128-byte swizzle: the transpose bit is set for B
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d = A . B (+ d when accumulate), A [64 x 16] bf16 from registers (the
// accumulator's own layout), B [16 x 128] from shared memory, MN-major (N
// contiguous) with the 128-byte swizzle: the transpose bit is set for B
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, accumulate);
  else wgmma_rs_n128(d, a, db, accumulate);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// keys per K/V tile: 128 at D = Dv = 64 (measured faster than 64 there);
// 64 when a head size is 128 (as fast, and 128 keys there leave too few
// registers to keep the products in flight)
template <int D, int DV>
constexpr int keys_per_tile() { return D == 64 && DV == 64 ? 128 : 64; }

// the block's shared memory: q tile, then per stage a K and a V tile, each
// stored as 64-column chunks [rows][64] (1024-byte aligned), then barriers
template <int D, int DV, int BK>
struct Smem {
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int K_BYTES = BK * D * 2;
  static constexpr int V_BYTES = BK * DV * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * V_BYTES;
  // + 1024 for aligning the dynamic base
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

// out[b, i, h, :] for the 128 rows i of q tile (gridDim.x - 1 -
// blockIdx.x), query head blockIdx.y, batch blockIdx.z
template <int D, int DV, int BK>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_kernel_sm90(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
    int Sq, int Sk, int H, int K, float scale_log2, int causal) {
  using L = Smem<D, DV, BK>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint8_t* Ks = smem + L::K_OFF;
  uint8_t* Vs = smem + L::V_OFF;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  // the warp's index, broadcast so the compiler sees it warp-uniform and
  // keeps each warpgroup's products in flight together
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int last_row = min(i0 + BQ, Sq);          // one past the last row
  const int kv_end = causal ? min(Sk, last_row) : Sk;
  const int n_tiles = (kv_end + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_THREADS / 32);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_THREADS / 32) {
    // ---------------------------------------------------- producer warp
    if (tid != CONSUMER_THREADS) return;
    mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
    for (int c = 0; c < D / CHUNK; ++c)
      tma_load_4d(Qs + c * BQ * CHUNK_ROW_BYTES, &tq, q_full, c * CHUNK, h,
                  i0, b);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
      mbar_expect_tx(&full[s], L::K_BYTES + L::V_BYTES);
      uint8_t* kt = Ks + s * L::K_BYTES;
      uint8_t* vt = Vs + s * L::V_BYTES;
#pragma unroll
      for (int c = 0; c < D / CHUNK; ++c)
        tma_load_4d(kt + c * BK * CHUNK_ROW_BYTES, &tk, &full[s], c * CHUNK,
                    kh, t * BK, b);
#pragma unroll
      for (int c = 0; c < DV / CHUNK; ++c)
        tma_load_4d(vt + c * BK * CHUNK_ROW_BYTES, &tv, &full[s], c * CHUNK,
                    kh, t * BK, b);
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  const int wg = warp / 4, w = warp % 4, lane = tid % 32;
  const int quad = lane % 4;
  // this thread's two rows of the block's tile, and its warpgroup's
  const int row0 = wg * 64 + w * 16 + lane / 4;
  const int wg_first = i0 + wg * 64, wg_last = wg_first + 63;

  float o[DV / 2];
#pragma unroll
  for (int x = 0; x < DV / 2; ++x) o[x] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES, j0 = t * BK;
    mbar_wait(&full[s], (t / STAGES) & 1);
    // a tile wholly above this warpgroup's diagonal adds nothing
    if (!(causal && j0 > wg_last)) {
      const uint8_t* kt = Ks + s * L::K_BYTES;
      const uint8_t* vt = Vs + s * L::V_BYTES;
      // S = Q K^T over D in steps of 16 (32 B within a 128-byte row)
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<BK>(sc,
                     kmajor_desc(Qs + c * BQ * CHUNK_ROW_BYTES +
                                 wg * 64 * CHUNK_ROW_BYTES + off),
                     kmajor_desc(kt + c * BK * CHUNK_ROW_BYTES + off), kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // the online softmax: sc[4 j + 2 r + e] is row row0 + 8 r, key
      // j0 + 8 j + 2 quad + e
      const bool mask = j0 + BK > Sk || (causal && j0 + BK - 1 > wg_first);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + row0 + 8 * r;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = sc[4 * j + 2 * r + e] * scale_log2;
            if (mask) {
              const int key = j0 + 8 * j + 2 * quad + e;
              if (key >= Sk || (causal && key > i)) v = -INFINITY;
            }
            sc[4 * j + 2 * r + e] = v;
            mx = fmaxf(mx, v);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        // m_new is -inf only while the row has seen no live key
        const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
        corr[r] = exp2f(m[r] - m_safe);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(sc[4 * j + 2 * r + e] - m_safe);
            sc[4 * j + 2 * r + e] = p;
            sum += p;
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[r] = l[r] * corr[r] + sum;
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        o[4 * j + 0] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }

      // O += P V over the tile's keys in steps of 16 (2048 B of V rows);
      // P in bf16 in the A operand's register layout, packed before the
      // fence so that one fence covers every product
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DV>(o, pa[kk],
                     mnmajor_desc(vt + kk * 16 * CHUNK_ROW_BYTES,
                                  BK * CHUNK_ROW_BYTES),
                     1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: rows i < Sq, two bf16 per store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + row0 + 8 * r;
    if (i >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* row = out + (((size_t)b * Sq + i) * H + h) * DV;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          __fdiv_rn(o[4 * j + 2 * r], denom),
          __fdiv_rn(o[4 * j + 2 * r + 1], denom));
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * quad) = v;
    }
  }
}

// ---------------------------------------------------------------- probe
// C1 = A B1^T (A [64, 64], B1 [N, 64], both K-major through TMA: the S
// product) and C2 = A B2 (A from registers in the accumulator layout,
// B2 [64, N] MN-major through TMA: the P V product), fp32 [64, N] each.
template <int N>
__global__ void __launch_bounds__(128) wgmma_probe_kernel(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb1,
    const __grid_constant__ CUtensorMap tb2,
    const __nv_bfloat16* __restrict__ a, float* __restrict__ c1,
    float* __restrict__ c2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* As = smem;                       // [64][64]
  uint8_t* B1s = As + 64 * CHUNK_ROW_BYTES; // [N][64]
  uint8_t* B2s = B1s + N * CHUNK_ROW_BYTES; // N / 64 chunks of [64][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(B2s + N * CHUNK_ROW_BYTES);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, (64 + 2 * N) * CHUNK_ROW_BYTES);
    tma_load_4d(As, &ta, bar, 0, 0, 0, 0);
    tma_load_4d(B1s, &tb1, bar, 0, 0, 0, 0);
    for (int c = 0; c < N / CHUNK; ++c)
      tma_load_4d(B2s + c * 64 * CHUNK_ROW_BYTES, &tb2, bar, c * CHUNK, 0, 0,
                  0);
  }
  mbar_wait(bar, 0);
  const int w = tid / 32, lane = tid % 32, quad = lane % 4;
  const int row0 = w * 16 + lane / 4;

  float d1[N / 2], d2[N / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<N>(d1, kmajor_desc(As + kk * 32), kmajor_desc(B1s + kk * 32),
                kk);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d1);
  // A's fragment for k-step kk: rows row0 / row0 + 8, columns
  // 16 kk + 2 quad (+1) and 16 kk + 8 + 2 quad (+1)
  const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int col = 16 * kk + 2 * quad;
    const uint32_t frag[4] = {a32[(row0 * 64 + col) / 2],
                              a32[((row0 + 8) * 64 + col) / 2],
                              a32[(row0 * 64 + col + 8) / 2],
                              a32[((row0 + 8) * 64 + col + 8) / 2]};
    wgmma_rs<N>(d2, frag,
                mnmajor_desc(B2s + kk * 16 * CHUNK_ROW_BYTES,
                             64 * CHUNK_ROW_BYTES),
                kk);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + 8 * r, col = 8 * j + 2 * quad + e;
        c1[row * N + col] = d1[4 * j + 2 * r + e];
        c2[row * N + col] = d2[4 * j + 2 * r + e];
      }
}

// ------------------------------------------------------------- host side
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-D map over a contiguous bf16 [n3, n2, n1, n0] tensor, boxes of
// [1, rows, 1, 64] with the 128-byte swizzle; zeros outside
int encode(CUtensorMap* map, const void* ptr, int n3, int n2, int n1, int n0,
           int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {(cuuint64_t)n0, (cuuint64_t)n1, (cuuint64_t)n2,
                              (cuuint64_t)n3};
  const cuuint64_t strides[3] = {(cuuint64_t)n0 * 2,
                                 (cuuint64_t)n0 * n1 * 2,
                                 (cuuint64_t)n0 * n1 * n2 * 2};
  const cuuint32_t box[4] = {CHUNK, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D, int DV, int BK = keys_per_tile<D, DV>()>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int K, float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = encode(&tq, q, B, Sq, H, D, BQ);
  if (rc == 0) rc = encode(&tk, k, B, Sk, K, D, BK);
  if (rc == 0) rc = encode(&tv, v, B, Sk, K, DV, BK);
  if (rc != 0) return rc;
  const int smem = Smem<D, DV, BK>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel_sm90<D, DV, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel_sm90<D, DV, BK><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, H, K,
      static_cast<float>(static_cast<double>(scale) * 1.4426950408889634),
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_probe(const void* a, const void* b1, const void* b2, float* c1,
                 float* c2, cudaStream_t stream) {
  CUtensorMap ta, tb1, tb2;
  int rc = encode(&ta, a, 1, 64, 1, 64, 64);
  if (rc == 0) rc = encode(&tb1, b1, 1, N, 1, 64, N);
  if (rc == 0) rc = encode(&tb2, b2, 1, 64, 1, N, 64);
  if (rc != 0) return rc;
  const int smem = (64 + 2 * N) * CHUNK_ROW_BYTES + 8 + 1024;
  const cudaError_t err = cudaFuncSetAttribute(
      wgmma_probe_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_probe_kernel<N><<<1, 128, smem, stream>>>(
      ta, tb1, tb2, static_cast<const __nv_bfloat16*>(a), c1, c2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bf16 q, k, v and out; D, Dv in {64, 128}; causal 0 or 1.  Every pointer
// 16-byte aligned (the wrapper checks).
int fog_flash_attention_sm90(const void* q, const void* k, const void* v,
                             void* out, int B, int Sq, int Sk, int H, int K,
                             int D, int Dv, float scale, int causal,
                             void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || K < 1 || H % K != 0 ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && Dv == 64)
    return launch<64, 64>(q, k, v, out, B, Sq, Sk, H, K, scale, causal, s);
  if (D == 128 && Dv == 128)
    return launch<128, 128>(q, k, v, out, B, Sq, Sk, H, K, scale, causal, s);
  if (D == 64 && Dv == 128)
    return launch<64, 128>(q, k, v, out, B, Sq, Sk, H, K, scale, causal, s);
  if (D == 128 && Dv == 64)
    return launch<128, 64>(q, k, v, out, B, Sq, Sk, H, K, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// n = 64 or 128: a [64, 64], b1 [n, 64], b2 [64, n] bf16 -> c1, c2 [64, n]
int fog_wgmma_probe(const void* a, const void* b1, const void* b2, float* c1,
                    float* c2, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 64) return launch_probe<64>(a, b1, b2, c1, c2, s);
  if (n == 128) return launch_probe<128>(a, b1, b2, c1, c2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
