// The Mamba-2 SSD intra-chunk block for NVIDIA Hopper (sm_90a) on the
// tensor cores: bf16 x, a, B, C with head size P = 64, state N in {64, 128}
// and a chunk of 1 <= Q <= 256 tokens.
//
//   fog_ssd_chunk_sm90    replaces repro/kernels/ssd_chunk.py::_ssd_chunk_kernel
//                         for bf16 at P = 64, N in {64, 128}
//   fog_wgmma_probe_ssd   the product forms this kernel issues that
//                         flash_attention_sm90 does not, for the tests (not
//                         counted)
//
// behind plain C entry points that launch on the caller's stream and
// return a CUDA error code (loaded with ctypes by
// repro_torch/kernels/_build.py, linked into the same library as the other
// kernels).  The wrapper (kernels/ssd_chunk.py::route) sends bf16 at these
// shapes here and everything else (fp32, other P or N) to csrc/ssd_chunk.cu;
// it allocates the outputs and checks the pointers' 16-byte alignment; the
// kernel allocates nothing.
//
// What it computes, per chunk bc and head h, with x [BC, Q, H, P],
// a [BC, H, Q], B/C [BC, Q, N] in and y [BC, Q, H, P], st [BC, H, P, N] out:
//
//   cum      = cumsum(a[bc, h])                         fp32, one warp's scan
//   S[i, j]  = sum_n C[i, n] B[j, n]                    bf16 products, fp32 sums
//   W[i, j]  = bf16(S[i, j] exp(cum_i - cum_j))         j <= i; 0 above (a select)
//              (as exp2 of the difference of cum log2(e))
//   y[i, p]  = bf16(sum_j W[i, j] x[j, p])              fp32 sums
//   st[p, n] = bf16(sum_j bf16(x[j, p] d_j) B[j, n])    d_j = exp(cum_{Q-1} - cum_j)
//
// So the route rounds twice where the plain version (fp32 throughout, one
// cast at the end) rounds once: W and the decay-scaled x are rounded to
// bf16 as wgmma's operands.  tests/test_torch_ssd_chunk.py replays that
// rounding at full width and sets the bar chip_smoke.py holds it to.
// Above the diagonal cum_i - cum_j > 0 can overflow exp, so W is 0 there by
// a select, never by a 0/1 multiply (inf * 0 = NaN).
//
// Design.  One block of 288 threads owns (chunk bc, a group of
// heads_per_block heads): two consumer warpgroups and one producer warp.
// The producer loads the chunk's C and B once ([256, N] each, zeros past a
// ragged Q) by TMA, then for each head of the group scans a[bc, h] into the
// fp32 cumsum and the decays d_j in shared memory and loads x[bc, :, h, :]
// ([256, 64], 32 KB) by TMA into a ring of two stages, under a full and an
// empty mbarrier per stage (the full one also counts the warp's 32 lanes,
// which wrote the cumsum).  Per head, each consumer warpgroup
//   * computes y for two of the four 64-row tiles, {3, 0} or {2, 1}, so both
//     run five (row, column) tiles on or below the diagonal: per tile
//     S = C B^T with wgmma m64n64k16 (both K-major in shared memory, N / 16
//     k-steps), W in registers (the accumulator's layout is wgmma's A
//     layout), packed to bf16, then y += W x with wgmma m64n64k16 (A from
//     registers, x MN-major: the transpose bit);
//   * computes the states of one 64-column half of N (at N = 64 warpgroup 0
//     alone): A[p, j] = bf16(x[j, p] d_j) built in registers from the x
//     tile in shared memory (MN-major for A: read element by element through
//     the swizzle), B = Bm MN-major, one m64n64k16 per 16 of the 256 j, in
//     two halves of 128 j so that one half's operand is live at a time
//     (ptxas then keeps every value in registers: no spills);
// then releases the stage.  x is read from device memory once.
//
// S is recomputed per head from C and B in shared memory, not shared by a
// group of heads: keeping it for a group would take the 10 fp32 [64, 64]
// tiles of a chunk, 160 KB of shared memory beside C, B and x, or 160
// registers a thread, while recomputing costs 26.8 GFLOP more on the tensor
// cores at the serving shape (0.027 ms at their peak, about what a second
// read of x would cost at the memory's rate).  The [BC, Q, Q] fp32 scores
// scratch of the SIMT kernel and its launch are gone.
//
// What bounds it: at the serving shape (BC = 32, Q = 256, H = 80, P = 64,
// N = 128) it must move 215.2 MB (x, y, states, a, B, C once each; C and B
// come in once per block, 128 blocks x 128 KB, mostly from L2), 0.0642 ms
// at 3.35 TB/s; this design does 51.0 GFLOP on the bf16 tensor cores
// (S 26.8, y 13.4, states 10.7), 0.0516 ms at 989 TFLOP/s: bytes bound it.
// Within a warpgroup each tile's products and its elementwise work (one
// exp per W entry, the states' operand read through the swizzle) run in
// turn; only the two warpgroups and the TMA ring overlap (PERF.md gives
// the measured time and what holds it back).

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int QMAX = 256;             // rows of a chunk; one TMA box
constexpr int P = 64;                 // head size (one 64-column chunk)
constexpr int STAGES = 2;             // heads' x tiles in flight
constexpr int CONSUMER_THREADS = 256;
constexpr int THREADS = CONSUMER_THREADS + 32;
constexpr int X_BYTES = QMAX * P * 2;
constexpr int CHUNK_BYTES = QMAX * CHUNK_ROW_BYTES;   // one [256][64] chunk

// the block's shared memory: C and B ([256][64] chunks, N / 64 each), the x
// ring, per stage the cumsum and the decays (fp32 [256]), then barriers
template <int N>
struct Smem {
  static constexpr int CB_BYTES = QMAX * N * 2;
  static constexpr int B_OFF = CB_BYTES;
  static constexpr int X_OFF = 2 * CB_BYTES;
  static constexpr int CUM_OFF = X_OFF + STAGES * X_BYTES;
  static constexpr int DEC_OFF = CUM_OFF + STAGES * QMAX * 4;
  static constexpr int BAR_OFF = DEC_OFF + STAGES * QMAX * 4;
  // + 1024 for aligning the dynamic base
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// S = C[64 ti:, :] B[64 tj:, :]^T in the accumulator layout: sc[4 j + 2 r +
// e] is row 16 w + lane / 4 + 8 r, column 8 j + 2 quad + e of the tile
template <int N>
__device__ __forceinline__ void s_tile(float (&sc)[32], const uint8_t* Cs,
                                       const uint8_t* Bs, int ti, int tj) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    wgmma_ss<64>(sc,
                 kmajor_desc(Cs + c * CHUNK_BYTES + ti * 64 * CHUNK_ROW_BYTES +
                             off),
                 kmajor_desc(Bs + c * CHUNK_BYTES + tj * 64 * CHUNK_ROW_BYTES +
                             off),
                 kk);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(sc);
}

// the states of the 64 columns n of chunk c: acc[4 j + 2 r + e] is row
// p = r0 + 8 r, column 64 c + 8 j + 2 quad + e.  A[p, j] = bf16(x[j, p] d_j)
// from the swizzled x tile (rows j, columns p), in wgmma's A register
// layout: for k-step kk, rows r0 and r0 + 8, columns 16 kk + 2 quad (+1)
// and 16 kk + 8 + 2 quad (+1).  Every such j has j % 8 = 2 quad + e, so the
// swizzle leaves this thread four offsets into an 8-row group (rows 2 quad
// + e, columns r0 + 8 r), and each load is one of them plus a constant
__device__ __forceinline__ void states_acc(float (&acc)[32], const uint8_t* Bs,
                                           const uint8_t* xs, const float* ds,
                                           int c, int r0, int quad) {
  const __nv_bfloat16* at[2][2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      at[e][r] = swizzled_at(xs, 2 * quad + e, r0 + 8 * r);
  const float* dq = ds + 2 * quad;
  // two halves of 8 k-steps, each built, issued and waited for in turn,
  // so that only one half's operand (32 registers) is live
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    uint32_t fa[QMAX / 32][4];
#pragma unroll
    for (int kq = 0; kq < QMAX / 32; ++kq)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j0 = 16 * (b * (QMAX / 32) + kq) + 8 * half;  // 8 | j0
        const float d0 = dq[j0], d1 = dq[j0 + 1];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          fa[kq][2 * half + r] = pack_bf16(
              __fmul_rn(__bfloat162float(at[0][r][j0 * CHUNK]), d0),
              __fmul_rn(__bfloat162float(at[1][r][j0 * CHUNK]), d1));
      }
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < QMAX / 32; ++kq) {
      const int kk = b * (QMAX / 32) + kq;
      wgmma_rs<64>(acc, fa[kq],
                   mnmajor_desc(
                       Bs + c * CHUNK_BYTES + kk * 16 * CHUNK_ROW_BYTES,
                       CHUNK_BYTES),
                   kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
}

// y[i, h, :] for the 64 rows i of row tile ti, written as bf16 through
// `y_head` (y at (bc, row 0, h), rows `row_stride` elements apart)
template <int N>
__device__ __forceinline__ void y_row_tile(const uint8_t* Cs,
                                           const uint8_t* Bs,
                                           const uint8_t* xs, const float* cs,
                                           int ti, int r0, int quad, int Q,
                                           __nv_bfloat16* y_head,
                                           size_t row_stride) {
  float acc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = 0.0f;
  const float ci[2] = {cs[ti * 64 + r0], cs[ti * 64 + r0 + 8]};
  for (int tj = 0; tj <= ti; ++tj) {
    float sc[32];
    s_tile<N>(sc, Cs, Bs, ti, tj);
    // W = S exp(cum_i - cum_j) on and below the diagonal, 0 above it
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jl = 8 * j + 2 * quad + e;
        const float cj = cs[tj * 64 + jl];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool live = tj < ti || jl <= r0 + 8 * r;
          const float v = __fmul_rn(sc[4 * j + 2 * r + e],
                                    exp2f(__fsub_rn(ci[r], cj)));
          sc[4 * j + 2 * r + e] = live ? v : 0.0f;
        }
      }
    // y += W x over the tile's 64 j in steps of 16; W in bf16 in the A
    // operand's register layout, packed before the fence
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<64>(acc, pa[kk],
                   mnmajor_desc(xs + (tj * 64 + kk * 16) * CHUNK_ROW_BYTES,
                                CHUNK_BYTES),
                   1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = ti * 64 + r0 + 8 * r;
    if (i >= Q) continue;
    __nv_bfloat16* row = y_head + (size_t)i * row_stride;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * quad) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// y and the states of chunk blockIdx.y for heads blockIdx.x *
// heads_per_block onwards
template <int N>
__global__ void __launch_bounds__(THREADS, 1) ssd_chunk_kernel_sm90(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap tc,
    const __nv_bfloat16* __restrict__ a, __nv_bfloat16* __restrict__ y,
    __nv_bfloat16* __restrict__ states, int Q, int H, int heads_per_block) {
  using L = Smem<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* Cs = smem;
  uint8_t* Bs = smem + L::B_OFF;
  uint8_t* Xs = smem + L::X_OFF;
  float* cum = reinterpret_cast<float*>(smem + L::CUM_OFF);
  float* dec = reinterpret_cast<float*>(smem + L::DEC_OFF);
  uint64_t* cb_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = cb_full + 1;
  uint64_t* empty = full + STAGES;

  const int bc = blockIdx.y;
  const int h0 = blockIdx.x * heads_per_block;
  const int n_heads = min(heads_per_block, H - h0);
  const int tid = threadIdx.x;
  // the warp's index, broadcast so the compiler sees it warp-uniform and
  // keeps each warpgroup's products in flight together
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;

  if (tid == 0) {
    mbar_init(cb_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);                       // the producer's lanes
      mbar_init(&empty[s], CONSUMER_THREADS / 32);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_THREADS / 32) {
    // ---------------------------------------------------- producer warp
    if (lane == 0) {
      mbar_expect_tx(cb_full, 2 * L::CB_BYTES);
#pragma unroll
      for (int c = 0; c < N / CHUNK; ++c) {
        tma_load_4d(Cs + c * CHUNK_BYTES, &tc, cb_full, c * CHUNK, 0, 0, bc);
        tma_load_4d(Bs + c * CHUNK_BYTES, &tb, cb_full, c * CHUNK, 0, 0, bc);
      }
    }
    for (int t = 0; t < n_heads; ++t) {
      const int s = t % STAGES, h = h0 + t;
      if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
      float* cs = cum + s * QMAX;
      float* ds = dec + s * QMAX;
      // inclusive fp32 prefix sum of a[bc, h, 0:Q), 32 entries at a time
      const __nv_bfloat16* ah = a + ((size_t)bc * H + h) * Q;
      float carry = 0.0f;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + lane;
        float v = i < Q ? __bfloat162float(ah[i]) : 0.0f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float n = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v = __fadd_rn(v, n);
        }
        v = __fadd_rn(v, carry);
        if (i < Q) cs[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
      __syncwarp();
      // the decays; the cumsum kept as cum log2(e), so that W's factor is
      // one exp2f; rows past a ragged Q: no further decay (their S and x
      // are 0), and a 0 decay for the states
      const float last = cs[Q - 1];
      for (int j = lane; j < QMAX; j += 32) {
        const float cj = j < Q ? cs[j] : last;
        ds[j] = j < Q ? expf(__fsub_rn(last, cj)) : 0.0f;
        cs[j] = __fmul_rn(cj, 1.4426950408889634f);
      }
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(&full[s], X_BYTES);
        tma_load_4d(Xs + s * X_BYTES, &tx, &full[s], 0, h, 0, bc);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  const int wg = warp / 4, w = warp % 4, quad = lane % 4;
  const int r0 = w * 16 + lane / 4;   // this thread's first row of a tile
  const int n_tiles = (Q + 63) / 64;

  mbar_wait(cb_full, 0);
  for (int t = 0; t < n_heads; ++t) {
    const int s = t % STAGES, h = h0 + t;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint8_t* xs = Xs + s * X_BYTES;
    const float* cs = cum + s * QMAX;
#pragma unroll 1
    for (int k = 0; k < 2; ++k) {
      const int ti = k == 0 ? 3 - wg : wg;   // {3, 0} or {2, 1}
      if (ti < n_tiles)
        y_row_tile<N>(Cs, Bs, xs, cs, ti, r0, quad, Q,
                      y + ((size_t)bc * Q * H + h) * P, (size_t)H * P);
    }
    if (N == 128 || wg == 0) {
      float acc[32];
      states_acc(acc, Bs, xs, dec + s * QMAX, wg, r0, quad);
      __nv_bfloat16* st = states + ((size_t)bc * H + h) * P * N + wg * 64;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(
              st + (size_t)(r0 + 8 * r) * N + 8 * j + 2 * quad) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r],
                                    acc[4 * j + 2 * r + 1]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// ---------------------------------------------------------------- probe
// The forms of this kernel's products, on one warpgroup and one chunk's
// tiles loaded by TMA as the kernel loads them (c, b [256, 128], x [256,
// 64]): s = C[192:256] B[64:128]^T (the S product at N = 128, two K-major
// chunks, tile offsets 3 and 1), and st = bf16(x d)^T b (A built in
// registers from the MN-major x tile and scaled, B MN-major in both
// 64-column halves), fp32 each: s [64, 64], st [64, 128].
__global__ void __launch_bounds__(128) wgmma_probe_ssd_kernel(
    const __grid_constant__ CUtensorMap tc,
    const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap tx, const float* __restrict__ d,
    float* __restrict__ s_out, float* __restrict__ st_out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* Cs = smem;
  uint8_t* Bs = Cs + 2 * CHUNK_BYTES;
  uint8_t* Xs = Bs + 2 * CHUNK_BYTES;
  float* ds = reinterpret_cast<float*>(Xs + X_BYTES);
  uint64_t* bar = reinterpret_cast<uint64_t*>(ds + QMAX);
  const int tid = threadIdx.x;
  for (int j = tid; j < QMAX; j += 128) ds[j] = d[j];
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 4 * CHUNK_BYTES + X_BYTES);
    for (int c = 0; c < 2; ++c) {
      tma_load_4d(Cs + c * CHUNK_BYTES, &tc, bar, c * CHUNK, 0, 0, 0);
      tma_load_4d(Bs + c * CHUNK_BYTES, &tb, bar, c * CHUNK, 0, 0, 0);
    }
    tma_load_4d(Xs, &tx, bar, 0, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  const int w = tid / 32, lane = tid % 32, quad = lane % 4;
  const int r0 = w * 16 + lane / 4;
  float sc[32];
  s_tile<128>(sc, Cs, Bs, 3, 1);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        s_out[(r0 + 8 * r) * 64 + 8 * j + 2 * quad + e] = sc[4 * j + 2 * r + e];
  for (int c = 0; c < 2; ++c) {
    float acc[32];
    states_acc(acc, Bs, Xs, ds, c, r0, quad);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          st_out[(r0 + 8 * r) * 128 + 64 * c + 8 * j + 2 * quad + e] =
              acc[4 * j + 2 * r + e];
  }
}

// ------------------------------------------------------------- host side
template <int N>
int launch(const void* x, const void* a, const void* Bm, const void* Cm,
           void* y, void* states, int BC, int Q, int H, int heads_per_block,
           cudaStream_t stream) {
  CUtensorMap tx, tb, tc;
  int rc = encode(&tx, x, BC, Q, H, P, QMAX);
  if (rc == 0) rc = encode(&tb, Bm, BC, Q, 1, N, QMAX);
  if (rc == 0) rc = encode(&tc, Cm, BC, Q, 1, N, QMAX);
  if (rc != 0) return rc;
  const int smem = Smem<N>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel_sm90<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + heads_per_block - 1) / heads_per_block, BC);
  ssd_chunk_kernel_sm90<N><<<grid, THREADS, smem, stream>>>(
      tx, tb, tc, static_cast<const __nv_bfloat16*>(a),
      static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(states), Q,
      H, heads_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bf16 x [BC, Q, H, 64], a [BC, H, Q], Bm/Cm [BC, Q, N] -> y [BC, Q, H,
// 64], states [BC, H, 64, N]; N in {64, 128}, 1 <= Q <= 256.  x, Bm, Cm
// 16-byte aligned (the wrapper checks).
int fog_ssd_chunk_sm90(const void* x, const void* a, const void* Bm,
                       const void* Cm, void* y, void* states, int BC, int Q,
                       int H, int P_, int N, int heads_per_block,
                       void* stream) {
  if (BC < 1 || BC > 65535 || Q < 1 || Q > QMAX || H < 1 || P_ != P ||
      heads_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 64)
    return launch<64>(x, a, Bm, Cm, y, states, BC, Q, H, heads_per_block, s);
  if (N == 128)
    return launch<128>(x, a, Bm, Cm, y, states, BC, Q, H, heads_per_block,
                       s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// c, b [256, 128], x [256, 64] bf16, d [256] fp32 -> s [64, 64], st [64,
// 128] fp32 (see wgmma_probe_ssd_kernel)
int fog_wgmma_probe_ssd(const void* c, const void* b, const void* x,
                        const float* d, float* s_out, float* st_out,
                        void* stream) {
  CUtensorMap tc, tb, tx;
  int rc = encode(&tc, c, 1, QMAX, 1, 128, QMAX);
  if (rc == 0) rc = encode(&tb, b, 1, QMAX, 1, 128, QMAX);
  if (rc == 0) rc = encode(&tx, x, 1, QMAX, 1, P, QMAX);
  if (rc != 0) return rc;
  const int smem = 4 * CHUNK_BYTES + X_BYTES + QMAX * 4 + 8 + 1024;
  const cudaError_t err = cudaFuncSetAttribute(
      wgmma_probe_ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_probe_ssd_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      tc, tb, tx, d, s_out, st_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
