// The backward of the Mamba-2 SSD intra-chunk block for NVIDIA Hopper
// (sm_90a) on the tensor cores: bf16 x, a, B, C, dy, dst with head size
// P = 64, state N in {64, 128} and a chunk of 1 <= Q <= 256 tokens (the
// shapes the forward's tensor-core route takes, ssd_chunk_sm90.cu).
//
//   fog_ssd_chunk_bwd_sm90   the gradient of fog_ssd_chunk (ssd_chunk.cu,
//                            ssd_chunk_sm90.cu) at these shapes; replaces
//                            no TPU kernel: the JAX package takes it with
//                            jax.grad of the einsum branch of
//                            repro/models/mamba2.py::ssd_chunked
//
// behind a plain C entry point that launches five kernels in order on the
// caller's stream and returns a CUDA error code (loaded with ctypes by
// repro_torch/kernels/_build.py).  The wrapper (kernels/ssd_chunk.py::
// ssd_chunk_bwd_cuda) sends bf16 at these shapes here (ssd_chunk.route,
// the forward's rule) and everything else to csrc/ssd_chunk_bwd.cu; it
// allocates the scratch and the four outputs and checks the pointers'
// 16-byte alignment; the kernels allocate nothing.
//
// What it computes, per chunk bc and head h (the formulas of
// ssd_chunk_bwd.cu and kernels/ssd_chunk.py::ssd_chunk_bwd_ref), with
// x [BC, Q, H, 64], a [BC, H, Q], B/C [BC, Q, N], dy [BC, Q, H, 64],
// dst [BC, H, 64, N]:
//
//   cum = cumsum(a_h),  L[i, j] = exp(cum_i - cum_j) for i >= j (else 0),
//   S = C B^T,  W_h = S o L,  d_j = exp(cum_{Q-1} - cum_j),
//   G_h = B dst_h^T,  dW_h = dy_h x_h^T,  t_h = dW_h o S o L
//   dx_h = bf16(W_h)^T dy_h + d o G_h                               dx pass
//   dS   = sum_h dW_h o L_h (lower triangle)                        ds pass
//   dC   = bf16(dS) B,  dB = bf16(dS)^T C + sum_h d o (x_h dst_h)  dbdc pass
//   dcum_i += sum_j t_ij (ds pass),  dcum_j -= sum_i t_ij (dx pass),
//   e_j = d_j sum_p x_jp G_jp:  dcum_{Q-1} += sum_j e_j,  dcum_j -= e_j
//   da_h = reverse cumsum of dcum_h                                 da kernel
//
// Every product is bf16 x bf16 with fp32 sums; every elementwise step is
// fp32.  Two operands are rounded to bf16 where ssd_chunk_bwd.cu keeps
// fp32: W_h (the A operand of dx's product, from the fp32 S o L) and dS
// (the A operand of dC's and dB's, from its fp32 sum over the heads).
// The t sums, e, and the states' term of dB (each head's x_h dst_h summed
// in fp32 with its decay) are not rounded.  kernels/ssd_chunk.py::
// ssd_chunk_bwd_sm90_replay replays exactly that rounding; the CPU tests
// hold it to float64, chip_smoke.py holds this kernel to it.  The
// gradients are stored in bf16.  L is taken as exp2 of the difference of
// cum log2(e), as the forward takes it.  Above the diagonal cum_i - cum_j >
// 0 can overflow exp, so those entries are 0 by a select, never by 0 x inf.
//
// The five launches:
//   1. cum kernel, one warp per (chunk, head): cum and d into scratch.
//   2. ds pass, one block (two warpgroups) per (chunk, 64 x 64 [i, j]
//      tile on or below the diagonal): S's tile (C_i B_j^T, wgmma from
//      the TMA-loaded 64-row tiles), then over the heads, the even ones on
//      one warpgroup and the odd ones on the other, each in order: dW's
//      tile (dy_i x_j^T, both K-major 64-row tiles by TMA through a ring
//      of 6 stages, two of which hold C_i and B_j until S is taken), dS +=
//      dW o L in registers, and t's row sums over the
//      tile per head into scratch; the two warpgroups' dS are added (even
//      + odd) and stored once, rounded to bf16, with its transpose beside
//      it ([2, BC, QP, QP], QP = Q rounded up to 64).
//   3. dx pass, one block (two warpgroups) per (chunk, group of
//      ssd_chunk.py::sm90_heads_per_block heads): C and B [256, N] once by
//      TMA; per head dy_h [256, 64] and dst_h [64, N] by TMA into a ring of
//      2 stages.  Each warpgroup owns two 64-row tiles of j, {3, 0} or
//      {2, 1} (five [j, i] tiles each, as the forward balances its rows);
//      per tile of i >= j: S^T = B_j C_i^T (wgmma, both K-major), dW^T =
//      x_j dy_i^T (x_j's A fragments loaded from device memory, dy_i the
//      K-major B operand), W^T = S^T o L^T and t's column sums in fp32,
//      then dx += bf16(W^T) dy_i (W^T in registers is wgmma's A layout; dy
//      the MN-major B operand, the transpose bit); then G = B_j dst_h^T
//      (wgmma), dx = acc + d o G stored, and e from x_j's fragments (the A
//      fragments of x are the accumulator positions of G).
//   4. dbdc pass, one block (one warpgroup) per (chunk, 64-row tile, 64
//      columns of N): dC over the tiles of B j <= i and dB over the tiles
//      of C i >= j (bf16 dS or dS^T as A fragments loaded from the scratch,
//      the 64 x 64 tile of B or C the MN-major B operand by TMA), then per
//      head in order x_h dst_h (x's fragments from device memory, dst_h's
//      [64, 64] tile by TMA) scaled by d_j and added in fp32: a ring of 4
//      stages of 8 KB tiles, the next head's x fragments loaded while a
//      head's product runs.
//   5. da kernel, one warp per (chunk, head): dcum from the t sums and e,
//      then a reverse scan.
//
// No atomics: every output and every scratch entry is written once by one
// thread, every sum taken in a fixed order, so the result is the same bit
// for bit from run to run.  Rows past a ragged Q are zeros in every TMA
// tile (the maps' extent is Q) and are masked in every store.
//
// Shared memory per block (bytes, against the 232,448 a block may opt
// into): ds pass 6 stages x 16 KB + 1080 = 99,384 (two blocks an SM); dx
// pass 2 x 256 N x 2 of C and B + 2 stages x (32 KB dy + 128 N dst) + 1048
// = 230,424 at N = 128 (148,504 at 64; kernels/ssd_chunk.py::
// bwd_smem_bytes_sm90); dbdc pass 4 x 8 KB + 1056.
//
// What bounds it: at the bf16 training shape (xbar [2, 16, 256, 80, 64],
// N = 128) it must move ~305 MB (x, dy, dx, dst, a, da, B, C, dB, dC once
// each; 0.091 ms at 3.35 TB/s) and needs ~43.8 GFLOP of products (0.044
// ms at 989 TFLOP/s bf16): bytes bound it.  This design runs ~83 GFLOP
// on the tensor cores (S^T per head per [j, i] tile as the forward does,
// dW in both the ds and the dx pass) and reads dy, x and dst two to four
// times, mostly from L2; within a warpgroup each tile's products and its
// elementwise work (one exp per entry) run in turn (PERF.md row 7b gives
// the measured time).

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int QMAX = 256;                              // rows of a chunk
constexpr int P = 64;                                  // head size
constexpr int TR = 64;                                 // rows of a tile
constexpr int TILE_BYTES = TR * CHUNK_ROW_BYTES;       // [64][64] bf16
constexpr int FULL_BYTES = QMAX * CHUNK_ROW_BYTES;     // [256][64] bf16
constexpr int DS_STAGES = 6;
constexpr int DX_STAGES = 2;
constexpr int DB_STAGES = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// d = A . B (+ d when accumulate), A [64 x 16] bf16 from registers (the
// accumulator's layout), B [64 x 16] from shared memory K-major with the
// 128-byte swizzle (no transpose bit: the B operand's rows are N)
__device__ __forceinline__ void wgmma_rs_n64_kmajor(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
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

// the A fragments of a [64, 64] bf16 row-major tile in device memory, rows
// `row0 + r0 (+ 8)` (0 at rows >= rows_end), columns `col0 + 16 kk + 2
// quad (+ 8)`, rows `ld` elements apart: four k-steps of wgmma's A layout
__device__ __forceinline__ void load_fragments(uint32_t (&f)[4][4],
                                               const __nv_bfloat16* base,
                                               size_t ld, int row0,
                                               int rows_end, int col0,
                                               int r0, int quad) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = row0 + r0 + 8 * (x & 1);
      const int col = col0 + 16 * kk + 8 * (x >> 1) + 2 * quad;
      f[kk][x] = row < rows_end
                     ? *reinterpret_cast<const uint32_t*>(
                           base + (size_t)row * ld + col)
                     : 0u;
    }
}

// element e of a packed bf16 pair as fp32
__device__ __forceinline__ float unpack(uint32_t v, int e) {
  return __uint_as_float(e ? (v & 0xffff0000u) : (v << 16));
}

// ------------------------------------------------------------ 1. cum
// cum[bc, h, 0, :] = cumsum(a[bc, h, :]); cum[bc, h, 1, j] = exp(cum_{Q-1}
// - cum_j): one warp per (chunk, head), 32 entries at a time
__global__ void __launch_bounds__(256) ssd_bwd_sm90_cum_kernel(
    const __nv_bfloat16* __restrict__ a, float* __restrict__ cum, int Q,
    long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* ar = a + row * Q;
  float* cr = cum + row * 2 * Q;
  float carry = 0.0f;
  for (int base = 0; base < Q; base += 32) {
    const int i = base + lane;
    float v = i < Q ? __bfloat162float(ar[i]) : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(FULL, v, off);
      if (lane >= off) v = __fadd_rn(v, n);
    }
    v = __fadd_rn(v, carry);
    if (i < Q) cr[i] = v;
    carry = __shfl_sync(FULL, v, 31);
  }
  __syncwarp();
  const float last = cr[Q - 1];
  for (int j = lane; j < Q; j += 32)
    cr[Q + j] = expf(__fsub_rn(last, cr[j]));
}

// ------------------------------------------------------------ 2. ds pass
// the ring of DS_STAGES stages (dy_i and x_j a stage), C_i and B_j at
// first in its last stages (their 2 N / 64 tiles), then the barriers
template <int N>
struct DsSmem {
  static constexpr int CB = (N / CHUNK) * TILE_BYTES;   // C_i or B_j
  static constexpr int STAGE = 2 * TILE_BYTES;
  static constexpr int C_OFF = DS_STAGES * STAGE - 2 * CB;
  static constexpr int B_OFF = C_OFF + CB;
  static constexpr int BAR_OFF = DS_STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + DS_STAGES) + 1024;
};

// dS for the [i, j] tile (ti >= tj) blockIdx.x of chunk blockIdx.y, and
// per head the row sums of t's tile into rowpart[bc, h, tj, i].  Two
// warpgroups: the first takes the even heads, the second the odd ones,
// each summing its own dS in head order; the two sums are added at the end
template <int N>
__global__ void __launch_bounds__(256) ssd_bwd_sm90_ds(
    const __grid_constant__ CUtensorMap tdy,
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tc,
    const __grid_constant__ CUtensorMap tb, const float* __restrict__ cum,
    float* __restrict__ rowpart, __nv_bfloat16* __restrict__ dS, int BC,
    int Q, int H, int QP, int nt) {
  using L = DsSmem<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* ring = smem;
  uint8_t* Cs = smem + L::C_OFF;
  uint8_t* Bs = smem + L::B_OFF;
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = own + 1;

  int ti = 0, rest = blockIdx.x;
  while (rest > ti) rest -= ++ti;
  const int tj = rest, bc = blockIdx.y;
  const int i0 = ti * TR, j0 = tj * TR;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < DS_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // head h's dy rows i and x rows j into stage h % DS_STAGES
  auto load_head = [&](int h) {
    const int s = h % DS_STAGES;
    uint8_t* st = ring + s * L::STAGE;
    mbar_expect_tx(&full[s], 2 * TILE_BYTES);
    tma_load_4d(st, &tdy, &full[s], 0, h, i0, bc);
    tma_load_4d(st + TILE_BYTES, &tx, &full[s], 0, h, j0, bc);
  };
  if (tid == 0) {
    mbar_expect_tx(own, 2 * L::CB);
#pragma unroll
    for (int c = 0; c < N / CHUNK; ++c) {
      tma_load_4d(Cs + c * TILE_BYTES, &tc, own, c * CHUNK, 0, i0, bc);
      tma_load_4d(Bs + c * TILE_BYTES, &tb, own, c * CHUNK, 0, j0, bc);
    }
    // the stages C_i and B_j do not hold
    for (int h = 0; h < DS_STAGES - 2 && h < H; ++h) load_head(h);
  }

  // the warpgroup and the warp within it, broadcast so the compiler sees
  // them warp-uniform
  const int wg = __shfl_sync(FULL, tid / 128, 0);
  const int warp = __shfl_sync(FULL, (tid / 32) % 4, 0);
  const int t = tid % 128, lane = tid % 32, quad = lane % 4;
  const int r0 = warp * 16 + lane / 4;   // rows r0, r0 + 8 of the tile

  // S's tile: sc[4 c + 2 r + e] is row i0 + r0 + 8 r, column j0 + 8 c + 2
  // quad + e
  float sc[32], ds[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) ds[x] = 0.0f;
  mbar_wait(own, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    wgmma_ss<64>(sc, kmajor_desc(Cs + c * TILE_BYTES + off),
                 kmajor_desc(Bs + c * TILE_BYTES + off), kk);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(sc);
  __syncthreads();   // C_i and B_j read: their stages take heads
  if (tid == 0)
    for (int h = DS_STAGES - 2; h < DS_STAGES && h < H; ++h) load_head(h);

  // heads 2 n and 2 n + 1 at step n, one a warpgroup; the ring's six
  // stages hold three steps
  for (int n = 0; 2 * n < H; ++n) {
    const int h = 2 * n + wg;
    if (h < H) {
      const int s = h % DS_STAGES;
      // this head's cumsum (base 2) at the thread's rows and columns,
      // loaded before the tiles are waited for
      const float* ch = cum + ((size_t)bc * H + h) * 2 * Q;
      float ci[2], cj[16];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + r0 + 8 * r;
        ci[r] = i < Q ? __fmul_rn(ch[i], LOG2E) : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 8 * c + 2 * quad + e;
          cj[2 * c + e] = j < Q ? __fmul_rn(ch[j], LOG2E) : 0.0f;
        }
      mbar_wait(&full[s], (h / DS_STAGES) & 1);
      const uint8_t* dyt = ring + s * L::STAGE;
      const uint8_t* xt = dyt + TILE_BYTES;
      float dw[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64>(dw, kmajor_desc(dyt + kk * 32),
                     kmajor_desc(xt + kk * 32), kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dw);

      float rsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * c + 2 * r + e;
            const int i = i0 + r0 + 8 * r, j = j0 + 8 * c + 2 * quad + e;
            if (i < Q && j <= i) {
              const float L = exp2f(__fsub_rn(ci[r], cj[2 * c + e]));
              ds[x] = __fmaf_rn(dw[x], L, ds[x]);
              rsum[r] = __fadd_rn(rsum[r],
                                  __fmul_rn(__fmul_rn(dw[x], sc[x]), L));
            }
          }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rsum[r] = __fadd_rn(rsum[r], __shfl_xor_sync(FULL, rsum[r], 1));
        rsum[r] = __fadd_rn(rsum[r], __shfl_xor_sync(FULL, rsum[r], 2));
        const int i = i0 + r0 + 8 * r;
        if (quad == 0 && i < Q)
          rowpart[(((size_t)bc * H + h) * nt + tj) * Q + i] = rsum[r];
      }
    }
    __syncthreads();   // both heads' products done with their stages
    if (tid == 0)
      for (int w = 0; w < 2; ++w)
        if (2 * n + w + DS_STAGES < H) load_head(2 * n + w + DS_STAGES);
  }

  // the odd heads' sum handed over through the ring (free now), added to
  // the even heads' in that order
  float* part = reinterpret_cast<float*>(ring);
  if (wg == 1)
#pragma unroll
    for (int x = 0; x < 32; ++x) part[x * 128 + t] = ds[x];
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int x = 0; x < 32; ++x) ds[x] = __fadd_rn(ds[x], part[x * 128 + t]);

  // dS rounded to bf16, and its transpose at dS + BC QP QP
  __nv_bfloat16* dst = dS + (size_t)bc * QP * QP;
  __nv_bfloat16* dstT = dS + ((size_t)BC + bc) * QP * QP;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + r0 + 8 * r;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = j0 + 8 * c + 2 * quad;
      const __nv_bfloat162 v = __floats2bfloat162_rn(ds[4 * c + 2 * r],
                                                     ds[4 * c + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)i * QP + j) = v;
      dstT[(size_t)j * QP + i] = v.x;
      dstT[(size_t)(j + 1) * QP + i] = v.y;
    }
  }
}

// ------------------------------------------------------------ 3. dx pass
template <int N>
struct DxSmem {
  static constexpr int CB = QMAX * N * 2;        // C or B: N / 64 chunks
  static constexpr int B_OFF = CB;
  static constexpr int DST_BYTES = P * N * 2;     // dst_h: N / 64 chunks
  static constexpr int STAGE = FULL_BYTES + DST_BYTES;   // dy_h, dst_h
  static constexpr int RING_OFF = 2 * CB;
  static constexpr int BAR_OFF = RING_OFF + DX_STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + DX_STAGES) + 1024;
};

// dx of head h for the 64 rows j of tile tj, e_j and the column sums of t
// over those rows
template <int N>
__device__ __forceinline__ void dx_row_tile(
    const uint8_t* Cs, const uint8_t* Bs, const uint8_t* dys,
    const uint8_t* dsts, const float* ch, const __nv_bfloat16* xg,
    __nv_bfloat16* dxg, float* e_out, float* colsum, int tj, int n_tiles,
    int r0, int quad, int Q, int H) {
  // x_h's rows j as A fragments (K = p), rows H P elements apart
  uint32_t xa[4][4];
  load_fragments(xa, xg, (size_t)H * P, tj * TR, Q, 0, r0, quad);
  float cjv[2], dj[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = tj * TR + r0 + 8 * r;
    cjv[r] = j < Q ? __fmul_rn(ch[j], LOG2E) : 0.0f;
    dj[r] = j < Q ? ch[Q + j] : 0.0f;
  }
  float acc[32], csum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = 0.0f;

  for (int ti = tj; ti < n_tiles; ++ti) {
    // the cumsum at this tile's columns i
    float ci[16];
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = ti * TR + 8 * c + 2 * quad + e;
        ci[2 * c + e] = i < Q ? __fmul_rn(ch[i], LOG2E) : 0.0f;
      }
    // S^T = B_j C_i^T and dW^T = x_j dy_i^T: st[4 c + 2 r + e] is row j =
    // tj 64 + r0 + 8 r, column i = ti 64 + 8 c + 2 quad + e
    float st[32], dwt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      wgmma_ss<64>(st,
                   kmajor_desc(Bs + c * FULL_BYTES + tj * TILE_BYTES + off),
                   kmajor_desc(Cs + c * FULL_BYTES + ti * TILE_BYTES + off),
                   kk);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64_kmajor(dwt, xa[kk],
                          kmajor_desc(dys + ti * TILE_BYTES + kk * 32), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dwt);

    // W^T (fp32, 0 off the causal half) and t's sums over i for each j
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * c + 2 * r + e;
          const int j = tj * TR + r0 + 8 * r;
          const int i = ti * TR + 8 * c + 2 * quad + e;
          const bool live = i < Q && i >= j;
          const float L = exp2f(__fsub_rn(ci[2 * c + e], cjv[r]));
          const float t = __fmul_rn(__fmul_rn(dwt[x], st[x]), L);
          const float w = __fmul_rn(st[x], L);
          csum[r] = live ? __fadd_rn(csum[r], t) : csum[r];
          st[x] = live ? w : 0.0f;
        }
    // dx += bf16(W^T) dy_i, W^T packed in the A operand's register layout
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = pack_bf16(st[8 * kk + 2 * x], st[8 * kk + 2 * x + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<64>(acc, pa[kk],
                   mnmajor_desc(dys + (ti * TR + kk * 16) * CHUNK_ROW_BYTES,
                                FULL_BYTES),
                   1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }

  // G = B_j dst_h^T: g[4 c + 2 r + e] is row j, column p = 8 c + 2 quad + e
  float g[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    wgmma_ss<64>(g, kmajor_desc(Bs + c * FULL_BYTES + tj * TILE_BYTES + off),
                 kmajor_desc(dsts + c * TILE_BYTES + off), kk);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(g);

  // dx = acc + d_j G; e_j = d_j sum_p x_jp G_jp, x from its fragments
  // (column 8 c + 2 quad + e of row r0 + 8 r is half e of xa[c / 2][2 (c %
  // 2) + r])
  float ee[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = tj * TR + r0 + 8 * r;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t xv = xa[c / 2][2 * (c % 2) + r];
      float o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * c + 2 * r + e;
        ee[r] = __fmaf_rn(unpack(xv, e), g[x], ee[r]);
        o[e] = __fmaf_rn(dj[r], g[x], acc[x]);
      }
      if (j < Q)
        *reinterpret_cast<__nv_bfloat162*>(dxg + (size_t)j * H * P + 8 * c +
                                           2 * quad) =
            __floats2bfloat162_rn(o[0], o[1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ee[r] = __fadd_rn(ee[r], __shfl_xor_sync(FULL, ee[r], off));
      csum[r] = __fadd_rn(csum[r], __shfl_xor_sync(FULL, csum[r], off));
    }
    const int j = tj * TR + r0 + 8 * r;
    if (quad == 0 && j < Q) {
      e_out[j] = __fmul_rn(ee[r], dj[r]);
      colsum[j] = csum[r];
    }
  }
}

// dx, e and t's column sums for chunk blockIdx.y and heads blockIdx.x *
// heads_per_block onwards
template <int N>
__global__ void __launch_bounds__(256, 1) ssd_bwd_sm90_dx(
    const __grid_constant__ CUtensorMap tdy,
    const __grid_constant__ CUtensorMap tc,
    const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap tdst,
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ cum,
    __nv_bfloat16* __restrict__ dx, float* __restrict__ e,
    float* __restrict__ colsum, int Q, int H, int heads_per_block) {
  using L = DxSmem<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* Cs = smem;
  uint8_t* Bs = smem + L::B_OFF;
  uint8_t* ring = smem + L::RING_OFF;
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = own + 1;

  const int bc = blockIdx.y;
  const int h0 = blockIdx.x * heads_per_block;
  const int n_heads = min(heads_per_block, H - h0);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < DX_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // head h0 + t's dy [256, 64] and dst [64, N] into stage s
  auto load_head = [&](int t, int s) {
    uint8_t* st = ring + s * L::STAGE;
    const int h = h0 + t;
    mbar_expect_tx(&full[s], L::STAGE);
    tma_load_4d(st, &tdy, &full[s], 0, h, 0, bc);
#pragma unroll
    for (int c = 0; c < N / CHUNK; ++c)
      tma_load_4d(st + FULL_BYTES + c * TILE_BYTES, &tdst, &full[s],
                  c * CHUNK, 0, 0, bc * H + h);
  };
  if (tid == 0) {
    mbar_expect_tx(own, 2 * L::CB);
#pragma unroll
    for (int c = 0; c < N / CHUNK; ++c) {
      tma_load_4d(Cs + c * FULL_BYTES, &tc, own, c * CHUNK, 0, 0, bc);
      tma_load_4d(Bs + c * FULL_BYTES, &tb, own, c * CHUNK, 0, 0, bc);
    }
    for (int t = 0; t < DX_STAGES && t < n_heads; ++t) load_head(t, t);
  }

  // the warpgroup and the warp within it, broadcast so the compiler sees
  // them warp-uniform
  const int wg = __shfl_sync(FULL, tid / 128, 0);
  const int warp = __shfl_sync(FULL, (tid / 32) % 4, 0);
  const int lane = tid % 32, quad = lane % 4;
  const int r0 = warp * 16 + lane / 4;
  const int n_tiles = (Q + TR - 1) / TR;

  mbar_wait(own, 0);
  for (int t = 0; t < n_heads; ++t) {
    const int s = t % DX_STAGES, h = h0 + t;
    mbar_wait(&full[s], (t / DX_STAGES) & 1);
    const uint8_t* dys = ring + s * L::STAGE;
    const float* ch = cum + ((size_t)bc * H + h) * 2 * Q;
    const size_t row_h = ((size_t)bc * Q * H + h) * P;   // (bc, 0, h, 0)
    const size_t at = ((size_t)bc * H + h) * Q;
#pragma unroll 1
    for (int k = 0; k < 2; ++k) {
      const int tj = k == 0 ? 3 - wg : wg;   // {3, 0} or {2, 1}
      if (tj < n_tiles)
        dx_row_tile<N>(Cs, Bs, dys, dys + FULL_BYTES, ch, x + row_h,
                       dx + row_h, e + at, colsum + at, tj, n_tiles, r0,
                       quad, Q, H);
    }
    __syncthreads();   // both warpgroups done with stage s
    if (tid == 0 && t + DX_STAGES < n_heads) load_head(t + DX_STAGES, s);
  }
}

// ---------------------------------------------------------- 4. dbdc pass
// dC and dB of chunk bc for the 64 rows of tile t and the 64 columns of
// N chunk c, blockIdx.x = (bc nt + t) (N / 64) + c.  Its loop items, each
// one [64, 64] tile by TMA: B's tiles tj <= t (dC), C's tiles ti >= t
// (dB), then dst_h's tile for each head h in order (dB's states term)
template <int N>
__global__ void __launch_bounds__(128) ssd_bwd_sm90_dbdc(
    const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap tc,
    const __grid_constant__ CUtensorMap tdst,
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dS,
    const float* __restrict__ cum, __nv_bfloat16* __restrict__ dB,
    __nv_bfloat16* __restrict__ dC, int BC, int Q, int H, int QP, int nt) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + DB_STAGES * TILE_BYTES);

  constexpr int NCH = N / CHUNK;
  const int c = blockIdx.x % NCH;
  const int t = (blockIdx.x / NCH) % nt;
  const int bc = blockIdx.x / (NCH * nt);
  const int r_start = t * TR;
  const int n_b = t + 1, n_c = nt - t;
  const int n_items = n_b + n_c + H;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < DB_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_item = [&](int k, int s) {
    uint8_t* st = ring + s * TILE_BYTES;
    mbar_expect_tx(&full[s], TILE_BYTES);
    if (k < n_b)
      tma_load_4d(st, &tb, &full[s], c * CHUNK, 0, k * TR, bc);
    else if (k < n_b + n_c)
      tma_load_4d(st, &tc, &full[s], c * CHUNK, 0, (t + k - n_b) * TR, bc);
    else
      tma_load_4d(st, &tdst, &full[s], c * CHUNK, 0, 0,
                  bc * H + (k - n_b - n_c));
  };
  if (tid == 0)
    for (int k = 0; k < DB_STAGES && k < n_items; ++k) load_item(k, k);

  const int warp = __shfl_sync(FULL, tid / 32, 0);
  const int lane = tid % 32, quad = lane % 4;
  const int r0 = warp * 16 + lane / 4;
  // the end of an item: every product on its stage done, then the stage
  // takes the item DB_STAGES ahead
  auto next = [&](int k) {
    __syncthreads();
    if (tid == 0 && k + DB_STAGES < n_items)
      load_item(k + DB_STAGES, k % DB_STAGES);
  };
  const __nv_bfloat16* dSc = dS + (size_t)bc * QP * QP;
  const __nv_bfloat16* dStc = dS + ((size_t)BC + bc) * QP * QP;
  float acc_c[32], acc_b[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) acc_c[x] = acc_b[x] = 0.0f;
  int k = 0;

  // dC[i, n] = sum_{j <= i} bf16(dS)[i, j] B[j, n]
  for (int tj = 0; tj <= t; ++tj, ++k) {
    uint32_t fa[4][4];
    load_fragments(fa, dSc, QP, r_start, QP, tj * TR, r0, quad);
    mbar_wait(&full[k % DB_STAGES], (k / DB_STAGES) & 1);
    const uint8_t* st = ring + (k % DB_STAGES) * TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<64>(acc_c, fa[kk],
                   mnmajor_desc(st + kk * 16 * CHUNK_ROW_BYTES, TILE_BYTES),
                   1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_c);
    next(k);
  }
  // dB[j, n] = sum_{i >= j} bf16(dS)^T[j, i] C[i, n]
  for (int ti = t; ti < nt; ++ti, ++k) {
    uint32_t fa[4][4];
    load_fragments(fa, dStc, QP, r_start, QP, ti * TR, r0, quad);
    mbar_wait(&full[k % DB_STAGES], (k / DB_STAGES) & 1);
    const uint8_t* st = ring + (k % DB_STAGES) * TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<64>(acc_b, fa[kk],
                   mnmajor_desc(st + kk * 16 * CHUNK_ROW_BYTES, TILE_BYTES),
                   1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_b);
    next(k);
  }
  // + sum_h d_h[j] (x_h dst_h)[j, n], the heads in order, each product
  // summed in fp32 and added with its decay; the next head's x fragments
  // and decays are loaded while a head's product runs
  auto head_operands = [&](int h, uint32_t (&f)[4][4], float (&d)[2]) {
    load_fragments(f, x + ((size_t)bc * Q * H + h) * P, (size_t)H * P,
                   r_start, Q, 0, r0, quad);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = r_start + r0 + 8 * r;
      d[r] = j < Q ? cum[(((size_t)bc * H + h) * 2 + 1) * Q + j] : 0.0f;
    }
  };
  uint32_t fa[4][4];
  float d[2];
  head_operands(0, fa, d);
  for (int h = 0; h < H; ++h, ++k) {
    uint32_t fn[4][4];
    float dn[2];
    head_operands(h + 1 < H ? h + 1 : h, fn, dn);
    mbar_wait(&full[k % DB_STAGES], (k / DB_STAGES) & 1);
    const uint8_t* st = ring + (k % DB_STAGES) * TILE_BYTES;
    float xd[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<64>(xd, fa[kk],
                   mnmajor_desc(st + kk * 16 * CHUNK_ROW_BYTES, TILE_BYTES),
                   kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(xd);
#pragma unroll
    for (int x = 0; x < 32; ++x)
      acc_b[x] = __fmaf_rn(d[(x >> 1) & 1], xd[x], acc_b[x]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) fa[kk][x] = fn[kk][x];
    d[0] = dn[0];
    d[1] = dn[1];
    next(k);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r_start + r0 + 8 * r;
    if (i >= Q) continue;
    const size_t at = ((size_t)bc * Q + i) * N + c * CHUNK;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int x = 4 * jj + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(dC + at + 8 * jj + 2 * quad) =
          __floats2bfloat162_rn(acc_c[x], acc_c[x + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dB + at + 8 * jj + 2 * quad) =
          __floats2bfloat162_rn(acc_b[x], acc_b[x + 1]);
    }
  }
}

// ------------------------------------------------------------ 5. da
// da[bc, h, :]: dcum_k = sum_{u <= k / 64} rowpart[u][k] - colsum[k] -
// e[k] (+ sum_j e_j at k = Q - 1), reverse-scanned 32 entries at a time
// from the end: one warp per (chunk, head)
__global__ void __launch_bounds__(256) ssd_bwd_sm90_da_kernel(
    const float* __restrict__ rowpart, const float* __restrict__ colsum,
    const float* __restrict__ e, __nv_bfloat16* __restrict__ da, int Q,
    int nt, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const float* rp = rowpart + row * nt * Q;
  const float* cs = colsum + row * Q;
  const float* er = e + row * Q;
  float esum = 0.0f;
  for (int j = lane; j < Q; j += 32) esum = __fadd_rn(esum, er[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    esum = __fadd_rn(esum, __shfl_xor_sync(FULL, esum, off));
  float carry = 0.0f;
  for (int base = Q - 1; base >= 0; base -= 32) {
    const int k = base - lane;
    float v = 0.0f;
    if (k >= 0) {
      for (int u = 0; u <= k / TR; ++u) v = __fadd_rn(v, rp[(size_t)u * Q + k]);
      v = __fsub_rn(__fsub_rn(v, cs[k]), er[k]);
      if (k == Q - 1) v = __fadd_rn(v, esum);
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(FULL, v, off);
      if (lane >= off) v = __fadd_rn(v, n);
    }
    v = __fadd_rn(v, carry);
    if (k >= 0) da[row * Q + k] = __float2bfloat16_rn(v);
    carry = __shfl_sync(FULL, v, 31);
  }
}

// ------------------------------------------------------------- host side
template <class Kernel>
int opt_in(Kernel kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int N>
int launch(const void* x, const void* a, const void* Bm, const void* Cm,
           const void* dy, const void* dst, float* cum, void* dS,
           float* rowpart, float* colsum, float* e, void* dx, void* da,
           void* dB, void* dC, int BC, int Q, int H, int heads_per_block,
           cudaStream_t s) {
  const int nt = (Q + TR - 1) / TR, QP = nt * TR;
  const long long rows = (long long)BC * H;
  const unsigned warp_blocks = (unsigned)((rows + 7) / 8);
  ssd_bwd_sm90_cum_kernel<<<warp_blocks, 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(a), cum, Q, rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  CUtensorMap tdy64, tx64, tc64, tb64, tdy, tc, tb, tdst;
  int rc = encode(&tdy64, dy, BC, Q, H, P, TR);
  if (rc == 0) rc = encode(&tx64, x, BC, Q, H, P, TR);
  if (rc == 0) rc = encode(&tc64, Cm, BC, Q, 1, N, TR);
  if (rc == 0) rc = encode(&tb64, Bm, BC, Q, 1, N, TR);
  if (rc == 0) rc = encode(&tdy, dy, BC, Q, H, P, QMAX);
  if (rc == 0) rc = encode(&tc, Cm, BC, Q, 1, N, QMAX);
  if (rc == 0) rc = encode(&tb, Bm, BC, Q, 1, N, QMAX);
  if (rc == 0) rc = encode(&tdst, dst, BC * H, P, 1, N, TR);
  if (rc != 0) return rc;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* dSb = static_cast<__nv_bfloat16*>(dS);

  err = opt_in(ssd_bwd_sm90_ds<N>, DsSmem<N>::BYTES);
  if (err) return err;
  ssd_bwd_sm90_ds<N><<<dim3(nt * (nt + 1) / 2, BC), 256, DsSmem<N>::BYTES,
                       s>>>(tdy64, tx64, tc64, tb64, cum, rowpart, dSb, BC,
                            Q, H, QP, nt);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  err = opt_in(ssd_bwd_sm90_dx<N>, DxSmem<N>::BYTES);
  if (err) return err;
  ssd_bwd_sm90_dx<N><<<dim3((H + heads_per_block - 1) / heads_per_block,
                            BC),
                       256, DxSmem<N>::BYTES, s>>>(
      tdy, tc, tb, tdst, xb, cum, static_cast<__nv_bfloat16*>(dx), e,
      colsum, Q, H, heads_per_block);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  const int db_smem = DB_STAGES * TILE_BYTES + 8 * DB_STAGES + 1024;
  err = opt_in(ssd_bwd_sm90_dbdc<N>, db_smem);
  if (err) return err;
  const long long db_blocks = (long long)BC * nt * (N / CHUNK);
  if (db_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ssd_bwd_sm90_dbdc<N><<<(unsigned)db_blocks, 128, db_smem, s>>>(
      tb64, tc64, tdst, xb, dSb, cum, static_cast<__nv_bfloat16*>(dB),
      static_cast<__nv_bfloat16*>(dC), BC, Q, H, QP, nt);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  ssd_bwd_sm90_da_kernel<<<warp_blocks, 256, 0, s>>>(
      rowpart, colsum, e, static_cast<__nv_bfloat16*>(da), Q, nt, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bf16 x [BC, Q, H, 64], a [BC, H, Q], Bm/Cm [BC, Q, N], dy [BC, Q, H,
// 64], dst [BC, H, 64, N] -> dx, da, dB, dC shaped as x, a, Bm, Cm; N in
// {64, 128}, 1 <= Q <= 256.  fp32 scratch from the wrapper: cum [BC, H,
// 2, Q], rowpart [BC, H, nt, Q] (nt = ceil(Q / 64)), colsum and e [BC, H,
// Q]; bf16 dS [2, BC, QP, QP] (QP = 64 nt).  x, Bm, Cm, dy, dst 16-byte
// aligned (the wrapper checks).
int fog_ssd_chunk_bwd_sm90(const void* x, const void* a, const void* Bm,
                           const void* Cm, const void* dy, const void* dst,
                           void* cum, void* dS, void* rowpart, void* colsum,
                           void* e, void* dx, void* da, void* dB, void* dC,
                           int BC, int Q, int H, int P_, int N,
                           int heads_per_block, void* stream) {
  if (BC < 1 || BC > 65535 || Q < 1 || Q > QMAX || H < 1 || P_ != P ||
      heads_per_block < 1 || (long long)BC * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fc = static_cast<float*>(cum);
  float* fr = static_cast<float*>(rowpart);
  float* fs = static_cast<float*>(colsum);
  float* fe = static_cast<float*>(e);
  if (N == 64)
    return launch<64>(x, a, Bm, Cm, dy, dst, fc, dS, fr, fs, fe, dx, da, dB,
                      dC, BC, Q, H, heads_per_block, s);
  if (N == 128)
    return launch<128>(x, a, Bm, Cm, dy, dst, fc, dS, fr, fs, fe, dx, da,
                       dB, dC, BC, Q, H, heads_per_block, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
