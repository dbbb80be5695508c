// The backward of causal or non-causal GQA/MQA attention for NVIDIA Hopper
// (sm_90a) on the tensor cores: bf16 q, k, v, o, do at the forward's head
// pairs (D, Dv): (64, 64), (128, 128), (64, 128), (128, 64), (96, 64)
// (minicpm3), (192, 128) (deepseek) and (256, 256) (gemma); fp32 lse and
// delta.
//
//   fog_flash_attention_bwd_sm90   the gradient of fog_flash_attention_sm90
//                                  (flash_attention_sm90.cu); replaces no
//                                  TPU kernel: the JAX package
//                                  differentiates its blocked jnp attention
//                                  with jax.grad
//
// behind a plain C entry point that launches three kernels in order on the
// caller's stream and returns cudaGetLastError() (loaded with ctypes by
// repro_torch/kernels/_build.py).  The wrapper
// (kernels/flash_attention.py::flash_attention_bwd_cuda) routes bf16 at
// these pairs here, allocates delta and the three outputs and checks the
// pointers' 16-byte alignment; the kernels allocate nothing.
//
// What it computes (the function of flash_attention_bwd_ref), with q [B,
// Sq, H, D], k [B, Sk, K, D], v [B, Sk, K, Dv], the forward's output o and
// its gradient do [B, Sq, H, Dv], the forward's lse [B, H, Sq], G = H / K:
//
//   delta[i] = sum_e do[i, e] o[i, e]                  fp32       delta
//   s[i, j]  = q[i] . k[j]                bf16 products, fp32 sums
//   p[i, j]  = exp(s[i, j] scale - lse[i]) where (i, j) is live, else 0
//   dp[i, j] = do[i] . v[j]               bf16 products, fp32 sums
//   ds[i, j] = p[i, j] (dp[i, j] - delta[i])          fp32
//   dv[j]    = sum over the G heads, i of bf16(p[i, j]) do[i]   dkdv pass
//   dk[j]    = scale * sum over the G heads, i of bf16(ds[i, j]) q[i]
//   dq[i]    = scale * sum_j bf16(ds[i, j]) k[j]                dq pass
//
// live(i, j) = j < Sk and (not causal or i >= j), both counted from 0 (the
// forward's top-left diagonal); a row whose lse is -inf (it saw no key)
// has p = 0 everywhere.  p and ds are rounded to bf16 only as the A
// operands of the last products; ds is taken from the fp32 p.  The
// outputs are stored as bf16.
//
// Design.  The three parts of the SIMT backward (flash_attention_bwd.cu),
// so that nothing is summed by atomics and every output is written once:
// the result is the same bit for bit from run to run.  Both passes run on
// 64-row tiles; thread 0 loads tiles by TMA (4-D tensor maps over [B, S,
// heads, 64-column chunk], the 128-byte swizzle, zeros past the edge)
// into a two-stage ring, the next tile's load in flight while the current
// one is computed.
//   * dkdv pass, one block per (64-key tile, KV head, batch): K and V once;
//     then for each q tile from the causal start and each of the G query
//     heads in turn, q and do's tiles: S^T = K q^T and dP^T = V do^T with
//     wgmma (A and B K-major from shared memory), P^T and dS^T in
//     registers, then dV += bf16(P^T) do and dK += bf16(dS^T) q with wgmma,
//     the A operand taken from registers in the accumulator's own layout
//     and B = do or q MN-major (the transpose bit).  dK is scaled once at
//     the end.
//   * dq pass, one block per (64-row q tile, query head, batch), the
//     longest causal rows first: q and do once, then each key tile up to
//     the diagonal: S = q K^T, dP = do V^T, dS, and dQ += bf16(dS) K.
// Seven products in all (S and dP twice); each block's lse and delta for
// the tile's rows go through shared memory.
//
// The dkdv pass's registers.  One warpgroup holds, a thread, dK (Dp / 2
// fp32 values), dV (Dv / 2), S^T and dP^T (32 each): 160 at (96, 64), 192
// at (128, 128), which ptxas holds in 220 registers without spilling; 224
// at (192, 128) and 320 at (256, 256) do not fit the 255 a thread may
// have.  So where D + Dv > 256 (split_dkdv) the block runs two warpgroups
// on the same 64 keys: the first computes S^T and P^T, hands P^T in fp32
// to the second through shared memory (16 KB, each thread's 32 values at
// the same layout positions the other warpgroup's thread holds dP^T in)
// and accumulates dV; the second computes dP^T, then dS^T from the fp32
// P^T, and accumulates dK.  The products are the same seven: the split
// moves dV's and dK's accumulators apart, not the work, and the two
// warpgroups' products overlap.  Named barriers order them: each
// warpgroup's own rows of lse or delta, P^T written (the first arrives,
// the second waits), and the stage and P^T free at the end of a tile.
// The dq pass holds dQ (Dp / 2), S and dP: 192 values at most (D = 256),
// as the dkdv pass at (128, 128), in one warpgroup.
//
// D = 96 (minicpm3) is not a multiple of the 64-column chunk: its q and K
// tiles take two whole chunks, columns 96 to 127 zeros (TMA's fill past
// the tensor maps' inner extent D, counted on the barrier with the box's
// bytes).  The products over D (S^T, S) run over the 6 real k-steps; the
// products that give D columns (dK += dS^T q, dQ += dS K) run at N = Dp =
// 128, a third more of those two products' work, and the padded columns
// of dK and dQ (zeros) are never stored.
//
// Shared memory: the block's own two tiles (64 x Dp and 64 x Dv bf16), per
// stage two loop tiles, each 64-column chunk 1024-byte aligned, and P^T
// (64 x 64 fp32) where the dkdv pass is split: at D = Dv = 64 48 KB, at 128
// 96 KB, at 256 208 KB (kernels/flash_attention.py::bwd_smem_bytes_sm90
// gives the exact figures).
//
// What bounds it: at the training shape (q [2, 4096, 32, 64], k/v [2,
// 4096, 4, 64], causal) the function does five causal products (s
// recomputed, dp, dv, dk, dq), 3.44e11 FLOP, 0.347 ms at 989 TFLOP/s
// bf16, against ~153 MB of q, k, v, o, do, lse read and dq, dk, dv
// written, 0.046 ms at 3.35 TB/s: operations bound it; at minicpm3's
// (q [2, 4096, 40, 96], v [.., 64]) 0.565 ms by operations.  This design
// runs seven products, does not overlap a tile's products with its
// elementwise part (the split dkdv pass overlaps its two warpgroups'
// products only), and has one load in flight, so it runs well above that
// bound (PERF.md rows 6b, 6c).

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int BT = 64;          // rows of every tile: keys or q rows
constexpr int THREADS = 128;    // one warpgroup
constexpr int STAGES = 2;       // loop tiles in flight
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// the dkdv pass on two warpgroups, one holding dV and one dK (see the
// header): where one warpgroup cannot hold both accumulators
template <int D, int DV>
__host__ __device__ constexpr bool split_dkdv() {
  return D + DV > 256;
}

// named barriers (bar.sync / bar.arrive over `n` threads), for the two
// warpgroups of the split dkdv pass; 0 is __syncthreads'
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// a block's shared memory: its own two tiles (K and V in the dkdv pass,
// q and do in the dq pass), per stage the two loop tiles (q and do, or K
// and V), P^T (fp32, the split dkdv pass only), the loop tile's lse and
// delta, then the barriers; widths padded to whole 64-column chunks
template <int D, int DV>
struct Smem {
  static constexpr int DP = padded<D>();
  static constexpr int A_BYTES = BT * DP * 2;
  static constexpr int B_BYTES = BT * DV * 2;
  static constexpr int B_OFF = A_BYTES;
  static constexpr int C_OFF = B_OFF + B_BYTES;
  static constexpr int E_OFF = C_OFF + STAGES * A_BYTES;
  static constexpr int P_OFF = E_OFF + STAGES * B_BYTES;
  static constexpr int P_BYTES = split_dkdv<D, DV>() ? BT * BT * 4 : 0;
  static constexpr int ROW_OFF = P_OFF + P_BYTES;
  static constexpr int BAR_OFF = ROW_OFF + 2 * BT * 4;
  // + 1024 for aligning the dynamic base
  static constexpr int BYTES = BAR_OFF + 8 * (1 + STAGES) + 1024;
};

// a [64, W] tile at (head, row0, batch) into 64-column chunks at dst (the
// last chunk's columns past W zeros)
template <int W>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* m,
                                          uint64_t* bar, int head, int row0,
                                          int b) {
#pragma unroll
  for (int c = 0; c < padded<W>() / CHUNK; ++c)
    tma_load_4d(dst + c * BT * CHUNK_ROW_BYTES, m, bar, c * CHUNK, head,
                row0, b);
}

// a [64, W1] and a [64, W2] tile at the same (head, row0, batch), both
// completing on `bar`
template <int W1, int W2>
__device__ __forceinline__ void load_pair(uint8_t* d1, const CUtensorMap* m1,
                                          uint8_t* d2, const CUtensorMap* m2,
                                          uint64_t* bar, int head, int row0,
                                          int b) {
  mbar_expect_tx(bar, BT * (padded<W1>() + padded<W2>()) * 2);
  load_tile<W1>(d1, m1, bar, head, row0, b);
  load_tile<W2>(d2, m2, bar, head, row0, b);
}

// d[64 x 64] = A[64 x W] . B[64 x W]^T, both K-major 64-row tiles (the W
// real columns: W / 16 k-steps)
template <int W>
__device__ __forceinline__ void product_nt(float (&d)[32], const uint8_t* a,
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    wgmma_ss<64>(d, kmajor_desc(a + c * BT * CHUNK_ROW_BYTES + off),
                 kmajor_desc(b + c * BT * CHUNK_ROW_BYTES + off), kk);
  }
}

// d[64 x N] += A[64 x 64] . B[64 x N], A from registers (four k-steps of
// the accumulator's layout), B an MN-major 64-row tile of N / 64 chunks
template <int N>
__device__ __forceinline__ void product_rn(float (&d)[N / 2],
                                           const uint32_t (&a)[4][4],
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_wide<N>(d, a[kk], b + kk * 16 * CHUNK_ROW_BYTES,
                     BT * CHUNK_ROW_BYTES, 1);
}

// x[32] (fp32, the accumulator's layout) as bf16 A fragments
__device__ __forceinline__ void to_fragments(const float (&x)[32],
                                             uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// row row0 + 8 r of a [64, 2 N] fp32 accumulator (N values a thread), its
// first W columns scaled, as bf16 into dst (the columns past W, a padded
// tile's zeros, are not stored)
template <int W, int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N],
                                           __nv_bfloat16* dst, int r,
                                           float scale, int quad) {
  static_assert(W % 8 == 0 && W <= 2 * N, "W columns of the accumulator");
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
    *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * quad) =
        __floats2bfloat162_rn(__fmul_rn(acc[4 * j + 2 * r], scale),
                              __fmul_rn(acc[4 * j + 2 * r + 1], scale));
}

// delta[b, h, i] = sum_e do[b, i, h, e] o[b, i, h, e] in fp32: one warp a
// row
__global__ void __launch_bounds__(256) flash_attention_bwd_sm90_delta_kernel(
    const __nv_bfloat16* __restrict__ o,
    const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
    int Sq, int H, int Dv, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const __nv_bfloat16* orow = o + row * Dv;
  const __nv_bfloat16* drow = dout + row * Dv;
  float sum = 0.0f;
  for (int e = lane; e < Dv; e += 32)
    sum = __fmaf_rn(__bfloat162float(drow[e]), __bfloat162float(orow[e]),
                    sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, off));
  if (lane == 0) {
    const long long h = row % H, bi = row / H, i = bi % Sq, b = bi / Sq;
    delta[(b * H + h) * Sq + i] = sum;
  }
}

// dk, dv for the 64 keys of tile blockIdx.x, KV head blockIdx.y, batch
// blockIdx.z
template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_bwd_sm90_dkdv(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H, int K,
    float scale, float scale_log2, int causal) {
  using L = Smem<D, DV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Ks = smem;
  uint8_t* Vs = smem + L::B_OFF;
  uint8_t* Qs = smem + L::C_OFF;
  uint8_t* dOs = smem + L::E_OFF;
  float* lse_s = reinterpret_cast<float*>(smem + L::ROW_OFF);
  float* dl_s = lse_s + BT;
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = own + 1;

  const int j0 = blockIdx.x * BT, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int tid = threadIdx.x;
  // causal: row i sees key j only for i >= j, so the q tiles start at j0
  const int i_start = causal ? j0 : 0;
  const int n_qt = i_start < Sq ? (Sq - i_start + BT - 1) / BT : 0;
  const int n_items = n_qt * G;   // (q tile, head of the group), heads inner

  if (tid == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_pair<D, DV>(Ks, &tk, Vs, &tv, own, kh, j0, b);
    for (int n = 0; n < STAGES && n < n_items; ++n)
      load_pair<D, DV>(Qs + n * L::A_BYTES, &tq, dOs + n * L::B_BYTES, &tdo,
                       &full[n], kh * G + n % G, i_start + (n / G) * BT, b);
  }

  // the warp's index, broadcast so the compiler sees it warp-uniform
  const int warp = __shfl_sync(FULL, tid / 32, 0);
  const int lane = tid % 32, quad = lane % 4;
  const int row0 = warp * 16 + lane / 4;   // this thread's keys row0, +8
  float dk_acc[L::DP / 2], dv_acc[DV / 2];
#pragma unroll
  for (int x = 0; x < L::DP / 2; ++x) dk_acc[x] = 0.0f;
#pragma unroll
  for (int x = 0; x < DV / 2; ++x) dv_acc[x] = 0.0f;

  mbar_wait(own, 0);
  for (int n = 0; n < n_items; ++n) {
    const int s = n % STAGES;
    const int i0 = i_start + (n / G) * BT, h = kh * G + n % G;
    // the tile's lse (base 2) and delta; a row past Sq or with no key has
    // lse -inf and so p = 0
    if (tid < BT) {
      const int i = i0 + tid;
      lse_s[tid] = i < Sq ? lse[((size_t)b * H + h) * Sq + i] * LOG2E
                          : -INFINITY;
    } else {
      const int i = i0 + tid - BT;
      dl_s[tid - BT] = i < Sq ? delta[((size_t)b * H + h) * Sq + i] : 0.0f;
    }
    __syncthreads();
    mbar_wait(&full[s], (n / STAGES) & 1);
    const uint8_t* qt = Qs + s * L::A_BYTES;
    const uint8_t* dot = dOs + s * L::B_BYTES;

    // S^T = K q^T and dP^T = V do^T: rows are keys, columns q rows
    float st[32], dpt[32];
    wgmma_fence();
    product_nt<D>(st, Ks, qt);
    product_nt<DV>(dpt, Vs, dot);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T: st[4 c + 2 r + e] is key j0 + row0 + 8 r, q row
    // i0 + 8 c + 2 quad + e
    const bool mask = (j0 + BT > Sk) || (causal && i0 < j0 + BT - 1);
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * c + 2 * r + e, ii = 8 * c + 2 * quad + e;
          const float ls = lse_s[ii];
          bool live = ls > -INFINITY;
          if (mask) {
            const int j = j0 + row0 + 8 * r, i = i0 + ii;
            live = live && j < Sk && (!causal || i >= j);
          }
          const float p =
              live ? exp2f(__fsub_rn(__fmul_rn(st[x], scale_log2), ls))
                   : 0.0f;
          st[x] = p;
          dpt[x] = __fmul_rn(p, __fsub_rn(dpt[x], dl_s[ii]));
        }
    uint32_t pa[4][4], da[4][4];
    to_fragments(st, pa);
    to_fragments(dpt, da);

    // dV += P^T do, dK += dS^T q
    wgmma_fence();
    product_rn<DV>(dv_acc, pa, dot);
    product_rn<L::DP>(dk_acc, da, qt);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncthreads();   // every product on stage s and the row tile done
    const int nn = n + STAGES;
    if (tid == 0 && nn < n_items)
      load_pair<D, DV>(Qs + s * L::A_BYTES, &tq, dOs + s * L::B_BYTES, &tdo,
                       &full[s], kh * G + nn % G, i_start + (nn / G) * BT, b);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + row0 + 8 * r;
    if (j >= Sk) continue;
    const size_t at = ((size_t)b * Sk + j) * K + kh;
    store_rows<D>(dk_acc, dk + at * D, r, scale, quad);
    store_rows<DV>(dv_acc, dv + at * DV, r, 1.0f, quad);
  }
}

// dk, dv for the 64 keys of tile blockIdx.x, KV head blockIdx.y, batch
// blockIdx.z on two warpgroups (split_dkdv): the first computes P^T and
// holds dV, the second computes dS^T from the first's P^T and holds dK
template <int D, int DV>
__global__ void __launch_bounds__(2 * THREADS, 1)
    flash_attention_bwd_sm90_dkdv_split(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
        const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
        __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H, int K,
        float scale, float scale_log2, int causal) {
  using L = Smem<D, DV>;
  static_assert(split_dkdv<D, DV>(), "the split pass's pairs");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Ks = smem;
  uint8_t* Vs = smem + L::B_OFF;
  uint8_t* Qs = smem + L::C_OFF;
  uint8_t* dOs = smem + L::E_OFF;
  // P^T, fp32: value x of thread t of a warpgroup at x * THREADS + t
  float* p_s = reinterpret_cast<float*>(smem + L::P_OFF);
  float* lse_s = reinterpret_cast<float*>(smem + L::ROW_OFF);
  float* dl_s = lse_s + BT;
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = own + 1;

  const int j0 = blockIdx.x * BT, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int tid = threadIdx.x;
  const int i_start = causal ? j0 : 0;
  const int n_qt = i_start < Sq ? (Sq - i_start + BT - 1) / BT : 0;
  const int n_items = n_qt * G;   // (q tile, head of the group), heads inner

  if (tid == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_pair<D, DV>(Ks, &tk, Vs, &tv, own, kh, j0, b);
    for (int n = 0; n < STAGES && n < n_items; ++n)
      load_pair<D, DV>(Qs + n * L::A_BYTES, &tq, dOs + n * L::B_BYTES, &tdo,
                       &full[n], kh * G + n % G, i_start + (n / G) * BT, b);
  }

  // the warpgroup and the warp within it, broadcast so the compiler sees
  // them warp-uniform
  const int wg = __shfl_sync(FULL, tid / THREADS, 0);
  const int warp = __shfl_sync(FULL, (tid / 32) % 4, 0);
  const int t = tid % THREADS, lane = tid % 32, quad = lane % 4;
  const int row0 = warp * 16 + lane / 4;   // this thread's keys row0, +8
  const bool edge = j0 + BT > Sk;
  mbar_wait(own, 0);

  if (wg == 0) {
    // ------------------------------------ S^T, P^T; dV += bf16(P^T) do
    float dv_acc[DV / 2];
#pragma unroll
    for (int x = 0; x < DV / 2; ++x) dv_acc[x] = 0.0f;
    for (int n = 0; n < n_items; ++n) {
      const int s = n % STAGES;
      const int i0 = i_start + (n / G) * BT, h = kh * G + n % G;
      // the tile's lse (base 2); a row past Sq or with no key has lse -inf
      // and so p = 0
      if (t < BT) {
        const int i = i0 + t;
        lse_s[t] = i < Sq ? lse[((size_t)b * H + h) * Sq + i] * LOG2E
                          : -INFINITY;
      }
      bar_sync(1, THREADS);
      mbar_wait(&full[s], (n / STAGES) & 1);
      const uint8_t* qt = Qs + s * L::A_BYTES;
      const uint8_t* dot = dOs + s * L::B_BYTES;

      float st[32];
      wgmma_fence();
      product_nt<D>(st, Ks, qt);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);

      // st[4 c + 2 r + e] is key j0 + row0 + 8 r, q row i0 + 8 c + 2 quad
      // + e
      const bool mask = edge || (causal && i0 < j0 + BT - 1);
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * c + 2 * r + e, ii = 8 * c + 2 * quad + e;
            const float ls = lse_s[ii];
            bool live = ls > -INFINITY;
            if (mask) {
              const int j = j0 + row0 + 8 * r, i = i0 + ii;
              live = live && j < Sk && (!causal || i >= j);
            }
            st[x] = live ? exp2f(__fsub_rn(__fmul_rn(st[x], scale_log2), ls))
                         : 0.0f;
            p_s[x * THREADS + t] = st[x];
          }
      bar_arrive(2, 2 * THREADS);   // P^T is in shared memory
      uint32_t pa[4][4];
      to_fragments(st, pa);
      wgmma_fence();
      product_rn<DV>(dv_acc, pa, dot);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      // both warpgroups done with stage s, P^T and the rows
      bar_sync(3, 2 * THREADS);
      const int nn = n + STAGES;
      if (t == 0 && nn < n_items)
        load_pair<D, DV>(Qs + s * L::A_BYTES, &tq, dOs + s * L::B_BYTES,
                         &tdo, &full[s], kh * G + nn % G,
                         i_start + (nn / G) * BT, b);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = j0 + row0 + 8 * r;
      if (j >= Sk) continue;
      const size_t at = ((size_t)b * Sk + j) * K + kh;
      store_rows<DV>(dv_acc, dv + at * DV, r, 1.0f, quad);
    }
  } else {
    // ------------------------- dP^T; dS^T from P^T; dK += bf16(dS^T) q
    float dk_acc[L::DP / 2];
#pragma unroll
    for (int x = 0; x < L::DP / 2; ++x) dk_acc[x] = 0.0f;
    for (int n = 0; n < n_items; ++n) {
      const int s = n % STAGES;
      const int i0 = i_start + (n / G) * BT, h = kh * G + n % G;
      if (t < BT) {
        const int i = i0 + t;
        dl_s[t] = i < Sq ? delta[((size_t)b * H + h) * Sq + i] : 0.0f;
      }
      bar_sync(4, THREADS);
      mbar_wait(&full[s], (n / STAGES) & 1);
      const uint8_t* qt = Qs + s * L::A_BYTES;
      const uint8_t* dot = dOs + s * L::B_BYTES;

      float dpt[32];
      wgmma_fence();
      product_nt<DV>(dpt, Vs, dot);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dpt);

      bar_sync(2, 2 * THREADS);     // P^T written
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * c + 2 * r + e, ii = 8 * c + 2 * quad + e;
            dpt[x] = __fmul_rn(p_s[x * THREADS + t],
                               __fsub_rn(dpt[x], dl_s[ii]));
          }
      uint32_t da[4][4];
      to_fragments(dpt, da);
      wgmma_fence();
      product_rn<L::DP>(dk_acc, da, qt);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dk_acc);
      bar_sync(3, 2 * THREADS);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = j0 + row0 + 8 * r;
      if (j >= Sk) continue;
      const size_t at = ((size_t)b * Sk + j) * K + kh;
      store_rows<D>(dk_acc, dk + at * D, r, scale, quad);
    }
  }
}

// dq for the 64 rows of q tile (gridDim.x - 1 - blockIdx.x), query head
// blockIdx.y, batch blockIdx.z
template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_bwd_sm90_dq(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq,
    int Sk, int H, int K, float scale, float scale_log2, int causal) {
  using L = Smem<D, DV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint8_t* dOs = smem + L::B_OFF;
  uint8_t* Ks = smem + L::C_OFF;
  uint8_t* Vs = smem + L::E_OFF;
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = own + 1;

  // the longest causal rows first, so the short ones fill the tail
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int last_row = min(i0 + BT, Sq);
  const int kv_end = causal ? min(Sk, last_row) : Sk;
  const int n_tiles = (kv_end + BT - 1) / BT;

  if (tid == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_pair<D, DV>(Qs, &tq, dOs, &tdo, own, h, i0, b);
    for (int t = 0; t < STAGES && t < n_tiles; ++t)
      load_pair<D, DV>(Ks + t * L::A_BYTES, &tk, Vs + t * L::B_BYTES, &tv,
                       &full[t], kh, t * BT, b);
  }

  const int warp = __shfl_sync(FULL, tid / 32, 0);
  const int lane = tid % 32, quad = lane % 4;
  const int row0 = warp * 16 + lane / 4;   // this thread's rows row0, +8
  float ls[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + row0 + 8 * r;
    const size_t at = ((size_t)b * H + h) * Sq + i;
    ls[r] = i < Sq ? lse[at] * LOG2E : -INFINITY;
    dl[r] = i < Sq ? delta[at] : 0.0f;
  }
  float dq_acc[L::DP / 2];
#pragma unroll
  for (int x = 0; x < L::DP / 2; ++x) dq_acc[x] = 0.0f;

  mbar_wait(own, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES, j0 = t * BT;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint8_t* kt = Ks + s * L::A_BYTES;
    const uint8_t* vt = Vs + s * L::B_BYTES;

    // S = q K^T and dP = do V^T
    float sc[32], dp[32];
    wgmma_fence();
    product_nt<D>(sc, Qs, kt);
    product_nt<DV>(dp, dOs, vt);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // sc[4 c + 2 r + e] is row i0 + row0 + 8 r, key j0 + 8 c + 2 quad + e
    const bool mask = (j0 + BT > Sk) || (causal && j0 + BT - 1 > i0);
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * c + 2 * r + e;
          bool live = ls[r] > -INFINITY;
          if (mask) {
            const int j = j0 + 8 * c + 2 * quad + e, i = i0 + row0 + 8 * r;
            live = live && j < Sk && (!causal || i >= j);
          }
          const float p =
              live ? exp2f(__fsub_rn(__fmul_rn(sc[x], scale_log2), ls[r]))
                   : 0.0f;
          dp[x] = __fmul_rn(p, __fsub_rn(dp[x], dl[r]));
        }
    uint32_t da[4][4];
    to_fragments(dp, da);

    // dQ += dS K
    wgmma_fence();
    product_rn<L::DP>(dq_acc, da, kt);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq_acc);
    __syncthreads();   // every product on stage s done
    if (tid == 0 && t + STAGES < n_tiles)
      load_pair<D, DV>(Ks + s * L::A_BYTES, &tk, Vs + s * L::B_BYTES, &tv,
                       &full[s], kh, (t + STAGES) * BT, b);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + row0 + 8 * r;
    if (i >= Sq) continue;
    store_rows<D>(dq_acc, dq + (((size_t)b * Sq + i) * H + h) * D, r, scale,
                  quad);
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int Sq, int Sk, int H, int K,
           float scale, int causal, cudaStream_t stream) {
  const long long rows = (long long)B * Sq * H;
  const long long delta_blocks = (rows + 7) / 8;
  if (delta_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_bwd_sm90_delta_kernel<<<(unsigned)delta_blocks, 256, 0,
                                          stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), delta, Sq, H, DV, rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  CUtensorMap tq, tk, tv, tdo;
  int rc = encode(&tq, q, B, Sq, H, D, BT);
  if (rc == 0) rc = encode(&tk, k, B, Sk, K, D, BT);
  if (rc == 0) rc = encode(&tv, v, B, Sk, K, DV, BT);
  if (rc == 0) rc = encode(&tdo, dout, B, Sq, H, DV, BT);
  if (rc != 0) return rc;
  const int smem = Smem<D, DV>::BYTES;
  const float scale_log2 =
      static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  const dim3 kv_grid((Sk + BT - 1) / BT, K, B);
  __nv_bfloat16* dk_ = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* dv_ = static_cast<__nv_bfloat16*>(dv);
  if constexpr (split_dkdv<D, DV>()) {
    err = static_cast<int>(cudaFuncSetAttribute(
        flash_attention_bwd_sm90_dkdv_split<D, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (err) return err;
    flash_attention_bwd_sm90_dkdv_split<D, DV>
        <<<kv_grid, 2 * THREADS, smem, stream>>>(
            tq, tk, tv, tdo, lse, delta, dk_, dv_, Sq, Sk, H, K, scale,
            scale_log2, causal);
  } else {
    err = static_cast<int>(cudaFuncSetAttribute(
        flash_attention_bwd_sm90_dkdv<D, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (err) return err;
    flash_attention_bwd_sm90_dkdv<D, DV><<<kv_grid, THREADS, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, dk_, dv_, Sq, Sk, H, K, scale,
        scale_log2, causal);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = static_cast<int>(cudaFuncSetAttribute(
      flash_attention_bwd_sm90_dq<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err) return err;
  flash_attention_bwd_sm90_dq<D, DV>
      <<<dim3((Sq + BT - 1) / BT, H, B), THREADS, smem, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), Sq,
          Sk, H, K, scale, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bf16 q, k, v, o, do, dq, dk, dv; fp32 lse [B, H, Sq] from
// fog_flash_attention_sm90 and delta [B, H, Sq] scratch; (D, Dv) one of
// the seven pairs (kernels/flash_attention.py::SM90_PAIRS); causal 0 or
// 1.  Every pointer 16-byte aligned (the wrapper checks).
int fog_flash_attention_bwd_sm90(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int B, int Sq, int Sk,
                                 int H, int K, int D, int Dv, float scale,
                                 int causal, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || K < 1 || H % K != 0 ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (D == 64 && Dv == 64)
    return launch<64, 64>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, H,
                          K, scale, causal, s);
  if (D == 128 && Dv == 128)
    return launch<128, 128>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk,
                            H, K, scale, causal, s);
  if (D == 64 && Dv == 128)
    return launch<64, 128>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, H,
                           K, scale, causal, s);
  if (D == 128 && Dv == 64)
    return launch<128, 64>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, H,
                           K, scale, causal, s);
  if (D == 96 && Dv == 64)
    return launch<96, 64>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, H,
                          K, scale, causal, s);
  if (D == 192 && Dv == 128)
    return launch<192, 128>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk,
                            H, K, scale, causal, s);
  if (D == 256 && Dv == 256)
    return launch<256, 256>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk,
                            H, K, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
