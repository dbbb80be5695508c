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

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int BQ = 128;              // q rows of one block
constexpr int STAGES = 2;            // K/V tiles in flight
constexpr int CONSUMER_THREADS = 256;
constexpr int THREADS = CONSUMER_THREADS + 32;

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
