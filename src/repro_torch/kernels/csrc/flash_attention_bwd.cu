// The backward of causal or non-causal GQA/MQA attention for NVIDIA Hopper
// (sm_90a), in fp32 on CUDA cores, from fp32 or bf16 inputs.
//
//   fog_flash_attention_bwd   the gradient of fog_flash_attention's SIMT
//                             forward (flash_attention.cu); replaces no TPU
//                             kernel: the JAX package differentiates its
//                             blocked jnp attention with jax.grad
//
// behind a plain C entry point that launches three kernels in order on the
// caller's stream and returns cudaGetLastError() (loaded with ctypes by
// repro_torch/kernels/_build.py).  The wrapper (kernels/flash_attention.py)
// allocates delta and the three outputs; the kernels allocate nothing.
//
// With q [B, Sq, H, D], k [B, Sk, K, D], v [B, Sk, K, Dv], the forward's
// output o and its gradient do [B, Sq, H, Dv], and the forward's lse
// [B, H, Sq] (m + log l per row), G = H / K; q, k, v, o, do and the
// outputs dq, dk, dv all fp32 or all bf16 (the kernels are templated on
// that type: loads convert to fp32, every sum is fp32, stores round to
// the inputs' type), lse and delta fp32:
//
//   s[i, j]  = (q[b, i, h] . k[b, j, h / G]) * scale  (the forward's order)
//   p[i, j]  = exp(s[i, j] - lse[i]) where (i, j) is live, else 0; a row
//              whose lse is -inf (it saw no key) has p = 0 everywhere
//   delta[i] = sum_e do[i, e] o[i, e]                     delta_kernel
//   dp[i, j] = do[i] . v[j]
//   ds[i, j] = p[i, j] (dp[i, j] - delta[i])
//   dv[j]    = sum over the G heads and i of p[i, j] do[i]     dkdv_kernel
//   dk[j]    = scale * sum over the G heads and i of ds[i, j] q[i]
//   dq[i]    = scale * sum_j ds[i, j] k[j]                      dq_kernel
//
// live(i, j) = j < Sk and (not causal or i >= j), both counted from 0 (the
// forward's top-left diagonal).
//
// No atomics, so every output is written once by one thread and the
// result is the same bit for bit from run to run.  dkdv_kernel: one block
// of 256 threads per (tile of 32 keys, KV head, batch) loops over the q
// tiles that can see its keys (causal: from the diagonal down) and the G
// query heads of its KV head, keeping dK and dV in registers (2 keys x NC
// columns a thread) and writing them once.  dq_kernel: one block per
// (tile of BQT q rows, query head, batch) loops over the key tiles up to
// the diagonal with dQ in registers.  Each recomputes s and dp for its
// pairs (five products in all, s and dp twice).  Tiles are staged in
// shared memory as fp32 with rows padded by one float; the tile sizes
// follow the head size alone (kernels/flash_attention.py::bwd_tiles):
// max(D, Dv) <= 64: 32 keys / 64 q rows, NC = 4; <= 128: 32 / 64, NC = 8;
// <= 256: 32 / 32, NC = 16, so that at D = Dv = 256 a block's K, V, q, do
// and two score tiles take 214,528 B, under the 227 KB a block may opt
// into (64 rows there would take over 256 KB).  dK and dV take 32-key
// tiles at every head size, for twice the blocks of 64-key tiles (256 at
// the training shape, for 132 SMs): measured, that moved dkdv_kernel only
// from 0.756 to 0.739 ms (PERF.md row 6b), so the loads from shared memory
// (about one per FMA), not the grid, bound it.
//
// What bounds it: at the training shape (q [8, 256, 32, 64], k/v [8, 256,
// 4, 64], causal) the function moves ~76 MB (q, k, v, o, do read, dq, dk,
// dv written; 0.023 ms at 3.35 TB/s) and does 5.4 GFLOP over the causal
// pairs (0.080 ms at 67 TFLOP/s fp32), so operations bound it.  This design
// does 7 products (s and dp twice) as fp32 FMAs from shared memory, about
// one shared load per FMA, on 256 dkdv blocks at that shape (one per key
// tile, KV head and batch), so it runs well above the bound (PERF.md row
// 6b).  bf16 at the head sizes the tensor cores take (D, Dv in {64, 128})
// runs flash_attention_bwd_sm90.cu instead; this kernel takes bf16 at the
// others (MLA's 96 / 64 and 192 / 128, gemma's 256, small test widths).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// an input element as fp32, and an fp32 result stored in the inputs' type
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int THREADS = 256;   // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int MAX_HEAD = 256;
constexpr int TILE = 64;       // the loop tile: q rows (dkdv), keys (dq)
constexpr unsigned FULL = 0xffffffffu;

// floats of shared memory of one block of either kernel with R rows a
// thread (16 R rows of its own tile) against the 64-row loop tile
size_t smem_floats(int R, int D, int Dv) {
  const size_t own = 16 * R, loop = TILE;
  return own * (D + 1) + own * (Dv + 1) + loop * (D + 1) + loop * (Dv + 1) +
         2 * own * (TILE + 1) + 2 * loop;
}

// delta[b, h, i] = sum_e do[b, i, h, e] o[b, i, h, e]: one warp per row
template <class T>
__global__ void __launch_bounds__(THREADS) flash_attention_bwd_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ delta, int Sq, int H, int Dv, long long rows) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + row * Dv;
  const T* drow = dout + row * Dv;
  float sum = 0.0f;
  for (int e = lane; e < Dv; e += 32)
    sum = __fmaf_rn(ld(drow + e), ld(orow + e), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, off));
  if (lane == 0) {
    // row = (b * Sq + i) * H + h
    const long long h = row % H, bi = row / H, i = bi % Sq, b = bi / Sq;
    delta[(b * H + h) * Sq + i] = sum;
  }
}

// dk, dv for the 16 RK keys of tile blockIdx.x, KV head blockIdx.y, batch
// blockIdx.z.  NC * 16 >= max(D, Dv).
template <class T, int RK, int NC>
__global__ void __launch_bounds__(THREADS) flash_attention_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
    int K, int D, int Dv, float scale, int causal) {
  constexpr int BKT = 16 * RK;
  extern __shared__ float smem[];
  const int ldd = D + 1, ldv = Dv + 1, ldp = TILE + 1;
  float* Ks = smem;                 // [BKT][D + 1]
  float* Vs = Ks + BKT * ldd;       // [BKT][Dv + 1]
  float* Qs = Vs + BKT * ldv;       // [TILE][D + 1]
  float* dOs = Qs + TILE * ldd;     // [TILE][Dv + 1]
  float* Ps = dOs + TILE * ldv;     // [BKT][TILE + 1]  p
  float* dSs = Ps + BKT * ldp;      // [BKT][TILE + 1]  ds
  float* lse_s = dSs + BKT * ldp;   // [TILE]
  float* dl_s = lse_s + TILE;       // [TILE]

  const int j0 = blockIdx.x * BKT, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  for (int idx = tid; idx < BKT * D; idx += THREADS) {
    const int jj = idx / D, d = idx % D, j = j0 + jj;
    Ks[jj * ldd + d] =
        j < Sk ? ld(k + (((size_t)b * Sk + j) * K + kh) * D + d) : 0.0f;
  }
  for (int idx = tid; idx < BKT * Dv; idx += THREADS) {
    const int jj = idx / Dv, e = idx % Dv, j = j0 + jj;
    Vs[jj * ldv + e] =
        j < Sk ? ld(v + (((size_t)b * Sk + j) * K + kh) * Dv + e) : 0.0f;
  }

  float dk_acc[RK][NC], dv_acc[RK][NC];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.0f;

  // causal: row i sees key j only for i >= j, so the q tiles start at the
  // one holding row j0
  const int i_start = causal ? (j0 / TILE) * TILE : 0;
  for (int i0 = i_start; i0 < Sq; i0 += TILE) {
    for (int g = 0; g < G; ++g) {
      const int h = kh * G + g;
      __syncthreads();   // Ks, Vs written; the last tile's reads done
      for (int idx = tid; idx < TILE * D; idx += THREADS) {
        const int ii = idx / D, d = idx % D, i = i0 + ii;
        Qs[ii * ldd + d] =
            i < Sq ? ld(q + (((size_t)b * Sq + i) * H + h) * D + d) : 0.0f;
      }
      for (int idx = tid; idx < TILE * Dv; idx += THREADS) {
        const int ii = idx / Dv, e = idx % Dv, i = i0 + ii;
        dOs[ii * ldv + e] =
            i < Sq ? ld(dout + (((size_t)b * Sq + i) * H + h) * Dv + e) : 0.0f;
      }
      for (int ii = tid; ii < TILE; ii += THREADS) {
        const int i = i0 + ii;
        const size_t at = ((size_t)b * H + h) * Sq + i;
        lse_s[ii] = i < Sq ? lse[at] : -INFINITY;
        dl_s[ii] = i < Sq ? delta[at] : 0.0f;
      }
      __syncthreads();

      // s and dp for keys ty * RK + r, rows tx + 16 c
      float s[RK][4], dp[RK][4];
#pragma unroll
      for (int r = 0; r < RK; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[RK], bq[4];
#pragma unroll
        for (int r = 0; r < RK; ++r) a[r] = Ks[(ty * RK + r) * ldd + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) bq[c] = Qs[(tx + 16 * c) * ldd + d];
#pragma unroll
        for (int r = 0; r < RK; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = __fmaf_rn(a[r], bq[c], s[r][c]);
      }
#pragma unroll 4
      for (int e = 0; e < Dv; ++e) {
        float a[RK], bo[4];
#pragma unroll
        for (int r = 0; r < RK; ++r) a[r] = Vs[(ty * RK + r) * ldv + e];
#pragma unroll
        for (int c = 0; c < 4; ++c) bo[c] = dOs[(tx + 16 * c) * ldv + e];
#pragma unroll
        for (int r = 0; r < RK; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            dp[r][c] = __fmaf_rn(a[r], bo[c], dp[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RK; ++r) {
        const int jj = ty * RK + r, j = j0 + jj;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ii = tx + 16 * c, i = i0 + ii;
          const float ls = lse_s[ii];
          const bool live = j < Sk && i < Sq && (!causal || i >= j) &&
                            ls > -INFINITY;
          const float p =
              live ? expf(__fsub_rn(__fmul_rn(s[r][c], scale), ls)) : 0.0f;
          Ps[jj * ldp + ii] = p;
          dSs[jj * ldp + ii] = __fmul_rn(p, __fsub_rn(dp[r][c], dl_s[ii]));
        }
      }
      __syncthreads();

      // dv += p^T do, dk += ds^T q (scaled at the end) over the tile's rows
      const int in = min(TILE, Sq - i0);
      for (int ii = 0; ii < in; ++ii) {
        float p[RK], ds[RK];
#pragma unroll
        for (int r = 0; r < RK; ++r) {
          p[r] = Ps[(ty * RK + r) * ldp + ii];
          ds[r] = dSs[(ty * RK + r) * ldp + ii];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int e = tx + 16 * c;
          const float o = e < Dv ? dOs[ii * ldv + e] : 0.0f;
          const float qq = e < D ? Qs[ii * ldd + e] : 0.0f;
#pragma unroll
          for (int r = 0; r < RK; ++r) {
            dv_acc[r][c] = __fmaf_rn(p[r], o, dv_acc[r][c]);
            dk_acc[r][c] = __fmaf_rn(ds[r], qq, dk_acc[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int j = j0 + ty * RK + r;
    if (j >= Sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int e = tx + 16 * c;
      if (e < D)
        st(dk + (((size_t)b * Sk + j) * K + kh) * D + e,
           __fmul_rn(dk_acc[r][c], scale));
      if (e < Dv)
        st(dv + (((size_t)b * Sk + j) * K + kh) * Dv + e, dv_acc[r][c]);
    }
  }
}

// dq for the 16 RQ rows of q tile blockIdx.x, query head blockIdx.y, batch
// blockIdx.z.  NC * 16 >= max(D, Dv).
template <class T, int RQ, int NC>
__global__ void __launch_bounds__(THREADS) flash_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int Sq, int Sk, int H, int K, int D, int Dv,
    float scale, int causal) {
  constexpr int BQT = 16 * RQ;
  extern __shared__ float smem[];
  const int ldd = D + 1, ldv = Dv + 1, lds = TILE + 1;
  float* Qs = smem;                 // [BQT][D + 1]
  float* dOs = Qs + BQT * ldd;      // [BQT][Dv + 1]
  float* Ks = dOs + BQT * ldv;      // [TILE][D + 1]
  float* Vs = Ks + TILE * ldd;      // [TILE][Dv + 1]
  float* dSs = Vs + TILE * ldv;     // [BQT][TILE + 1]
  float* lse_s = dSs + 2 * BQT * lds;   // [BQT] (past a second score tile,
  float* dl_s = lse_s + TILE;           // the layout smem_floats counts)

  // the longest causal rows first, so the short ones fill the tail
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  for (int idx = tid; idx < BQT * D; idx += THREADS) {
    const int ii = idx / D, d = idx % D, i = i0 + ii;
    Qs[ii * ldd + d] =
        i < Sq ? ld(q + (((size_t)b * Sq + i) * H + h) * D + d) : 0.0f;
  }
  for (int idx = tid; idx < BQT * Dv; idx += THREADS) {
    const int ii = idx / Dv, e = idx % Dv, i = i0 + ii;
    dOs[ii * ldv + e] =
        i < Sq ? ld(dout + (((size_t)b * Sq + i) * H + h) * Dv + e) : 0.0f;
  }
  for (int ii = tid; ii < BQT; ii += THREADS) {
    const int i = i0 + ii;
    const size_t at = ((size_t)b * H + h) * Sq + i;
    lse_s[ii] = i < Sq ? lse[at] : -INFINITY;
    dl_s[ii] = i < Sq ? delta[at] : 0.0f;
  }
  const int i_last = min(i0 + BQT, Sq) - 1;
  const int kv_end = causal ? min(Sk, i_last + 1) : Sk;

  float dq_acc[RQ][NC];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[r][c] = 0.0f;

  for (int j0 = 0; j0 < kv_end; j0 += TILE) {
    __syncthreads();   // Qs, dOs written; the last tile's reads done
    for (int idx = tid; idx < TILE * D; idx += THREADS) {
      const int jj = idx / D, d = idx % D, j = j0 + jj;
      Ks[jj * ldd + d] =
          j < Sk ? ld(k + (((size_t)b * Sk + j) * K + kh) * D + d) : 0.0f;
    }
    for (int idx = tid; idx < TILE * Dv; idx += THREADS) {
      const int jj = idx / Dv, e = idx % Dv, j = j0 + jj;
      Vs[jj * ldv + e] =
          j < Sk ? ld(v + (((size_t)b * Sk + j) * K + kh) * Dv + e) : 0.0f;
    }
    __syncthreads();

    // s and dp for rows ty * RQ + r, keys tx + 16 c
    float s[RQ][4], dp[RQ][4];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RQ], bk[4];
#pragma unroll
      for (int r = 0; r < RQ; ++r) a[r] = Qs[(ty * RQ + r) * ldd + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) bk[c] = Ks[(tx + 16 * c) * ldd + d];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = __fmaf_rn(a[r], bk[c], s[r][c]);
    }
#pragma unroll 4
    for (int e = 0; e < Dv; ++e) {
      float a[RQ], bv[4];
#pragma unroll
      for (int r = 0; r < RQ; ++r) a[r] = dOs[(ty * RQ + r) * ldv + e];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = Vs[(tx + 16 * c) * ldv + e];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dp[r][c] = __fmaf_rn(a[r], bv[c], dp[r][c]);
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int ii = ty * RQ + r, i = i0 + ii;
      const float ls = lse_s[ii];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jj = tx + 16 * c, j = j0 + jj;
        const bool live = j < Sk && i < Sq && (!causal || i >= j) &&
                          ls > -INFINITY;
        const float p =
            live ? expf(__fsub_rn(__fmul_rn(s[r][c], scale), ls)) : 0.0f;
        dSs[ii * lds + jj] = __fmul_rn(p, __fsub_rn(dp[r][c], dl_s[ii]));
      }
    }
    __syncthreads();

    // dq += ds k (scaled at the end) over this tile's keys below kv_end
    const int jn = min(TILE, kv_end - j0);
    for (int jj = 0; jj < jn; ++jj) {
      float ds[RQ], kk[NC];
#pragma unroll
      for (int r = 0; r < RQ; ++r) ds[r] = dSs[(ty * RQ + r) * lds + jj];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        kk[c] = d < D ? Ks[jj * ldd + d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          dq_acc[r][c] = __fmaf_rn(ds[r], kk[c], dq_acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int i = i0 + ty * RQ + r;
    if (i >= Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D)
        st(dq + (((size_t)b * Sq + i) * H + h) * D + d,
           __fmul_rn(dq_acc[r][c], scale));
    }
  }
}

template <class Kernel>
int opt_in(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

// RK keys a thread in dkdv_kernel (16 RK a block), RQ rows in dq_kernel
template <class T, int RK, int RQ, int NC>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout,
           const float* lse, float* delta, T* dq, T* dk, T* dv, int B,
           int Sq, int Sk, int H, int K, int D, int Dv, float scale,
           int causal, cudaStream_t stream) {
  const long long rows = (long long)B * Sq * H;
  const long long delta_blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (delta_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_bwd_delta_kernel<T><<<(unsigned)delta_blocks, THREADS, 0,
                                        stream>>>(o, dout, delta, Sq, H, Dv,
                                                  rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  const size_t smem_k = sizeof(float) * smem_floats(RK, D, Dv);
  err = opt_in(flash_attention_bwd_dkdv_kernel<T, RK, NC>, smem_k);
  if (err) return err;
  const dim3 kgrid((Sk + 16 * RK - 1) / (16 * RK), K, B);
  flash_attention_bwd_dkdv_kernel<T, RK, NC><<<kgrid, THREADS, smem_k,
                                               stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Sk, H, K, D, Dv, scale, causal);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  const size_t smem_q = sizeof(float) * smem_floats(RQ, D, Dv);
  err = opt_in(flash_attention_bwd_dq_kernel<T, RQ, NC>, smem_q);
  if (err) return err;
  const dim3 qgrid((Sq + 16 * RQ - 1) / (16 * RQ), H, B);
  flash_attention_bwd_dq_kernel<T, RQ, NC><<<qgrid, THREADS, smem_q,
                                             stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, H, K, D, Dv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// the tiles by head size (kernels/flash_attention.py::bwd_tiles)
template <class T>
int launch_by_head(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int H, int K, int D, int Dv, float scale,
                   int causal, cudaStream_t s) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* to = static_cast<const T*>(o);
  const T* td = static_cast<const T*>(dout);
  T* tdq = static_cast<T*>(dq);
  T* tdk = static_cast<T*>(dk);
  T* tdv = static_cast<T*>(dv);
  const int head = D > Dv ? D : Dv;
  if (head <= 64)
    return launch<T, 2, 4, 4>(tq, tk, tv, to, td, lse, delta, tdq, tdk, tdv,
                              B, Sq, Sk, H, K, D, Dv, scale, causal, s);
  if (head <= 128)
    return launch<T, 2, 4, 8>(tq, tk, tv, to, td, lse, delta, tdq, tdk, tdv,
                              B, Sq, Sk, H, K, D, Dv, scale, causal, s);
  return launch<T, 2, 2, 16>(tq, tk, tv, to, td, lse, delta, tdq, tdk, tdv,
                             B, Sq, Sk, H, K, D, Dv, scale, causal, s);
}

}  // namespace

extern "C" {

// dtype 0: fp32, 1: bf16 for q, k, v, o, do, dq, dk, dv; lse [B, H, Sq]
// from fog_flash_attention and delta [B, H, Sq] scratch, fp32 either way.
// causal: 0 or 1.
int fog_flash_attention_bwd(int dtype, const void* q, const void* k,
                            const void* v, const void* o, const void* dout,
                            const void* lse, void* delta, void* dq, void* dk,
                            void* dv, int B, int Sq, int Sk, int H, int K,
                            int D, int Dv, float scale, int causal,
                            void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || K < 1 || H % K != 0 || D < 1 ||
      Dv < 1 || D > MAX_HEAD || Dv > MAX_HEAD || B > 65535 || H > 65535 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fl = static_cast<const float*>(lse);
  float* fdl = static_cast<float*>(delta);
  if (dtype == 0)
    return launch_by_head<float>(q, k, v, o, dout, fl, fdl, dq, dk, dv, B,
                                 Sq, Sk, H, K, D, Dv, scale, causal, s);
  return launch_by_head<__nv_bfloat16>(q, k, v, o, dout, fl, fdl, dq, dk, dv,
                                       B, Sq, Sk, H, K, D, Dv, scale, causal,
                                       s);
}

}  // extern "C"
