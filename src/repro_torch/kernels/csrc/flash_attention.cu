// Causal or non-causal GQA/MQA attention with an online softmax for NVIDIA
// Hopper (sm_90a).
//
//   fog_flash_attention   replaces repro/kernels/flash_attention.py::_flash_kernel
//
// behind a plain C entry point that launches on the caller's stream and
// returns cudaGetLastError() (loaded with ctypes by
// repro_torch/kernels/_build.py, linked into the same library as the other
// kernels).  The wrapper (kernels/flash_attention.py) allocates the output;
// the kernel allocates nothing.
//
// What it computes, with q [B, Sq, H, D], k [B, Sk, K, D], v [B, Sk, K, Dv]
// in, all fp32 or all bf16, H % K == 0 and G = H / K query heads per KV
// head:
//
//   s[i, j]   = (q[b, i, h] . k[b, j, h / G]) * scale               fp32
//   live(i,j) = j < Sk and (not causal or i >= j)   (both counted from 0)
//   m, l      = running max and sum of exp(s - m) over the live j   fp32
//   acc       = sum_j round_v(exp(s[i, j] - m)) v[b, j, h / G]        fp32
//   out[b, i, h] = acc / max(l, 1e-30), in q's dtype
//
// where round_v rounds p to v's dtype before the product, and each KV tile
// rescales m, l and acc as the TPU kernel's loop does.  A score that is not
// live takes no part, by a branch: it never enters the max, and its p is 0
// (no exp(-inf - -inf)).  A row that sees no key keeps l = 0 and acc = 0
// and writes 0.
//
// The TPU kernel flattens (batch, KV head, group) into one grid axis over
// K/V repeated G times in HBM (jnp.repeat), holds a 512-row q block and
// the whole K/V stripe in VMEM, and needs Sq, Sk divisible by its blocks.
// Here one block of 256 threads owns (64-row q tile, query head, batch),
// reaches its KV head as h / G (K/V are never repeated in memory), and
// loops 64-key tiles up to the diagonal (the causal upper triangle is
// skipped as on the TPU).  Q, K, V and P tiles are staged in shared memory
// as fp32 (BQ (D+1) + BK (D+1) + BK Dv + BQ (BK+1) floats: 66,304 B at
// D = Dv = 64, 213,760 B at 256, so the launch opts into more than 48 KB).
// Each thread holds 4 rows x 4 columns of the score tile and 4 rows x NC
// columns of acc (NC = 4, 8 or 16 by Dv); a row's max and sum are
// butterfly shuffles over the 16 threads that share it, so all 16 hold
// bit-equal m and l.  Every edge is masked: any Sq, Sk >= 1, any
// D, Dv <= 256.
//
// What bounds it: at the tinyllama prefill shape (B=4, S=2048, H=32, K=4,
// D = Dv = 64, causal, bf16) it must move 75.5 MB (q, k, v and the output
// once), 0.023 ms at 3.35 TB/s, and do 68.7 GFLOP over the 2,098,176
// causal pairs of each (batch, head), 0.069 ms on the bf16 tensor cores,
// so operations bound it.  This first kernel does plain fp32 FMAs on CUDA
// cores (explicit __fmaf_rn: the build passes -fmad=false; expf, not
// __expf) from shared-memory tiles, ~0.5 shared loads per FMA, so it is
// bound by those FMAs and loads: at least 1.03 ms at 67 TFLOP/s, several
// ms in practice (PERF.md).  wgmma on bf16 tiles fed by TMA is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows of one block
constexpr int BK = 64;          // keys of one KV tile
constexpr int MAX_HEAD = 256;   // the largest D and Dv
constexpr int THREADS = 256;    // 16 x 16: rows ty*4 + r, columns tx + 16*c
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
// p rounded to v's dtype (the TPU kernel's p.astype(v.dtype))
__device__ __forceinline__ float in_dtype(float p, const float*) { return p; }
__device__ __forceinline__ float in_dtype(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// max / sum over the 16 threads of a half-warp that share a row; the xor
// butterfly leaves the bit-equal result in all 16
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

size_t smem_bytes(int D, int Dv) {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) +
                          (size_t)BK * Dv + (size_t)BQ * (BK + 1));
}

// out[b, i, h, :] for the 64 rows i of q tile (gridDim.x - 1 - blockIdx.x),
// query head blockIdx.y, batch blockIdx.z.  NC * 16 >= Dv.
template <class T, int NC>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int Sq, int Sk, int H, int K, int D, int Dv,
    float scale, int causal) {
  extern __shared__ float smem[];
  const int ld_qk = D + 1, ld_p = BK + 1;
  float* Qs = smem;                 // [BQ][D + 1]
  float* Ks = Qs + BQ * ld_qk;      // [BK][D + 1]
  float* Vs = Ks + BK * ld_qk;      // [BK][Dv]
  float* Ps = Vs + BK * Dv;         // [BQ][BK + 1]

  // the longest causal rows first, so the short ones fill the tail
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D, i = i0 + r;
    Qs[r * ld_qk + d] =
        i < Sq ? ld(q, (((size_t)b * Sq + i) * H + h) * D + d) : 0.0f;
  }
  const int i_last = min(i0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, i_last + 1) : Sk;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;
  }

  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    __syncthreads();   // Qs written; the last tile's Ks, Vs, Ps read
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int jj = idx / D, d = idx % D, j = j0 + jj;
      Ks[jj * ld_qk + d] =
          j < Sk ? ld(k, (((size_t)b * Sk + j) * K + kh) * D + d) : 0.0f;
    }
    for (int idx = tid; idx < BK * Dv; idx += THREADS) {
      const int jj = idx / Dv, e = idx % Dv, j = j0 + jj;
      Vs[jj * Dv + e] =
          j < Sk ? ld(v, (((size_t)b * Sk + j) * K + kh) * Dv + e) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Qs[(ty * 4 + r) * ld_qk + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kk[c] = Ks[(tx + 16 * c) * ld_qk + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = __fmaf_rn(a[r], kk[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      bool live[4];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tx + 16 * c;
        live[c] = j < Sk && (!causal || i >= j);
        s[r][c] = __fmul_rn(s[r][c], scale);
        if (live[c]) mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      // m_new is -inf only while the row has seen no live key
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      const float corr =
          isfinite(m[r]) ? expf(__fsub_rn(m[r], m_safe)) : 0.0f;
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = live[c] ? expf(__fsub_rn(s[r][c], m_safe)) : 0.0f;
        sum = __fadd_rn(sum, p);
        Ps[(ty * 4 + r) * ld_p + tx + 16 * c] = in_dtype(p, v);
      }
      l[r] = __fadd_rn(__fmul_rn(l[r], corr), row_sum(sum));
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = __fmul_rn(acc[r][c], corr);
    }
    __syncthreads();

    // acc += P . V over this tile's keys below kv_end (the rest have p = 0)
    const int jn = min(BK, kv_end - j0);
    for (int jj = 0; jj < jn; ++jj) {
      float p[4], vv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = Ps[(ty * 4 + r) * ld_p + jj];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int e = tx + 16 * c;
        vv[c] = e < Dv ? Vs[jj * Dv + e] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[r][c] = __fmaf_rn(p[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int e = tx + 16 * c;
      if (e < Dv)
        st(out, (((size_t)b * Sq + i) * H + h) * Dv + e,
           __fdiv_rn(acc[r][c], denom));
    }
  }
}

template <class T, int NC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int K, int D, int Dv, float scale,
           int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, Dv);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, NC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, K, D, Dv,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_dv(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int H, int K, int D, int Dv, float scale,
              int causal, cudaStream_t s) {
  if (Dv <= 64)
    return launch<T, 4>(q, k, v, out, B, Sq, Sk, H, K, D, Dv, scale, causal,
                        s);
  if (Dv <= 128)
    return launch<T, 8>(q, k, v, out, B, Sq, Sk, H, K, D, Dv, scale, causal,
                        s);
  return launch<T, 16>(q, k, v, out, B, Sq, Sk, H, K, D, Dv, scale, causal,
                       s);
}

}  // namespace

extern "C" {

// dtype 0: q, k, v and out fp32; 1: all bf16.  causal: 0 or 1.
int fog_flash_attention(int dtype, const void* q, const void* k,
                        const void* v, void* out, int B, int Sq, int Sk,
                        int H, int K, int D, int Dv, float scale, int causal,
                        void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || K < 1 || H % K != 0 || D < 1 ||
      Dv < 1 || D > MAX_HEAD || Dv > MAX_HEAD || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dv<float>(q, k, v, out, B, Sq, Sk, H, K, D, Dv, scale,
                            causal, s);
  if (dtype == 1)
    return launch_dv<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, K, D, Dv,
                                    scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
