// The Mamba-2 SSD intra-chunk block for NVIDIA Hopper (sm_90a).
//
//   fog_ssd_chunk   replaces repro/kernels/ssd_chunk.py::_ssd_chunk_kernel
//
// behind a plain C entry point that launches on the caller's stream and
// returns cudaGetLastError() (loaded with ctypes by
// repro_torch/kernels/_build.py, linked into the same library as the other
// kernels).  The wrapper (kernels/ssd_chunk.py) allocates the outputs and
// the fp32 scores scratch; the kernels allocate nothing.
//
// What it computes, per chunk bc = (batch, chunk) and head h, with
// x [BC, Q, H, P], a [BC, H, Q], B/C [BC, Q, N] in, all fp32 or all bf16:
//
//   scores[i, j] = sum_n C[i, n] B[j, n]                      (shared by heads)
//   cum          = cumsum(a[h])                                     [Q]
//   y[i, h, p]   = sum_{j <= i} scores[i, j] exp(cum_i - cum_j) x[j, h, p]
//   st[h, p, n]  = sum_j B[j, n] exp(cum_{Q-1} - cum_j) x[j, h, p]
//
// fp32 inside, y [BC, Q, H, P] and st [BC, H, P, N] written in x's dtype.
//
// The TPU kernel holds one whole (batch, chunk) in VMEM (x alone is 5.2 MB
// at Q=256, H=80, P=64) and unrolls every head over full [Q, Q] tiles.  A
// Hopper block has 227 KB, and the [Q, Q] fp32 tile alone is 256 KB at
// Q=256, so the work is split three ways, one launch each:
//
//   1. ssd_chunk_scores_kernel: C B^T once per chunk into an fp32 scratch
//      [BC, Q, Q] (8 MB at the serving shape B=4, nc=8), only the 64 x 64
//      tiles on or below the diagonal.  Recomputing it in every head's
//      block would cost 80x its 2 Q^2 N operations (+21 GFLOP on CUDA
//      cores at the serving shape); the scratch stays in the 50 MB L2 and
//      each (head, row tile) block reads its rows of it.
//   2. ssd_chunk_y_kernel: one block per (64-row tile of i, head, chunk);
//      it loops over the 64-column tiles of j up to the diagonal, builds
//      the weight tile scores * exp(cum_i - cum_j) in shared memory and
//      multiplies it into the x tile.  Above the diagonal cum_i - cum_j > 0
//      can overflow exp, so those entries are 0 by a branch, never by a
//      0/1 multiply (inf * 0 = NaN).
//   3. ssd_chunk_state_kernel: one block per (64 x 128 tile of [P, N],
//      head, chunk), summing over j in steps of 32.
//
// Each block first scans its head's a into an fp32 cumsum in shared memory
// (so Q <= 256, the ssm_chunk of every config; the wrapper refuses more).
// Any 1 <= Q <= 256 works: every tile masks its ragged edge.
//
// What bounds it: at the serving shape it must move ~215 MB (x, y, states,
// a, B, C once each), 0.064 ms at 3.35 TB/s, and do ~32.7 GFLOP, 0.033 ms
// on the bf16 tensor cores or 0.49 ms at 67 TFLOP/s fp32 on CUDA cores.
// This first kernel does plain fp32 FMAs on CUDA cores (explicit
// __fmaf_rn: the build passes -fmad=false), 4 x 4 or 4 x 8 outputs per
// thread from shared-memory tiles, so it is bound by those operations
// and their shared-memory loads, not by bytes: ~1.6 ms on the device at
// the serving shape on an H100 80GB HBM3 at 700 W, 25x the bytes bound
// (PERF.md).  wgmma on bf16 tiles fed by TMA is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_Q = 256;    // the cumsum of one head lives in shared memory
constexpr int TILE = 64;      // rows i, columns j and p of one tile
constexpr int KC = 32;        // reduction step over n (scores) and j (states)
constexpr int NT = 128;       // columns n of one state tile
constexpr int THREADS = 256;  // 16 x 16: rows ty*4 + r, columns tx + 16*s

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Inclusive fp32 prefix sum of a[0:Q] into cum[0:Q]: warp 0 scans 32
// entries at a time with shuffles and carries the running total.
template <class T>
__device__ void chunk_cumsum(const T* __restrict__ a, int Q, float* cum) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float carry = 0.0f;
    for (int base = 0; base < Q; base += 32) {
      const int i = base + lane;
      float v = i < Q ? ld(a, i) : 0.0f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v = __fadd_rn(v, n);
      }
      v = __fadd_rn(v, carry);
      if (i < Q) cum[i] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
}

// scores[bc, i, j] = C[bc, i, :] . B[bc, j, :] for the tiles with tj <= ti.
template <class T>
__global__ void __launch_bounds__(THREADS) ssd_chunk_scores_kernel(
    const T* __restrict__ Bm, const T* __restrict__ Cm,
    float* __restrict__ scores, int Q, int N, int n_tiles) {
  const int ti = blockIdx.x / n_tiles, tj = blockIdx.x % n_tiles;
  if (tj > ti) return;
  const int bc = blockIdx.y;
  const int i0 = ti * TILE, j0 = tj * TILE;
  __shared__ float Cs[KC][TILE + 1];
  __shared__ float Bs[KC][TILE + 1];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* C = Cm + (size_t)bc * Q * N;
  const T* B = Bm + (size_t)bc * Q * N;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += KC) {
    for (int idx = tid; idx < TILE * KC; idx += THREADS) {
      const int r = idx / KC, k = idx % KC, n = n0 + k;
      const int i = i0 + r, j = j0 + r;
      Cs[k][r] = (i < Q && n < N) ? ld(C, (size_t)i * N + n) : 0.0f;
      Bs[k][r] = (j < Q && n < N) ? ld(B, (size_t)j * N + n) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float c[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) c[r] = Cs[k][ty * 4 + r];
#pragma unroll
      for (int s = 0; s < 4; ++s) b[s] = Bs[k][tx + 16 * s];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = __fmaf_rn(c[r], b[s], acc[r][s]);
    }
    __syncthreads();
  }
  float* S = scores + (size_t)bc * Q * Q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = j0 + tx + 16 * s;
      if (i < Q && j <= i) S[(size_t)i * Q + j] = acc[r][s];
    }
  }
}

// y[bc, i, h, :] for the 64 rows i of blockIdx.x, head blockIdx.y.
template <class T>
__global__ void __launch_bounds__(THREADS) ssd_chunk_y_kernel(
    const T* __restrict__ x, const T* __restrict__ a,
    const float* __restrict__ scores, T* __restrict__ y, int Q, int H,
    int P) {
  const int i0 = blockIdx.x * TILE, h = blockIdx.y, bc = blockIdx.z;
  __shared__ float cum[MAX_Q];
  __shared__ float Ws[TILE][TILE + 1];   // [i][j] weights
  __shared__ float Xs[TILE][TILE + 1];   // [j][p]
  chunk_cumsum(a + ((size_t)bc * H + h) * Q, Q, cum);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* S = scores + (size_t)bc * Q * Q;
  const int i_end = min(i0 + TILE, Q);
  for (int p0 = 0; p0 < P; p0 += TILE) {
    float acc[4][4] = {};
    for (int j0 = 0; j0 < i_end; j0 += TILE) {
      for (int idx = tid; idx < TILE * TILE; idx += THREADS) {
        const int r = idx / TILE, k = idx % TILE;
        const int i = i0 + r, j = j0 + k;
        float w = 0.0f;
        if (i < Q && j <= i)
          w = __fmul_rn(S[(size_t)i * Q + j], expf(__fsub_rn(cum[i], cum[j])));
        Ws[r][k] = w;
        const int jr = j0 + r, p = p0 + k;
        Xs[r][k] = (jr < Q && p < P)
                       ? ld(x, (((size_t)bc * Q + jr) * H + h) * P + p)
                       : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < TILE; ++k) {
        float w[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) w[r] = Ws[ty * 4 + r][k];
#pragma unroll
        for (int s = 0; s < 4; ++s) xv[s] = Xs[k][tx + 16 * s];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            acc[r][s] = __fmaf_rn(w[r], xv[s], acc[r][s]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int p = p0 + tx + 16 * s;
        if (i < Q && p < P)
          st(y, (((size_t)bc * Q + i) * H + h) * P + p, acc[r][s]);
      }
    }
  }
}

// states[bc, h, p, n] for one 64 x 128 tile of [P, N] (blockIdx.x), head
// blockIdx.y.
template <class T>
__global__ void __launch_bounds__(THREADS) ssd_chunk_state_kernel(
    const T* __restrict__ x, const T* __restrict__ a,
    const T* __restrict__ Bm, T* __restrict__ states, int Q, int H, int P,
    int N, int n_ntiles) {
  const int p0 = (blockIdx.x / n_ntiles) * TILE;
  const int n0 = (blockIdx.x % n_ntiles) * NT;
  const int h = blockIdx.y, bc = blockIdx.z;
  __shared__ float cum[MAX_Q];
  __shared__ float Xs[KC][TILE + 1];     // [j][p]
  __shared__ float Bs[KC][NT + 1];       // [j][n] B * exp(cum_{Q-1} - cum_j)
  chunk_cumsum(a + ((size_t)bc * H + h) * Q, Q, cum);
  const float last = cum[Q - 1];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* B = Bm + (size_t)bc * Q * N;
  float acc[4][8] = {};
  for (int j0 = 0; j0 < Q; j0 += KC) {
    for (int idx = tid; idx < KC * TILE; idx += THREADS) {
      const int r = idx / TILE, k = idx % TILE;
      const int j = j0 + r, p = p0 + k;
      Xs[r][k] = (j < Q && p < P)
                     ? ld(x, (((size_t)bc * Q + j) * H + h) * P + p)
                     : 0.0f;
    }
    for (int idx = tid; idx < KC * NT; idx += THREADS) {
      const int r = idx / NT, k = idx % NT;
      const int j = j0 + r, n = n0 + k;
      Bs[r][k] = (j < Q && n < N)
                     ? __fmul_rn(ld(B, (size_t)j * N + n),
                                 expf(__fsub_rn(last, cum[j])))
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float xv[4], bv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = Xs[k][ty * 4 + r];
#pragma unroll
      for (int s = 0; s < 8; ++s) bv[s] = Bs[k][tx + 16 * s];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 8; ++s)
          acc[r][s] = __fmaf_rn(bv[s], xv[r], acc[r][s]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + ty * 4 + r;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int n = n0 + tx + 16 * s;
      if (p < P && n < N)
        st(states, (((size_t)bc * H + h) * P + p) * N + n, acc[r][s]);
    }
  }
}

template <class T>
int launch_all(const void* x, const void* a, const void* Bm, const void* Cm,
               void* y, void* states, float* scores, int BC, int Q, int H,
               int P, int N, cudaStream_t stream) {
  const int n_tiles = (Q + TILE - 1) / TILE;
  const int n_ntiles = (N + NT - 1) / NT;
  const T* xt = static_cast<const T*>(x);
  const T* at = static_cast<const T*>(a);
  ssd_chunk_scores_kernel<T><<<dim3(n_tiles * n_tiles, BC), THREADS, 0,
                               stream>>>(static_cast<const T*>(Bm),
                                         static_cast<const T*>(Cm), scores, Q,
                                         N, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_y_kernel<T><<<dim3(n_tiles, H, BC), THREADS, 0, stream>>>(
      xt, at, scores, static_cast<T*>(y), Q, H, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_state_kernel<T>
      <<<dim3(((P + TILE - 1) / TILE) * n_ntiles, H, BC), THREADS, 0,
         stream>>>(xt, at, static_cast<const T*>(Bm), static_cast<T*>(states),
                   Q, H, P, N, n_ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype 0: every tensor fp32; 1: every tensor bf16 (scores is always fp32).
int fog_ssd_chunk(int dtype, const void* x, const void* a, const void* Bm,
                  const void* Cm, void* y, void* states, float* scores,
                  int BC, int Q, int H, int P, int N, void* stream) {
  if (Q < 1 || Q > MAX_Q || BC < 1 || H < 1 || P < 1 || N < 1 ||
      BC > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_all<float>(x, a, Bm, Cm, y, states, scores, BC, Q, H, P, N,
                             s);
  if (dtype == 1)
    return launch_all<__nv_bfloat16>(x, a, Bm, Cm, y, states, scores, BC, Q,
                                     H, P, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
