// The backward of the Mamba-2 SSD intra-chunk block for NVIDIA Hopper
// (sm_90a), in fp32 on CUDA cores, from fp32 or bf16 inputs.
//
//   fog_ssd_chunk_bwd   the gradient of fog_ssd_chunk (ssd_chunk.cu); it
//                       replaces no TPU kernel: the JAX package takes it
//                       with jax.grad of the einsum branch of
//                       repro/models/mamba2.py::ssd_chunked
//
// behind a plain C entry point that launches four kernels in order on the
// caller's stream and returns cudaGetLastError() (loaded with ctypes by
// repro_torch/kernels/_build.py).  The wrapper (kernels/ssd_chunk.py::
// ssd_chunk_bwd_cuda) allocates the scratch and the four outputs; the
// kernels allocate nothing.
//
// Per chunk bc = (batch, chunk) and head h, with x [BC, Q, H, P], a [BC,
// H, Q], B/C [BC, Q, N], the gradients dy [BC, Q, H, P] of y_diag and dst
// [BC, H, P, N] of the states, all fp32 or all bf16 (the kernels are
// templated on that type: loads convert to fp32, every sum and the scratch
// are fp32, dx, da, dB, dC are stored in the inputs' type; a bf16 input is
// differentiated exactly at its value, not through the tensor-core
// forward's rounding of W and of the decayed x):
//
//   cum = cumsum(a_h),  L[i, j] = exp(cum_i - cum_j) for i >= j (else 0),
//   S = C B^T,  W_h = S o L,  d_j = exp(cum_{Q-1} - cum_j),
//   G_h[j, p] = sum_n B[j, n] dst[h, p, n]
//   dx_h = W_h^T dy_h + d o G_h                                  dx_kernel
//   dS   = sum_h (dy_h x_h^T) o L_h   (lower triangle)           ds_kernel
//   dC   = dS B,  dB = dS^T C + sum_h d o (x_h dst_h)          dbdc_kernel
//   t_h  = (dy_h x_h^T) o W_h:  dcum_i += sum_j t_ij,  dcum_j -= sum_i t_ij
//   e_j  = d_j sum_p x_jp G_jp:  dcum_{Q-1} += sum_j e_j,  dcum_j -= e_j
//   da_h = reverse cumsum of dcum_h                            dbdc_kernel
//
// The four launches:
//   1. cum_kernel, one warp per (chunk, head): cum and d into scratch.
//   2. ds_kernel, one block per (chunk, 64 x 64 [i, j] tile on or below
//      the diagonal): S's tile (written to scratch for pass 3), then over
//      the heads in order the tile of dy_h x_h^T, summed into dS with L_h,
//      and t_h's row and column sums over the tile written per head.
//   3. dx_kernel, one block per (64-row tile of j, head, chunk): dx from
//      the W tiles below the diagonal (S from scratch, L from the cumsum)
//      and G_h, and e_j for the tile's rows.
//   4. dbdc_kernel: one block per (32-row tile, 64-column tile of n,
//      chunk) for dC and dB (the heads summed in order), and one per
//      (chunk, head) for da: dcum from the tile sums and e, then a serial
//      reverse scan.
//
// No atomics: every output and every scratch entry is written once by one
// thread, each sum taken in a fixed order, so the result is the same bit
// for bit from run to run.  Any 1 <= Q <= 256 (the cumsum of one head
// lives in shared memory) and any P and N: every tile masks its ragged
// edge.  Above the diagonal cum_i - cum_j > 0 can overflow exp, so those
// entries are 0 by a branch, never by a 0/1 multiply (inf * 0 = NaN).
//
// What bounds it: at the training shape (x [8, 1, 256, 80, 64], N = 128)
// it moves ~151 MB (x, dy, dx, dst, a, da, B, C, dB, dC once each; 0.045
// ms at 3.35 TB/s) and does ~11 GFLOP (the four Q x Q x P or Q x P x N
// products per (chunk, head) over the causal half or the whole chunk,
// and S and its two products per chunk; ~0.16 ms at 67 TFLOP/s fp32), so
// operations bound it.  This first kernel does them as fp32 FMAs from
// shared-memory tiles (explicit __fmaf_rn: the build passes -fmad=false),
// about one shared load per two FMAs, so it runs well above the bound
// (PERF.md row 7b).  bf16 inputs halve the bytes, not the operations.
// bf16 at the forward's tensor-core shapes (P = 64, N in {64, 128}: the
// mamba2 and jamba training path) runs ssd_chunk_bwd_sm90.cu instead
// (kernels/ssd_chunk.py::route); this kernel takes fp32 and bf16 at
// every other shape.

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

constexpr int MAX_Q = 256;    // the cumsum of one head lives in shared memory
constexpr int TILE = 64;      // rows i, columns j, columns p of one tile
constexpr int KC = 32;        // reduction step over p or n
constexpr int ROWS = 32;      // rows of one dbdc tile
constexpr int COLS = 64;      // state columns n of one dbdc tile
constexpr int THREADS = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr unsigned FULL = 0xffffffffu;

// cum[bc, h, 0, :] = cumsum(a[bc, h, :]); cum[bc, h, 1, j] = exp(cum_{Q-1}
// - cum_j).  One warp per (chunk, head): 32 entries at a time with
// shuffles, the running total carried.
template <class T>
__global__ void __launch_bounds__(32) ssd_bwd_cum_kernel(
    const T* __restrict__ a, float* __restrict__ cum, int Q) {
  const size_t row = blockIdx.x;        // bc * H + h
  const T* ar = a + row * Q;
  float* cr = cum + row * 2 * Q;
  const int lane = threadIdx.x;
  float carry = 0.0f;
  for (int base = 0; base < Q; base += 32) {
    const int i = base + lane;
    float v = i < Q ? ld(ar + i) : 0.0f;
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

// One [i, j] tile (ti >= tj) of chunk blockIdx.y: S into S[bc, 0], dS into
// S[bc, 1], t's row sums into part[bc, h, 0, tj, i] and column sums into
// part[bc, h, 1, ti, j] for every head.
template <class T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_ds_kernel(
    const T* __restrict__ x, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const T* __restrict__ dy,
    const float* __restrict__ cum, float* __restrict__ S,
    float* __restrict__ part, int Q, int H, int P, int N, int nt) {
  int ti = 0, rest = blockIdx.x;
  while (rest > ti) rest -= ++ti;
  const int tj = rest;
  const int bc = blockIdx.y;
  const int i0 = ti * TILE, j0 = tj * TILE;
  __shared__ float As[KC][TILE + 1];     // [k][i]: C, then dy
  __shared__ float Bs[KC][TILE + 1];     // [k][j]: B, then x
  __shared__ float Ts[TILE][TILE + 1];   // t_h's tile
  __shared__ float ci[TILE], cj[TILE];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  // S's tile from C's rows i and B's rows j
  float s_t[4][4] = {};
  const T* C = Cm + (size_t)bc * Q * N;
  const T* Bp = Bm + (size_t)bc * Q * N;
  for (int n0 = 0; n0 < N; n0 += KC) {
    for (int idx = tid; idx < TILE * KC; idx += THREADS) {
      const int r = idx / KC, k = idx % KC, n = n0 + k;
      const int i = i0 + r, j = j0 + r;
      As[k][r] = (i < Q && n < N) ? ld(C + (size_t)i * N + n) : 0.0f;
      Bs[k][r] = (j < Q && n < N) ? ld(Bp + (size_t)j * N + n) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float c[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) c[r] = As[k][ty * 4 + r];
#pragma unroll
      for (int s = 0; s < 4; ++s) b[s] = Bs[k][tx + 16 * s];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) s_t[r][s] = __fmaf_rn(c[r], b[s], s_t[r][s]);
    }
    __syncthreads();
  }
  float* Sc = S + (size_t)bc * 2 * Q * Q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = j0 + tx + 16 * s;
      if (i < Q && j <= i) Sc[(size_t)i * Q + j] = s_t[r][s];
    }
  }

  float ds[4][4] = {};
  for (int h = 0; h < H; ++h) {
    const float* ch = cum + ((size_t)bc * H + h) * 2 * Q;
    for (int r = tid; r < TILE; r += THREADS) {
      ci[r] = i0 + r < Q ? ch[i0 + r] : 0.0f;
      cj[r] = j0 + r < Q ? ch[j0 + r] : 0.0f;
    }
    // dW = dy_h x_h^T over the tile
    float dw[4][4] = {};
    for (int p0 = 0; p0 < P; p0 += KC) {
      for (int idx = tid; idx < TILE * KC; idx += THREADS) {
        const int r = idx / KC, k = idx % KC, p = p0 + k;
        const int i = i0 + r, j = j0 + r;
        As[k][r] = (i < Q && p < P)
                       ? ld(dy + (((size_t)bc * Q + i) * H + h) * P + p)
                       : 0.0f;
        Bs[k][r] = (j < Q && p < P)
                       ? ld(x + (((size_t)bc * Q + j) * H + h) * P + p)
                       : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float u[4], v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = As[k][ty * 4 + r];
#pragma unroll
        for (int s = 0; s < 4; ++s) v[s] = Bs[k][tx + 16 * s];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) dw[r][s] = __fmaf_rn(u[r], v[s], dw[r][s]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int ii = ty * 4 + r, i = i0 + ii;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int jj = tx + 16 * s, j = j0 + jj;
        float t = 0.0f;
        if (i < Q && j <= i) {
          const float L = expf(__fsub_rn(ci[ii], cj[jj]));
          ds[r][s] = __fmaf_rn(dw[r][s], L, ds[r][s]);
          t = __fmul_rn(__fmul_rn(dw[r][s], s_t[r][s]), L);
        }
        Ts[ii][jj] = t;
      }
    }
    __syncthreads();
    float* ph = part + ((size_t)bc * H + h) * 2 * nt * Q;
    if (tid < TILE) {
      const int i = i0 + tid;
      float sum = 0.0f;
      for (int jj = 0; jj < TILE; ++jj) sum = __fadd_rn(sum, Ts[tid][jj]);
      if (i < Q) ph[(size_t)tj * Q + i] = sum;
    } else if (tid < 2 * TILE) {
      const int c = tid - TILE, j = j0 + c;
      float sum = 0.0f;
      for (int ii = 0; ii < TILE; ++ii) sum = __fadd_rn(sum, Ts[ii][c]);
      if (j < Q) ph[(size_t)(nt + ti) * Q + j] = sum;
    }
    __syncthreads();
  }
  float* dSc = Sc + (size_t)Q * Q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = j0 + tx + 16 * s;
      if (i < Q && j <= i) dSc[(size_t)i * Q + j] = ds[r][s];
    }
  }
}

// dx for the 64 rows j of tile blockIdx.x, head blockIdx.y, chunk
// blockIdx.z, and e[bc, h, j].
template <class T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_dx_kernel(
    const T* __restrict__ x, const T* __restrict__ Bm,
    const T* __restrict__ dy, const T* __restrict__ dst,
    const float* __restrict__ cum, const float* __restrict__ S,
    float* __restrict__ e, T* __restrict__ dx, int Q, int H, int P,
    int N, int nt) {
  const int tj = blockIdx.x, h = blockIdx.y, bc = blockIdx.z;
  const int j0 = tj * TILE;
  __shared__ float ch[MAX_Q];
  __shared__ float buf[2 * TILE * (TILE + 1)];
  float (*Wt)[TILE + 1] = reinterpret_cast<float (*)[TILE + 1]>(buf);
  float (*Ys)[TILE + 1] =
      reinterpret_cast<float (*)[TILE + 1]>(buf + TILE * (TILE + 1));
  float (*Bs)[TILE + 1] = Wt;   // [k][j], the G pass (KC rows)
  float (*Ds)[TILE + 1] = Ys;   // [k][p]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* cr = cum + ((size_t)bc * H + h) * 2 * Q;
  for (int i = tid; i < Q; i += THREADS) ch[i] = cr[i];
  float dj[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty * 4 + r;
    dj[r] = j < Q ? cr[Q + j] : 0.0f;
  }
  __syncthreads();
  const float* Sc = S + (size_t)bc * 2 * Q * Q;
  const T* B = Bm + (size_t)bc * Q * N;
  const T* dsth = dst + ((size_t)bc * H + h) * P * N;
  float dd[4] = {};
  for (int p0 = 0; p0 < P; p0 += TILE) {
    float acc[4][4] = {};
    for (int ti = tj; ti < nt; ++ti) {
      const int i0 = ti * TILE;
      for (int idx = tid; idx < TILE * TILE; idx += THREADS) {
        const int r = idx / TILE, k = idx % TILE;
        const int j = j0 + r, i = i0 + k;
        float w = 0.0f;
        if (i < Q && j <= i)
          w = __fmul_rn(Sc[(size_t)i * Q + j], expf(__fsub_rn(ch[i], ch[j])));
        Wt[r][k] = w;
        const int ir = i0 + r, p = p0 + k;
        Ys[r][k] = (ir < Q && p < P)
                       ? ld(dy + (((size_t)bc * Q + ir) * H + h) * P + p)
                       : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < TILE; ++k) {
        float w[4], yv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) w[r] = Wt[ty * 4 + r][k];
#pragma unroll
        for (int s = 0; s < 4; ++s) yv[s] = Ys[k][tx + 16 * s];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            acc[r][s] = __fmaf_rn(w[r], yv[s], acc[r][s]);
      }
      __syncthreads();
    }
    // G[j, p] = sum_n B[j, n] dst[h, p, n]
    float g[4][4] = {};
    for (int n0 = 0; n0 < N; n0 += KC) {
      for (int idx = tid; idx < TILE * KC; idx += THREADS) {
        const int r = idx / KC, k = idx % KC, n = n0 + k;
        const int j = j0 + r, p = p0 + r;
        Bs[k][r] = (j < Q && n < N) ? ld(B + (size_t)j * N + n) : 0.0f;
        Ds[k][r] = (p < P && n < N) ? ld(dsth + (size_t)p * N + n) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float bv[4], dv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) bv[r] = Bs[k][ty * 4 + r];
#pragma unroll
        for (int s = 0; s < 4; ++s) dv[s] = Ds[k][tx + 16 * s];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) g[r][s] = __fmaf_rn(bv[r], dv[s], g[r][s]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + ty * 4 + r;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int p = p0 + tx + 16 * s;
        if (j < Q && p < P) {
          const size_t at = (((size_t)bc * Q + j) * H + h) * P + p;
          st(dx + at, __fmaf_rn(dj[r], g[r][s], acc[r][s]));
          dd[r] = __fmaf_rn(ld(x + at), g[r][s], dd[r]);
        }
      }
    }
  }
  // dd over the 16 threads of a row (tx), which share a warp
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      dd[r] = __fadd_rn(dd[r], __shfl_xor_sync(FULL, dd[r], off));
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + ty * 4 + r;
      if (j < Q) e[((size_t)bc * H + h) * Q + j] = __fmul_rn(dd[r], dj[r]);
    }
  }
}

// Blocks [0, n_tiles): dC and dB for one (32-row, 64-column) tile of a
// chunk; blocks [n_tiles, n_tiles + BC H): da of one (chunk, head).
template <class T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_dbdc_kernel(
    const T* __restrict__ x, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const T* __restrict__ dst,
    const float* __restrict__ cum, const float* __restrict__ S,
    const float* __restrict__ part, const float* __restrict__ e,
    T* __restrict__ dB, T* __restrict__ dC, T* __restrict__ da,
    int Q, int H, int P, int N, int nt, int n_rt, int n_ct, int n_tiles) {
  const int tid = threadIdx.x;
  __shared__ float As[ROWS][ROWS + 1];
  __shared__ float Vs[ROWS][COLS + 1];
  __shared__ float dcum[MAX_Q];
  if ((int)blockIdx.x >= n_tiles) {
    const size_t row = blockIdx.x - n_tiles;     // bc * H + h
    const float* ph = part + row * 2 * nt * Q;
    const float* er = e + row * Q;
    for (int k = tid; k < Q; k += THREADS) {
      const int t = k / TILE;
      float v = 0.0f;
      for (int u = 0; u <= t; ++u) v = __fadd_rn(v, ph[(size_t)u * Q + k]);
      for (int u = t; u < nt; ++u)
        v = __fsub_rn(v, ph[(size_t)(nt + u) * Q + k]);
      dcum[k] = __fsub_rn(v, er[k]);
    }
    __syncthreads();
    if (tid == 0) {
      float esum = 0.0f;
      for (int j = 0; j < Q; ++j) esum = __fadd_rn(esum, er[j]);
      dcum[Q - 1] = __fadd_rn(dcum[Q - 1], esum);
      float run = 0.0f;
      T* dr = da + row * Q;
      for (int k = Q - 1; k >= 0; --k) {
        run = __fadd_rn(run, dcum[k]);
        st(dr + k, run);
      }
    }
    return;
  }
  const int bc = blockIdx.x / (n_rt * n_ct);
  const int rt = (blockIdx.x / n_ct) % n_rt, ct = blockIdx.x % n_ct;
  const int r0 = rt * ROWS, n0 = ct * COLS;
  const int ty = tid / 16, tx = tid % 16;   // rows ty * 2 + r, cols tx + 16 s
  const float* dS = S + ((size_t)bc * 2 + 1) * Q * Q;
  const T* B = Bm + (size_t)bc * Q * N;
  const T* C = Cm + (size_t)bc * Q * N;
  float acc_c[2][4] = {}, acc_b[2][4] = {};

  // dC[i, n] = sum_{j <= i} dS[i, j] B[j, n] for rows i of the tile
  const int r_end = min(r0 + ROWS, Q);
  for (int k0 = 0; k0 < r_end; k0 += ROWS) {
    for (int idx = tid; idx < ROWS * ROWS; idx += THREADS) {
      const int r = idx / ROWS, k = idx % ROWS, i = r0 + r, j = k0 + k;
      As[r][k] = (i < Q && j <= i) ? dS[(size_t)i * Q + j] : 0.0f;
    }
    for (int idx = tid; idx < ROWS * COLS; idx += THREADS) {
      const int k = idx / COLS, c = idx % COLS, j = k0 + k, n = n0 + c;
      Vs[k][c] = (j < Q && n < N) ? ld(B + (size_t)j * N + n) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < ROWS; ++k) {
      float u[2], v[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) u[r] = As[ty * 2 + r][k];
#pragma unroll
      for (int s = 0; s < 4; ++s) v[s] = Vs[k][tx + 16 * s];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          acc_c[r][s] = __fmaf_rn(u[r], v[s], acc_c[r][s]);
    }
    __syncthreads();
  }
  // dB[j, n] = sum_{i >= j} dS[i, j] C[i, n] for rows j of the tile
  for (int k0 = r0; k0 < Q; k0 += ROWS) {
    for (int idx = tid; idx < ROWS * ROWS; idx += THREADS) {
      const int r = idx / ROWS, k = idx % ROWS, j = r0 + r, i = k0 + k;
      As[r][k] = (i < Q && j < Q && j <= i) ? dS[(size_t)i * Q + j] : 0.0f;
    }
    for (int idx = tid; idx < ROWS * COLS; idx += THREADS) {
      const int k = idx / COLS, c = idx % COLS, i = k0 + k, n = n0 + c;
      Vs[k][c] = (i < Q && n < N) ? ld(C + (size_t)i * N + n) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < ROWS; ++k) {
      float u[2], v[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) u[r] = As[ty * 2 + r][k];
#pragma unroll
      for (int s = 0; s < 4; ++s) v[s] = Vs[k][tx + 16 * s];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          acc_b[r][s] = __fmaf_rn(u[r], v[s], acc_b[r][s]);
    }
    __syncthreads();
  }
  // + sum_h d_h[j] (x_h dst_h)[j, n], the heads in order
  for (int h = 0; h < H; ++h) {
    float xs[2][4] = {};
    const T* dsth = dst + ((size_t)bc * H + h) * P * N;
    for (int k0 = 0; k0 < P; k0 += ROWS) {
      for (int idx = tid; idx < ROWS * ROWS; idx += THREADS) {
        const int r = idx / ROWS, k = idx % ROWS, j = r0 + r, p = k0 + k;
        As[r][k] = (j < Q && p < P)
                       ? ld(x + (((size_t)bc * Q + j) * H + h) * P + p)
                       : 0.0f;
      }
      for (int idx = tid; idx < ROWS * COLS; idx += THREADS) {
        const int k = idx / COLS, c = idx % COLS, p = k0 + k, n = n0 + c;
        Vs[k][c] = (p < P && n < N) ? ld(dsth + (size_t)p * N + n) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < ROWS; ++k) {
        float u[2], v[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) u[r] = As[ty * 2 + r][k];
#pragma unroll
        for (int s = 0; s < 4; ++s) v[s] = Vs[k][tx + 16 * s];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) xs[r][s] = __fmaf_rn(u[r], v[s], xs[r][s]);
      }
      __syncthreads();
    }
    const float* dh = cum + ((size_t)bc * H + h) * 2 * Q + Q;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = r0 + ty * 2 + r;
      const float d = j < Q ? dh[j] : 0.0f;
#pragma unroll
      for (int s = 0; s < 4; ++s) acc_b[r][s] = __fmaf_rn(d, xs[r][s], acc_b[r][s]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + ty * 2 + r;
    if (i >= Q) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int n = n0 + tx + 16 * s;
      if (n < N) {
        const size_t at = ((size_t)bc * Q + i) * N + n;
        st(dC + at, acc_c[r][s]);
        st(dB + at, acc_b[r][s]);
      }
    }
  }
}

template <class T>
int launch(const void* x, const void* a, const void* Bm, const void* Cm,
           const void* dy, const void* dst, float* cum, float* S,
           float* part, float* e, void* dx, void* da, void* dB, void* dC,
           int BC, int Q, int H, int P, int N, cudaStream_t s) {
  const T* tx = static_cast<const T*>(x);
  const T* tB = static_cast<const T*>(Bm);
  const T* tC = static_cast<const T*>(Cm);
  const T* tdst = static_cast<const T*>(dst);
  const int nt = (Q + TILE - 1) / TILE;
  ssd_bwd_cum_kernel<T><<<(unsigned)(BC * H), 32, 0, s>>>(
      static_cast<const T*>(a), cum, Q);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ssd_bwd_ds_kernel<T><<<dim3(nt * (nt + 1) / 2, BC), THREADS, 0, s>>>(
      tx, tB, tC, static_cast<const T*>(dy), cum, S, part, Q, H, P, N, nt);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ssd_bwd_dx_kernel<T><<<dim3(nt, H, BC), THREADS, 0, s>>>(
      tx, tB, static_cast<const T*>(dy), tdst, cum, S, e,
      static_cast<T*>(dx), Q, H, P, N, nt);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int n_rt = (Q + ROWS - 1) / ROWS, n_ct = (N + COLS - 1) / COLS;
  const long long n_tiles = (long long)BC * n_rt * n_ct;
  const long long blocks = n_tiles + (long long)BC * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ssd_bwd_dbdc_kernel<T><<<(unsigned)blocks, THREADS, 0, s>>>(
      tx, tB, tC, tdst, cum, S, part, e, static_cast<T*>(dB),
      static_cast<T*>(dC), static_cast<T*>(da), Q, H, P, N, nt, n_rt, n_ct,
      (int)n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype 0: fp32, 1: bf16 for x, a, Bm, Cm, dy, dst and the outputs dx,
// da, dB, dC.  fp32 scratch from the wrapper: cum [BC, H, 2, Q], S [BC, 2,
// Q, Q], part [BC, H, 2, nt, Q] (nt = ceil(Q / 64)), e [BC, H, Q].
int fog_ssd_chunk_bwd(int dtype, const void* x, const void* a,
                      const void* Bm, const void* Cm, const void* dy,
                      const void* dst, void* cum, void* S, void* part,
                      void* e, void* dx, void* da, void* dB, void* dC, int BC,
                      int Q, int H, int P, int N, void* stream) {
  if (Q < 1 || Q > MAX_Q || BC < 1 || H < 1 || P < 1 || N < 1 ||
      BC > 65535 || H > 65535 || (long long)BC * H > 0x7fffffffLL ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fcum = static_cast<float*>(cum);
  float* fS = static_cast<float*>(S);
  float* fpart = static_cast<float*>(part);
  float* fe = static_cast<float*>(e);
  if (dtype == 0)
    return launch<float>(x, a, Bm, Cm, dy, dst, fcum, fS, fpart, fe, dx, da,
                         dB, dC, BC, Q, H, P, N, s);
  return launch<__nv_bfloat16>(x, a, Bm, Cm, dy, dst, fcum, fS, fpart, fe,
                               dx, da, dB, dC, BC, Q, H, P, N, s);
}

}  // extern "C"
