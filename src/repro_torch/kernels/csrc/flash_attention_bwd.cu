// The backward of causal or non-causal GQA/MQA attention for NVIDIA Hopper
// (sm_90a), in fp32 on CUDA cores, from fp32 or bf16 inputs.
//
//   fog_flash_attention_bwd   the gradient of fog_flash_attention's SIMT
//                             forward (flash_attention.cu); replaces no TPU
//                             kernel: the JAX package differentiates its
//                             blocked jnp attention with jax.grad
//
// behind a plain C entry point that launches its kernels in order on the
// caller's stream and returns cudaGetLastError() (loaded with ctypes by
// repro_torch/kernels/_build.py).  The wrapper (kernels/flash_attention.py)
// allocates delta, the dK/dV partial sums and the three outputs; the
// kernels allocate nothing.
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
// Design.  TF32 stays off, so this route runs on the CUDA cores, and what
// bounds a CUDA-core product is how many FMAs each load from shared memory
// feeds.  Every tile is staged in shared memory as fp32 rows of ld floats
// (the width rounded up to 4, then to an odd number of 16-byte units, so
// that eight lanes reading eight rows at one column hit eight distinct
// bank groups); every product reads float4s and keeps a register tile:
//   * dkdv_kernel, one block of 256 threads per (T-key tile, QUERY head h,
//     batch), over the q tiles of T rows that see its keys (causal: from
//     the diagonal down).  Per q tile: s^T = K q^T and dp^T = V do^T, a
//     thread holding RT keys x RT rows of each (RT = T / 16; per step of 4
//     columns RT float4s of K or V and RT of q or do feed 4 RT^2 FMAs,
//     RT = 4: 8 per float4), then p^T and ds^T in fp32 into shared memory
//     as [row][key]; then dV += p^T do and dK += ds^T q, a thread holding
//     RT keys x 4 NC columns of each (per row one float4 of p, one of ds,
//     NC of do and NC of q feed 8 RT NC FMAs).  The G query heads of a KV
//     head are separate blocks (G times the blocks, each with a G-th of
//     the causal work), the key tiles on the grid's slowest axis so that
//     the longest blocks start first; where G > 1 each writes its partial
//     dK, dV (fp32, [B, Sk, H, D / Dv]) and reduce_kernel sums the G
//     partials of each KV head in head order, scales dK and stores both
//     (G = 1: the block stores them itself).
//   * dq_kernel, one block per (T-row q tile, query head, batch), the
//     longest causal rows first: s = q K^T and dp = do V^T as above (RT
//     rows x RT keys a thread), ds^T into shared memory as [key][row], then
//     dQ += ds K (RT rows x 4 NC columns a thread).
// Seven products in all (s and dp in both passes).  Tiles follow the head
// size alone (kernels/flash_attention.py::bwd_tiles): max(D, Dv) <= 128:
// T = 64 (RT = 4); <= 256: T = 32 (RT = 2), so that at D = Dv = 256 a
// dkdv block's K, V, q, do, p^T and ds^T take 142,592 B, under the 227 KB
// a block may opt into; NC = 1, 2, 4 up to 64, 128, 256 columns.  At D =
// Dv = 64 a dkdv block takes 104,960 B, a dq block 87,040 B: two blocks
// an SM each (their launch bounds hold a thread to 128 registers there).
//
// No atomics: every output and partial is written once by one thread and
// every sum runs in a fixed order, so the result is the same bit for bit
// from run to run.
//
// What bounds it: at the training shape (q [8, 256, 32, 64], k/v [8, 256,
// 4, 64], causal) the function moves ~76 MB (q, k, v, o, do read, dq, dk,
// dv written; 0.023 ms at 3.35 TB/s) and does 5.4 GFLOP over the causal
// pairs (0.080 ms at 67 TFLOP/s fp32), so operations bound it; this design
// runs 7.5 GFLOP (0.112 ms) and writes and reads 34 MB of dK/dV partials
// (PERF.md row 6b gives the measured time).  bf16 at the tensor cores'
// pairs (flash_attention.SM90_PAIRS) runs flash_attention_bwd_sm90.cu
// instead; this kernel takes bf16 at the others (jamba's 32, MLA at smoke
// width 48 / 32, small test widths).

#include <math.h>

#include "flash_simt.cuh"

namespace {

constexpr int THREADS = 256;   // 16 x 16: ty = tid / 16, tx = tid % 16

// floats of shared memory of a dkdv block (the larger of the two kernels)
// at T rows: K, V, q, do tiles, p^T and ds^T, the rows' lse and delta
__host__ __device__ constexpr int smem_floats(int T, int D, int Dv) {
  return 2 * T * (row_ld(D) + row_ld(Dv)) + 2 * T * row_ld(T) + 2 * T;
}
// a dq block's: q, do, K, V tiles and ds^T
__host__ __device__ constexpr int smem_floats_dq(int T, int D, int Dv) {
  return 2 * T * (row_ld(D) + row_ld(Dv)) + T * row_ld(T);
}

// a [T, w] tile (rows row0.., `stride` elements apart from `src`, rows at
// or past `rows` zeros, columns w..ld zeros) into shared memory as fp32:
// 16 lanes a row, four columns a lane (one vector load where vec)
template <class T_, int T>
__device__ __forceinline__ void stage(float* dst, const T_* src,
                                      size_t stride, int row0, int rows,
                                      int w, bool vec) {
  const int q4 = (w + 3) / 4, ldw = row_ld(w);
  for (int r = threadIdx.x / 16; r < T; r += THREADS / 16) {
    const int row = row0 + r;
    const T_* s = src + (size_t)row * stride;
    for (int c4 = threadIdx.x % 16; c4 < q4; c4 += 16) {
      const int c = 4 * c4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < rows) {
        if (vec) {
          v = ld_vec4(s + c);
        } else {
          v.x = ld(s + c);
          if (c + 1 < w) v.y = ld(s + c + 1);
          if (c + 2 < w) v.z = ld(s + c + 2);
          if (c + 3 < w) v.w = ld(s + c + 3);
        }
      }
      *reinterpret_cast<float4*>(dst + r * ldw + c) = v;
    }
  }
}

// acc[a][b] += sum over the columns of A's rows ra[a] and B's rows rb[b]
// (both [rows][ld] tiles of width w, ld floats a row), 4 columns a step
template <int RA, int RB>
__device__ __forceinline__ void product_nt(float (&acc)[RA][RB],
                                           const float* A, const int* ra,
                                           const float* B, const int* rb,
                                           int w, int ldw) {
#pragma unroll 4
  for (int c = 0; c < w; c += 4) {
    float4 a[RA], b[RB];
#pragma unroll
    for (int x = 0; x < RA; ++x) a[x] = lds4(A + ra[x] * ldw + c);
#pragma unroll
    for (int y = 0; y < RB; ++y) b[y] = lds4(B + rb[y] * ldw + c);
#pragma unroll
    for (int x = 0; x < RA; ++x)
#pragma unroll
      for (int y = 0; y < RB; ++y) {
        float s = acc[x][y];
        s = __fmaf_rn(a[x].x, b[y].x, s);
        s = __fmaf_rn(a[x].y, b[y].y, s);
        s = __fmaf_rn(a[x].z, b[y].z, s);
        s = __fmaf_rn(a[x].w, b[y].w, s);
        acc[x][y] = s;
      }
  }
}

// acc[x][m][q] += sum over the rows i < n of coef[i][col0 + x] *
// M[i][4 tx + 64 m + q], for the columns below w; coef a [rows][ldc]
// tile (col0 a multiple of R), M a [rows][ldm] tile
template <int R, int NC>
__device__ __forceinline__ void product_tn(float (&acc)[R][NC][4],
                                           const float* coef, int ldc,
                                           int col0, const float* M, int ldm,
                                           int w, int n, int tx) {
  static_assert(R == 2 || R == 4, "a register tile of 2 or 4 rows");
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    float cf[R];
    if constexpr (R == 4) {
      const float4 c4 = lds4(coef + i * ldc + col0);
      cf[0] = c4.x, cf[1] = c4.y, cf[2] = c4.z, cf[3] = c4.w;
    } else {
      const float2 c2 = *reinterpret_cast<const float2*>(coef + i * ldc +
                                                         col0);
      cf[0] = c2.x, cf[1] = c2.y;
    }
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int col = 4 * tx + 64 * m;
      if (col < w) {
        const float4 v = lds4(M + i * ldm + col);
#pragma unroll
        for (int x = 0; x < R; ++x) {
          acc[x][m][0] = __fmaf_rn(cf[x], v.x, acc[x][m][0]);
          acc[x][m][1] = __fmaf_rn(cf[x], v.y, acc[x][m][1]);
          acc[x][m][2] = __fmaf_rn(cf[x], v.z, acc[x][m][2]);
          acc[x][m][3] = __fmaf_rn(cf[x], v.w, acc[x][m][3]);
        }
      }
    }
  }
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

// dk, dv of query head blockIdx.x (its share of its KV head's) for the T
// keys of tile blockIdx.z, batch blockIdx.y (the key tiles slowest, so the
// blocks with the most causal q tiles start first).  G = 1: stored in the
// inputs' type (dk scaled); else fp32 partials into dk_part, dv_part
// [B, Sk, H, D / Dv], summed by reduce_kernel
template <class T_, int T, int NC>
__global__ void __launch_bounds__(THREADS, NC == 1 ? 2 : 1)
    flash_attention_bwd_dkdv_kernel(
        const T_* __restrict__ q, const T_* __restrict__ k,
        const T_* __restrict__ v, const T_* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        T_* __restrict__ dk, T_* __restrict__ dv,
        float* __restrict__ dk_part, float* __restrict__ dv_part, int Sq,
        int Sk, int H, int K, int D, int Dv, float scale, int causal) {
  constexpr int RT = T / 16;
  extern __shared__ __align__(16) float smem[];
  const int ldd = row_ld(D), ldv = row_ld(Dv), ldp = row_ld(T);
  float* Ks = smem;                 // [T][ldd]
  float* Vs = Ks + T * ldd;         // [T][ldv]
  float* Qs = Vs + T * ldv;         // [T][ldd]
  float* dOs = Qs + T * ldd;        // [T][ldv]
  float* Ps = dOs + T * ldv;        // [T rows][ldp keys]  p^T
  float* dSs = Ps + T * ldp;        // [T rows][ldp keys]  ds^T
  float* lse_s = dSs + T * ldp;     // [T]
  float* dl_s = lse_s + T;          // [T]

  const int j0 = blockIdx.z * T, h = blockIdx.x, b = blockIdx.y;
  const int G = H / K, kh = h / G;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int D4 = (D + 3) & ~3, Dv4 = (Dv + 3) & ~3;

  const T_* kb = k + (size_t)b * Sk * K * D + (size_t)kh * D;
  const T_* vb = v + (size_t)b * Sk * K * Dv + (size_t)kh * Dv;
  const T_* qb = q + (size_t)b * Sq * H * D + (size_t)h * D;
  const T_* db = dout + (size_t)b * Sq * H * Dv + (size_t)h * Dv;
  const bool vq = vec_rows(qb, (size_t)H * D, D);
  const bool vd = vec_rows(db, (size_t)H * Dv, Dv);
  stage<T_, T>(Ks, kb, (size_t)K * D, j0, Sk, D,
               vec_rows(kb, (size_t)K * D, D));
  stage<T_, T>(Vs, vb, (size_t)K * Dv, j0, Sk, Dv,
               vec_rows(vb, (size_t)K * Dv, Dv));

  // this thread's keys (rows of K, V; columns of p^T's rows) and q rows
  int rk[RT], rq[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    rk[r] = ty * RT + r;
    rq[r] = tx + 16 * r;
  }
  float dk_acc[RT][NC][4], dv_acc[RT][NC][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int m = 0; m < NC; ++m)
#pragma unroll
      for (int x = 0; x < 4; ++x) dk_acc[r][m][x] = dv_acc[r][m][x] = 0.0f;

  // causal: row i sees key j only for i >= j, so the q tiles start at j0
  const int i_start = causal ? j0 : 0;
  for (int i0 = i_start; i0 < Sq; i0 += T) {
    __syncthreads();   // K, V staged; the last tile's reads done
    stage<T_, T>(Qs, qb, (size_t)H * D, i0, Sq, D, vq);
    stage<T_, T>(dOs, db, (size_t)H * Dv, i0, Sq, Dv, vd);
    for (int ii = tid; ii < T; ii += THREADS) {
      const int i = i0 + ii;
      const size_t at = ((size_t)b * H + h) * Sq + i;
      lse_s[ii] = i < Sq ? lse[at] : -INFINITY;
      dl_s[ii] = i < Sq ? delta[at] : 0.0f;
    }
    __syncthreads();

    // s^T and dp^T: keys rk[r], rows rq[c]
    float s[RT][RT], dp[RT][RT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < RT; ++c) s[r][c] = dp[r][c] = 0.0f;
    product_nt<RT, RT>(s, Ks, rk, Qs, rq, D4, ldd);
    product_nt<RT, RT>(dp, Vs, rk, dOs, rq, Dv4, ldv);
#pragma unroll
    for (int c = 0; c < RT; ++c) {
      const int ii = rq[c], i = i0 + ii;
      const float ls = lse_s[ii], dl = dl_s[ii];
      float pv[RT], dsv[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int j = j0 + rk[r];
        const bool live = j < Sk && i < Sq && (!causal || i >= j) &&
                          ls > -INFINITY;
        pv[r] = live ? expf(__fsub_rn(__fmul_rn(s[r][c], scale), ls)) : 0.0f;
        dsv[r] = __fmul_rn(pv[r], __fsub_rn(dp[r][c], dl));
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        Ps[ii * ldp + rk[r]] = pv[r];
        dSs[ii * ldp + rk[r]] = dsv[r];
      }
    }
    __syncthreads();

    // dv += p^T do, dk += ds^T q (scaled at the end) over the tile's rows
    const int in = min(T, Sq - i0);
    product_tn<RT, NC>(dv_acc, Ps, ldp, ty * RT, dOs, ldv, Dv4, in, tx);
    product_tn<RT, NC>(dk_acc, dSs, ldp, ty * RT, Qs, ldd, D4, in, tx);
  }

#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int j = j0 + rk[r];
    if (j >= Sk) continue;
#pragma unroll
    for (int m = 0; m < NC; ++m)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int e = 4 * tx + 64 * m + x;
        if (G == 1) {
          const size_t at = ((size_t)b * Sk + j) * K + kh;
          if (e < D) st(dk + at * D + e, __fmul_rn(dk_acc[r][m][x], scale));
          if (e < Dv) st(dv + at * Dv + e, dv_acc[r][m][x]);
        } else {
          const size_t at = ((size_t)b * Sk + j) * H + h;
          if (e < D) dk_part[at * D + e] = dk_acc[r][m][x];
          if (e < Dv) dv_part[at * Dv + e] = dv_acc[r][m][x];
        }
      }
  }
}

// dk[b, j, kh, :] = scale * sum_g dk_part[b, j, kh G + g, :] and dv
// likewise (the G heads of a KV head in order): one thread per element
template <class T_>
__global__ void __launch_bounds__(THREADS) flash_attention_bwd_reduce_kernel(
    const float* __restrict__ dk_part, const float* __restrict__ dv_part,
    T_* __restrict__ dk, T_* __restrict__ dv, long long n_k, int G, int D,
    int Dv, float scale) {
  const long long rows = n_k;   // B Sk K
  const long long n = rows * (D + Dv);
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * THREADS) {
    const bool is_k = idx < rows * D;
    const int w = is_k ? D : Dv;
    const long long at = is_k ? idx : idx - rows * D;
    const long long row = at / w;   // (b Sk + j) K + kh
    const int e = (int)(at % w);
    const float* part = (is_k ? dk_part : dv_part) + row * G * w + e;
    float sum = 0.0f;
    for (int g = 0; g < G; ++g) sum = __fadd_rn(sum, part[(size_t)g * w]);
    if (is_k)
      st(dk + at, __fmul_rn(sum, scale));
    else
      st(dv + at, sum);
  }
}

// dq for the T rows of q tile (gridDim.z - 1 - blockIdx.z), query head
// blockIdx.x, batch blockIdx.y (the q tiles slowest, the longest causal
// rows first, so the short ones fill the tail)
template <class T_, int T, int NC>
__global__ void __launch_bounds__(THREADS, NC == 1 ? 2 : 1)
    flash_attention_bwd_dq_kernel(
        const T_* __restrict__ q, const T_* __restrict__ k,
        const T_* __restrict__ v, const T_* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        T_* __restrict__ dq, int Sq, int Sk, int H, int K, int D, int Dv,
        float scale, int causal) {
  constexpr int RT = T / 16;
  extern __shared__ __align__(16) float smem[];
  const int ldd = row_ld(D), ldv = row_ld(Dv), ldp = row_ld(T);
  float* Qs = smem;                 // [T][ldd]
  float* dOs = Qs + T * ldd;        // [T][ldv]
  float* Ks = dOs + T * ldv;        // [T][ldd]
  float* Vs = Ks + T * ldd;         // [T][ldv]
  float* dSs = Vs + T * ldv;        // [T keys][ldp rows]  ds^T

  const int i0 = (gridDim.z - 1 - blockIdx.z) * T;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int D4 = (D + 3) & ~3, Dv4 = (Dv + 3) & ~3;

  const T_* kb = k + (size_t)b * Sk * K * D + (size_t)kh * D;
  const T_* vb = v + (size_t)b * Sk * K * Dv + (size_t)kh * Dv;
  const T_* qb = q + (size_t)b * Sq * H * D + (size_t)h * D;
  const T_* db = dout + (size_t)b * Sq * H * Dv + (size_t)h * Dv;
  const bool vk = vec_rows(kb, (size_t)K * D, D);
  const bool vv = vec_rows(vb, (size_t)K * Dv, Dv);
  stage<T_, T>(Qs, qb, (size_t)H * D, i0, Sq, D,
               vec_rows(qb, (size_t)H * D, D));
  stage<T_, T>(dOs, db, (size_t)H * Dv, i0, Sq, Dv,
               vec_rows(db, (size_t)H * Dv, Dv));
  // this thread's q rows and keys
  int rr[RT], rk[RT];
  float ls[RT], dl[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    rr[r] = ty * RT + r;
    rk[r] = tx + 16 * r;
    const int i = i0 + rr[r];
    const size_t at = ((size_t)b * H + h) * Sq + i;
    ls[r] = i < Sq ? lse[at] : -INFINITY;
    dl[r] = i < Sq ? delta[at] : 0.0f;
  }
  const int i_last = min(i0 + T, Sq) - 1;
  const int kv_end = causal ? min(Sk, i_last + 1) : Sk;

  float dq_acc[RT][NC][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int m = 0; m < NC; ++m)
#pragma unroll
      for (int x = 0; x < 4; ++x) dq_acc[r][m][x] = 0.0f;

  for (int j0 = 0; j0 < kv_end; j0 += T) {
    __syncthreads();   // q, do staged; the last tile's reads done
    stage<T_, T>(Ks, kb, (size_t)K * D, j0, Sk, D, vk);
    stage<T_, T>(Vs, vb, (size_t)K * Dv, j0, Sk, Dv, vv);
    __syncthreads();

    // s and dp: rows rr[r], keys rk[c]
    float s[RT][RT], dp[RT][RT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < RT; ++c) s[r][c] = dp[r][c] = 0.0f;
    product_nt<RT, RT>(s, Qs, rr, Ks, rk, D4, ldd);
    product_nt<RT, RT>(dp, dOs, rr, Vs, rk, Dv4, ldv);
#pragma unroll
    for (int c = 0; c < RT; ++c) {
      const int j = j0 + rk[c];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = i0 + rr[r];
        const bool live = j < Sk && i < Sq && (!causal || i >= j) &&
                          ls[r] > -INFINITY;
        const float p =
            live ? expf(__fsub_rn(__fmul_rn(s[r][c], scale), ls[r])) : 0.0f;
        dSs[rk[c] * ldp + rr[r]] = __fmul_rn(p, __fsub_rn(dp[r][c], dl[r]));
      }
    }
    __syncthreads();

    // dq += ds k (scaled at the end) over this tile's keys below kv_end
    product_tn<RT, NC>(dq_acc, dSs, ldp, ty * RT, Ks, ldd, D4,
                       min(T, kv_end - j0), tx);
  }

#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int i = i0 + rr[r];
    if (i >= Sq) continue;
#pragma unroll
    for (int m = 0; m < NC; ++m)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int d = 4 * tx + 64 * m + x;
        if (d < D)
          st(dq + (((size_t)b * Sq + i) * H + h) * D + d,
             __fmul_rn(dq_acc[r][m][x], scale));
      }
  }
}

template <class Kernel>
int opt_in(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

// T rows a tile, NC groups of 64 output columns a thread
template <class T_, int T, int NC>
int launch(const T_* q, const T_* k, const T_* v, const T_* o,
           const T_* dout, const float* lse, float* delta, T_* dq, T_* dk,
           T_* dv, float* dk_part, float* dv_part, int B, int Sq, int Sk,
           int H, int K, int D, int Dv, float scale, int causal,
           cudaStream_t stream) {
  const long long rows = (long long)B * Sq * H;
  const long long delta_blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (delta_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_bwd_delta_kernel<T_><<<(unsigned)delta_blocks, THREADS, 0,
                                         stream>>>(o, dout, delta, Sq, H, Dv,
                                                   rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  const int G = H / K;
  if ((G > 1 && (dk_part == nullptr || dv_part == nullptr)) ||
      (Sk + T - 1) / T > 65535 || (Sq + T - 1) / T > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_k = sizeof(float) * smem_floats(T, D, Dv);
  err = opt_in(flash_attention_bwd_dkdv_kernel<T_, T, NC>, smem_k);
  if (err) return err;
  const dim3 kgrid(H, B, (Sk + T - 1) / T);
  flash_attention_bwd_dkdv_kernel<T_, T, NC><<<kgrid, THREADS, smem_k,
                                               stream>>>(
      q, k, v, dout, lse, delta, dk, dv, dk_part, dv_part, Sq, Sk, H, K, D,
      Dv, scale, causal);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (G > 1) {
    const long long n_k = (long long)B * Sk * K;
    const long long n = n_k * (D + Dv);
    const long long blocks = (n + THREADS - 1) / THREADS;
    flash_attention_bwd_reduce_kernel<T_>
        <<<(unsigned)(blocks < 65535 * 16 ? blocks : 65535 * 16), THREADS, 0,
           stream>>>(dk_part, dv_part, dk, dv, n_k, G, D, Dv, scale);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }

  const size_t smem_q = sizeof(float) * smem_floats_dq(T, D, Dv);
  err = opt_in(flash_attention_bwd_dq_kernel<T_, T, NC>, smem_q);
  if (err) return err;
  const dim3 qgrid(H, B, (Sq + T - 1) / T);
  flash_attention_bwd_dq_kernel<T_, T, NC><<<qgrid, THREADS, smem_q,
                                             stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, H, K, D, Dv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// the tiles by head size (kernels/flash_attention.py::bwd_tiles)
template <class T_>
int launch_by_head(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv,
                   float* dk_part, float* dv_part, int B, int Sq, int Sk,
                   int H, int K, int D, int Dv, float scale, int causal,
                   cudaStream_t s) {
  const T_* tq = static_cast<const T_*>(q);
  const T_* tk = static_cast<const T_*>(k);
  const T_* tv = static_cast<const T_*>(v);
  const T_* to = static_cast<const T_*>(o);
  const T_* td = static_cast<const T_*>(dout);
  T_* tdq = static_cast<T_*>(dq);
  T_* tdk = static_cast<T_*>(dk);
  T_* tdv = static_cast<T_*>(dv);
  const int head = D > Dv ? D : Dv;
  if (head <= 64)
    return launch<T_, 64, 1>(
        tq, tk, tv, to, td, lse, delta, tdq, tdk, tdv,
                             dk_part, dv_part, B, Sq, Sk, H, K, D, Dv, scale,
                             causal, s);
  if (head <= 128)
    return launch<T_, 64, 2>(
        tq, tk, tv, to, td, lse, delta, tdq, tdk, tdv,
                             dk_part, dv_part, B, Sq, Sk, H, K, D, Dv, scale,
                             causal, s);
  return launch<T_, 32, 4>(
      tq, tk, tv, to, td, lse, delta, tdq, tdk, tdv,
                           dk_part, dv_part, B, Sq, Sk, H, K, D, Dv, scale,
                           causal, s);
}

}  // namespace

extern "C" {

// dtype 0: fp32, 1: bf16 for q, k, v, o, do, dq, dk, dv; lse [B, H, Sq]
// from fog_flash_attention and delta [B, H, Sq] scratch, fp32 either way;
// dk_part [B, Sk, H, D] and dv_part [B, Sk, H, Dv] fp32 scratch where H >
// K (may be null where H == K).  causal: 0 or 1.
int fog_flash_attention_bwd(int dtype, const void* q, const void* k,
                            const void* v, const void* o, const void* dout,
                            const void* lse, void* delta, void* dq, void* dk,
                            void* dv, void* dk_part, void* dv_part, int B,
                            int Sq, int Sk, int H, int K, int D, int Dv,
                            float scale, int causal, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || K < 1 || H % K != 0 || D < 1 ||
      Dv < 1 || D > MAX_HEAD || Dv > MAX_HEAD || B > 65535 || H > 65535 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fl = static_cast<const float*>(lse);
  float* fdl = static_cast<float*>(delta);
  float* pk = static_cast<float*>(dk_part);
  float* pv = static_cast<float*>(dv_part);
  if (dtype == 0)
    return launch_by_head<float>(q, k, v, o, dout, fl, fdl, dq, dk, dv, pk,
                                 pv, B, Sq, Sk, H, K, D, Dv, scale, causal,
                                 s);
  return launch_by_head<__nv_bfloat16>(q, k, v, o, dout, fl, fdl, dq, dk, dv,
                                       pk, pv, B, Sq, Sk, H, K, D, Dv, scale,
                                       causal, s);
}

}  // extern "C"
