// Causal or non-causal GQA/MQA attention with an online softmax for NVIDIA
// Hopper (sm_90a), in fp32 on CUDA cores, from fp32 or bf16 inputs.
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
//   lse[b, h, i] = m + log(l) (fp32; -inf where the row saw no key), only
//                  when the lse pointer is not null: the backward
//                  (flash_attention_bwd.cu) recomputes p = exp(s - lse)
//
// where round_v rounds p to v's dtype before the product, and each KV tile
// rescales m, l and acc as the TPU kernel's loop does.  A score that is not
// live takes no part, by a branch: it never enters the max, and its p is 0
// (no exp(-inf - -inf)).  A row that sees no key (every score -inf) keeps
// l = 0 and acc = 0 and writes 0.
//
// The TPU kernel flattens (batch, KV head, group) into one grid axis over
// K/V repeated G times in HBM (jnp.repeat), holds a 512-row q block and
// the whole K/V stripe in VMEM, and needs Sq, Sk divisible by its blocks.
//
// Design.  TF32 stays off, so this route runs on the CUDA cores, and what
// bounds a CUDA-core product is how many FMAs each load from shared memory
// feeds.  A block has two groups of 128 threads (ty = t / 8, tx = t % 8 in
// a group).  Each group owns one unit, a BQ-row q tile of one query head;
// the two units of a block share their batch and KV head, so one staging
// of each K/V tile feeds both: the G heads of a KV head in pairs, or, where
// G is odd, a head's q tiles too (the units of a (batch, KV head) taken
// longest causal tile first, two a block; the block's last unit may be
// empty).  The units' pairs are the grid's slowest axis, so the longest
// blocks start first.  Every tile is staged in shared memory as fp32 rows
// of row_ld(w) floats (w rounded up to 4, then to an odd number of float4s,
// so that eight lanes reading eight rows at one column hit eight distinct
// bank groups) and read only as float4s:
//   * S = q K^T, a thread holding RX rows (ty + 16 x) x RY keys (tx + 8 y)
//     in registers: per 4 columns of d, RX + RY float4s feed 4 RX RY FMAs
//     (RX = 4, RY = 8: 128 FMAs from 12 float4s);
//   * the online softmax in registers: a row's max and sum are xor
//     shuffles over the 8 threads that share it, so all 8 hold bit-equal m
//     and l; p goes to the group's P tile once, as [row][key];
//   * O += P V, a thread holding RX rows x 4 NQ columns (4 tx + 32 q + s):
//     per 4 keys, RX float4s of P and 4 NQ of V feed 16 RX NQ FMAs.
// The next tile's global loads are issued into registers before a product
// and stored after it: V during S and the softmax, the next K during P V,
// so the latency of each tile hides behind the other's product.  Tiles
// follow the head size (kernels/flash_attention.py::fwd_tiles):
// max(D, Dv) <= 64: 64-row q tiles and 64-key tiles (RX, RY, NQ = 4, 8,
// 2), 104,448 B of shared memory at D = Dv = 64 (two blocks an SM); <=
// 128: the same tiles with NQ = 4 (169,984 B at 128); <= 256: 32-row and
// 32-key tiles (2, 4, 8), 142,336 B at D = Dv = 256, under the 227 KB a
// block may opt into.  Every edge is masked: any Sq, Sk >= 1, any D, Dv <=
// 256.  No atomics: every output is written once by one thread and every
// sum runs in a fixed order, so the result is the same bit for bit from
// run to run.
//
// What bounds it: at the fp32 training shape (q [8, 256, 32, 64], k/v [8,
// 256, 4, 64], causal) it must move 45 MB (q, k, v and the output once,
// 0.0113 ms at 3.35 TB/s) and do 2.16 GFLOP over the causal pairs, 0.0322
// ms at 67 TFLOP/s fp32, so operations bound it; this design runs the
// diagonal tiles whole, 2.68 GFLOP (0.040 ms).  PERF.md row 6 gives the
// measured time.  bf16 at the tensor cores' pairs
// (flash_attention.SM90_PAIRS) runs flash_attention_sm90.cu instead; this
// kernel takes fp32 and bf16 at the others (jamba's 32, MLA at smoke width
// 48 / 32, small test widths).

#include <math.h>

#include "flash_simt.cuh"

namespace {

constexpr int GROUP = 128;      // threads of a group: ty = t / 8, tx = t % 8
constexpr int THREADS = 2 * GROUP;

// A thread's register tiles: RX rows x RY keys of S, RX rows x 4 NQ columns
// of the output; a q tile of BQ rows, K/V tiles of BK keys, and the float4s
// of a K or V tile (up to 32 NQ columns) that each of the block's threads
// fetches
template <int RX_, int RY_, int NQ_>
struct Tiles {
  static constexpr int RX = RX_, RY = RY_, NQ = NQ_;
  static constexpr int BQ = 16 * RX, BK = 8 * RY;
  static constexpr int FRAG = BK * 8 * NQ / THREADS;
};
using Tiles64 = Tiles<4, 8, 2>;    // max(D, Dv) <= 64
using Tiles128 = Tiles<4, 8, 4>;   // <= 128
using Tiles256 = Tiles<2, 4, 8>;   // <= 256

// dynamic shared memory of a block: the two groups' q tiles, the shared K
// and V tiles, the two groups' P tiles
template <class Tl>
size_t smem_bytes(int D, int Dv) {
  return sizeof(float) *
         ((size_t)2 * Tl::BQ * row_ld(D) +
          (size_t)Tl::BK * (row_ld(D) + row_ld(Dv)) +
          (size_t)2 * Tl::BQ * row_ld(Tl::BK));
}

// p rounded to v's dtype (the TPU kernel's p.astype(v.dtype))
__device__ __forceinline__ float in_dtype(float p, const float*) { return p; }
__device__ __forceinline__ float in_dtype(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// columns c..c+3 of row `row` of src (rows `stride` elements apart) as
// fp32: zeros at or past `rows` and past w (one vector load where vec)
template <class T>
__device__ __forceinline__ float4 load4(const T* src, size_t stride,
                                        int row, int rows, int c, int w,
                                        bool vec) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row < rows) {
    const T* s = src + (size_t)row * stride + c;
    if (vec) {
      v = ld_vec4(s);
    } else {
      v.x = ld(s);
      if (c + 1 < w) v.y = ld(s + 1);
      if (c + 2 < w) v.z = ld(s + 2);
      if (c + 3 < w) v.w = ld(s + 3);
    }
  }
  return v;
}

// A [BK, w] tile of K or V in two halves, so that the block can issue its
// loads before a product and store them after it: fetch() reads this
// thread's share (float4 m of the block's at index t + THREADS m: row
// index / ceil(w / 4), four columns from 4 (index % ceil(w / 4))) of rows
// row0.. into registers; put() stores it as rows of ld floats.
template <class T, class Tl>
__device__ __forceinline__ void fetch(float4 (&f)[Tl::FRAG], const T* src,
                                      size_t stride, int row0, int rows,
                                      int w, bool vec) {
  const int w4 = (w + 3) / 4;
#pragma unroll
  for (int m = 0; m < Tl::FRAG; ++m) {
    const int idx = threadIdx.x + THREADS * m;
    if (idx < Tl::BK * w4)
      f[m] = load4(src, stride, row0 + idx / w4, rows, 4 * (idx % w4), w,
                   vec);
  }
}

template <class Tl>
__device__ __forceinline__ void put(float* dst, int ld,
                                    const float4 (&f)[Tl::FRAG], int w) {
  const int w4 = (w + 3) / 4;
#pragma unroll
  for (int m = 0; m < Tl::FRAG; ++m) {
    const int idx = threadIdx.x + THREADS * m;
    if (idx < Tl::BK * w4)
      *reinterpret_cast<float4*>(dst + (idx / w4) * ld + 4 * (idx % w4)) =
          f[m];
  }
}

// max / sum over the 8 threads of a group that share a row; the xor
// butterfly leaves the bit-equal result in all 8
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// s[x][y] = sum over the w4 (a multiple of 4) columns of Q's row ty + 16 x
// and K's row tx + 8 y, both [rows][ld] tiles, in column order
template <int RX, int RY>
__device__ __forceinline__ void product_qk(float (&s)[RX][RY],
                                           const float* Q, const float* Kt,
                                           int ld, int w4, int ty, int tx) {
#pragma unroll
  for (int x = 0; x < RX; ++x)
#pragma unroll
    for (int y = 0; y < RY; ++y) s[x][y] = 0.0f;
#pragma unroll 1
  for (int c = 0; c < w4; c += 4) {
    float4 a[RX], b[RY];
#pragma unroll
    for (int x = 0; x < RX; ++x) a[x] = lds4(Q + (ty + 16 * x) * ld + c);
#pragma unroll
    for (int y = 0; y < RY; ++y) b[y] = lds4(Kt + (tx + 8 * y) * ld + c);
#pragma unroll
    for (int x = 0; x < RX; ++x)
#pragma unroll
      for (int y = 0; y < RY; ++y) {
        float v = s[x][y];
        v = __fmaf_rn(a[x].x, b[y].x, v);
        v = __fmaf_rn(a[x].y, b[y].y, v);
        v = __fmaf_rn(a[x].z, b[y].z, v);
        v = __fmaf_rn(a[x].w, b[y].w, v);
        s[x][y] = v;
      }
  }
}

// acc[x][q][c] += sum over the keys k < n (a multiple of 4) of P[ty + 16
// x][k] V[k][4 tx + 32 q + c], in key order, for the column groups q with
// 32 q < Dv (columns past Dv read whatever lies there; their sums are
// never stored)
template <int RX, int NQ>
__device__ __forceinline__ void product_pv(float (&acc)[RX][NQ][4],
                                           const float* P, int ldp,
                                           const float* V, int ldv, int n,
                                           int Dv, int ty, int tx) {
#pragma unroll 1
  for (int k = 0; k < n; k += 4) {
    float4 a[RX];
#pragma unroll
    for (int x = 0; x < RX; ++x) a[x] = lds4(P + (ty + 16 * x) * ldp + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (32 * q >= Dv) break;
        const float4 b = lds4(V + (k + kk) * ldv + 4 * tx + 32 * q);
#pragma unroll
        for (int x = 0; x < RX; ++x) {
          const float ax = comp(a[x], kk);
          acc[x][q][0] = __fmaf_rn(ax, b.x, acc[x][q][0]);
          acc[x][q][1] = __fmaf_rn(ax, b.y, acc[x][q][1]);
          acc[x][q][2] = __fmaf_rn(ax, b.z, acc[x][q][2]);
          acc[x][q][3] = __fmaf_rn(ax, b.w, acc[x][q][3]);
        }
      }
  }
}

// the keys the rows of q tile t see: all Sk, or (causal) up to its last row
__device__ __forceinline__ int kv_end(int t, int BQ, int Sq, int Sk,
                                      int causal) {
  return causal ? min(Sk, min((t + 1) * BQ, Sq)) : Sk;
}

// Units (q tile, query head) of KV head blockIdx.x, batch blockIdx.y, in
// the order (q tile from the last, head within the KV head's G): group g
// of block pair blockIdx.z owns unit 2 blockIdx.z + g, if it exists.  Two
// blocks an SM where their shared memory allows it (the 64-column class),
// which holds a thread to 128 registers (ptxas spills ~100 bytes there,
// faster than one block an SM on the card).
template <class T, class Tl>
__global__ void __launch_bounds__(THREADS, Tl::NQ == 2 ? 2 : 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Sk, int H,
                           int K, int D, int Dv, float scale, int causal) {
  constexpr int RX = Tl::RX, RY = Tl::RY, NQ = Tl::NQ;
  constexpr int BQ = Tl::BQ, BK = Tl::BK;
  extern __shared__ __align__(16) float smem[];
  const int ldd = row_ld(D), ldv = row_ld(Dv), ldp = row_ld(BK);
  const int g = threadIdx.x / GROUP, gt = threadIdx.x % GROUP;
  const int ty = gt / 8, tx = gt % 8;
  float* Qs = smem + g * BQ * ldd;                     // [BQ][ldd]
  float* Ks = smem + 2 * BQ * ldd;                     // [BK][ldd]
  float* Vs = Ks + BK * ldd;                           // [BK][ldv]
  float* Ps = Vs + BK * ldv + g * BQ * ldp;            // [BQ][ldp]

  const int kh = blockIdx.x, b = blockIdx.y, G = H / K;
  const int nT = (Sq + BQ - 1) / BQ;
  const int u = 2 * blockIdx.z + g;
  const bool own = u < nT * G;   // the last pair's second unit may not exist
  const int t = nT - 1 - u / G, h = kh * G + u % G, i0 = t * BQ;
  const int kv_own = own ? kv_end(t, BQ, Sq, Sk, causal) : 0;
  // the block's first unit has the longer (or equal) causal range
  const int kv_blk = kv_end(nT - 1 - 2 * blockIdx.z / G, BQ, Sq, Sk, causal);

  const T* kb = k + (size_t)b * Sk * K * D + (size_t)kh * D;
  const T* vb = v + (size_t)b * Sk * K * Dv + (size_t)kh * Dv;
  const bool vk = vec_rows(kb, (size_t)K * D, D);
  const bool vv = vec_rows(vb, (size_t)K * Dv, Dv);
  const int D4 = (D + 3) & ~3;

  if (own) {
    const T* qb = q + (size_t)b * Sq * H * D + (size_t)h * D;
    const bool vq = vec_rows(qb, (size_t)H * D, D);
    const int w4 = D4 / 4;
    for (int idx = gt; idx < BQ * w4; idx += GROUP)
      *reinterpret_cast<float4*>(Qs + (idx / w4) * ldd + 4 * (idx % w4)) =
          load4(qb, (size_t)H * D, i0 + idx / w4, Sq, 4 * (idx % w4), D, vq);
  }

  float m[RX], l[RX], acc[RX][NQ][4];
#pragma unroll
  for (int x = 0; x < RX; ++x) {
    m[x] = -INFINITY;
    l[x] = 0.0f;
#pragma unroll
    for (int c = 0; c < NQ; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[x][c][e] = 0.0f;
  }

  float4 f[Tl::FRAG];
  fetch<T, Tl>(f, kb, (size_t)K * D, 0, Sk, D, vk);
  put<Tl>(Ks, ldd, f, D);
  for (int j0 = 0; j0 < kv_blk; j0 += BK) {
    // this tile's V in flight during S and the softmax
    fetch<T, Tl>(f, vb, (size_t)K * Dv, j0, Sk, Dv, vv);
    __syncthreads();   // K tile and q staged; the last tile's P, V read
    const bool act = j0 < kv_own;
    if (act) {
      float s[RX][RY];
      product_qk<RX, RY>(s, Qs, Ks, ldd, D4, ty, tx);
#pragma unroll
      for (int x = 0; x < RX; ++x) {
        const int i = i0 + ty + 16 * x;
        bool live[RY];
        float mx = -INFINITY;
#pragma unroll
        for (int y = 0; y < RY; ++y) {
          const int j = j0 + tx + 8 * y;
          live[y] = j < Sk && (!causal || i >= j);
          s[x][y] = __fmul_rn(s[x][y], scale);
          if (live[y]) mx = fmaxf(mx, s[x][y]);
        }
        const float m_new = fmaxf(m[x], row_max(mx));
        // m_new is -inf only while the row has seen no live finite score
        const float m_safe = isfinite(m_new) ? m_new : 0.0f;
        const float corr =
            isfinite(m[x]) ? expf(__fsub_rn(m[x], m_safe)) : 0.0f;
        float sum = 0.0f;
#pragma unroll
        for (int y = 0; y < RY; ++y) {
          const float p = live[y] ? expf(__fsub_rn(s[x][y], m_safe)) : 0.0f;
          sum = __fadd_rn(sum, p);
          Ps[(ty + 16 * x) * ldp + tx + 8 * y] = in_dtype(p, v);
        }
        l[x] = __fadd_rn(__fmul_rn(l[x], corr), row_sum(sum));
        m[x] = m_new;
#pragma unroll
        for (int c = 0; c < NQ; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[x][c][e] = __fmul_rn(acc[x][c][e], corr);
      }
    }
    put<Tl>(Vs, ldv, f, Dv);
    __syncthreads();   // V tile and P written; this tile's K read
    const bool more = j0 + BK < kv_blk;
    // the next K tile in flight during P V
    if (more) fetch<T, Tl>(f, kb, (size_t)K * D, j0 + BK, Sk, D, vk);
    // acc += P V over this tile's keys below kv_own (the rest have p = 0)
    if (act)
      product_pv<RX, NQ>(acc, Ps, ldp, Vs, ldv,
                         (min(BK, kv_own - j0) + 3) & ~3, Dv, ty, tx);
    if (more) put<Tl>(Ks, ldd, f, D);
  }

  if (!own) return;
  T* ob = out + (size_t)b * Sq * H * Dv + (size_t)h * Dv;
  const bool vo = vec_rows(ob, (size_t)H * Dv, Dv) && sizeof(T) == 4;
#pragma unroll
  for (int x = 0; x < RX; ++x) {
    const int i = i0 + ty + 16 * x;
    if (i >= Sq) continue;
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * Sq + i] =
          l[x] > 0.0f ? __fadd_rn(m[x], logf(l[x])) : -INFINITY;
    const float denom = fmaxf(l[x], 1e-30f);
    T* row = ob + (size_t)i * H * Dv;
#pragma unroll
    for (int c = 0; c < NQ; ++c) {
      const int e0 = 4 * tx + 32 * c;
      if (e0 >= Dv) continue;
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] = __fdiv_rn(acc[x][c][e], denom);
      if (vo) {
        *reinterpret_cast<float4*>(row + e0) =
            make_float4(r[0], r[1], r[2], r[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e0 + e < Dv) st(row + e0 + e, r[e]);
      }
    }
  }
}

template <class T, class Tl>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Sq, int Sk, int H, int K, int D, int Dv, float scale,
           int causal, cudaStream_t stream) {
  const long long units = (long long)((Sq + Tl::BQ - 1) / Tl::BQ) * (H / K);
  const long long pairs = (units + 1) / 2;
  if (pairs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<Tl>(D, Dv);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, Tl>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(K, B, (unsigned)pairs);
  flash_attention_kernel<T, Tl><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Sk, H, K, D,
      Dv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// the tiles by head size (kernels/flash_attention.py::fwd_tiles)
template <class T>
int launch_by_head(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Sk, int H, int K, int D,
                   int Dv, float scale, int causal, cudaStream_t s) {
  const int head = D > Dv ? D : Dv;
  if (head <= 64)
    return launch<T, Tiles64>(q, k, v, out, lse, B, Sq, Sk, H, K, D, Dv,
                              scale, causal, s);
  if (head <= 128)
    return launch<T, Tiles128>(q, k, v, out, lse, B, Sq, Sk, H, K, D, Dv,
                               scale, causal, s);
  return launch<T, Tiles256>(q, k, v, out, lse, B, Sq, Sk, H, K, D, Dv,
                             scale, causal, s);
}

}  // namespace

extern "C" {

// dtype 0: q, k, v and out fp32; 1: all bf16.  causal: 0 or 1.  lse:
// null, or fp32 [B, H, Sq] written with each row's log-sum-exp.
int fog_flash_attention(int dtype, const void* q, const void* k,
                        const void* v, void* out, void* lse, int B, int Sq,
                        int Sk, int H, int K, int D, int Dv, float scale,
                        int causal, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || K < 1 || H % K != 0 || D < 1 ||
      Dv < 1 || D > MAX_HEAD || Dv > MAX_HEAD || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_by_head<float>(q, k, v, out, static_cast<float*>(lse), B,
                                 Sq, Sk, H, K, D, Dv, scale, causal, s);
  if (dtype == 1)
    return launch_by_head<__nv_bfloat16>(q, k, v, out,
                                         static_cast<float*>(lse), B, Sq, Sk,
                                         H, K, D, Dv, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
