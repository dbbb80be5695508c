// Building blocks shared by the CUDA-core (SIMT) SSD kernels, the forward
// (ssd_chunk.cu) and its backward (ssd_chunk_bwd.cu): fp32 arithmetic on
// fp32 or bf16 inputs, TF32 off, explicit _rn intrinsics (the build passes
// -fmad=false).  Every function is internal to the including file (an
// anonymous namespace), so each translation unit keeps its own copy.
//
// Tiles.  Every operand of a product is staged in shared memory as a 64 x
// 64 fp32 tile whose rows are LDT = 68 floats apart: 17 float4s, an odd
// number, so that eight lanes reading eight rows at one column hit eight
// distinct bank groups.  A block has 128 threads, ty = tid / 8 (0..15) and
// tx = tid % 8, and holds a 64 x 64 output as a register tile of 4 x 8
// outputs a thread, fed by float4 reads in one of three forms:
//
//   mma_nt  acc += A Bᵀ   both operands with k along their rows; a thread
//                         holds rows ty + 16 x and columns tx + 8 y; per
//                         4 k, 4 + 8 float4s feed 128 FMAs
//   mma_tn  acc += Aᵀ B   both operands with k down their columns (the
//                         outer-product form); rows 4 ty + x, columns
//                         4 tx + 32 q + s; per k, 1 + 2 float4s feed 32
//   mma_nn  acc += A B    A with k along its rows, B with k down its
//                         columns; rows ty + 16 x, columns 4 tx + 32 q + s;
//                         per 4 k, 4 + 8 float4s feed 128
//
// Each form reads its A rows (nt, nn: four consecutive rows a warp) and B
// rows or columns without a bank conflict.  Every sum runs over k in order,
// so a product's result is the same bit for bit from run to run.
//
// The S tiles.  S = C Bᵀ is computed once per chunk, only its 64 x 64
// tiles on or below the diagonal, tile (ti, tj) at index ti (ti + 1) / 2 +
// tj of a [BC, tiles, 64, 64] fp32 scratch, rows and columns past Q zero
// (prep(), which also scans each (chunk, head)'s cumsum once).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_Q = 256;    // a head's cumsum lives in shared memory
constexpr int TILE = 64;      // rows and columns of a tile, the k of a step
constexpr int LDT = 68;       // floats a staged row: 17 float4s (odd)
constexpr int TILE_FLOATS = TILE * LDT;
constexpr int THREADS = 128;  // ty = tid / 8, tx = tid % 8
constexpr unsigned FULL = 0xffffffffu;

// tiles on or below the diagonal of a chunk of nt row tiles, and the index
// of tile (ti, tj), tj <= ti
__host__ __device__ constexpr int n_tiles(int nt) { return nt * (nt + 1) / 2; }
__host__ __device__ constexpr int tile_index(int ti, int tj) {
  return ti * (ti + 1) / 2 + tj;
}
// (ti, tj) of tile index t
__device__ __forceinline__ void tile_of(int t, int& ti, int& tj) {
  ti = 0;
  while (t > ti) t -= ++ti;
  tj = t;
}

// an input element as fp32, and an fp32 result stored in the inputs' type
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// four input elements at p (16-byte aligned fp32, 8-byte aligned bf16) as
// fp32
__device__ __forceinline__ float4 ld_vec4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld_vec4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// this thread's index in its group of THREADS (a block of 256 threads
// runs two groups, each on its own tiles)
__device__ __forceinline__ int gtid() { return threadIdx.x % THREADS; }

// a barrier for the THREADS threads of group g of a block (named barrier
// g + 1; 0 is __syncthreads')
__device__ __forceinline__ void sync_group(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(THREADS) : "memory");
}

// A 64 x 64 tile in two halves, so that a block can issue the loads of
// its next tile before it computes on this one: fetch() reads this
// thread's share, rows (tid + 128 m) / 16 and four columns 4 ((tid + 128
// m) % 16) for m < 8, src[(row0 + r) * stride + col0 + c] as fp32, 0
// where row0 + r >= rows or col0 + c >= cols (one vector load where the
// four are aligned and in range); put() stores it as rows LDT floats
// apart.
constexpr int FRAG = TILE * TILE / 4 / THREADS;   // float4s a thread: 8
template <class T>
__device__ __forceinline__ void fetch(float4 (&v)[FRAG], const T* src,
                                      size_t stride, int row0, int rows,
                                      int col0, int cols) {
  const bool vec = stride % 4 == 0 && col0 % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % (4 * sizeof(T)) == 0;
#pragma unroll
  for (int m = 0; m < FRAG; ++m) {
    const int idx = gtid() + THREADS * m;
    const int r = idx / (TILE / 4), c = 4 * (idx % (TILE / 4));
    const int row = row0 + r, col = col0 + c;
    v[m] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < rows) {
      const T* s = src + (size_t)row * stride + col;
      if (vec && col + 3 < cols) {
        v[m] = ld_vec4(s);
      } else {
        if (col < cols) v[m].x = ld(s);
        if (col + 1 < cols) v[m].y = ld(s + 1);
        if (col + 2 < cols) v[m].z = ld(s + 2);
        if (col + 3 < cols) v[m].w = ld(s + 3);
      }
    }
  }
}

__device__ __forceinline__ void put(float* dst, const float4 (&v)[FRAG]) {
#pragma unroll
  for (int m = 0; m < FRAG; ++m) {
    const int idx = gtid() + THREADS * m;
    const int r = idx / (TILE / 4), c = 4 * (idx % (TILE / 4));
    *reinterpret_cast<float4*>(dst + r * LDT + c) = v[m];
  }
}

// the scales of this thread's put() rows: sc[m] = src[r] for its row r of
// slot m where r < n, else 0
__device__ __forceinline__ void fetch_rows(float (&sc)[FRAG],
                                           const float* src, int n) {
#pragma unroll
  for (int m = 0; m < FRAG; ++m) {
    const int r = (gtid() + THREADS * m) / (TILE / 4);
    sc[m] = r < n ? src[r] : 0.0f;
  }
}

// put() with row scales from fetch_rows()
__device__ __forceinline__ void put_scaled(float* dst,
                                           const float4 (&v)[FRAG],
                                           const float (&sc)[FRAG]) {
#pragma unroll
  for (int m = 0; m < FRAG; ++m) {
    const int idx = gtid() + THREADS * m;
    const int r = idx / (TILE / 4), c = 4 * (idx % (TILE / 4));
    const float f = sc[m];
    *reinterpret_cast<float4*>(dst + r * LDT + c) =
        make_float4(__fmul_rn(f, v[m].x), __fmul_rn(f, v[m].y),
                    __fmul_rn(f, v[m].z), __fmul_rn(f, v[m].w));
  }
}

// fetch() and put() at once
template <class T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      size_t stride, int row0, int rows,
                                      int col0, int cols) {
  float4 v[FRAG];
  fetch(v, src, stride, row0, rows, col0, cols);
  put(dst, v);
}

// A W tile, W[a][b] = S[a][b] exp(cum[i] - cum[j]) where i >= j and i < Q,
// else 0 by a branch (above the diagonal cum_i - cum_j > 0 can overflow
// exp, and inf * 0 = NaN), from this thread's fetch() share v of an S
// tile (a, b) = (i - i0, j - j0), or (j - j0, i - i0) where TRANSPOSED;
// cum in shared memory
template <bool TRANSPOSED>
__device__ __forceinline__ void put_w(float* dst, const float4 (&v)[FRAG],
                                      const float* cum, int i0, int j0,
                                      int Q) {
#pragma unroll
  for (int m = 0; m < FRAG; ++m) {
    const int idx = gtid() + THREADS * m;
    const int r = idx / (TILE / 4), c = 4 * (idx % (TILE / 4));
    float w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = TRANSPOSED ? i0 + c + u : i0 + r;
      const int j = TRANSPOSED ? j0 + r : j0 + c + u;
      w[u] = 0.0f;
      if (i < Q && j <= i)
        w[u] = __fmul_rn(comp(v[m], u), expf(__fsub_rn(cum[i], cum[j])));
    }
    *reinterpret_cast<float4*>(dst + r * LDT + c) =
        make_float4(w[0], w[1], w[2], w[3]);
  }
}

// acc[x][y] += sum_k A[ty + 16 x][k] B[tx + 8 y][k]
__device__ __forceinline__ void mma_nt(float (&acc)[4][8], const float* A,
                                       const float* B) {
  const int ty = gtid() / 8, tx = gtid() % 8;
#pragma unroll 2
  for (int k = 0; k < TILE; k += 4) {
    float4 a[4], b[8];
#pragma unroll
    for (int x = 0; x < 4; ++x) a[x] = lds4(A + (ty + 16 * x) * LDT + k);
#pragma unroll
    for (int y = 0; y < 8; ++y) b[y] = lds4(B + (tx + 8 * y) * LDT + k);
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 8; ++y) {
        float s = acc[x][y];
        s = __fmaf_rn(a[x].x, b[y].x, s);
        s = __fmaf_rn(a[x].y, b[y].y, s);
        s = __fmaf_rn(a[x].z, b[y].z, s);
        s = __fmaf_rn(a[x].w, b[y].w, s);
        acc[x][y] = s;
      }
  }
}

// acc[x][4 q + s] += sum_k A[k][4 ty + x] B[k][4 tx + 32 q + s]
__device__ __forceinline__ void mma_tn(float (&acc)[4][8], const float* A,
                                       const float* B) {
  const int ty = gtid() / 8, tx = gtid() % 8;
#pragma unroll 4
  for (int k = 0; k < TILE; ++k) {
    const float4 a = lds4(A + k * LDT + 4 * ty);
    const float4 b0 = lds4(B + k * LDT + 4 * tx);
    const float4 b1 = lds4(B + k * LDT + 4 * tx + 32);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float ax = comp(a, x);
      acc[x][0] = __fmaf_rn(ax, b0.x, acc[x][0]);
      acc[x][1] = __fmaf_rn(ax, b0.y, acc[x][1]);
      acc[x][2] = __fmaf_rn(ax, b0.z, acc[x][2]);
      acc[x][3] = __fmaf_rn(ax, b0.w, acc[x][3]);
      acc[x][4] = __fmaf_rn(ax, b1.x, acc[x][4]);
      acc[x][5] = __fmaf_rn(ax, b1.y, acc[x][5]);
      acc[x][6] = __fmaf_rn(ax, b1.z, acc[x][6]);
      acc[x][7] = __fmaf_rn(ax, b1.w, acc[x][7]);
    }
  }
}

// acc[x][4 q + s] += sum_k A[ty + 16 x][k] B[k][4 tx + 32 q + s]
__device__ __forceinline__ void mma_nn(float (&acc)[4][8], const float* A,
                                       const float* B) {
  const int ty = gtid() / 8, tx = gtid() % 8;
#pragma unroll 2
  for (int k = 0; k < TILE; k += 4) {
    float4 a[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) a[x] = lds4(A + (ty + 16 * x) * LDT + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = lds4(B + (k + kk) * LDT + 4 * tx);
      const float4 b1 = lds4(B + (k + kk) * LDT + 4 * tx + 32);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float ax = comp(a[x], kk);
        acc[x][0] = __fmaf_rn(ax, b0.x, acc[x][0]);
        acc[x][1] = __fmaf_rn(ax, b0.y, acc[x][1]);
        acc[x][2] = __fmaf_rn(ax, b0.z, acc[x][2]);
        acc[x][3] = __fmaf_rn(ax, b0.w, acc[x][3]);
        acc[x][4] = __fmaf_rn(ax, b1.x, acc[x][4]);
        acc[x][5] = __fmaf_rn(ax, b1.y, acc[x][5]);
        acc[x][6] = __fmaf_rn(ax, b1.z, acc[x][6]);
        acc[x][7] = __fmaf_rn(ax, b1.w, acc[x][7]);
      }
    }
  }
}

// Dynamic shared memory of prep(): C's and B's tiles.
constexpr size_t PREP_SMEM = 2 * TILE_FLOATS * sizeof(float);

// Blocks [0, BC tiles): tile (ti, tj) of S = C Bᵀ of chunk blockIdx.x /
// tiles into S[bc][tile] as [i][j] (TRANSPOSED: as [j][i]), a product over
// N in steps of 64.  Blocks from BC tiles on: four (chunk, head) rows a
// block, one warp a row (32 entries a step with shuffles, the running
// total carried): cum[row][0][i] = cumsum(a[row])_i and cum[row][1][j] =
// exp(cum_{Q-1} - cum_j).
template <class T, bool TRANSPOSED>
__device__ __forceinline__ void prep(const T* __restrict__ a,
                                     const T* __restrict__ Bm,
                                     const T* __restrict__ Cm,
                                     float* __restrict__ S,
                                     float* __restrict__ cum, int BC, int Q,
                                     int H, int N, int nt, float* smem) {
  const int tiles = n_tiles(nt);
  const long long n_s = (long long)BC * tiles;
  if ((long long)blockIdx.x >= n_s) {
    const long long row = ((long long)blockIdx.x - n_s) * (THREADS / 32) +
                          threadIdx.x / 32;
    if (row >= (long long)BC * H) return;
    const T* ar = a + row * Q;
    float* cr = cum + row * 2 * Q;
    const int lane = threadIdx.x % 32;
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
    // carry is now cum_{Q-1}; each lane rereads only its own entries
    for (int j = lane; j < Q; j += 32)
      cr[Q + j] = expf(__fsub_rn(carry, cr[j]));
    return;
  }
  const int bc = blockIdx.x / tiles, t = blockIdx.x % tiles;
  int ti, tj;
  tile_of(t, ti, tj);
  float* Cs = smem;
  float* Bs = smem + TILE_FLOATS;
  const T* C = Cm + (size_t)bc * Q * N;
  const T* B = Bm + (size_t)bc * Q * N;
  float acc[4][8] = {};
  for (int n0 = 0; n0 < N; n0 += TILE) {
    if (n0) __syncthreads();
    stage(Cs, C, N, ti * TILE, Q, n0, N);
    stage(Bs, B, N, tj * TILE, Q, n0, N);
    __syncthreads();
    mma_nt(acc, Cs, Bs);
  }
  const int ty = gtid() / 8, tx = gtid() % 8;
  float* St = S + ((size_t)bc * tiles + t) * TILE * TILE;
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const int r = ty + 16 * x, c = tx + 8 * y;
      St[TRANSPOSED ? c * TILE + r : r * TILE + c] = acc[x][y];
    }
}

template <class Kernel>
int opt_in(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

}  // namespace
