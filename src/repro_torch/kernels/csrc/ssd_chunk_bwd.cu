// The backward of the Mamba-2 SSD intra-chunk block for NVIDIA Hopper
// (sm_90a), in fp32 on CUDA cores, from fp32 or bf16 inputs.
//
//   fog_ssd_chunk_bwd   the gradient of fog_ssd_chunk (ssd_chunk.cu); it
//                       replaces no TPU kernel: the JAX package takes it
//                       with jax.grad of the einsum branch of
//                       repro/models/mamba2.py::ssd_chunked
//
// behind a plain C entry point that launches five kernels in order on the
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
//   dC   = dS B,  dB = dS^T C + sum_h d o (x_h dst_h)    xdst, dbdc_kernel
//   t_h  = (dy_h x_h^T) o W_h:  dcum_i += sum_j t_ij,  dcum_j -= sum_i t_ij
//   e_j  = d_j sum_p x_jp G_jp:  dcum_{Q-1} += sum_j e_j,  dcum_j -= e_j
//   da_h = reverse cumsum of dcum_h                            dbdc_kernel
//
// Design (the building blocks are ssd_simt.cuh's: 64 x 64 fp32 tiles with
// rows of 17 float4s, 128 threads a block, 4 x 8 outputs a thread fed by
// float4 reads).  The heads are cut into groups of hpg
// (kernels/ssd_chunk.py::simt_bwd_heads_per_group: enough groups that the
// dS pass has about four blocks an SM at Q = 256; at the training shape
// x [8, 1, 256, 80, 64], N = 128: 12 heads, 7 groups).  Each pass walks
// its tile products in a fixed order and loads the next one's tiles into
// registers during the current one's product.  Five launches, the grids
// at the training shape:
//   1. prep_kernel: S's tiles on or below the diagonal into a scratch [BC,
//      tiles, 64, 64] (80 blocks) and each (chunk, head)'s cumsum and end
//      decays, a warp a row (160 blocks of 4 rows).
//   2. ds_kernel, one block per (tile, group, chunk) (10 x 7 x 8 = 560):
//      per head of the group the tile of dW = dy_h x_h^T (mma_nt over P),
//      summed into the group's dS with L_h in registers, and t_h's row and
//      column sums over the tile by shuffles (the columns' four warps
//      summed in order), written per head; the group's partial dS tile is
//      written once to [BC, groups, tiles, 64, 64].
//   3. dx_kernel, one block per (64-row tile of j, head, chunk) (4 x 80 x
//      8 = 2560): G_h's tile (mma_nt over N) into shared memory, then dx =
//      W^T dy over the tiles of i from the diagonal down (the W tile built
//      from S's scratch and the cumsum, mma_tn), dx + d o G stored and e_j
//      summed by shuffles.
//   4. xdst_kernel, one block per (64-row tile of j, 64 columns of n,
//      group, chunk) (4 x 2 x 7 x 8 = 448): the split-K product sum_h d_h o
//      (x_h dst_h), [Q, H P] x [H P, N] over the group's heads (mma_nn),
//      into a partial [BC, groups, Q, N].
//   5. dbdc_kernel: per (chunk, 64-row tile, 64 columns of n) one block
//      for dC = dS B (mma_nn) and one for dB = dS^T C (mma_tn) plus the
//      x dst partials (2 x 8 x 4 x 2 = 128 blocks), each dS tile staged as
//      the sum of its group partials in group order; then 4 (chunk, head)
//      rows a block for da (160): dcum from the tile sums and e, then a
//      reverse warp scan.
// Shared memory a block: ds 53,760 B (dy, x and S tiles, the cumsum, the
// column sums), dx 53,248 B (its launch bounds ask for three blocks an SM:
// at most 168 registers a thread), xdst and dbdc 34,816 B, prep 34,816 B.  The
// fp32 scratch at the training shape: S 1.3 MB, cumsums 1.3 MB, partial dS
// 9.2 MB, tile sums 5.2 MB, e 0.7 MB, x dst partials 7.3 MB (25.0 MB).
//
// No atomics: every output and every scratch entry is written once by one
// thread, each sum taken in a fixed order (the group partials in group
// order), so the result is the same bit for bit from run to run.  Any 1 <=
// Q <= 256 (the cumsum of one head lives in shared memory) and any P and
// N: every tile masks its ragged edge; H need not be a multiple of hpg.
// Above the diagonal cum_i - cum_j > 0 can overflow exp, so those entries
// are 0 by a branch, never by a 0/1 multiply (inf * 0 = NaN).
//
// What bounds it: at the training shape it moves ~151 MB (x, dy, dx, dst,
// a, da, B, C, dB, dC once each; 0.045 ms at 3.35 TB/s) and needs 10.96
// GFLOP (the four Q x Q x P or Q x P x N products per (chunk, head) over
// the causal half or the whole chunk, and S and its two products per
// chunk; 0.164 ms at 67 TFLOP/s fp32), so operations bound it.  This
// design runs 12.33 GFLOP (the diagonal tiles whole: chip_smoke.
// ssd_bwd_work's simt_ops); PERF.md row 7b gives the measured time.  bf16 inputs halve the bytes, not the operations.
// bf16 at the forward's tensor-core shapes (P = 64, N in {64, 128}: the
// mamba2 and jamba training path) runs ssd_chunk_bwd_sm90.cu instead
// (kernels/ssd_chunk.py::route); this kernel takes fp32 and bf16 at every
// other shape.

#include "ssd_simt.cuh"

namespace {

// dynamic shared memory of each pass
constexpr size_t DS_SMEM =
    (3 * TILE_FLOATS + 2 * TILE + 4 * TILE) * sizeof(float);
constexpr size_t DX_SMEM = (3 * TILE_FLOATS + MAX_Q) * sizeof(float);
constexpr size_t TWO_TILES_SMEM = 2 * TILE_FLOATS * sizeof(float);

template <class T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_prep_kernel(
    const T* __restrict__ a, const T* __restrict__ Bm,
    const T* __restrict__ Cm, float* __restrict__ S,
    float* __restrict__ cum, int BC, int Q, int H, int N, int nt) {
  extern __shared__ __align__(16) float smem[];
  prep<T, false>(a, Bm, Cm, S, cum, BC, Q, H, N, nt, smem);
}

// Tile blockIdx.x = (ti, tj) of chunk blockIdx.z over the heads of group
// blockIdx.y: the group's partial dS tile into dSp[bc, g, tile], t's row
// sums into part[bc, h, 0, tj, i] and column sums into part[bc, h, 1, ti,
// j] for each head.
template <class T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_ds_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ S, const float* __restrict__ cum,
    float* __restrict__ dSp, float* __restrict__ part, int Q, int H, int P,
    int nt, int hpg) {
  extern __shared__ __align__(16) float smem[];
  float* Ys = smem;                     // dy rows i
  float* Xs = Ys + TILE_FLOATS;         // x rows j
  float* Ss = Xs + TILE_FLOATS;         // S's tile [i][j]
  float* ci = Ss + TILE_FLOATS;         // [64] cum at the rows i
  float* cj = ci + TILE;                // [64] cum at the columns j
  float* red = cj + TILE;               // [4 warps][64] column sums
  const int t = blockIdx.x, g = blockIdx.y, bc = blockIdx.z;
  const int tiles = n_tiles(nt);
  int ti, tj;
  tile_of(t, ti, tj);
  const int i0 = ti * TILE, j0 = tj * TILE;
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int warp = tid / 32, lane = tid % 32;
  const float* Sg = S + ((size_t)bc * tiles + t) * TILE * TILE;
  for (int idx = tid; idx < TILE * TILE / 4; idx += THREADS) {
    const int r = idx / (TILE / 4), c = 4 * (idx % (TILE / 4));
    *reinterpret_cast<float4*>(Ss + r * LDT + c) =
        *reinterpret_cast<const float4*>(Sg + r * TILE + c);
  }
  const size_t xrow = (size_t)H * P;
  float dsacc[4][8] = {};
  const int h_end = min(H, (g + 1) * hpg);
  // items (head h, 64 columns p0 of P), the heads in order; the next
  // item's dy and x tiles, and at a head's first item the cumsum at this
  // thread's row (tid < 64) or column, loaded during a product
  const int c_at = tid < TILE ? i0 + tid : j0 + tid - TILE;
  float4 va[FRAG], vb[FRAG];
  float cv = 0.0f;
  int h = g * hpg, p0 = 0;
  if (h < h_end) {
    const size_t at = (size_t)bc * Q * xrow + (size_t)h * P;
    fetch(va, dy + at, xrow, i0, Q, 0, P);
    fetch(vb, x + at, xrow, j0, Q, 0, P);
    cv = c_at < Q ? cum[((size_t)bc * H + h) * 2 * Q + c_at] : 0.0f;
  }
  float dw[4][8] = {};
  while (h < h_end) {
    __syncthreads();   // the last item's reads of Ys, Xs, ci, cj, red done
    put(Ys, va);
    put(Xs, vb);
    if (p0 == 0) (tid < TILE ? ci[tid] : cj[tid - TILE]) = cv;
    const bool last = p0 + TILE >= P;
    const int nh = last ? h + 1 : h, np = last ? 0 : p0 + TILE;
    if (nh < h_end) {
      const size_t at = (size_t)bc * Q * xrow + (size_t)nh * P;
      fetch(va, dy + at, xrow, i0, Q, np, P);
      fetch(vb, x + at, xrow, j0, Q, np, P);
      if (np == 0)
        cv = c_at < Q ? cum[((size_t)bc * H + nh) * 2 * Q + c_at] : 0.0f;
    }
    __syncthreads();
    mma_nt(dw, Ys, Xs);
    if (last) {
      // rows i = i0 + ty + 16 x, columns j = j0 + tx + 8 y
      float rs[4] = {}, cs[8] = {};
#pragma unroll
      for (int xx = 0; xx < 4; ++xx) {
        const int ii = ty + 16 * xx, i = i0 + ii;
#pragma unroll
        for (int yy = 0; yy < 8; ++yy) {
          const int jj = tx + 8 * yy, j = j0 + jj;
          if (i < Q && j <= i) {
            const float L = expf(__fsub_rn(ci[ii], cj[jj]));
            dsacc[xx][yy] = __fmaf_rn(dw[xx][yy], L, dsacc[xx][yy]);
            const float tv =
                __fmul_rn(__fmul_rn(dw[xx][yy], Ss[ii * LDT + jj]), L);
            rs[xx] = __fadd_rn(rs[xx], tv);
            cs[yy] = __fadd_rn(cs[yy], tv);
          }
          dw[xx][yy] = 0.0f;
        }
      }
      float* ph = part + ((size_t)bc * H + h) * 2 * nt * Q;
      // a row's 8 threads are 8 consecutive lanes
#pragma unroll
      for (int xx = 0; xx < 4; ++xx)
#pragma unroll
        for (int off = 4; off > 0; off >>= 1)
          rs[xx] = __fadd_rn(rs[xx], __shfl_xor_sync(FULL, rs[xx], off));
      if (tx == 0) {
#pragma unroll
        for (int xx = 0; xx < 4; ++xx) {
          const int i = i0 + ty + 16 * xx;
          if (i < Q) ph[(size_t)tj * Q + i] = rs[xx];
        }
      }
      // a column's 16 threads: 4 in each warp, lanes 8 apart; then the
      // warps in order
#pragma unroll
      for (int yy = 0; yy < 8; ++yy) {
        cs[yy] = __fadd_rn(cs[yy], __shfl_xor_sync(FULL, cs[yy], 8));
        cs[yy] = __fadd_rn(cs[yy], __shfl_xor_sync(FULL, cs[yy], 16));
      }
      if (lane < 8) {
#pragma unroll
        for (int yy = 0; yy < 8; ++yy)
          red[warp * TILE + tx + 8 * yy] = cs[yy];
      }
      __syncthreads();
      if (tid < TILE) {
        const int j = j0 + tid;
        float v = __fadd_rn(red[tid], red[TILE + tid]);
        v = __fadd_rn(v, red[2 * TILE + tid]);
        v = __fadd_rn(v, red[3 * TILE + tid]);
        if (j < Q) ph[(size_t)(nt + ti) * Q + j] = v;
      }
    }
    h = nh;
    p0 = np;
  }
  float* out = dSp + (((size_t)bc * gridDim.y + g) * tiles + t) * TILE * TILE;
#pragma unroll
  for (int xx = 0; xx < 4; ++xx)
#pragma unroll
    for (int yy = 0; yy < 8; ++yy)
      out[(ty + 16 * xx) * TILE + tx + 8 * yy] = dsacc[xx][yy];
}

// dx for the 64 rows j of tile blockIdx.x, head blockIdx.y, chunk
// blockIdx.z, and e[bc, h, j].
template <class T>
__global__ void __launch_bounds__(THREADS, 3) ssd_bwd_dx_kernel(
    const T* __restrict__ x, const T* __restrict__ Bm,
    const T* __restrict__ dy, const T* __restrict__ dst,
    const float* __restrict__ S, const float* __restrict__ cum,
    float* __restrict__ e, T* __restrict__ dx, int Q, int H, int P, int N,
    int nt) {
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;                     // W tile [i][j]; B rows j for G
  float* Ys = Ws + TILE_FLOATS;         // dy rows i; dst rows p for G
  float* Gs = Ys + TILE_FLOATS;         // G [j][p]
  float* ch = Gs + TILE_FLOATS;         // [MAX_Q] cumsum
  const int tj = blockIdx.x, h = blockIdx.y, bc = blockIdx.z;
  const int j0 = tj * TILE;
  const int tiles = n_tiles(nt);
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const float* cr = cum + ((size_t)bc * H + h) * 2 * Q;
  for (int i = tid; i < Q; i += THREADS) ch[i] = cr[i];
  // this thread's rows j = j0 + 4 ty + x (mma_tn's) and their end decays
  float dj[4];
#pragma unroll
  for (int xx = 0; xx < 4; ++xx) {
    const int j = j0 + 4 * ty + xx;
    dj[xx] = j < Q ? cr[Q + j] : 0.0f;
  }
  const size_t xrow = (size_t)H * P;
  const T* B = Bm + (size_t)bc * Q * N;
  const T* dsth = dst + ((size_t)bc * H + h) * P * N;
  const T* dyh = dy + (size_t)bc * Q * xrow + (size_t)h * P;
  const T* xh = x + (size_t)bc * Q * xrow + (size_t)h * P;
  T* dxh = dx + (size_t)bc * Q * xrow + (size_t)h * P;
  const float* Sc = S + (size_t)bc * tiles * TILE * TILE;
  float ee[4] = {};
  const int n_nc = (N + TILE - 1) / TILE;
  float4 va[FRAG], vb[FRAG];   // the next step's tiles, loaded during a product
  for (int p0 = 0; p0 < P; p0 += TILE) {
    // G[j, p] = sum_n B[j, n] dst[p, n] over N's 64-column steps, held as
    // mma_nt's rows and columns
    fetch(va, B, N, j0, Q, 0, N);
    fetch(vb, dsth, N, p0, P, 0, N);
    float g[4][8] = {};
    for (int k = 0; k < n_nc; ++k) {
      __syncthreads();   // ch written; the last tiles' reads done
      put(Ws, va);
      put(Ys, vb);
      if (k + 1 < n_nc) {
        fetch(va, B, N, j0, Q, (k + 1) * TILE, N);
        fetch(vb, dsth, N, p0, P, (k + 1) * TILE, N);
      } else {   // dx's first tiles
        fetch(va, Sc + (size_t)tile_index(tj, tj) * TILE * TILE, TILE, 0,
              TILE, 0, TILE);
        fetch(vb, dyh, xrow, tj * TILE, Q, p0, P);
      }
      __syncthreads();
      mma_nt(g, Ws, Ys);
    }
#pragma unroll
    for (int xx = 0; xx < 4; ++xx)
#pragma unroll
      for (int yy = 0; yy < 8; ++yy)
        Gs[(ty + 16 * xx) * LDT + tx + 8 * yy] = g[xx][yy];
    // dx[j, p] = sum_{i >= j} W[i, j] dy[i, p], the tiles of i from the
    // diagonal down (at least one: tj < nt)
    float acc[4][8] = {};
    for (int ti = tj; ti < nt; ++ti) {
      __syncthreads();   // Gs written; the last tiles' reads done
      put_w<false>(Ws, va, ch, ti * TILE, j0, Q);
      put(Ys, vb);
      if (ti + 1 < nt) {
        fetch(va, Sc + (size_t)tile_index(ti + 1, tj) * TILE * TILE, TILE,
              0, TILE, 0, TILE);
        fetch(vb, dyh, xrow, (ti + 1) * TILE, Q, p0, P);
      }
      __syncthreads();
      mma_tn(acc, Ws, Ys);
    }
#pragma unroll
    for (int xx = 0; xx < 4; ++xx) {
      const int jl = 4 * ty + xx, j = j0 + jl;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 gv = lds4(Gs + jl * LDT + 4 * tx + 32 * q);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int p = p0 + 4 * tx + 32 * q + s;
          if (j < Q && p < P) {
            const size_t at = (size_t)j * xrow + p;
            const float gs = comp(gv, s);
            st(dxh + at, __fmaf_rn(dj[xx], gs, acc[xx][4 * q + s]));
            ee[xx] = __fmaf_rn(ld(xh + at), gs, ee[xx]);
          }
        }
      }
    }
  }
  // a row's 8 threads are 8 consecutive lanes
#pragma unroll
  for (int xx = 0; xx < 4; ++xx)
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      ee[xx] = __fadd_rn(ee[xx], __shfl_xor_sync(FULL, ee[xx], off));
  if (tx == 0) {
#pragma unroll
    for (int xx = 0; xx < 4; ++xx) {
      const int j = j0 + 4 * ty + xx;
      if (j < Q) e[((size_t)bc * H + h) * Q + j] = __fmul_rn(ee[xx], dj[xx]);
    }
  }
}

// One group's share of sum_h d_h o (x_h dst_h) for the 64 rows j of tile
// blockIdx.x / n_nc and 64 columns n of tile blockIdx.x % n_nc, group
// blockIdx.y, chunk blockIdx.z, into xdp[bc, g, j, n].
template <class T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_xdst_kernel(
    const T* __restrict__ x, const T* __restrict__ dst,
    const float* __restrict__ cum, float* __restrict__ xdp, int Q, int H,
    int P, int N, int hpg, int n_nc) {
  extern __shared__ __align__(16) float smem[];
  float* Xd = smem;                     // d_h o x_h rows j
  float* Ds = Xd + TILE_FLOATS;         // dst_h rows p
  const int rt = blockIdx.x / n_nc, nc = blockIdx.x % n_nc;
  const int g = blockIdx.y, bc = blockIdx.z;
  const int j0 = rt * TILE, n0 = nc * TILE;
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const size_t xrow = (size_t)H * P;
  float acc[4][8] = {};
  const int h_end = min(H, (g + 1) * hpg);
  // items (head h, 64 columns p0 of P), the heads in order; the next
  // item's x rows, their end decays d_h[j] and dst rows loaded during a
  // product
  float4 va[FRAG], vb[FRAG];
  float sc[FRAG];
  int h = g * hpg, p0 = 0;
  if (h < h_end) {
    fetch(va, x + (size_t)bc * Q * xrow + (size_t)h * P, xrow, j0, Q, 0, P);
    fetch_rows(sc, cum + ((size_t)bc * H + h) * 2 * Q + Q + j0, Q - j0);
    fetch(vb, dst + ((size_t)bc * H + h) * P * N, N, 0, P, n0, N);
  }
  while (h < h_end) {
    __syncthreads();   // the last item's reads done
    put_scaled(Xd, va, sc);
    put(Ds, vb);
    const bool last = p0 + TILE >= P;
    const int nh = last ? h + 1 : h, np = last ? 0 : p0 + TILE;
    if (nh < h_end) {
      fetch(va, x + (size_t)bc * Q * xrow + (size_t)nh * P, xrow, j0, Q, np,
            P);
      fetch_rows(sc, cum + ((size_t)bc * H + nh) * 2 * Q + Q + j0, Q - j0);
      fetch(vb, dst + ((size_t)bc * H + nh) * P * N, N, np, P, n0, N);
    }
    __syncthreads();
    mma_nn(acc, Xd, Ds);
    h = nh;
    p0 = np;
  }
  float* out = xdp + ((size_t)bc * gridDim.y + g) * Q * N;
#pragma unroll
  for (int xx = 0; xx < 4; ++xx) {
    const int j = j0 + ty + 16 * xx;
    if (j >= Q) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = n0 + 4 * tx + 32 * (c / 4) + c % 4;
      if (n < N) out[(size_t)j * N + n] = acc[xx][c];
    }
  }
}

// dS's tile t of chunk bc, the sum of its G group partials in group order,
// into dst (rows LDT floats apart)
__device__ __forceinline__ void stage_ds(float* dst, const float* dSp,
                                         int bc, int G, int tiles, int t) {
  const float* src = dSp + ((size_t)bc * G * tiles + t) * TILE * TILE;
  const size_t group = (size_t)tiles * TILE * TILE;
  float4 v[FRAG], u[FRAG];
  fetch(v, src, TILE, 0, TILE, 0, TILE);
  for (int gg = 1; gg < G; ++gg) {
    fetch(u, src + gg * group, TILE, 0, TILE, 0, TILE);
#pragma unroll
    for (int m = 0; m < FRAG; ++m)
      v[m] = make_float4(__fadd_rn(v[m].x, u[m].x), __fadd_rn(v[m].y, u[m].y),
                         __fadd_rn(v[m].z, u[m].z), __fadd_rn(v[m].w, u[m].w));
  }
  put(dst, v);
}

// Blocks [0, 2 BC nt n_nc): block 2 k is dC, 2 k + 1 dB, for (chunk, 64-row
// tile, 64 columns of n) k; then four (chunk, head) rows a block for da, a
// warp a row.
template <class T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_dbdc_kernel(
    const T* __restrict__ Bm, const T* __restrict__ Cm,
    const float* __restrict__ dSp, const float* __restrict__ xdp,
    const float* __restrict__ part, const float* __restrict__ e,
    T* __restrict__ dB, T* __restrict__ dC, T* __restrict__ da, int BC,
    int Q, int H, int N, int nt, int G, int n_nc) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const long long n_tile_blocks = 2LL * BC * nt * n_nc;
  if ((long long)blockIdx.x >= n_tile_blocks) {
    const long long row = ((long long)blockIdx.x - n_tile_blocks) *
                              (THREADS / 32) + tid / 32;   // bc * H + h
    if (row >= (long long)BC * H) return;
    const int lane = tid % 32;
    float* dcum = smem + (tid / 32) * MAX_Q;
    const float* ph = part + row * 2 * nt * Q;
    const float* er = e + row * Q;
    float esum = 0.0f;
    for (int k = lane; k < Q; k += 32) {
      const int t = k / TILE;
      float v = 0.0f;
      for (int u = 0; u <= t; ++u) v = __fadd_rn(v, ph[(size_t)u * Q + k]);
      for (int u = t; u < nt; ++u)
        v = __fsub_rn(v, ph[(size_t)(nt + u) * Q + k]);
      dcum[k] = __fsub_rn(v, er[k]);
      esum = __fadd_rn(esum, er[k]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      esum = __fadd_rn(esum, __shfl_xor_sync(FULL, esum, off));
    __syncwarp();
    if (lane == 0) dcum[Q - 1] = __fadd_rn(dcum[Q - 1], esum);
    __syncwarp();
    // da[k] = sum_{k' >= k} dcum[k'], 32 entries a step from the end
    T* dr = da + row * Q;
    float carry = 0.0f;
    for (int base = 0; base < Q; base += 32) {
      const int k = Q - 1 - base - lane;
      float v = k >= 0 ? dcum[k] : 0.0f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(FULL, v, off);
        if (lane >= off) v = __fadd_rn(v, n);
      }
      v = __fadd_rn(v, carry);
      if (k >= 0) st(dr + k, v);
      carry = __shfl_sync(FULL, v, 31);
    }
    return;
  }
  const int which = blockIdx.x % 2;                 // 0: dC, 1: dB
  const int k = blockIdx.x / 2;
  const int bc = k / (nt * n_nc), r = (k / n_nc) % nt, nc = k % n_nc;
  const int r0 = r * TILE, n0 = nc * TILE;
  const int tiles = n_tiles(nt);
  float* Ds = smem;                     // dS's tile [i][j]
  float* Vs = Ds + TILE_FLOATS;         // B's or C's rows
  float acc[4][8] = {};
  if (which == 0) {
    // dC[i, n] = sum_{j <= i} dS[i, j] B[j, n], rows i = r0 + ty + 16 x
    const T* B = Bm + (size_t)bc * Q * N;
    for (int tj = 0; tj <= r; ++tj) {
      __syncthreads();
      stage_ds(Ds, dSp, bc, G, tiles, tile_index(r, tj));
      stage(Vs, B, N, tj * TILE, Q, n0, N);
      __syncthreads();
      mma_nn(acc, Ds, Vs);
    }
    T* out = dC + (size_t)bc * Q * N;
#pragma unroll
    for (int xx = 0; xx < 4; ++xx) {
      const int i = r0 + ty + 16 * xx;
      if (i >= Q) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int n = n0 + 4 * tx + 32 * (c / 4) + c % 4;
        if (n < N) st(out + (size_t)i * N + n, acc[xx][c]);
      }
    }
    return;
  }
  // dB[j, n] = sum_{i >= j} dS[i, j] C[i, n] + sum_g xdp[g, j, n], rows
  // j = r0 + 4 ty + x
  const T* C = Cm + (size_t)bc * Q * N;
  for (int ti = r; ti < nt; ++ti) {
    __syncthreads();
    stage_ds(Ds, dSp, bc, G, tiles, tile_index(ti, r));
    stage(Vs, C, N, ti * TILE, Q, n0, N);
    __syncthreads();
    mma_tn(acc, Ds, Vs);
  }
  // + the x dst partials, summed in group order (each group's 32 loads
  // independent)
  T* out = dB + (size_t)bc * Q * N;
  const float* xd = xdp + (size_t)bc * G * Q * N;
  float xs[4][8];
  for (int gg = 0; gg < G; ++gg) {
#pragma unroll
    for (int xx = 0; xx < 4; ++xx) {
      const int j = r0 + 4 * ty + xx;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int n = n0 + 4 * tx + 32 * (c / 4) + c % 4;
        const float u = j < Q && n < N
                            ? xd[(size_t)gg * Q * N + (size_t)j * N + n]
                            : 0.0f;
        xs[xx][c] = gg ? __fadd_rn(xs[xx][c], u) : u;
      }
    }
  }
#pragma unroll
  for (int xx = 0; xx < 4; ++xx) {
    const int j = r0 + 4 * ty + xx;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = n0 + 4 * tx + 32 * (c / 4) + c % 4;
      if (j < Q && n < N)
        st(out + (size_t)j * N + n, __fadd_rn(acc[xx][c], xs[xx][c]));
    }
  }
}

template <class T>
int launch(const void* x, const void* a, const void* Bm, const void* Cm,
           const void* dy, const void* dst, float* S, float* cum, float* dSp,
           float* part, float* e, float* xdp, void* dx, void* da, void* dB,
           void* dC, int BC, int Q, int H, int P, int N, int hpg,
           cudaStream_t s) {
  const T* tx = static_cast<const T*>(x);
  const T* tB = static_cast<const T*>(Bm);
  const T* tC = static_cast<const T*>(Cm);
  const T* tdy = static_cast<const T*>(dy);
  const T* tdst = static_cast<const T*>(dst);
  const int nt = (Q + TILE - 1) / TILE, tiles = n_tiles(nt);
  const int G = (H + hpg - 1) / hpg, n_nc = (N + TILE - 1) / TILE;
  const long long rows4 = ((long long)BC * H + 3) / 4;
  const long long prep_blocks = (long long)BC * tiles + rows4;
  const long long dbdc_blocks = 2LL * BC * nt * n_nc + rows4;
  if (G > 65535 || (long long)nt * n_nc > 0x7fffffffLL ||
      prep_blocks > 0x7fffffffLL || dbdc_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = opt_in(ssd_bwd_ds_kernel<T>, DS_SMEM);
  if (!err) err = opt_in(ssd_bwd_dx_kernel<T>, DX_SMEM);
  if (err) return err;
  ssd_bwd_prep_kernel<T><<<(unsigned)prep_blocks, THREADS, PREP_SMEM, s>>>(
      static_cast<const T*>(a), tB, tC, S, cum, BC, Q, H, N, nt);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ssd_bwd_ds_kernel<T><<<dim3(tiles, G, BC), THREADS, DS_SMEM, s>>>(
      tx, tdy, S, cum, dSp, part, Q, H, P, nt, hpg);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ssd_bwd_dx_kernel<T><<<dim3(nt, H, BC), THREADS, DX_SMEM, s>>>(
      tx, tB, tdy, tdst, S, cum, e, static_cast<T*>(dx), Q, H, P, N, nt);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ssd_bwd_xdst_kernel<T><<<dim3(nt * n_nc, G, BC), THREADS, TWO_TILES_SMEM,
                           s>>>(tx, tdst, cum, xdp, Q, H, P, N, hpg, n_nc);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ssd_bwd_dbdc_kernel<T><<<(unsigned)dbdc_blocks, THREADS, TWO_TILES_SMEM,
                           s>>>(tB, tC, dSp, xdp, part, e,
                                static_cast<T*>(dB), static_cast<T*>(dC),
                                static_cast<T*>(da), BC, Q, H, N, nt, G,
                                n_nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype 0: fp32, 1: bf16 for x, a, Bm, Cm, dy, dst and the outputs dx,
// da, dB, dC.  fp32 scratch from the wrapper (nt = ceil(Q / 64), tiles =
// nt (nt + 1) / 2, G = ceil(H / hpg)): S [BC, tiles, 64, 64], cum [BC, H,
// 2, Q], dSp [BC, G, tiles, 64, 64], part [BC, H, 2, nt, Q], e [BC, H, Q],
// xdp [BC, G, Q, N].
int fog_ssd_chunk_bwd(int dtype, const void* x, const void* a,
                      const void* Bm, const void* Cm, const void* dy,
                      const void* dst, void* S, void* cum, void* dSp,
                      void* part, void* e, void* xdp, void* dx, void* da,
                      void* dB, void* dC, int BC, int Q, int H, int P, int N,
                      int hpg, void* stream) {
  if (Q < 1 || Q > MAX_Q || BC < 1 || H < 1 || P < 1 || N < 1 || hpg < 1 ||
      BC > 65535 || H > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f[6] = {static_cast<float*>(S), static_cast<float*>(cum),
                 static_cast<float*>(dSp), static_cast<float*>(part),
                 static_cast<float*>(e), static_cast<float*>(xdp)};
  if (dtype == 0)
    return launch<float>(x, a, Bm, Cm, dy, dst, f[0], f[1], f[2], f[3],
                         f[4], f[5], dx, da, dB, dC, BC, Q, H, P, N, hpg, s);
  return launch<__nv_bfloat16>(x, a, Bm, Cm, dy, dst, f[0], f[1], f[2],
                               f[3], f[4], f[5], dx, da, dB, dC, BC, Q, H, P,
                               N, hpg, s);
}

}  // extern "C"
