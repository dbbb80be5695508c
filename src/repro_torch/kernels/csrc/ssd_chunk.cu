// The Mamba-2 SSD intra-chunk block for NVIDIA Hopper (sm_90a), in fp32 on
// CUDA cores, from fp32 or bf16 inputs.
//
//   fog_ssd_chunk   replaces repro/kernels/ssd_chunk.py::_ssd_chunk_kernel
//
// behind a plain C entry point that launches on the caller's stream and
// returns cudaGetLastError() (loaded with ctypes by
// repro_torch/kernels/_build.py, linked into the same library as the other
// kernels).  The wrapper (kernels/ssd_chunk.py::ssd_chunk_cuda) allocates
// the outputs and the fp32 scratch; the kernels allocate nothing.
//
// What it computes, per chunk bc = (batch, chunk) and head h, with
// x [BC, Q, H, P], a [BC, H, Q], B/C [BC, Q, N] in, all fp32 or all bf16:
//
//   scores[i, j] = sum_n C[i, n] B[j, n]                      (shared by heads)
//   cum          = cumsum(a[h])                                     [Q]
//   y[i, h, p]   = sum_{j <= i} scores[i, j] exp(cum_i - cum_j) x[j, h, p]
//   st[h, p, n]  = sum_j B[j, n] exp(cum_{Q-1} - cum_j) x[j, h, p]
//
// fp32 inside (loads convert, every sum is fp32, explicit _rn intrinsics:
// the build passes -fmad=false), y [BC, Q, H, P] and st [BC, H, P, N]
// written in x's dtype.  bf16 at the tensor cores' shapes (P = 64, N in
// {64, 128}) runs ssd_chunk_sm90.cu instead (kernels/ssd_chunk.py::route);
// this kernel takes fp32 at every shape and bf16 at the others.
//
// Design (the building blocks are ssd_simt.cuh's: 64 x 64 fp32 tiles with
// rows of 17 float4s, groups of 128 threads, 4 x 8 outputs a thread fed by
// float4 reads).  Two launches, the grids at the training shape (x [8, 1,
// 256, 80, 64], N = 128):
//   1. ssd_chunk_prep_kernel: C Bᵀ once per chunk, its tiles on or below
//      the diagonal transposed into an fp32 scratch [BC, tiles, 64, 64]
//      (recomputing it per head would cost H times its work), and every
//      (chunk, head)'s cumsum and end decays exp(cum_{Q-1} - cum_j) once,
//      a warp a row, into [BC, H, 2, Q]: 80 tile blocks and 160 blocks of
//      4 rows, 128 threads each.
//   2. ssd_chunk_fwd_kernel, one block of two 128-thread groups per (head,
//      chunk) (640): the block stages x's [Q, 64] column slice once and
//      both groups use it for both outputs, so x is read once.  Each group
//      walks its own list of tile products, the next one's loads in flight
//      during the current one's product: y's row tiles split between the
//      groups by their count of column tiles (at nt = 4: rows 3 and 0, 2
//      and 1, five products each), each over the tiles of j up to the
//      diagonal, the weight tile Wᵀ[j][i] = S[i, j] exp(cum_i - cum_j)
//      built in the group's shared tile from the scratch (0 above the
//      diagonal by a branch, never by a 0/1 multiply: there cum_i - cum_j
//      > 0 can overflow exp, and inf * 0 = NaN) and multiplied into the x
//      slice (mma_tn); then the states' 64-column tiles of N, alternately
//      (4 products each), B's rows scaled by the end decay multiplied with
//      the x slice (mma_tn).  P past 64 loops over 64-wide slices.
// A main block takes the x slice's nt tiles, one tile per group, the
// cumsum and the decays in shared memory: 106,496 B at Q = 256 (two blocks,
// 16 warps an SM); a prep block 34,816 B.
//
// Any 1 <= Q <= 256 (the cumsum of one head lives in shared memory; the
// wrapper refuses more) and any P and N: every tile masks its ragged edge.
// No atomics: every output and scratch entry is written once by one
// thread and every sum runs in a fixed order, so the result is the same
// bit for bit from run to run.
//
// What bounds it: at the training shape it moves 107.6 MB (x, a, B, C read
// once, y and the states written once; 0.032 ms at 3.35 TB/s) and needs
// 5.45 GFLOP (C Bᵀ and the weighted sum over the causal pairs, the states
// over the whole chunk; 0.081 ms at 67 TFLOP/s fp32), so operations bound
// it; this design runs 6.12 GFLOP (the diagonal tiles whole:
// chip_smoke.ssd_work's ops_simt).  PERF.md row 7 gives the measured time.

#include "ssd_simt.cuh"

namespace {

// a main block: two groups of THREADS, each with its own tile buffer
constexpr int FWD_THREADS = 2 * THREADS;

// dynamic shared memory of a main block: the x slice (nt tiles), a tile
// for each group's Wᵀ or decayed B rows, the cumsum and the end decays
__host__ __device__ constexpr size_t fwd_smem(int nt) {
  return ((size_t)(nt + 2) * TILE_FLOATS + 2 * MAX_Q) * sizeof(float);
}

template <class T>
__global__ void __launch_bounds__(THREADS) ssd_chunk_prep_kernel(
    const T* __restrict__ a, const T* __restrict__ Bm,
    const T* __restrict__ Cm, float* __restrict__ St,
    float* __restrict__ cum, int BC, int Q, int H, int N, int nt) {
  extern __shared__ __align__(16) float smem[];
  prep<T, true>(a, Bm, Cm, St, cum, BC, Q, H, N, nt, smem);
}

// One tile product of a group's list: y's (row tile a, column tile b) or
// the states' (64 columns a of N, row tile b of j); kind -1 ends the list.
struct Item {
  int kind, a, b;
};

// The group that computes y's row tile ti: the row tiles taken from the
// longest down (ti + 1 tile products each), each to the group with fewer
// products so far.
__device__ __forceinline__ int y_group(int ti, int nt) {
  int load0 = 0, load1 = 0, owner = 0;
  for (int t = nt - 1; t >= ti; --t) {
    owner = load1 < load0 ? 1 : 0;
    (owner ? load1 : load0) += t + 1;
  }
  return owner;
}

// group g's first item at or after y's row tile ti (descending), or its
// first states item
__device__ __forceinline__ Item y_from(int ti, int g, int nt, int n_nc) {
  for (; ti >= 0; --ti)
    if (y_group(ti, nt) == g) return {0, ti, 0};
  return g < n_nc ? Item{1, g, 0} : Item{-1, 0, 0};
}

// the item after it in group g's list: y's row tiles (each over its
// column tiles 0..ti), then the states' column tiles g, g + 2, ... (each
// over the row tiles of j)
__device__ __forceinline__ Item next_item(Item it, int g, int nt, int n_nc) {
  if (it.kind == 0)
    return it.b < it.a ? Item{0, it.a, it.b + 1}
                       : y_from(it.a - 1, g, nt, n_nc);
  if (it.b + 1 < nt) return {1, it.a, it.b + 1};
  return it.a + 2 < n_nc ? Item{1, it.a + 2, 0} : Item{-1, 0, 0};
}

// y and the states of head blockIdx.x, chunk blockIdx.y; the block's two
// groups share the x slice and split the tile products
template <class T>
__global__ void __launch_bounds__(FWD_THREADS) ssd_chunk_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ Bm,
    const float* __restrict__ St, const float* __restrict__ cum,
    T* __restrict__ y, T* __restrict__ states, int Q, int H, int P, int N,
    int nt) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, bc = blockIdx.y;
  const int g = threadIdx.x / THREADS;     // this thread's group
  float* Xs = smem;                        // [nt 64][LDT] x[:, h, p0:p0+64]
  float* Ws = Xs + (nt + g) * TILE_FLOATS; // [64][LDT] Wᵀ, or d o B rows
  float* cs = Xs + (nt + 2) * TILE_FLOATS; // [MAX_Q] cumsum
  float* ds = cs + MAX_Q;                  // [MAX_Q] end decays
  const int ty = gtid() / 8, tx = gtid() % 8;
  const float* cr = cum + ((size_t)bc * H + h) * 2 * Q;
  for (int i = threadIdx.x; i < Q; i += FWD_THREADS) {
    cs[i] = cr[i];
    ds[i] = cr[Q + i];
  }
  const size_t xrow = (size_t)H * P;       // elements between rows of x
  const T* xh = x + (size_t)bc * Q * xrow + (size_t)h * P;
  T* yh = y + (size_t)bc * Q * xrow + (size_t)h * P;
  T* sth = states + ((size_t)bc * H + h) * P * N;
  const T* B = Bm + (size_t)bc * Q * N;
  const float* Sc = St + (size_t)bc * n_tiles(nt) * TILE * TILE;
  const int n_nc = (N + TILE - 1) / TILE;
  float4 v[FRAG];        // the next item's loads, in flight during a product
  float sc[FRAG];        // the end decays of a states item's rows
  for (int p0 = 0; p0 < P; p0 += TILE) {
    __syncthreads();   // cs, ds written; the last slice's reads done
    for (int t = g; t < nt; t += 2)
      stage(Xs + t * TILE_FLOATS, xh, xrow, t * TILE, Q, p0, P);
    __syncthreads();
    // y[i, p] = sum_j W[i, j] x[j, p] over the tiles (ti, tj <= ti) of
    // this group's row tiles, then states[p, n] = sum_j x[j, p] d_j B[j,
    // n] over its 64-column tiles of n; the next item's S tile or B rows
    // loaded during a product
    Item it = y_from(nt - 1, g, nt, n_nc);
    if (it.kind == 0)
      fetch(v, Sc + (size_t)tile_index(it.a, 0) * TILE * TILE, TILE, 0,
            TILE, 0, TILE);
    else if (it.kind == 1)
      fetch(v, B, N, 0, Q, it.a * TILE, N);
    float acc[4][8] = {};
    while (it.kind >= 0) {
      sync_group(g);   // the last item's reads of Ws done
      if (it.kind == 0)
        put_w<true>(Ws, v, cs, it.a * TILE, it.b * TILE, Q);
      else {
        fetch_rows(sc, ds + it.b * TILE, Q - it.b * TILE);
        put_scaled(Ws, v, sc);
      }
      const Item nx = next_item(it, g, nt, n_nc);
      if (nx.kind == 0)
        fetch(v, Sc + (size_t)tile_index(nx.a, nx.b) * TILE * TILE, TILE,
              0, TILE, 0, TILE);
      else if (nx.kind == 1)
        fetch(v, B, N, nx.b * TILE, Q, nx.a * TILE, N);
      sync_group(g);
      if (it.kind == 0) {
        mma_tn(acc, Ws, Xs + it.b * TILE_FLOATS);
        if (it.b == it.a) {
#pragma unroll
          for (int xx = 0; xx < 4; ++xx) {
            const int i = it.a * TILE + 4 * ty + xx;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int p = p0 + 4 * tx + 32 * (c / 4) + c % 4;
              if (i < Q && p < P) st(yh + (size_t)i * xrow + p, acc[xx][c]);
              acc[xx][c] = 0.0f;
            }
          }
        }
      } else {
        mma_tn(acc, Xs + it.b * TILE_FLOATS, Ws);
        if (it.b == nt - 1) {
#pragma unroll
          for (int xx = 0; xx < 4; ++xx) {
            const int p = p0 + 4 * ty + xx;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int n = it.a * TILE + 4 * tx + 32 * (c / 4) + c % 4;
              if (p < P && n < N) st(sth + (size_t)p * N + n, acc[xx][c]);
              acc[xx][c] = 0.0f;
            }
          }
        }
      }
      it = nx;
    }
  }
}

template <class T>
int launch_all(const void* x, const void* a, const void* Bm, const void* Cm,
               void* y, void* states, float* St, float* cum, int BC, int Q,
               int H, int P, int N, cudaStream_t stream) {
  const int nt = (Q + TILE - 1) / TILE;
  const long long prep_blocks = (long long)BC * n_tiles(nt) +
                                ((long long)BC * H + 3) / 4;
  if (prep_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  ssd_chunk_prep_kernel<T><<<(unsigned)prep_blocks, THREADS, PREP_SMEM,
                             stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), St, cum, BC, Q, H, N, nt);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const size_t smem = fwd_smem(nt);
  err = opt_in(ssd_chunk_fwd_kernel<T>, smem);
  if (err) return err;
  ssd_chunk_fwd_kernel<T><<<dim3(H, BC), FWD_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bm), St, cum,
      static_cast<T*>(y), static_cast<T*>(states), Q, H, P, N, nt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype 0: every tensor fp32; 1: every tensor bf16 for x, a, Bm, Cm, y,
// states.  fp32 scratch from the wrapper: St [BC, tiles, 64, 64] (tiles =
// nt (nt + 1) / 2, nt = ceil(Q / 64)) and cum [BC, H, 2, Q].
int fog_ssd_chunk(int dtype, const void* x, const void* a, const void* Bm,
                  const void* Cm, void* y, void* states, void* St, void* cum,
                  int BC, int Q, int H, int P, int N, void* stream) {
  if (Q < 1 || Q > MAX_Q || BC < 1 || H < 1 || P < 1 || N < 1 ||
      BC > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fS = static_cast<float*>(St);
  float* fc = static_cast<float*>(cum);
  if (dtype == 0)
    return launch_all<float>(x, a, Bm, Cm, y, states, fS, fc, BC, Q, H, P,
                             N, s);
  return launch_all<__nv_bfloat16>(x, a, Bm, Cm, y, states, fS, fc, BC, Q,
                                   H, P, N, s);
}

}  // extern "C"
