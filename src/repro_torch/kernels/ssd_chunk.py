"""The Mamba-2 SSD intra-chunk block, on the card.

Replaces ``repro/kernels/ssd_chunk.py::_ssd_chunk_kernel`` (Pallas TPU)
with two CUDA kernels.  :func:`route` picks one by the dtype and the shapes
alone, a documented rule, never by a failure:

* ``"sm90"``, bf16 with head size ``P = 64``, state ``N`` in ``{64, 128}``
  and ``1 <= Q <= 256`` (``mamba2-2.7b``'s and ``jamba-1.5-large``'s SSM
  layers: P = 64, N = 128, Q = 256): ``csrc/ssd_chunk_sm90.cu``, on the
  tensor cores.  One block per (chunk, group of
  :func:`sm90_heads_per_block` heads) loads the chunk's C and B once by
  TMA; per head a producer warp scans ``a`` into the cumsum and loads
  ``xbar``'s ``[Q, 64]`` tile by TMA into a two-stage ring, and two
  consumer warpgroups compute ``C·Bᵀ``, the decay-weighted ``W`` (rounded
  to bf16) and ``W·x̄`` with ``wgmma``, then the states from
  ``bf16(x̄·decay)ᵀ·B``.  Every TMA operand must start on a 16-byte
  boundary; ``_build.check_tma`` checks that before the launch.
* ``"simt"``, every other case (fp32 included): ``csrc/ssd_chunk.cu``,
  two launches on CUDA cores, fp32 inside, which keeps fp32 within ~1e-4
  of the output's scale: ``C·Bᵀ``'s tiles on or below the diagonal once
  per chunk and every (chunk, head)'s cumsum once into an fp32 scratch
  (:func:`simt_plan`), then one block per (head, chunk) that stages x's
  column slice once and computes both ``y`` and the states from it, 4 x 8
  outputs a thread fed by float4 reads of shared-memory tiles.

Both write ``y`` and the states in ``xbar``'s dtype; each C entry point
counts as one launch.  The sources' headers say what bounds each.  The
plain version is :func:`ssd_chunk_ref`, which ``kernels.ref`` re-exports.

The backward (the gradient the JAX package takes with ``jax.grad`` of the
einsum branch of ``models/mamba2.py::ssd_chunked``) takes the forward's
rule, :func:`route`, on the same dtype and shapes, and is one counted
call either way (:func:`ssd_chunk_bwd_cuda`):

* ``"sm90"`` (bf16, P = 64, N in {64, 128}, Q <= 256):
  ``csrc/ssd_chunk_bwd_sm90.cu``, counted as ``ssd_chunk_bwd_sm90``, on
  the tensor cores in five launches: the cumsums; dS per (chunk, 64 x 64
  [i, j] tile) over the heads in order; dx, e and the t sums per (chunk,
  group of :func:`sm90_heads_per_block` heads), two warpgroups over TMA
  tiles; dC and dB per (chunk, 64-row tile, 64 columns of N); da.  It
  rounds two operands to bf16 where the SIMT kernel keeps fp32: ``W_h =
  S ∘ L_h`` (the A operand of ``dx = W_hᵀ dy_h``) and ``dS`` (the A
  operand of ``dC = dS B`` and ``dB = dSᵀ C``); :func:`
  ssd_chunk_bwd_sm90_replay` replays that rounding on the CPU.  Every
  TMA operand (x, B, C, dy, dstates) must start on a 16-byte boundary.
* ``"simt"`` (fp32, and bf16 at any other shape): ``csrc/ssd_chunk_bwd.cu``,
  counted as ``ssd_chunk_bwd``, fp32 arithmetic on CUDA cores, the
  gradients stored in the inputs' dtype, in five launches: S's tiles and
  the cumsums; dS per (tile, group of :func:`simt_bwd_heads_per_group`
  heads, chunk), a partial per group; dx and e per (row tile, head,
  chunk); ``Σ_h d ∘ (x_h dst_h)`` as one split-K product over the head
  groups; dC, dB (the partials summed in group order) and da.

Both are the gradient of the chunk function at the inputs (not of the
tensor-core forward's bf16 rounding of W and of the decayed x̄), take no
atomics and are bit-equal run to run.  The plain version is
:func:`ssd_chunk_bwd_ref`, written from the formulas and not by
autograd.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build

__all__ = ["MAX_Q", "SM90_N", "SM90_P", "bwd_smem_bytes_sm90",
           "check_shapes", "route", "segsum", "simt_bwd_heads_per_group",
           "simt_plan", "sm90_heads_per_block", "smem_bytes_sm90",
           "ssd_chunk_bwd_cuda", "ssd_chunk_bwd_ref",
           "ssd_chunk_bwd_sm90_replay", "ssd_chunk_cuda", "ssd_chunk_ref",
           "ssd_chunk_sm90_replay", "ssd_intra_chunk"]

# the kernels keep one head's cumsum of `a` in shared memory (and the
# tensor-core kernel loads a chunk as one TMA box of 256 rows); 256 is the
# ssm_chunk of every config
MAX_Q = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the tensor-core kernel: bf16 at this head size and these state sizes
SM90_P = 64
SM90_N = (64, 128)
SM90_STAGES = 2


def route(dtype: torch.dtype, Q: int, P: int, N: int) -> str:
    """The kernel a CUDA call takes, forward and backward alike:
    ``"sm90"`` (tensor cores) for bf16 with ``P == SM90_P``, ``N`` in
    ``SM90_N`` and ``1 <= Q <= MAX_Q``, else ``"simt"``."""
    if (dtype == torch.bfloat16 and P == SM90_P and N in SM90_N
            and 1 <= Q <= MAX_Q):
        return "sm90"
    return "simt"


def sm90_heads_per_block(n_chunks: int, H: int, n_sm: int) -> int:
    """Heads one block of the tensor-core kernel walks: enough blocks per
    chunk to give each of the card's ``n_sm`` multiprocessors one block
    (the kernel's shared memory allows one), at least one head each.  At
    the serving shape (32 chunks, 80 heads, 132 SMs): 20 heads, 4 x 32 =
    128 blocks."""
    per_chunk = max(1, n_sm // n_chunks)
    return -(-H // per_chunk)


# the SIMT kernels' tiles (csrc/ssd_simt.cuh): 64 x 64, staged in shared
# memory as rows of SIMT_LDT floats
SIMT_TILE = 64
SIMT_LDT = 68
# the SIMT backward's dS pass: blocks an SM its head groups aim for, at the
# row tiles of a chunk of MAX_Q
SIMT_BWD_BLOCKS_PER_SM = 4
_GRID_X, _GRID_YZ = 2**31 - 1, 65535


def simt_bwd_heads_per_group(BC: int, H: int, n_sm: int) -> int:
    """Heads one block of the SIMT backward's dS and ``x dst`` passes
    walks: enough groups that the dS pass, one block per (tile, group,
    chunk), has ``SIMT_BWD_BLOCKS_PER_SM`` blocks on each of the card's
    ``n_sm`` multiprocessors at Q = MAX_Q (10 tiles a chunk), at most one
    group a head.  At the fp32 training shape (8 chunks, 80 heads, 132
    SMs): 7 groups of 12 heads (the last 8), 560 dS blocks."""
    nt = MAX_Q // SIMT_TILE
    per_group = BC * nt * (nt + 1) // 2
    groups = min(H, max(1, -(-SIMT_BWD_BLOCKS_PER_SM * n_sm // per_group)))
    return -(-H // groups)


@functools.lru_cache(maxsize=256)
def simt_plan(BC: int, Q: int, H: int, P: int, N: int, n_sm: int) -> dict:
    """The SIMT kernels' launches at these shapes, as
    ``csrc/ssd_chunk.cu`` and ``csrc/ssd_chunk_bwd.cu`` make them: per
    kernel its grid ``(x, y, z)`` and dynamic shared memory, the backward's
    head groups (``heads``: each group's heads in order), and each fp32
    scratch's shape and bytes.  ``ssd_chunk_cuda`` and
    ``ssd_chunk_bwd_cuda`` allocate the scratch from it and refuse a grid
    over CUDA's limits before any launch (the result is cached: read it,
    do not change it)."""
    T, LDT = SIMT_TILE, SIMT_LDT
    nt = -(-Q // T)
    tiles = nt * (nt + 1) // 2
    n_nc = -(-N // T)
    hpg = simt_bwd_heads_per_group(BC, H, n_sm)
    G = -(-H // hpg)
    rows4 = -(-BC * H // 4)
    tile_b, two_tiles = 4 * T * LDT, 2 * 4 * T * LDT
    fwd = {"prep": ((BC * tiles + rows4, 1, 1), two_tiles),
           "fwd": ((H, BC, 1), 4 * ((nt + 2) * T * LDT + 2 * MAX_Q))}
    bwd = {"prep": ((BC * tiles + rows4, 1, 1), two_tiles),
           "ds": ((tiles, G, BC), 3 * tile_b + 4 * 6 * T),
           "dx": ((nt, H, BC), 3 * tile_b + 4 * MAX_Q),
           "xdst": ((nt * n_nc, G, BC), two_tiles),
           "dbdc": ((2 * BC * nt * n_nc + rows4, 1, 1), two_tiles)}
    scratch = {"fwd": {"S": (BC, tiles, T, T), "cum": (BC, H, 2, Q)},
               "bwd": {"S": (BC, tiles, T, T), "cum": (BC, H, 2, Q),
                       "dSp": (BC, G, tiles, T, T),
                       "part": (BC, H, 2, nt, Q), "e": (BC, H, Q),
                       "xdp": (BC, G, Q, N)}}
    nbytes = {k: {n: 4 * math.prod(sh) for n, sh in v.items()}
              for k, v in scratch.items()}
    return {"heads_per_group": hpg, "groups": G,
            "heads": [list(range(g * hpg, min(H, (g + 1) * hpg)))
                      for g in range(G)],
            "fwd": fwd, "bwd": bwd, "scratch": scratch,
            "scratch_bytes": nbytes}


def _scratch(shapes: dict, device) -> list:
    """fp32 tensors of ``shapes``' shapes, views of one allocation, each
    starting on a 256-byte boundary (the kernels read S's tiles as
    float4s)."""
    sizes = [math.prod(sh) for sh in shapes.values()]
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + -(-n // 64) * 64)
    buf = torch.empty(starts[-1], dtype=torch.float32, device=device)
    return [buf[a:a + n].view(sh)
            for a, n, sh in zip(starts, sizes, shapes.values())]


def _check_grids(what: str, launches: dict) -> None:
    """Raise unless every grid of ``launches`` (``simt_plan``'s) is within
    CUDA's limits: x < 2**31, y and z <= 65535."""
    for name, ((gx, gy, gz), _) in launches.items():
        if gx > _GRID_X or gy > _GRID_YZ or gz > _GRID_YZ:
            raise ValueError(f"{what}'s {name} pass would launch a grid of "
                             f"({gx}, {gy}, {gz}) blocks, over CUDA's "
                             f"limits ({_GRID_X}, {_GRID_YZ}, {_GRID_YZ})")


def smem_bytes_sm90(N: int) -> int:
    """Dynamic shared memory of one block of the tensor-core kernel: C and
    B ``[256, N]`` bf16, ``SM90_STAGES`` x̄ tiles ``[256, 64]``, per stage
    the fp32 cumsum and decays, the mbarriers, and 1024 B to align the
    base for the 128-byte swizzle (``csrc/ssd_chunk_sm90.cu::Smem``)."""
    return (2 * 2 * MAX_Q * N + SM90_STAGES * 2 * MAX_Q * SM90_P
            + SM90_STAGES * 2 * 4 * MAX_Q + 8 * (1 + 2 * SM90_STAGES) + 1024)


# the tensor-core backward's dx pass: dy and dst tiles in flight
SM90_BWD_STAGES = 2


def bwd_smem_bytes_sm90(N: int) -> int:
    """Dynamic shared memory of a block of the tensor-core backward's
    largest pass (the dx pass, ``csrc/ssd_chunk_bwd_sm90.cu::DxSmem``): C
    and B ``[256, N]`` bf16, ``SM90_BWD_STAGES`` stages of dy_h ``[256,
    64]`` and dst_h ``[64, N]``, the mbarriers, and 1024 B to align the
    base for the 128-byte swizzle: 230,424 B at N = 128."""
    return (2 * 2 * MAX_Q * N
            + SM90_BWD_STAGES * 2 * (MAX_Q * SM90_P + SM90_P * N)
            + 8 * (1 + SM90_BWD_STAGES) + 1024)


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a: [..., Q] -> lower-tri cumulative sums L[i,j] = sum_{j<m<=i} a_m,
    -inf above the diagonal (where ``exp`` of the difference may overflow;
    ``exp(-inf)`` is 0, never ``inf * 0``)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, float("-inf"))


def ssd_intra_chunk(xbar: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor):
    """The intra-chunk block in the inputs' dtype (the einsum branch of
    ``models.mamba2.ssd_chunked``); shapes as :func:`ssd_chunk_ref`."""
    L = torch.exp(segsum(a))                                  # [B,nc,H,Q,Q]
    scores = torch.einsum("bcin,bcjn->bcij", Cm, Bm)
    y_diag = torch.einsum("bcij,bchij,bcjhp->bcihp", scores, L, xbar)
    cs = torch.cumsum(a, dim=-1)
    decay_end = torch.exp(cs[..., -1:] - cs)                  # [B,nc,H,Q]
    states = torch.einsum("bchj,bcjn,bcjhp->bchpn", decay_end, Bm, xbar)
    return y_diag, states


def ssd_chunk_ref(xbar: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor):
    """Intra-chunk SSD: the ``y_diag`` and chunk-state terms of
    ``models.mamba2.ssd_chunked``.

    xbar [B, nc, Q, H, P], a [B, nc, H, Q], Bm/Cm [B, nc, Q, N]
    -> (y_diag [B, nc, Q, H, P], states [B, nc, H, P, N])

    Computed in fp32 (float64 stays float64) and returned in ``xbar``'s
    dtype, as the TPU kernel does (at fp32 this is exactly
    ``repro.kernels.ref.ssd_chunk_ref``).
    """
    work = _work_dtype(xbar)
    y_diag, states = ssd_intra_chunk(
        *(t.to(work) for t in (xbar, a, Bm, Cm)))
    return y_diag.to(xbar.dtype), states.to(xbar.dtype)


def _work_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def ssd_chunk_bwd_ref(xbar: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                      Cm: torch.Tensor, dy: torch.Tensor,
                      dstates: torch.Tensor):
    """The gradient of :func:`ssd_chunk_ref`, in plain PyTorch from the
    formulas the kernel computes (not autograd): per chunk and head h, with
    ``cum = cumsum(a)``, ``L_ij = exp(cum_i - cum_j)`` for i >= j (0
    above), ``S = C Bᵀ``, ``W_h = S ∘ L_h``, ``d_j = exp(cum_{Q-1} -
    cum_j)`` and ``G_h = B dst_hᵀ`` (``[Q, P]``):

    * ``dx_h = W_hᵀ dy_h + d ∘ G_h``
    * ``dS = Σ_h (dy_h x_hᵀ) ∘ L_h``; ``dC = dS B``;
      ``dB = dSᵀ C + Σ_h d ∘ (x_h dst_h)``
    * ``dcum_i += Σ_j t_ij`` and ``dcum_j -= Σ_i t_ij`` with ``t_h =
      (dy_h x_hᵀ) ∘ W_h``; from the states ``e_j = d_j Σ_p x_jp G_jp``,
      ``dcum_{Q-1} += Σ_j e_j``, ``dcum_j -= e_j``
    * ``da`` is the reverse cumsum of ``dcum``.

    Shapes as :func:`ssd_chunk_ref`, ``dy`` as y_diag and ``dstates`` as
    the states; returns ``(dxbar, da, dBm, dCm)`` in the inputs' dtypes,
    computed in fp32 (bf16 inputs upcast, float64 stays float64)."""
    return _chunk_bwd(xbar, a, Bm, Cm, dy, dstates, sm90=False)


def ssd_chunk_bwd_sm90_replay(xbar: torch.Tensor, a: torch.Tensor,
                              Bm: torch.Tensor, Cm: torch.Tensor,
                              dy: torch.Tensor, dstates: torch.Tensor):
    """The tensor-core backward's rounding (``csrc/ssd_chunk_bwd_sm90.cu``),
    replayed in PyTorch on bf16 inputs: :func:`ssd_chunk_bwd_ref`'s
    formulas in fp32 with two operands rounded to bf16 as the kernel's
    products take them, ``dx_h = bf16(S ∘ L_h)ᵀ dy_h + d ∘ G_h``, ``dC =
    bf16(dS) B`` and ``dB = bf16(dS)ᵀ C + Σ_h d ∘ (x_h dst_h)`` (dS summed
    over the heads in fp32 first); the t sums, e and da as the plain
    version.  It differs from the kernel only in the order of fp32 sums
    and in ``exp``'s last bits (and so, now and then, in which way an
    operand's rounding goes); the CPU tests hold it to a float64 oracle,
    chip_smoke.py holds the kernel to it.  Returns bf16 gradients."""
    return _chunk_bwd(xbar, a, Bm, Cm, dy, dstates, sm90=True)


def _chunk_bwd(xbar, a, Bm, Cm, dy, dstates, *, sm90: bool):
    B, nc, Q, H, P, N = check_shapes(xbar, a, Bm, Cm)
    work = torch.float32 if sm90 else _work_dtype(xbar)
    x, a32, Bf, Cf, dyf, dst = (t.to(work) for t in (xbar, a, Bm, Cm, dy,
                                                     dstates))
    cum = torch.cumsum(a32, dim=-1)                           # [B,nc,H,Q]
    live = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.where(live, torch.exp(torch.where(
        live, cum[..., :, None] - cum[..., None, :], 0.0)), 0.0)
    S = torch.einsum("bcin,bcjn->bcij", Cf, Bf)               # [B,nc,Q,Q]
    d = torch.exp(cum[..., -1:] - cum)                        # [B,nc,H,Q]
    G = torch.einsum("bcjn,bchpn->bchjp", Bf, dst)            # [B,nc,H,Q,P]
    dW = torch.einsum("bcihp,bcjhp->bchij", dyf, x) * live    # [B,nc,H,Q,Q]
    if sm90:
        W = _bf16(S[:, :, None] * L)
        dx = torch.einsum("bchij,bcihp->bcjhp", W, dyf)
    else:
        dx = torch.einsum("bcij,bchij,bcihp->bcjhp", S, L, dyf)
    dx = dx + (d[..., None] * G).permute(0, 1, 3, 2, 4)
    dS = (dW * L).sum(dim=2)                                  # [B,nc,Q,Q]
    if sm90:
        dS = _bf16(dS)
    dC = torch.einsum("bcij,bcjn->bcin", dS, Bf)
    dB = (torch.einsum("bcij,bcin->bcjn", dS, Cf)
          + torch.einsum("bchj,bcjhp,bchpn->bcjn", d, x, dst))
    t = dW * S[:, :, None] * L
    e = d * torch.einsum("bcjhp,bchjp->bchj", x, G)           # [B,nc,H,Q]
    dcum = t.sum(dim=-1) - t.sum(dim=-2) - e
    dcum[..., -1] += e.sum(dim=-1)
    da = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), dim=-1), (-1,))
    return (dx.to(xbar.dtype), da.to(a.dtype), dB.to(Bm.dtype),
            dC.to(Cm.dtype))


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 once, back in fp32: a product's bf16
    operand."""
    return t.to(torch.bfloat16).to(torch.float32)


def ssd_chunk_sm90_replay(xbar: torch.Tensor, a: torch.Tensor,
                          Bm: torch.Tensor, Cm: torch.Tensor):
    """The tensor-core route's rounding, replayed in PyTorch on bf16
    inputs (shapes as :func:`ssd_chunk_ref`): fp32 cumsum and ``C·Bᵀ``,
    ``W = bf16(S exp(cum_i - cum_j))`` on and below the diagonal (0 above,
    by a select), ``y = bf16(W x̄)`` with fp32 sums, and the states
    ``bf16(bf16(x̄ d_j)ᵀ B)`` with ``d_j = exp(cum_{Q-1} - cum_j)``.  It
    differs from the kernel only in the order of fp32 sums and in ``exp``'s
    last bits; the CPU tests hold it to a float64 oracle and use its
    distance from :func:`ssd_chunk_ref` to set the kernel's bar."""
    x, a, Bm, Cm = (t.to(torch.float32) for t in (xbar, a, Bm, Cm))
    Q = x.shape[2]
    cs = torch.cumsum(a, dim=-1)                              # [B,nc,H,Q]
    S = torch.einsum("bcin,bcjn->bcij", Cm, Bm)
    live = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    W = torch.where(live, S[:, :, None] * torch.exp(
        cs[..., :, None] - cs[..., None, :]), 0.0)
    W = W.to(torch.bfloat16).to(torch.float32)
    y = torch.einsum("bchij,bcjhp->bcihp", W, x)
    decay = torch.exp(cs[..., -1:] - cs).permute(0, 1, 3, 2)  # [B,nc,Q,H]
    xd = (x * decay[..., None]).to(torch.bfloat16).to(torch.float32)
    states = torch.einsum("bcjhp,bcjn->bchpn", xd, Bm)
    return y.to(torch.bfloat16), states.to(torch.bfloat16)


def check_shapes(xbar: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor) -> tuple[int, ...]:
    """``(B, nc, Q, H, P, N)`` of a consistent set of inputs, or raise."""
    if xbar.ndim != 5:
        raise ValueError(f"xbar must be [B, nc, Q, H, P], got "
                         f"{tuple(xbar.shape)}")
    B, nc, Q, H, P = xbar.shape
    N = Bm.shape[-1]
    want = {"a": (B, nc, H, Q), "Bm": (B, nc, Q, N), "Cm": (B, nc, Q, N)}
    for name, t in (("a", a), ("Bm", Bm), ("Cm", Cm)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]} for xbar "
                             f"{tuple(xbar.shape)}, got {tuple(t.shape)}")
    return B, nc, Q, H, P, N


def ssd_chunk_cuda(xbar: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor):
    """The kernel :func:`route` names, on contiguous CUDA tensors, all fp32
    or all bf16 (one counted launch)."""
    B, nc, Q, H, P, N = check_shapes(xbar, a, Bm, Cm)
    if xbar.dtype not in _DTYPES:
        raise TypeError(f"ssd_chunk takes fp32 or bf16, got {xbar.dtype}")
    if not 1 <= Q <= MAX_Q:
        raise ValueError(
            f"ssd_chunk takes a chunk of 1 <= Q <= {MAX_Q} tokens (each "
            f"block keeps one head's cumsum in shared memory), got Q={Q}; "
            f"lower ssm_chunk")
    if B * nc > 65535 or H > 65535:
        raise ValueError(f"ssd_chunk launches one grid row per chunk and "
                         f"head (at most 65535 each), got B*nc={B * nc}, "
                         f"H={H}")
    for name, t, nd in (("xbar", xbar, 5), ("a", a, 4), ("Bm", Bm, 4),
                        ("Cm", Cm, 4)):
        _build.check_cuda(name, t, xbar.dtype, nd)
    y = torch.empty_like(xbar)
    states = torch.empty((B, nc, H, P, N), dtype=xbar.dtype,
                         device=xbar.device)
    if route(xbar.dtype, Q, P, N) == "sm90":
        for name, t in (("xbar", xbar), ("Bm", Bm), ("Cm", Cm)):
            _build.check_tma(name, t)
        smem = smem_bytes_sm90(N)
        if smem > _build.smem_optin(xbar.device):
            raise ValueError(f"ssd_chunk at N={N} needs {smem} B of shared "
                             f"memory per block, the card allows "
                             f"{_build.smem_optin(xbar.device)}")
        hpb = sm90_heads_per_block(B * nc, H, _build.sm_count(xbar.device))
        _build.launch("ssd_chunk", xbar.device, xbar.data_ptr(),
                      a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                      y.data_ptr(), states.data_ptr(), B * nc, Q, H, P, N,
                      hpb, entry="ssd_chunk_sm90")
        return y, states
    plan = simt_plan(B * nc, Q, H, P, N, _build.sm_count(xbar.device))
    _check_grids("ssd_chunk", plan["fwd"])
    S, cum = _scratch(plan["scratch"]["fwd"], xbar.device)
    _build.launch("ssd_chunk", xbar.device, _DTYPES[xbar.dtype],
                  xbar.data_ptr(), a.data_ptr(), Bm.data_ptr(),
                  Cm.data_ptr(), y.data_ptr(), states.data_ptr(),
                  S.data_ptr(), cum.data_ptr(), B * nc, Q, H, P, N)
    return y, states


# the backward kernels' [i, j] tiles (csrc/ssd_chunk_bwd.cu,
# csrc/ssd_chunk_bwd_sm90.cu), which size their scratch of per-tile row
# and column sums
BWD_TILE = 64


def ssd_chunk_bwd_cuda(xbar: torch.Tensor, a: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                       dstates: torch.Tensor):
    """``(dxbar, da, dBm, dCm)`` in the inputs' dtype by the backward of
    the route :func:`route` names, on contiguous CUDA tensors, all fp32 or
    all bf16, shaped as :func:`ssd_chunk_bwd_ref`'s (one counted launch:
    ``ssd_chunk_bwd_sm90`` on the tensor cores, ``ssd_chunk_bwd`` on CUDA
    cores).  Refuses by shape and dtype what the kernels do not take;
    never falls back to the other route or to the plain version."""
    B, nc, Q, H, P, N = check_shapes(xbar, a, Bm, Cm)
    f32 = torch.float32
    if xbar.dtype not in _DTYPES:
        raise TypeError(f"ssd_chunk's backward takes fp32 or bf16, got "
                        f"{xbar.dtype}")
    if not 1 <= Q <= MAX_Q:
        raise ValueError(
            f"ssd_chunk's backward takes a chunk of 1 <= Q <= {MAX_Q} "
            f"tokens (each block keeps one head's cumsum in shared memory), "
            f"got Q={Q}; lower ssm_chunk")
    BC = B * nc
    if BC * H > 2**31 - 1 or BC > 65535 or H > 65535:
        raise ValueError(f"ssd_chunk's backward launches one block per "
                         f"chunk and head: B*nc={BC}, H={H} is too many")
    if tuple(dy.shape) != tuple(xbar.shape):
        raise ValueError(f"dy must be {tuple(xbar.shape)}, got "
                         f"{tuple(dy.shape)}")
    if tuple(dstates.shape) != (B, nc, H, P, N):
        raise ValueError(f"dstates must be {(B, nc, H, P, N)}, got "
                         f"{tuple(dstates.shape)}")
    for name, t, nd in (("xbar", xbar, 5), ("a", a, 4), ("Bm", Bm, 4),
                        ("Cm", Cm, 4), ("dy", dy, 5), ("dstates", dstates,
                                                        5)):
        _build.check_cuda(name, t, xbar.dtype, nd)
    nt = -(-Q // BWD_TILE)
    dev = xbar.device
    dx = torch.empty_like(xbar)
    da = torch.empty_like(a)
    dB = torch.empty_like(Bm)
    dC = torch.empty_like(Cm)
    if route(xbar.dtype, Q, P, N) == "sm90":
        for name, t in (("xbar", xbar), ("Bm", Bm), ("Cm", Cm), ("dy", dy),
                        ("dstates", dstates)):
            _build.check_tma(name, t)
        smem = bwd_smem_bytes_sm90(N)
        if smem > _build.smem_optin(dev):
            raise ValueError(f"ssd_chunk's backward at N={N} needs {smem} B "
                             f"of shared memory per block, the card allows "
                             f"{_build.smem_optin(dev)}")
        # scratch: cumsums and end decays, dS rounded to bf16 and its
        # transpose (each [BC, QP, QP]), the per-head row and column sums
        # of t, and e
        cum = torch.empty((BC, H, 2, Q), dtype=f32, device=dev)
        e = torch.empty((BC, H, Q), dtype=f32, device=dev)
        qp = nt * BWD_TILE
        dS = torch.empty((2, BC, qp, qp), dtype=torch.bfloat16, device=dev)
        rowpart = torch.empty((BC, H, nt, Q), dtype=f32, device=dev)
        colsum = torch.empty((BC, H, Q), dtype=f32, device=dev)
        hpb = sm90_heads_per_block(BC, H, _build.sm_count(dev))
        _build.launch("ssd_chunk_bwd_sm90", dev, *(
            t.data_ptr() for t in (xbar, a, Bm, Cm, dy, dstates, cum, dS,
                                   rowpart, colsum, e, dx, da, dB, dC)),
            BC, Q, H, P, N, hpb)
        return dx, da, dB, dC
    # S's tiles, the cumsums, the group partials of dS, the per-head row
    # and column sums of t per tile, e, the group partials of x dst
    plan = simt_plan(BC, Q, H, P, N, _build.sm_count(dev))
    _check_grids("ssd_chunk's backward", plan["bwd"])
    scratch = _scratch(plan["scratch"]["bwd"], dev)
    _build.launch("ssd_chunk_bwd", dev, _DTYPES[xbar.dtype], *(
        t.data_ptr() for t in (xbar, a, Bm, Cm, dy, dstates, *scratch, dx,
                               da, dB, dC)), BC, Q, H, P, N,
        plan["heads_per_group"])
    return dx, da, dB, dC
