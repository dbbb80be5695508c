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
  three launches on CUDA cores (``C·Bᵀ`` once per chunk into an fp32
  scratch, then ``y`` per (row tile, head, chunk) and the states per
  (``[P, N]`` tile, head, chunk)), fp32 inside, which keeps fp32 within
  ~1e-4 of the output's scale.

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
  counted as ``ssd_chunk_bwd``, fp32 arithmetic on CUDA cores (four
  launches), the gradients stored in the inputs' dtype.

Both are the gradient of the chunk function at the inputs (not of the
tensor-core forward's bf16 rounding of W and of the decayed x̄), take no
atomics and are bit-equal run to run.  The plain version is
:func:`ssd_chunk_bwd_ref`, written from the formulas and not by
autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["MAX_Q", "SM90_N", "SM90_P", "bwd_smem_bytes_sm90",
           "check_shapes", "route", "segsum", "sm90_heads_per_block",
           "smem_bytes_sm90", "ssd_chunk_bwd_cuda", "ssd_chunk_bwd_ref",
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
    scores = torch.empty((B * nc, Q, Q), dtype=torch.float32,
                         device=xbar.device)
    _build.launch("ssd_chunk", xbar.device, _DTYPES[xbar.dtype],
                  xbar.data_ptr(), a.data_ptr(), Bm.data_ptr(),
                  Cm.data_ptr(), y.data_ptr(), states.data_ptr(),
                  scores.data_ptr(), B * nc, Q, H, P, N)
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
    # scratch: cumsums and end decays, the per-head row and column sums of
    # t, and e
    cum = torch.empty((BC, H, 2, Q), dtype=f32, device=dev)
    e = torch.empty((BC, H, Q), dtype=f32, device=dev)
    if route(xbar.dtype, Q, P, N) == "sm90":
        for name, t in (("xbar", xbar), ("Bm", Bm), ("Cm", Cm), ("dy", dy),
                        ("dstates", dstates)):
            _build.check_tma(name, t)
        smem = bwd_smem_bytes_sm90(N)
        if smem > _build.smem_optin(dev):
            raise ValueError(f"ssd_chunk's backward at N={N} needs {smem} B "
                             f"of shared memory per block, the card allows "
                             f"{_build.smem_optin(dev)}")
        # dS rounded to bf16 and its transpose, each [BC, QP, QP]
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
    # S and dS, the per-head row and column sums of t per tile
    S = torch.empty((BC, 2, Q, Q), dtype=f32, device=dev)
    part = torch.empty((BC, H, 2, nt, Q), dtype=f32, device=dev)
    _build.launch("ssd_chunk_bwd", dev, _DTYPES[xbar.dtype], *(
        t.data_ptr() for t in (xbar, a, Bm, Cm, dy, dstates, cum, S, part,
                               e, dx, da, dB, dC)), BC, Q, H, P, N)
    return dx, da, dB, dC
