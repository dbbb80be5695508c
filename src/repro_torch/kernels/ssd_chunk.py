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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["MAX_Q", "SM90_N", "SM90_P", "check_shapes", "route",
           "segsum", "sm90_heads_per_block", "smem_bytes_sm90",
           "ssd_chunk_cuda", "ssd_chunk_ref", "ssd_chunk_sm90_replay",
           "ssd_intra_chunk"]

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
    """The kernel a CUDA call takes: ``"sm90"`` (tensor cores) for bf16
    with ``P == SM90_P``, ``N`` in ``SM90_N`` and ``1 <= Q <= MAX_Q``, else
    ``"simt"``."""
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

    Computed in fp32 and returned in ``xbar``'s dtype, as the TPU kernel
    does (at fp32 this is exactly ``repro.kernels.ref.ssd_chunk_ref``).
    """
    y_diag, states = ssd_intra_chunk(
        *(t.to(torch.float32) for t in (xbar, a, Bm, Cm)))
    return y_diag.to(xbar.dtype), states.to(xbar.dtype)


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
