"""The Mamba-2 SSD intra-chunk block, on the card.

Replaces ``repro/kernels/ssd_chunk.py::_ssd_chunk_kernel`` (Pallas TPU).
CUDA source: ``csrc/ssd_chunk.cu``, one C entry point that launches three
kernels on the caller's stream: ``C·Bᵀ`` once per chunk into an fp32
scratch, then ``y`` per (row tile, head, chunk) and the chunk states per
(``[P, N]`` tile, head, chunk), fp32 inside and written in ``xbar``'s
dtype.  The source's header says what bounds it.  The plain version is
:func:`ssd_chunk_ref`, which ``kernels.ref`` re-exports.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["MAX_Q", "check_shapes", "segsum", "ssd_chunk_cuda",
           "ssd_chunk_ref", "ssd_intra_chunk"]

# the kernel keeps one head's cumsum of `a` in shared memory; 256 is the
# ssm_chunk of every config
MAX_Q = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    """The kernel on CUDA tensors, all fp32 or all bf16, contiguous."""
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
    scores = torch.empty((B * nc, Q, Q), dtype=torch.float32,
                         device=xbar.device)
    _build.launch("ssd_chunk", xbar.device, _DTYPES[xbar.dtype],
                  xbar.data_ptr(), a.data_ptr(), Bm.data_ptr(),
                  Cm.data_ptr(), y.data_ptr(), states.data_ptr(),
                  scores.data_ptr(), B * nc, Q, H, P, N)
    return y, states
