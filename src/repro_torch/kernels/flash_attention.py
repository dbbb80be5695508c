"""Causal or non-causal GQA/MQA attention with an online softmax, on the
card.

Replaces ``repro/kernels/flash_attention.py::_flash_kernel`` (Pallas TPU).
CUDA source: ``csrc/flash_attention.cu``, one block per (64-row q tile,
query head, batch) that reaches its KV head as ``h // G`` (K/V are never
repeated over the G query heads) and loops 64-key tiles up to the
diagonal; fp32 scores, running max and sum, ``p`` rounded to v's dtype
before ``p·v``, an fp32 accumulator, the output in q's dtype.  The
source's header says what bounds it.  The plain version is
:func:`flash_attention_ref` (full-matrix), which ``kernels.ref``
re-exports.

Positions of the causal mask count from 0 for both q and k (``i >= j``,
top-left), as the TPU kernel and the JAX reference do; FlashAttention-2
and SDPA align the diagonal bottom-right instead, which differs when
``Sq != Sk``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["MAX_HEAD", "check_shapes", "flash_attention_cuda",
           "flash_attention_ref", "smem_bytes", "softmax_scale"]

# the q, k, v and p tiles of one block live in shared memory
MAX_HEAD = 256
BQ = BK = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def softmax_scale(D: int, scale: float | None = None) -> float:
    """The scores' scale: ``1/sqrt(D)`` unless given."""
    return float(1.0 / np.sqrt(D)) if scale is None else float(scale)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """Full-matrix attention in fp32: q [B, Sq, H, D], k [B, Sk, K, D],
    v [B, Sk, K, Dv] with H % K == 0 (GQA broadcast) -> [B, Sq, H, Dv] in
    q's dtype (``repro.kernels.ref.flash_attention_ref``)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, D)
    s = torch.einsum("bqkgd,bpkd->bkgqp", qg.to(torch.float32),
                     k.to(torch.float32)) * softmax_scale(D, scale)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqp,bpkd->bkgqd", p, v.to(torch.float32))
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, v.shape[3]).to(
        q.dtype)


def check_shapes(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> tuple[int, ...]:
    """``(B, Sq, Sk, H, K, D, Dv)`` of inputs the kernel takes, or raise."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4:
            raise ValueError(f"{name} must be [B, S, heads, head_dim], got "
                             f"{tuple(t.shape)}")
    B, Sq, H, D = q.shape
    _, Sk, K, Dv = v.shape
    if tuple(k.shape) != (B, Sk, K, D):
        raise ValueError(f"k must be {(B, Sk, K, D)} for q {tuple(q.shape)} "
                         f"and v {tuple(v.shape)}, got {tuple(k.shape)}")
    if v.shape[0] != B:
        raise ValueError(f"v's batch {v.shape[0]} != q's {B}")
    if min(B, Sq, Sk, H, K, D, Dv) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, v "
                         f"{tuple(v.shape)}")
    if H % K:
        raise ValueError(f"{H} query heads do not split into groups over "
                         f"{K} KV heads (H % K must be 0)")
    if D > MAX_HEAD or Dv > MAX_HEAD:
        raise ValueError(f"flash_attention takes head sizes up to "
                         f"{MAX_HEAD} (the tiles live in shared memory), got "
                         f"D={D}, Dv={Dv}")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention launches one grid row per query "
                         f"head and batch (at most 65535 each), got B={B}, "
                         f"H={H}")
    return B, Sq, Sk, H, K, D, Dv


def smem_bytes(D: int, Dv: int) -> int:
    """Dynamic shared memory of one block: the fp32 q, k, v and p tiles."""
    return 4 * (BQ * (D + 1) + BK * (D + 1) + BK * Dv + BQ * (BK + 1))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         scale: float | None = None) -> torch.Tensor:
    """The kernel on contiguous CUDA tensors, all fp32 or all bf16."""
    B, Sq, Sk, H, K, D, Dv = check_shapes(q, k, v)
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes fp32 or bf16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_cuda(name, t, q.dtype, 4)
    smem = smem_bytes(D, Dv)
    if smem > _build.smem_optin(q.device):
        raise ValueError(f"flash_attention at D={D}, Dv={Dv} needs {smem} B "
                         f"of shared memory per block, the card allows "
                         f"{_build.smem_optin(q.device)}")
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    _build.launch("flash_attention", q.device, _DTYPES[q.dtype],
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, Sq, Sk, H, K, D, Dv, softmax_scale(D, scale), int(causal))
    return out
