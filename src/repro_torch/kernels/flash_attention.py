"""Causal or non-causal GQA/MQA attention with an online softmax, on the
card.

Replaces ``repro/kernels/flash_attention.py::_flash_kernel`` (Pallas TPU)
with two CUDA kernels.  :func:`route` picks one by the dtype and the head
sizes alone, a documented rule, never by a failure:

* ``"sm90"``, bf16 with ``D`` and ``Dv`` in ``{64, 128}`` (tinyllama's and
  musicgen's 64, chameleon's and granite's 128):
  ``csrc/flash_attention_sm90.cu::flash_attention_kernel_sm90``, on the
  tensor cores.  One block per (128-row q tile, query head, batch): a
  producer warp loads q once and K/V tiles of :func:`sm90_keys` keys by TMA
  into a 2-stage ring in shared memory; two consumer warpgroups compute
  S = q·kᵀ with ``wgmma`` (bf16 products, fp32 sums), the online softmax
  in registers, and O += bf16(p)·v with a second ``wgmma`` (p from
  registers).  Every pointer must be 16-byte aligned (TMA's rule); the
  wrapper checks that before the launch.
* ``"simt"``, every other case (fp32, and the head sizes the tensor-core
  kernel does not take: MLA's 96 and 192, gemma's 256, any other up to
  256): ``csrc/flash_attention.cu::flash_attention_kernel``, one block
  per (64-row q tile, query head, batch) over 64-key tiles staged in
  shared memory as fp32, with fp32 FMAs on CUDA cores, which keeps fp32
  within ~1e-6 of the plain version.

Both reach their KV head as ``h // G`` (K/V are never repeated over the G
query heads), loop key tiles only up to the diagonal, take any Sq, Sk >= 1
and mask their ragged edges; both compute fp32 scores, running max and
sum, ``p`` rounded to v's dtype before ``p·v``, an fp32 accumulator and
the output in q's dtype.  The sources' headers say what bounds each.  The
plain version is :func:`flash_attention_ref` (full-matrix), which
``kernels.ref`` re-exports.

Positions of the causal mask count from 0 for both q and k (``i >= j``,
top-left), as the TPU kernel and the JAX reference do; FlashAttention-2
and SDPA align the diagonal bottom-right instead, which differs when
``Sq != Sk``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["MAX_HEAD", "SM90_HEADS", "check_shapes", "flash_attention_cuda",
           "flash_attention_ref", "route", "sm90_keys", "smem_bytes",
           "smem_bytes_sm90", "softmax_scale"]

# the q, k, v and p tiles of one block of the SIMT kernel live in shared
# memory
MAX_HEAD = 256
BQ = BK = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the tensor-core kernel: bf16 at these head sizes; 128 q rows per block,
# K/V tiles in flight
SM90_HEADS = (64, 128)
SM90_BQ = 128
SM90_STAGES = 2


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
    """Dynamic shared memory of one block of the SIMT kernel: the fp32 q,
    k, v and p tiles."""
    return 4 * (BQ * (D + 1) + BK * (D + 1) + BK * Dv + BQ * (BK + 1))


def sm90_keys(D: int, Dv: int) -> int:
    """Keys per K/V tile of the tensor-core kernel
    (``csrc/flash_attention_sm90.cu::keys_per_tile``)."""
    return 128 if D == Dv == 64 else 64


def smem_bytes_sm90(D: int, Dv: int) -> int:
    """Dynamic shared memory of one block of the tensor-core kernel: the
    bf16 q tile, ``SM90_STAGES`` K and V tiles, the mbarriers, and 1024 B
    to align the base for the 128-byte swizzle
    (``csrc/flash_attention_sm90.cu::Smem``)."""
    bk = sm90_keys(D, Dv)
    return (2 * SM90_BQ * D + SM90_STAGES * 2 * bk * (D + Dv)
            + 8 * (1 + 2 * SM90_STAGES) + 1024)


def route(dtype: torch.dtype, D: int, Dv: int) -> str:
    """The kernel a CUDA call takes: ``"sm90"`` (tensor cores) for bf16
    with D and Dv in ``SM90_HEADS``, else ``"simt"``."""
    if dtype == torch.bfloat16 and D in SM90_HEADS and Dv in SM90_HEADS:
        return "sm90"
    return "simt"


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         scale: float | None = None) -> torch.Tensor:
    """The kernel :func:`route` names, on contiguous CUDA tensors, all fp32
    or all bf16 (one counted launch)."""
    B, Sq, Sk, H, K, D, Dv = check_shapes(q, k, v)
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes fp32 or bf16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_cuda(name, t, q.dtype, 4)
    sm90 = route(q.dtype, D, Dv) == "sm90"
    if sm90:
        for name, t in (("q", q), ("k", k), ("v", v)):
            _build.check_tma(name, t)
    smem = smem_bytes_sm90(D, Dv) if sm90 else smem_bytes(D, Dv)
    if smem > _build.smem_optin(q.device):
        raise ValueError(f"flash_attention at D={D}, Dv={Dv} needs {smem} B "
                         f"of shared memory per block, the card allows "
                         f"{_build.smem_optin(q.device)}")
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if sm90:
        _build.launch("flash_attention", q.device, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
                      H, K, D, Dv, softmax_scale(D, scale), int(causal),
                      entry="flash_attention_sm90")
    else:
        _build.launch("flash_attention", q.device, _DTYPES[q.dtype],
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), B, Sq, Sk, H, K, D, Dv,
                      softmax_scale(D, scale), int(causal))
    return out
