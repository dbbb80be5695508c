"""Causal or non-causal GQA/MQA attention with an online softmax, on the
card.

Replaces ``repro/kernels/flash_attention.py::_flash_kernel`` (Pallas TPU)
with two CUDA kernels.  :func:`route` picks one by the dtype and the head
sizes alone, a documented rule, never by a failure:

* ``"sm90"``, bf16 with ``(D, Dv)`` in :data:`SM90_PAIRS`: (64, 64),
  (128, 128), (64, 128), (128, 64) (tinyllama's and musicgen's 64,
  chameleon's and granite's 128), (96, 64) (minicpm3's MLA), (192, 128)
  (deepseek's MLA) and (256, 256) (gemma); each pair is one template
  instance in each source, so the set is explicit, not a product:
  ``csrc/flash_attention_sm90.cu::flash_attention_kernel_sm90``, on the
  tensor cores.  One block per (128-row q tile, query head, batch): a
  producer warp loads q once and K/V tiles of :func:`sm90_keys` keys by TMA
  into a 2-stage ring in shared memory; two consumer warpgroups compute
  S = q·kᵀ with ``wgmma`` (bf16 products, fp32 sums), the online softmax
  in registers, and O += bf16(p)·v with a second ``wgmma`` (p from
  registers); at Dv = 256 a block owns 64 rows and its warpgroups split
  the output's 256 columns (:func:`sm90_rows`).  Every pointer must be
  16-byte aligned (TMA's rule); the wrapper checks that before the
  launch.  D = 96 is stored as two whole 64-column chunks, the last 32
  columns zeros (TMA's fill), and never reaches the output.
* ``"simt"``, every other case (fp32, and the bf16 pairs the tensor-core
  kernel does not take: jamba's 32, MLA at smoke width 48 / 32, any other
  up to 256): ``csrc/flash_attention.cu::flash_attention_kernel``, fp32
  FMAs on CUDA cores, which keeps fp32 within ~1e-6 of the plain version.
  A block's two groups of 128 threads each own a q tile of one query head
  and share each staged K/V tile (two heads of a KV head, or two q tiles
  of one); register tiles fed by float4 reads of fp32 tiles whose rows are
  an odd number of float4s; the next K/V tile's loads in flight during a
  product; its tile sizes by head size (:func:`fwd_tiles`).

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

The backward (training) is hand-written too, on the forward's route
(:func:`flash_attention_bwd_cuda`): both kernels recompute ``p = exp(s -
lse)`` from q, k and the forward's per-row log-sum-exp
(``flash_attention_cuda(..., with_lse=True)``, which both forwards
write) and write dq, dk and dv once each without atomics
(deterministic).

* ``"sm90"``: ``csrc/flash_attention_bwd_sm90.cu``, bf16 on the tensor
  cores: a dK/dV pass per (64-key tile, KV head, batch) over the q tiles
  and the G query heads, and a dQ pass per (64-row q tile, head, batch),
  each one warpgroup with ``wgmma`` products and a two-stage TMA ring;
  where one warpgroup cannot hold dK and dV (``D + Dv > 256``: (192, 128),
  (256, 256)) the dK/dV pass runs two, one holding dV and one dK, fp32
  p^T passed between them through shared memory; p and ds are rounded to
  bf16 only as the A operands of the last products (``dv += p^T do``,
  ``dk += ds^T q``, ``dq += ds k``).
* ``"simt"``: ``csrc/flash_attention_bwd.cu``, fp32 arithmetic on CUDA
  cores from fp32 or bf16 inputs (loads and stores in the inputs' dtype):
  register tiles fed by float4 reads of fp32 tiles in shared memory, a
  dK/dV block per (key tile, query head, batch) whose G partials a
  reduce step sums in head order (fp32 scratch), and a dQ block per (q
  tile, head, batch); its tile sizes by head size (:func:`bwd_tiles`).

Both are counted separately (``launches["flash_attention_bwd_sm90"]``,
``launches["flash_attention_bwd"]``).  The plain version is
:func:`flash_attention_bwd_ref`.  The plain versions compute in fp32
(float64 stays float64, as an oracle's).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["MAX_HEAD", "SM90_PAIRS", "bwd_smem_bytes",
           "bwd_smem_bytes_sm90", "bwd_split_dkdv", "bwd_tiles",
           "check_shapes", "flash_attention_bwd_cuda",
           "flash_attention_bwd_ref", "flash_attention_cuda",
           "flash_attention_ref", "flash_attention_ref_lse", "fwd_tiles",
           "route", "sm90_keys", "sm90_padded", "sm90_rows", "smem_bytes",
           "smem_bytes_sm90", "softmax_scale"]

# the q, k, v and p tiles of one block of the SIMT kernels live in shared
# memory
MAX_HEAD = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the tensor-core kernels: bf16 at these (D, Dv) pairs, each a template
# instance of the forward and the backward; 128 q rows per forward block
# (64 at Dv = 256, :func:`sm90_rows`), K/V tiles in flight
SM90_PAIRS = frozenset({(64, 64), (128, 128), (64, 128), (128, 64),
                        (96, 64), (192, 128), (256, 256)})
SM90_BQ = 128
SM90_STAGES = 2
# the 64-column chunk of the tensor-core kernels' swizzled tiles
SM90_CHUNK = 64


def softmax_scale(D: int, scale: float | None = None) -> float:
    """The scores' scale: ``1/sqrt(D)`` unless given."""
    return float(1.0 / np.sqrt(D)) if scale is None else float(scale)


def _scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
            scale: float | None) -> torch.Tensor:
    """fp32 (float64 for float64) scores ``[B, K, G, Sq, Sk]`` scaled,
    -inf where masked."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    work = _work_dtype(q)
    qg = q.reshape(B, Sq, K, H // K, D)
    s = torch.einsum("bqkgd,bpkd->bkgqp", qg.to(work),
                     k.to(work)) * softmax_scale(D, scale)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask, s, float("-inf"))
    return s


def _work_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def _attend(s: torch.Tensor, q: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    B, Sq, H, _ = q.shape
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqp,bpkd->bkgqd", p, v.to(s.dtype))
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, v.shape[3]).to(
        q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """Full-matrix attention in fp32: q [B, Sq, H, D], k [B, Sk, K, D],
    v [B, Sk, K, Dv] with H % K == 0 (GQA broadcast) -> [B, Sq, H, Dv] in
    q's dtype (``repro.kernels.ref.flash_attention_ref``)."""
    return _attend(_scores(q, k, causal=causal, scale=scale), q, v)


def flash_attention_ref_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            scale: float | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_ref`'s output (the same bits) and each row's
    log-sum-exp of the scaled scores, fp32 ``[B, H, Sq]`` (-inf for a row
    that sees no key), as the SIMT kernel writes it."""
    s = _scores(q, k, causal=causal, scale=scale)
    B, Sq, H, _ = q.shape
    lse = torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    return _attend(s, q, v), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, *,
                            causal: bool = True, scale: float | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The backward in plain PyTorch, in fp32 (float64 for float64
    inputs), from the formulas the kernels compute: ``p = exp(s - lse)``
    (0 where masked or where the row's lse is -inf), ``delta = rowsum(do *
    o)``, ``dv = p^T do``, ``dp = do v^T``, ``ds = p (dp - delta)``, ``dq =
    ds k * scale``, ``dk = ds^T q * scale``; dk and dv summed over each KV
    head's G query heads.  Returns (dq, dk, dv) in q's, k's and v's
    dtypes."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    f32 = _work_dtype(q)
    sc = softmax_scale(D, scale)
    s = _scores(q, k, causal=causal, scale=scale)
    lse_g = lse.to(f32).reshape(B, K, G, Sq)[..., None]
    p = torch.where(torch.isfinite(lse_g), torch.exp(s - lse_g), 0.0)
    dog = do.to(f32).reshape(B, Sq, K, G, -1)
    delta = (do.to(f32) * o.to(f32)).sum(-1).reshape(B, Sq, K, G)
    dv = torch.einsum("bkgqp,bqkgd->bpkd", p, dog)
    dp = torch.einsum("bqkgd,bpkd->bkgqp", dog, v.to(f32))
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    qg = q.to(f32).reshape(B, Sq, K, G, D)
    dq = torch.einsum("bkgqp,bpkd->bqkgd", ds, k.to(f32)) * sc
    dk = torch.einsum("bkgqp,bqkgd->bpkd", ds, qg) * sc
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def fwd_tiles(D: int, Dv: int) -> tuple[int, int, int]:
    """The SIMT forward's tiles by head size (``csrc/flash_attention.cu``):
    (q rows of a group's tile, keys of a K/V tile, 32-column groups of a
    thread's output columns).  Up to 64 columns: 64, 64, 2 (a thread's
    register tiles 4 x 8 of S, 4 x 8 of the output); up to 128: 64, 64, 4;
    up to 256: 32, 32, 8 (2 x 4 of S, 2 x 32 of the output), so that a
    block's tiles fit the 227 KB a Hopper block may opt into."""
    head = max(D, Dv)
    if head <= 64:
        return 64, 64, 2
    if head <= 128:
        return 64, 64, 4
    return 32, 32, 8


def smem_bytes(D: int, Dv: int) -> int:
    """Dynamic shared memory of one block of the SIMT forward: its two
    groups' q tiles, the shared K and V tiles and the two groups' p tiles,
    fp32 rows of ``_row_ld`` floats (``csrc/flash_attention.cu::
    smem_bytes``)."""
    bq, bk, _ = fwd_tiles(D, Dv)
    return 4 * (2 * bq * _row_ld(D) + bk * (_row_ld(D) + _row_ld(Dv))
                + 2 * bq * _row_ld(bk))


def sm90_keys(D: int, Dv: int) -> int:
    """Keys per K/V tile of the tensor-core kernel
    (``csrc/flash_attention_sm90.cu::keys_per_tile``): 128 where Dv = 64
    and D <= 96, else 64."""
    return 128 if Dv == 64 and D <= 96 else 64


def sm90_padded(D: int) -> int:
    """D rounded up to whole 64-column chunks, the width of the
    tensor-core kernels' q and K tiles (``csrc/sm90_common.cuh::padded``):
    96 -> 128."""
    return -(-D // SM90_CHUNK) * SM90_CHUNK


def sm90_rows(Dv: int) -> int:
    """q rows of one block of the tensor-core forward
    (``csrc/flash_attention_sm90.cu::rows_per_block``): 128, a warpgroup's
    64 each; 64 at Dv = 256, where the two warpgroups split the output's
    columns (one holding all 256 spilled)."""
    return SM90_BQ // 2 if Dv == 256 else SM90_BQ


def smem_bytes_sm90(D: int, Dv: int) -> int:
    """Dynamic shared memory of one block of the tensor-core kernel: the
    bf16 q tile (:func:`sm90_rows` rows), ``SM90_STAGES`` K and V tiles (q
    and K padded to whole 64-column chunks), the mbarriers, and 1024 B to
    align the base for the 128-byte swizzle
    (``csrc/flash_attention_sm90.cu::Smem``)."""
    bk, dp = sm90_keys(D, Dv), sm90_padded(D)
    return (2 * sm90_rows(Dv) * dp + SM90_STAGES * 2 * bk * (dp + Dv)
            + 8 * (1 + 2 * SM90_STAGES) + 1024)


def route(dtype: torch.dtype, D: int, Dv: int) -> str:
    """The kernel a CUDA call takes, forward and backward alike:
    ``"sm90"`` (tensor cores) for bf16 with ``(D, Dv)`` in
    :data:`SM90_PAIRS`, else ``"simt"``."""
    if dtype == torch.bfloat16 and (D, Dv) in SM90_PAIRS:
        return "sm90"
    return "simt"


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, scale: float | None = None,
                         with_lse: bool = False):
    """The kernel :func:`route` names, on contiguous CUDA tensors, all fp32
    or all bf16 (one counted launch).  ``with_lse`` also returns each row's
    log-sum-exp, fp32 ``[B, H, Sq]``, for the backward: ``(out, lse)``."""
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
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if sm90:
        _build.launch("flash_attention", q.device, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      None if lse is None else lse.data_ptr(), B, Sq, Sk,
                      H, K, D, Dv, softmax_scale(D, scale), int(causal),
                      entry="flash_attention_sm90")
    else:
        _build.launch("flash_attention", q.device, _DTYPES[q.dtype],
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), None if lse is None else lse.data_ptr(),
                      B, Sq, Sk, H, K, D, Dv, softmax_scale(D, scale),
                      int(causal))
    return (out, lse) if with_lse else out


def bwd_tiles(D: int, Dv: int) -> tuple[int, int, int]:
    """The SIMT backward's tiles by head size (``csrc/
    flash_attention_bwd.cu``): (keys a dK/dV block, q rows a dQ block,
    64-column groups of a thread's output columns, the kernel's template
    instance).  Up to 64 columns: 64, 64, 1 (a thread's register tile 4 x
    4); up to 128: 64, 64, 2; up to 256: 32, 32 (2 x 2), 4, so that a
    block's tiles fit the 227 KB a Hopper block may opt into."""
    head = max(D, Dv)
    if head <= 64:
        return 64, 64, 1
    if head <= 128:
        return 64, 64, 2
    return 32, 32, 4


def _row_ld(w: int) -> int:
    """Floats of a staged fp32 row of ``w`` columns: ``w`` rounded up to
    4, then to an odd number of float4s (``csrc/flash_attention_bwd.cu::
    row_ld``)."""
    return 4 * (-(-w // 4) | 1)


def bwd_smem_bytes(D: int, Dv: int) -> int:
    """Dynamic shared memory of a dK/dV block of the SIMT backward (the
    larger of its two kernels): its K and V tiles, the loop tile of q and
    do, pᵀ and dsᵀ, fp32 rows of ``_row_ld`` floats, and the loop tile's
    lse and delta (``csrc/flash_attention_bwd.cu::smem_floats``)."""
    T = bwd_tiles(D, Dv)[0]
    return 4 * (2 * T * (_row_ld(D) + _row_ld(Dv)) + 2 * T * _row_ld(T)
                + 2 * T)


def bwd_split_dkdv(D: int, Dv: int) -> bool:
    """The tensor-core backward's dK/dV pass runs two warpgroups (one
    holding dV, one dK) where one cannot hold both accumulators
    (``csrc/flash_attention_bwd_sm90.cu::split_dkdv``)."""
    return D + Dv > 256


def bwd_smem_bytes_sm90(D: int, Dv: int) -> int:
    """Dynamic shared memory of a block of either tensor-core backward
    kernel: its own two bf16 tiles (64 x D padded to whole 64-column
    chunks, 64 x Dv), ``SM90_STAGES`` pairs of loop tiles, p^T in fp32
    (64 x 64) where the dK/dV pass is split, the loop tile's lse and
    delta, the mbarriers, and 1024 B to align the base for the 128-byte
    swizzle (``csrc/flash_attention_bwd_sm90.cu::Smem``)."""
    return (2 * 64 * (sm90_padded(D) + Dv) * (1 + SM90_STAGES)
            + (4 * 64 * 64 if bwd_split_dkdv(D, Dv) else 0) + 2 * 4 * 64
            + 8 * (1 + SM90_STAGES) + 1024)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, scale: float | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtype by the backward of the route
    :func:`route` names, on contiguous CUDA tensors, q, k, v, o and do all
    fp32 or all bf16: o and do ``[B, Sq, H, Dv]``, lse fp32 ``[B, H, Sq]``
    from :func:`flash_attention_cuda` with ``with_lse`` (one counted launch
    of three kernels: ``flash_attention_bwd_sm90`` on the tensor cores,
    ``flash_attention_bwd`` on CUDA cores).  Refuses by shape and dtype
    what the kernels do not take; never falls back to the plain
    version."""
    B, Sq, Sk, H, K, D, Dv = check_shapes(q, k, v)
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention's backward takes fp32 or bf16, "
                        f"got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _build.check_cuda(name, t, q.dtype, 4)
    _build.check_cuda("lse", lse, torch.float32, 3)
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != (B, Sq, H, Dv):
            raise ValueError(f"{name} must be {(B, Sq, H, Dv)}, got "
                             f"{tuple(t.shape)}")
    if tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"lse must be {(B, H, Sq)}, got {tuple(lse.shape)}")
    sm90 = route(q.dtype, D, Dv) == "sm90"
    if sm90:
        for name, t in (("q", q), ("k", k), ("v", v), ("o", o),
                        ("do", do)):
            _build.check_tma(name, t)
    smem = bwd_smem_bytes_sm90(D, Dv) if sm90 else bwd_smem_bytes(D, Dv)
    if smem > _build.smem_optin(q.device):
        raise ValueError(f"flash_attention's backward at D={D}, Dv={Dv} "
                         f"needs {smem} B of shared memory per block, the "
                         f"card allows {_build.smem_optin(q.device)}")
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    shape = (B, Sq, Sk, H, K, D, Dv, softmax_scale(D, scale), int(causal))
    if sm90:
        _build.launch("flash_attention_bwd_sm90", q.device, *(
            t.data_ptr() for t in (q, k, v, o, do, lse, delta, dq, dk, dv)),
            *shape)
        return dq, dk, dv
    # each query head's share of dk and dv, summed over a KV head's G
    # heads in order by the kernel's reduce step (none where G = 1)
    parts = ((torch.empty((B, Sk, H, D), dtype=torch.float32,
                          device=q.device),
              torch.empty((B, Sk, H, Dv), dtype=torch.float32,
                          device=q.device)) if H > K else (None, None))
    _build.launch("flash_attention_bwd", q.device, _DTYPES[q.dtype], *(
        t.data_ptr() for t in (q, k, v, o, do, lse, delta, dq, dk, dv)),
        *(None if t is None else t.data_ptr() for t in parts), *shape)
    return dq, dk, dv
