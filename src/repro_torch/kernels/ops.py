"""Public wrappers for the kernels.

A CPU (or meta) tensor runs the kernel's plain PyTorch version; a CUDA
tensor launches the hand-written CUDA kernel (built at first use) or raises —
there is no fallback.  ``launches`` counts kernel launches per kernel.
On meta (shapes without values, where ``launch.dryrun`` counts a step)
``flash_attention`` and its backward return their kernels' outputs
unfilled instead (:func:`_flash_stand_in`): the plain version's full
score matrix is work and memory the kernels never take.

A kernel's output is a fresh tensor with no autograd history, so a CUDA
dispatch never lets a gradient fall silently out of the graph: with grad
mode on and a floating input that requires grad, ``flash_attention`` and
``ssd_chunk`` go through :class:`FlashAttention` and :class:`SsdChunk`
(their backwards hand-written kernels too, for fp32 and bf16; any other
dtype that needs a gradient, fp16 among them, raises) and every other
kernel raises (``_build.refuse_grad``).  On the CPU the two Functions
run their kernels' plain forward and backward; the other kernels' plain
versions are differentiated by autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import launches, needs_grad, refuse_grad
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                flash_attention_bwd_ref,
                                                flash_attention_cuda,
                                                flash_attention_ref_lse)
from repro_torch.kernels.fused_fog import fused_fog_on_route, fused_fog_ref
from repro_torch.kernels.grove_aggregate import (check_contrib,
                                                 grove_aggregate_cuda)
from repro_torch.kernels.histogram import (histogram_level,
                                           histogram_level_scatter,
                                           onehot_rows)
from repro_torch.kernels.ssd_chunk import (ssd_chunk_bwd_cuda,
                                           ssd_chunk_bwd_ref, ssd_chunk_cuda)
from repro_torch.kernels.top2_confidence import (partial_runs,
                                                 top2_confidence_cuda,
                                                 top2_merge_cuda,
                                                 top2_partials_cuda)
from repro_torch.kernels.tree_traverse import tree_traverse_cuda


# the devices whose tensors run a kernel's plain version: the CPU, and
# ``meta`` (shapes without values: ``launch.dryrun`` counts the work of a
# step there, and meta runs nothing, so no kernel is passed over)
PLAIN_DEVICES = ("cpu", "meta")


def _runs_plain(t: torch.Tensor) -> bool:
    return t.device.type in PLAIN_DEVICES


def _stands_in(t: torch.Tensor) -> bool:
    """Whether the attention kernels' outputs are only allocated (meta)."""
    return t.device.type == "meta"


# where set (a list), each stand-in call appends (kind, q, k and v's
# shapes, q's itemsize, causal, the bytes of its inputs), for
# ``launch.dryrun`` to price as the kernel's work
stand_in_calls: list | None = None


def _flash_stand_in(kind: str, inputs: tuple, outputs: tuple,
                    causal: bool) -> tuple:
    """The outputs a flash kernel would write, allocated with the shapes
    and dtypes of ``outputs`` ((shape, dtype) pairs), nothing computed;
    the call is recorded in ``stand_in_calls``."""
    q, k, v = inputs[:3]
    if stand_in_calls is not None:
        stand_in_calls.append((kind, tuple(q.shape), tuple(k.shape),
                               tuple(v.shape), q.element_size(), causal,
                               sum(t.numel() * t.element_size()
                                   for t in inputs)))
    return tuple(q.new_empty(sh, dtype=dt) for sh, dt in outputs)


# the dtypes whose gradient the backward kernels take; the plain versions
# on the CPU take float64 too (an oracle's)
GRAD_DTYPES = (torch.float32, torch.bfloat16)


def _refuse_dtype(kernel: str, t: torch.Tensor) -> None:
    if t.dtype in GRAD_DTYPES or (t.dtype == torch.float64
                                  and _runs_plain(t)):
        return
    raise TypeError(
        f"{kernel}'s backward kernels take fp32 or bf16, got {t.dtype}; an "
        f"input requires grad, and its output would carry no gradient. "
        f"Train in fp32 or bf16, or run it under torch.no_grad()")


def tree_traverse(feature, threshold, leaf, x, thr_scale=None,
                  leaf_scale=None, *, block_b: int = 128):
    """Grove bundle walk [B, F] -> [B, C] over packed fp32/bf16/int8 tables,
    or over ``S`` stacked ring shards ``[S, b, F] -> [S, b, C]`` (plain:
    ref.tree_traverse_ref).  Omitted scales are ones."""
    if _runs_plain(x):
        if thr_scale is None:
            thr_scale = torch.ones(feature.shape[:-1] + (1,))
        if leaf_scale is None:
            leaf_scale = torch.ones(leaf.shape[:-2] + (1, 1))
        return ref.tree_traverse_ref(feature, threshold, leaf, x, thr_scale,
                                     leaf_scale)
    refuse_grad("tree_traverse", threshold, leaf, x)
    return tree_traverse_cuda(feature, threshold, leaf, x, thr_scale,
                              leaf_scale, block_b=block_b)


def top2_confidence(prob: torch.Tensor, *, block_b: int = 256) -> torch.Tensor:
    """MaxDiff margin [B, C] -> [B] (plain: ref.top2_confidence_ref)."""
    if _runs_plain(prob):
        return ref.top2_confidence_ref(prob)
    refuse_grad("top2_confidence", prob)
    return top2_confidence_cuda(prob, block_b=block_b)


def top2_partials(prob: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """The top-2 partials [3, B, n] of a [B, C] block of each row whose
    first column is ``offset`` (plain: ref.top2_partials_ref, at the
    kernel's runs a row)."""
    if _runs_plain(prob):
        return ref.top2_partials_ref(prob, offset,
                                     partial_runs(*prob.shape))
    refuse_grad("top2_confidence", prob)
    return top2_partials_cuda(prob, offset)


def top2_merge(parts: torch.Tensor) -> torch.Tensor:
    """MaxDiff margins [B] from partials [3, B, n] covering each row
    (plain: ref.top2_merge_ref)."""
    if _runs_plain(parts):
        return ref.top2_merge_ref(parts)
    return top2_merge_cuda(parts)


def grove_aggregate(prob_acc, contrib, live, hops, thresh, *,
                    block_b: int = 256):
    """Fused Algorithm-2 hop update; thresh is a scalar or per-lane [B]
    vector (plain: ref.grove_aggregate_ref)."""
    check_contrib(contrib)
    if _runs_plain(prob_acc):
        return ref.grove_aggregate_ref(prob_acc, contrib, live, hops, thresh)
    refuse_grad("grove_aggregate", prob_acc, contrib, thresh)
    return grove_aggregate_cuda(prob_acc, contrib, live, hops, thresh,
                                block_b=block_b)


def fused_fog(feature, threshold, leaf, x, start, thresh, budget,
              thr_scale=None, leaf_scale=None, *, max_hops: int,
              block_b: int = 128, route: str | None = None,
              hops_per_walk: int | None = None):
    """Whole Algorithm-2 loop over head-stacked packed tables; returns
    (proba [B, O, C], hops [B]) (plain: fused_fog.fused_fog_ref).  On the
    card ``route`` and ``hops_per_walk`` name the launch (``None``: the
    rule's); the plain version has neither."""
    if _runs_plain(x):
        return fused_fog_ref(feature, threshold, leaf, x, start, thresh,
                             budget, thr_scale, leaf_scale,
                             max_hops=max_hops, block_b=block_b)
    refuse_grad("fused_fog", threshold, leaf, x, thresh)
    return fused_fog_on_route(feature, threshold, leaf, x, start, thresh,
                              budget, thr_scale, leaf_scale,
                              max_hops=max_hops, block_b=block_b,
                              route=route, hops_per_walk=hops_per_walk)


def _ssd_forward(xbar, a, Bm, Cm):
    if _runs_plain(xbar):
        return ref.ssd_chunk_ref(xbar, a, Bm, Cm)
    return ssd_chunk_cuda(xbar, a, Bm, Cm)


class SsdChunk(torch.autograd.Function):
    """``ssd_chunk`` with a gradient: the forward (the kernel on CUDA, the
    plain version on the CPU) saves xbar, a, Bm and Cm; the backward is
    ``ssd_chunk_bwd_cuda`` on CUDA, on the forward's route rule
    (``ssd_chunk.route``): bf16 at P = 64, N in {64, 128} on the tensor
    cores (``csrc/ssd_chunk_bwd_sm90.cu``, which rounds W_h and dS to bf16
    as its products' operands, replayed by
    ``ssd_chunk.ssd_chunk_bwd_sm90_replay``), fp32 and every other shape
    on CUDA cores (``csrc/ssd_chunk_bwd.cu``: fp32 register tiles over
    shared-memory tiles, dS summed over groups of
    ``ssd_chunk.simt_bwd_heads_per_group`` heads whose partials the dB/dC
    pass adds in group order, five launches, no atomics);
    ``ssd_chunk_bwd_ref`` on the CPU.  An unused output's gradient arrives
    as zeros."""

    @staticmethod
    def forward(ctx, xbar, a, Bm, Cm):
        y, states = _ssd_forward(xbar, a, Bm, Cm)
        ctx.save_for_backward(xbar, a, Bm, Cm)
        return y, states

    @staticmethod
    def backward(ctx, dy, dstates):
        xbar, a, Bm, Cm = ctx.saved_tensors
        bwd = ssd_chunk_bwd_ref if _runs_plain(xbar) else ssd_chunk_bwd_cuda
        return bwd(xbar, a, Bm, Cm, dy.contiguous(), dstates.contiguous())


def ssd_chunk(xbar, a, Bm, Cm):
    """Mamba-2 SSD intra-chunk block: xbar [B, nc, Q, H, P], a [B, nc, H, Q],
    Bm/Cm [B, nc, Q, N] -> (y_diag [B, nc, Q, H, P], states
    [B, nc, H, P, N]) in xbar's dtype (plain: ref.ssd_chunk_ref).  Where a
    gradient is wanted it goes through :class:`SsdChunk` (fp32 or bf16;
    another dtype raises)."""
    if needs_grad(xbar, a, Bm, Cm):
        _refuse_dtype("ssd_chunk", xbar)
        return SsdChunk.apply(xbar, a, Bm, Cm)
    return _ssd_forward(xbar, a, Bm, Cm)


def _flash_forward(q, k, v, causal, scale, with_lse):
    if _stands_in(q):
        B, Sq, H, _ = q.shape
        out, lse = _flash_stand_in(
            "flash_attention", (q, k, v),
            (((B, Sq, H, v.shape[-1]), q.dtype), ((B, H, Sq), torch.float32)),
            causal)
        return (out, lse) if with_lse else out
    if _runs_plain(q):
        out, lse = flash_attention_ref_lse(q, k, v, causal=causal,
                                           scale=scale)
        return (out, lse) if with_lse else out
    return flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                with_lse=with_lse)


def _flash_backward(q, k, v, o, do, lse, causal, scale):
    if _stands_in(q):
        return _flash_stand_in(
            "flash_attention_bwd", (q, k, v, o, do, lse),
            tuple((t.shape, t.dtype) for t in (q, k, v)), causal)
    if _runs_plain(q):
        return flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                       scale=scale)
    return flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                                    scale=scale)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward (the kernel of
    ``flash_attention.route`` with its per-row lse on CUDA, the plain
    version on the CPU) saves q, k, v, the output and lse; the backward
    is ``flash_attention_bwd_cuda`` on CUDA (the same route: the
    tensor-core backward for bf16 at the (D, Dv) pairs of
    ``flash_attention.SM90_PAIRS``, the SIMT one otherwise),
    ``flash_attention_bwd_ref`` on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale):
        out, lse = _flash_forward(q, k, v, causal, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, out, do.contiguous(), lse,
                                     ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """GQA/MQA attention q [B, Sq, H, D], k [B, Sk, K, D], v [B, Sk, K, Dv]
    -> [B, Sq, H, Dv] in q's dtype, causal with both positions counted from
    0 (plain: ref.flash_attention_ref).  Where a gradient is wanted it goes
    through :class:`FlashAttention` (fp32 or bf16; another dtype
    raises)."""
    if needs_grad(q, k, v):
        _refuse_dtype("flash_attention", q)
        return FlashAttention.apply(q, k, v, causal, scale)
    return _flash_forward(q, k, v, causal, scale, False)


__all__ = ["tree_traverse", "top2_confidence", "top2_partials", "top2_merge", "grove_aggregate", "fused_fog",
           "histogram_level", "histogram_level_scatter", "onehot_rows",
           "ssd_chunk", "SsdChunk", "flash_attention", "FlashAttention",
           "launches",
           "ref"]
