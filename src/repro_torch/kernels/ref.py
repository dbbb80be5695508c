"""Plain PyTorch versions of the inference kernels (port of
``repro.kernels.ref``).  They are what the wrappers in ``kernels.ops`` run
on CPU tensors, and what each CUDA kernel is checked against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.forest.tree import grove_traverse, mean_over_trees
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_ref)
from repro_torch.kernels.ssd_chunk import ssd_chunk_ref  # noqa: F401


def dequantize_tables(threshold: torch.Tensor, leaf: torch.Tensor,
                      thr_scale: torch.Tensor | None = None,
                      leaf_scale: torch.Tensor | None = None):
    """Packed table values -> the fp32 values every backend compares.

    fp32 passes through, bf16 upcasts exactly, int8 multiplies by its
    per-tree fp32 scale (scales broadcast over the trailing node/leaf
    axes) and restores the ±127 threshold codes to ±inf.
    """
    quantized = threshold.dtype == torch.int8
    thr = threshold.to(torch.float32)
    lf = leaf.to(torch.float32)
    if quantized:
        if thr_scale is None or leaf_scale is None:
            raise ValueError("int8 tables need thr_scale/leaf_scale")
        thr = thr * thr_scale
        # ±127 are the padding sentinels (±inf thresholds, "always go
        # left" complete-tree nodes) — restore them exactly
        thr = torch.where(threshold == 127, float("inf"), thr)
        thr = torch.where(threshold == -127, float("-inf"), thr)
        lf = lf * leaf_scale
    return thr, lf


def tree_traverse_ref(feature: torch.Tensor, threshold: torch.Tensor,
                      leaf: torch.Tensor, x: torch.Tensor,
                      thr_scale: torch.Tensor | None = None,
                      leaf_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Grove bundle evaluation: mean leaf distribution over trees.

    feature   int32           [t, 2**d - 1]
    threshold fp32|bf16|int8  [t, 2**d - 1]
    leaf      fp32|bf16|int8  [t, 2**d, C]
    x         float32         [B, F]
    returns   float32         [B, C]

    Stacked ring shards take one more leading axis everywhere: tables
    ``[S, t, ...]`` (scales ``[S, t, 1]`` / ``[S, t, 1, 1]``), ``x [S, b, F]``
    -> ``[S, b, C]``, each shard's lanes walking its own grove.
    """
    threshold, leaf = dequantize_tables(threshold, leaf, thr_scale,
                                        leaf_scale)
    if feature.ndim == 2:
        return mean_over_trees(grove_traverse(feature, threshold, leaf, x))
    S, b, F = x.shape
    shard = torch.arange(S, device=x.device).repeat_interleave(b)
    out = mean_over_trees(grove_traverse(feature, threshold, leaf,
                                         x.reshape(S * b, F), shard))
    return out.reshape(S, b, -1)


def top2_confidence_ref(prob: torch.Tensor) -> torch.Tensor:
    """MaxDiff margin per row: [B, C] -> [B].  Only the first maximal
    entry is masked, so a tie gives a margin of 0."""
    m1 = prob.amax(dim=-1)
    is_max = prob == m1[:, None]
    first = torch.cumsum(is_max.to(torch.int32), dim=-1) == 1
    m2 = torch.where(is_max & first, float("-inf"), prob).amax(dim=-1)
    return (m1 - m2).abs()


def grove_aggregate_ref(prob_acc: torch.Tensor, contrib: torch.Tensor,
                        live: torch.Tensor, hops: torch.Tensor, thresh):
    """Algorithm 2 lines 7-11 fused: accumulate, normalize, gate.

    prob_acc [B, C], contrib [B, C], live [B] bool, hops [B] int32,
    thresh scalar or per-lane [B] -> (prob_acc', hops', live', margin)
    """
    prob_acc = prob_acc + torch.where(live[:, None], contrib,
                                      torch.zeros_like(contrib))
    hops = hops + live.to(torch.int32)
    prob_norm = prob_acc / torch.clamp(hops, min=1)[:, None].to(prob_acc.dtype)
    margin = top2_confidence_ref(prob_norm)
    live = live & (margin < thresh)
    return prob_acc, hops, live, margin
