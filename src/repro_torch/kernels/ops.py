"""Public wrappers for the kernels.

A CPU tensor runs the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written CUDA kernel (built at first use) or raises —
there is no fallback.  ``launches`` counts kernel launches per kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import launches
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.fused_fog import fused_fog_on_route, fused_fog_ref
from repro_torch.kernels.grove_aggregate import (check_contrib,
                                                 grove_aggregate_cuda)
from repro_torch.kernels.histogram import (histogram_level,
                                           histogram_level_scatter,
                                           onehot_rows)
from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda
from repro_torch.kernels.top2_confidence import top2_confidence_cuda
from repro_torch.kernels.tree_traverse import tree_traverse_cuda


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def tree_traverse(feature, threshold, leaf, x, thr_scale=None,
                  leaf_scale=None, *, block_b: int = 128):
    """Grove bundle walk [B, F] -> [B, C] over packed fp32/bf16/int8 tables,
    or over ``S`` stacked ring shards ``[S, b, F] -> [S, b, C]`` (plain:
    ref.tree_traverse_ref).  Omitted scales are ones."""
    if _on_cpu(x):
        if thr_scale is None:
            thr_scale = torch.ones(feature.shape[:-1] + (1,))
        if leaf_scale is None:
            leaf_scale = torch.ones(leaf.shape[:-2] + (1, 1))
        return ref.tree_traverse_ref(feature, threshold, leaf, x, thr_scale,
                                     leaf_scale)
    return tree_traverse_cuda(feature, threshold, leaf, x, thr_scale,
                              leaf_scale, block_b=block_b)


def top2_confidence(prob: torch.Tensor, *, block_b: int = 256) -> torch.Tensor:
    """MaxDiff margin [B, C] -> [B] (plain: ref.top2_confidence_ref)."""
    if _on_cpu(prob):
        return ref.top2_confidence_ref(prob)
    return top2_confidence_cuda(prob, block_b=block_b)


def grove_aggregate(prob_acc, contrib, live, hops, thresh, *,
                    block_b: int = 256):
    """Fused Algorithm-2 hop update; thresh is a scalar or per-lane [B]
    vector (plain: ref.grove_aggregate_ref)."""
    check_contrib(contrib)
    if _on_cpu(prob_acc):
        return ref.grove_aggregate_ref(prob_acc, contrib, live, hops, thresh)
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
    if _on_cpu(x):
        return fused_fog_ref(feature, threshold, leaf, x, start, thresh,
                             budget, thr_scale, leaf_scale,
                             max_hops=max_hops, block_b=block_b)
    return fused_fog_on_route(feature, threshold, leaf, x, start, thresh,
                              budget, thr_scale, leaf_scale,
                              max_hops=max_hops, block_b=block_b,
                              route=route, hops_per_walk=hops_per_walk)


def ssd_chunk(xbar, a, Bm, Cm):
    """Mamba-2 SSD intra-chunk block: xbar [B, nc, Q, H, P], a [B, nc, H, Q],
    Bm/Cm [B, nc, Q, N] -> (y_diag [B, nc, Q, H, P], states
    [B, nc, H, P, N]) in xbar's dtype (plain: ref.ssd_chunk_ref)."""
    if _on_cpu(xbar):
        return ref.ssd_chunk_ref(xbar, a, Bm, Cm)
    return ssd_chunk_cuda(xbar, a, Bm, Cm)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """GQA/MQA attention q [B, Sq, H, D], k [B, Sk, K, D], v [B, Sk, K, Dv]
    -> [B, Sq, H, Dv] in q's dtype, causal with both positions counted from
    0 (plain: ref.flash_attention_ref)."""
    if _on_cpu(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    return flash_attention_cuda(q, k, v, causal=causal, scale=scale)


__all__ = ["tree_traverse", "top2_confidence", "grove_aggregate", "fused_fog",
           "histogram_level", "histogram_level_scatter", "onehot_rows",
           "ssd_chunk", "flash_attention", "launches", "ref"]
