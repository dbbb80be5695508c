"""The whole Algorithm-2 loop in one launch, on the card.

Replaces ``repro/kernels/fused_fog.py::_fused_fog_kernel`` (Pallas TPU).
CUDA source: ``csrc/fog_kernels.cu::fused_fog_kernel``, templated on the
table dtype.  One thread per lane, ``block_b`` threads per block; each
thread loops ``j < max_hops`` and stops as soon as its lane dies.  A hop
walks grove ``(start + j) % G`` of every head: per tree, ``d`` levels of
``idx = 2*idx + 1 + (x[f] > thr)``, then the leaf row at ``idx - (L-1)``.
Values are dequantized after the gather (int8: the codes ±127 are ±inf
thresholds, otherwise ``q * scale``; bf16: exact upcast).  Leaf rows are
summed over trees in order and divided by ``t``, accumulated, divided by
``max(hops, 1)``, and gated on the first-max MaxDiff (minimum over heads)
against the lane's threshold and hop budget.

It is bound by the latency of its dependent gathers (``d`` levels x ``t``
trees per hop), not by bytes: the tables are read from global memory and
the bench field (192 KiB at fp32) stays resident in L2.  The ``[O, C]``
accumulators of each lane live in a scratch buffer the wrapper allocates,
laid out lane-minor.  The TPU kernel's live-lane compaction only relocates
lanes; one thread per lane already stops walking dead lanes, so the port
has no ``compact`` knob.

:func:`fused_fog_ref` is the plain version: the same loop in PyTorch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.forest.tree import grove_traverse, mean_over_trees
from repro_torch.kernels import _build
from repro_torch.kernels.ref import dequantize_tables, top2_confidence_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _scales(feature, thr_scale, leaf_scale):
    O, G, t, _ = feature.shape
    if thr_scale is None:
        thr_scale = torch.ones((O, G, t, 1), dtype=torch.float32,
                               device=feature.device)
    if leaf_scale is None:
        leaf_scale = torch.ones((O, G, t, 1, 1), dtype=torch.float32,
                                device=feature.device)
    return thr_scale, leaf_scale


def fused_fog_ref(feature, threshold, leaf, x, start, thresh, budget,
                  thr_scale=None, leaf_scale=None, *, max_hops: int,
                  block_b: int = 128):
    """Plain PyTorch Algorithm 2 over head-stacked packed tables.

    Same arguments and results as :func:`fused_fog_cuda`; ``block_b`` has
    no effect here.  Every lane is walked each hop and dead lanes are
    masked; the loop stops once no lane is live.
    """
    thr_scale, leaf_scale = _scales(feature, thr_scale, leaf_scale)
    thr, lf = dequantize_tables(threshold, leaf, thr_scale, leaf_scale)
    B = x.shape[0]
    O, G = feature.shape[:2]
    C = leaf.shape[4]
    prob = torch.zeros((O, B, C), dtype=torch.float32, device=x.device)
    live = torch.ones((B,), dtype=torch.bool, device=x.device)
    hops = torch.zeros((B,), dtype=torch.int32, device=x.device)
    start = start.to(torch.long)
    for j in range(max_hops):
        if not bool(live.any()):
            break
        g = (start + j) % G
        for o in range(O):
            contrib = mean_over_trees(
                grove_traverse(feature[o], thr[o], lf[o], x, g))
            prob[o] = prob[o] + torch.where(live[:, None], contrib,
                                            torch.zeros_like(contrib))
        hops = hops + live.to(torch.int32)
        denom = torch.clamp(hops, min=1).to(torch.float32)
        margin = top2_confidence_ref(
            (prob / denom[None, :, None]).reshape(O * B, C))
        margin = margin.reshape(O, B).amin(dim=0)   # min over heads
        live = live & (margin < thresh) & (hops < budget)
    denom = torch.clamp(hops, min=1).to(torch.float32)
    proba = (prob / denom[None, :, None]).permute(1, 0, 2).contiguous()
    return proba, hops


def fused_fog_cuda(feature, threshold, leaf, x, start, thresh, budget,
                   thr_scale=None, leaf_scale=None, *, max_hops: int,
                   block_b: int = 128):
    """One-launch Algorithm 2 over head-stacked packed CUDA tables.

    feature    int32           [O, G, t, 2**d - 1]
    threshold  fp32|bf16|int8  [O, G, t, 2**d - 1]
    leaf       same dtype      [O, G, t, 2**d, C]
    thr_scale  float32         [O, G, t, 1]      (default ones)
    leaf_scale float32         [O, G, t, 1, 1]   (default ones)
    x float32 [B, F]; start int32 [B] in [0, G); thresh float32 [B];
    budget int32 [B].  Feature indices must be < F.
    returns    (proba float32 [B, O, C], hops int32 [B])
    """
    _build.check_block(block_b)
    thr_scale, leaf_scale = _scales(feature, thr_scale, leaf_scale)
    if threshold.dtype not in _DTYPE_CODE or leaf.dtype != threshold.dtype:
        raise TypeError(f"tables must be fp32, bf16 or int8 with one dtype, "
                        f"got threshold {threshold.dtype}, leaf {leaf.dtype}")
    for name, t, dt, nd in (
            ("feature", feature, torch.int32, 4),
            ("threshold", threshold, threshold.dtype, 4),
            ("leaf", leaf, threshold.dtype, 5),
            ("thr_scale", thr_scale, torch.float32, 4),
            ("leaf_scale", leaf_scale, torch.float32, 5),
            ("x", x, torch.float32, 2), ("start", start, torch.int32, 1),
            ("thresh", thresh, torch.float32, 1),
            ("budget", budget, torch.int32, 1)):
        _build.check_cuda(name, t, dt, nd)
    B, F = x.shape
    O, G, t, N = feature.shape
    L, C = leaf.shape[3], leaf.shape[4]
    depth = int(np.log2(L) + 0.5)
    if (N != L - 1 or L != 2**depth or threshold.shape != feature.shape
            or leaf.shape[:3] != feature.shape[:3]
            or any(v.shape != (B,) for v in (start, thresh, budget))):
        raise ValueError(
            f"inconsistent shapes: feature {tuple(feature.shape)}, threshold "
            f"{tuple(threshold.shape)}, leaf {tuple(leaf.shape)}, x "
            f"{tuple(x.shape)}, start/thresh/budget {tuple(start.shape)}/"
            f"{tuple(thresh.shape)}/{tuple(budget.shape)}")
    proba = torch.empty((B, O, C), dtype=torch.float32, device=x.device)
    hops = torch.empty((B,), dtype=torch.int32, device=x.device)
    # per-lane [O, C] accumulators plus one [C] grove contribution
    scratch = torch.empty(((O + 1) * C * B,), dtype=torch.float32,
                          device=x.device)
    if B:
        _build.launch(
            "fused_fog", x.device,
            _DTYPE_CODE[threshold.dtype], feature.data_ptr(),
            threshold.data_ptr(), leaf.data_ptr(), thr_scale.data_ptr(),
            leaf_scale.data_ptr(), x.data_ptr(), start.data_ptr(),
            thresh.data_ptr(), budget.data_ptr(), proba.data_ptr(),
            hops.data_ptr(), scratch.data_ptr(), B, F, O, G, t, depth, C,
            max_hops, block_b)
    return proba, hops
