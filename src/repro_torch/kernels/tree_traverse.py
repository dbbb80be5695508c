"""One grove's bundle walk per ring shard, on the card.

Replaces ``repro/kernels/tree_traverse.py::_tree_traverse_kernel`` (Pallas
TPU), which the ring runs when each shard holds one grove.  CUDA source:
``csrc/tree_traverse.cu::tree_traverse_kernel``, templated on the table
dtype.  One launch covers ``S`` stacked shards: tables ``[S, t, N]`` and
``[S, t, L, C]`` at their packed dtype, scales ``[S, t]``, ``x [S, b, F]``
-> ``[S, b, C]``; the TPU kernel's signature is ``S = 1`` with 2-D tables,
which the wrapper also takes.  The grid is ``(ceil(b / block_b), S)``.
Each block copies its shard's grove into dynamic shared memory at the
packed width (the counterpart of the TPU kernel's VMEM-pinned tables),
then one thread per lane walks the ``t`` trees: ``d`` levels of
``idx = 2*idx + 1 + (x[f] > thr)`` with the threshold dequantized after
the gather, then the leaf row; rows are summed in tree order and divided
by ``t``.

It is bound by each lane's chain of dependent loads (node from shared
memory, then ``x[f]`` from global memory, per level), not by bytes.

A grove must fit one block's shared memory: :func:`smem_bytes` counts it
and :func:`check_smem` rejects one over the device's opt-in limit
(227 KB on an H100) with the remedies.  The plain version is
``ref.tree_traverse_ref``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_fog import _DTYPE_CODE
from repro_torch.kernels.ref import tree_traverse_ref

__all__ = ["check_smem", "smem_bytes", "tree_traverse_cuda",
           "tree_traverse_ref"]


def smem_bytes(n_trees: int, depth: int, n_classes: int,
               itemsize: int) -> int:
    """Shared memory one block holds: one grove's int32 features, two fp32
    scales per tree, and thresholds and leaves at ``itemsize`` bytes."""
    n_nodes, n_leaves = 2**depth - 1, 2**depth
    return n_trees * (n_nodes * 4 + 2 * 4
                      + (n_nodes + n_leaves * n_classes) * itemsize)


def check_smem(required: int, available: int, detail: str) -> None:
    """Raise ``ValueError`` when a grove needs more shared memory than one
    block may hold, naming both sizes and the remedies."""
    if required > available:
        raise ValueError(
            f"tree_traverse needs {required} B of shared memory per block "
            f"for one grove ({detail}) but the device allows {available} B "
            "per block; remedies: pack the tables with precision=\"int8\" "
            "(~4x smaller than fp32), or use smaller groves (fewer trees "
            "per grove, less depth)")


def _stacked(feature, threshold, leaf, x, thr_scale, leaf_scale):
    """The TPU signature (2-D tables, ``x [B, F]``) as one stacked shard;
    scales default to ones and flatten to ``[S, t]``."""
    if feature.ndim == 2:
        feature, threshold, leaf = feature[None], threshold[None], leaf[None]
        x = x[None]
        thr_scale = None if thr_scale is None else thr_scale[None]
        leaf_scale = None if leaf_scale is None else leaf_scale[None]
    S, t = feature.shape[:2]
    ones = torch.ones((S, t), dtype=torch.float32, device=feature.device)
    thr_scale = ones if thr_scale is None else thr_scale.reshape(S, t)
    leaf_scale = ones if leaf_scale is None else leaf_scale.reshape(S, t)
    return (feature, threshold, leaf, x, thr_scale.contiguous(),
            leaf_scale.contiguous())


def tree_traverse_cuda(feature, threshold, leaf, x, thr_scale=None,
                       leaf_scale=None, *, block_b: int = 128):
    """Grove bundle walk on CUDA tensors (one kernel launch).

    feature    int32           [t, 2**d - 1]   or stacked [S, t, 2**d - 1]
    threshold  fp32|bf16|int8  [t, 2**d - 1]   or [S, t, 2**d - 1]
    leaf       same dtype      [t, 2**d, C]    or [S, t, 2**d, C]
    thr_scale  float32         [t, 1]          or [S, t, 1]    (default ones)
    leaf_scale float32         [t, 1, 1]       or [S, t, 1, 1] (default ones)
    x          float32         [B, F]          or [S, b, F]
    returns    float32         [B, C]          or [S, b, C]
    Feature indices must be < F.
    """
    _build.check_block(block_b)
    squeeze = feature.ndim == 2
    feature, threshold, leaf, x, thr_scale, leaf_scale = _stacked(
        feature, threshold, leaf, x, thr_scale, leaf_scale)
    if threshold.dtype not in _DTYPE_CODE or leaf.dtype != threshold.dtype:
        raise TypeError(f"tables must be fp32, bf16 or int8 with one dtype, "
                        f"got threshold {threshold.dtype}, leaf {leaf.dtype}")
    for name, t_, dt, nd in (
            ("feature", feature, torch.int32, 3),
            ("threshold", threshold, threshold.dtype, 3),
            ("leaf", leaf, threshold.dtype, 4),
            ("thr_scale", thr_scale, torch.float32, 2),
            ("leaf_scale", leaf_scale, torch.float32, 2),
            ("x", x, torch.float32, 3)):
        _build.check_cuda(name, t_, dt, nd)
    S, t, N = feature.shape
    L, C = leaf.shape[2], leaf.shape[3]
    b, F = x.shape[1], x.shape[2]
    depth = int(np.log2(L) + 0.5)
    if (N != L - 1 or L != 2**depth or threshold.shape != feature.shape
            or leaf.shape[:2] != (S, t) or x.shape[0] != S or S > 65535):
        raise ValueError(
            f"inconsistent shapes: feature {tuple(feature.shape)}, threshold "
            f"{tuple(threshold.shape)}, leaf {tuple(leaf.shape)}, x "
            f"{tuple(x.shape)} (at most 65535 shards)")
    smem = smem_bytes(t, depth, C, threshold.element_size())
    check_smem(smem, _build.smem_optin(x.device),
               f"{t} trees of depth {depth}, {C} classes, {threshold.dtype}")
    out = torch.empty((S, b, C), dtype=torch.float32, device=x.device)
    if S and b and C:
        _build.launch(
            "tree_traverse", x.device, _DTYPE_CODE[threshold.dtype],
            feature.data_ptr(), threshold.data_ptr(), leaf.data_ptr(),
            thr_scale.data_ptr(), leaf_scale.data_ptr(), x.data_ptr(),
            out.data_ptr(), S, b, F, t, depth, C, block_b, smem)
    return out[0] if squeeze else out
