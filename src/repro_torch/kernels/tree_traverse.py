"""One grove's bundle walk per ring shard, on the card.

Replaces ``repro/kernels/tree_traverse.py::_tree_traverse_kernel`` (Pallas
TPU), which the ring runs when each shard holds one grove.  One launch
covers ``S`` stacked shards: tables ``[S, t, N]`` and ``[S, t, L, C]`` at
their packed dtype, scales ``[S, t]``, ``x [S, b, F]`` -> ``[S, b, C]``;
the TPU kernel's signature is ``S = 1`` with 2-D tables, which the wrapper
also takes.  Per lane: each tree walks ``d`` levels of ``idx = 2*idx + 1 +
(x[f] > thr)`` with the threshold dequantized after the gather, then its
leaf row; rows are summed in tree order and divided by ``t``.

What bounds it is one tree's chain of dependent loads per lane (node,
then ``x[f]``, per level, then the leaf row) and how many SMs carry the
lanes, not bytes.  :func:`tree_traverse_cuda` launches the spread kernel
(``csrc/tree_traverse.cu::tree_traverse_spread_kernel``): it serves
:func:`lane_plan`'s ``lanes`` lanes of one shard a block, so that the grid
has many blocks per SM (2 lanes, 504 blocks at the ring's B = 1000),
reads the grove in place through L1 (a block of a few lanes visits a few
hundred of a grove's nodes), stages the block's x rows in shared memory
where they fit, walks one (lane, tree) a thread, and writes each output
entry once, its trees summed in order.  The first port's kernel (one
thread per lane, ``block_b`` lanes a block, the grove copied into shared
memory one element a thread) stays as the ``"lane"`` route of
:func:`tree_traverse_on_route`, the comparison that ``chip_smoke.py`` times
on the same inputs.  ``_build.routes`` counts each.

``block_b`` is the most lanes one block serves.  A grove must fit one
block's shared memory (:func:`smem_bytes`, :func:`check_smem`, 227 KB on
an H100), as the lane route needs, so both routes accept the same calls.
The plain version is ``ref.tree_traverse_ref``;
:func:`tree_traverse_spread_replay` replays the spread kernel's plan and
tree-order sums in PyTorch, for the tests.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_fog import _DTYPE_CODE
from repro_torch.kernels.ref import dequantize_tables, tree_traverse_ref

__all__ = ["ROUTES", "block_lanes", "check_smem", "lane_plan",
           "smem_bytes", "tree_traverse_cuda", "tree_traverse_ref",
           "tree_traverse_on_route", "tree_traverse_spread_replay"]

ROUTES = ("spread", "lane")
# blocks per SM the lane plan aims at, and the fewest lanes a block serves
BLOCKS_PER_SM = 16
MIN_LANES = 2
# a block stages its lanes' x rows in shared memory up to this many bytes,
# else each level gathers x[f] through L1
X_STAGE_BYTES = 16 * 1024


def smem_bytes(n_trees: int, depth: int, n_classes: int,
               itemsize: int) -> int:
    """Shared memory one block holds: one grove's int32 features, two fp32
    scales per tree, and thresholds and leaves at ``itemsize`` bytes."""
    n_nodes, n_leaves = 2**depth - 1, 2**depth
    return n_trees * (n_nodes * 4 + 2 * 4
                      + (n_nodes + n_leaves * n_classes) * itemsize)


def lane_plan(S: int, b: int, t: int, F: int, block_b: int, n_sm: int,
              lanes: int | None = None) -> dict:
    """The spread kernel's launch: ``lanes`` lanes of one shard a block,
    by default enough blocks for ``BLOCKS_PER_SM`` on each of ``n_sm`` SMs
    (``ceil(S * b / (BLOCKS_PER_SM * n_sm))``, at least ``MIN_LANES``, at
    most ``block_b``); a grid of ``(ceil(b / lanes), S)``; ``threads`` for
    one (lane, tree) each, a multiple of 32 in [32, 1024]; x staged when
    ``lanes * F * 4 <= X_STAGE_BYTES``; the dynamic shared memory (the
    leaf rows, and the x rows when staged).  At the ring's B = 1000 (8
    shards of 125) on 132 SMs: 2 lanes, 63 x 8 = 504 blocks of 32 threads;
    at 65,536: 32 lanes (``chip_smoke.py --sweep``: the fastest of 2-128
    lanes at B = 1000 and 16,384, within 3 % of it at 65,536 and 7 % at
    4096)."""
    if lanes is None:
        lanes = max(1, min(block_b, max(MIN_LANES,
                                        -(-S * b // (BLOCKS_PER_SM * n_sm)))))
    stage_x = lanes * F * 4 <= X_STAGE_BYTES
    return {"lanes": lanes, "grid": (-(-b // lanes), S),
            "threads": min(1024, max(32, -(-lanes * t // 32) * 32)),
            "stage_x": stage_x,
            "smem": t * lanes * 4 + (lanes * F * 4 if stage_x else 0)}


def block_lanes(plan: dict, S: int, b: int):
    """Yield ``(shard, first lane, lanes)`` for every block of ``plan``'s
    grid, as the kernel reads its block index."""
    lanes = plan["lanes"]
    for s in range(plan["grid"][1]):
        for k in range(plan["grid"][0]):
            lane0 = k * lanes
            yield s, lane0, min(lanes, b - lane0)


def tree_traverse_spread_replay(feature, threshold, leaf, x, thr_scale,
                                leaf_scale, plan: dict) -> torch.Tensor:
    """The spread kernel in plain PyTorch on stacked inputs ``[S, ...]``:
    per block of ``plan``, every (lane, tree) walks its tree, then each
    output entry sums its trees' leaf values in tree order and divides by
    ``t``, written once."""
    thr, lf = dequantize_tables(threshold, leaf, thr_scale, leaf_scale)
    S, t, N = feature.shape
    b, F = x.shape[1:]
    C = leaf.shape[3]
    depth = int(np.log2(N + 1) + 0.5)
    tf = torch.tensor(float(t))
    out = torch.full((S, b, C), float("nan"))
    for s, lane0, nl in block_lanes(plan, S, b):
        xb = x[s, lane0:lane0 + nl]
        idx = torch.zeros((nl, t), dtype=torch.long)
        tr = torch.arange(t)[None, :]
        for _ in range(depth):
            f = feature[s][tr, idx].long()
            xv = xb.gather(1, f)
            idx = 2 * idx + 1 + (xv > thr[s][tr, idx]).long()
        rows = lf[s][tr, idx - N]                       # [nl, t, C]
        v = rows[:, 0]
        for k in range(1, t):
            v = v + rows[:, k]
        if not torch.isnan(out[s, lane0:lane0 + nl]).all():
            raise AssertionError(f"shard {s} lanes {lane0}.. served twice")
        out[s, lane0:lane0 + nl] = v / tf
    return out


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
    """Grove bundle walk on CUDA tensors: one launch of the spread kernel
    (``block_b`` is the most lanes a block serves).

    feature    int32           [t, 2**d - 1]   or stacked [S, t, 2**d - 1]
    threshold  fp32|bf16|int8  [t, 2**d - 1]   or [S, t, 2**d - 1]
    leaf       same dtype      [t, 2**d, C]    or [S, t, 2**d, C]
    thr_scale  float32         [t, 1]          or [S, t, 1]    (default ones)
    leaf_scale float32         [t, 1, 1]       or [S, t, 1, 1] (default ones)
    x          float32         [B, F]          or [S, b, F]
    returns    float32         [B, C]          or [S, b, C]
    Feature indices must be < F.
    """
    return tree_traverse_on_route(feature, threshold, leaf, x, thr_scale,
                               leaf_scale, block_b=block_b)


def tree_traverse_on_route(feature, threshold, leaf, x, thr_scale=None,
                        leaf_scale=None, *, block_b: int = 128,
                        route: str = "spread", lanes: int | None = None):
    """:func:`tree_traverse_cuda` on a named route of :data:`ROUTES`:
    ``"spread"`` (``lanes`` overrides :func:`lane_plan`'s lane count) or
    ``"lane"``, the first port's kernel with ``block_b`` lanes a block.
    For measurements and checks that hold the routes side by side."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
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
    itemsize = threshold.element_size()
    optin = _build.smem_optin(x.device)
    check_smem(smem_bytes(t, depth, C, itemsize), optin,
               f"{t} trees of depth {depth}, {C} classes, {threshold.dtype}")
    out = torch.empty((S, b, C), dtype=torch.float32, device=x.device)
    if S and b and C:
        tables = (_DTYPE_CODE[threshold.dtype], feature.data_ptr(),
                  threshold.data_ptr(), leaf.data_ptr(),
                  thr_scale.data_ptr(), leaf_scale.data_ptr(), x.data_ptr(),
                  out.data_ptr(), S, b, F, t, depth, C)
        if route == "lane":
            _build.launch("tree_traverse", x.device, *tables, block_b,
                          smem_bytes(t, depth, C, itemsize))
        else:
            plan = lane_plan(S, b, t, F, block_b, _build.sm_count(x.device),
                             lanes)
            _build.launch("tree_traverse", x.device, *tables, plan["lanes"],
                          plan["threads"], int(plan["stage_x"]),
                          plan["smem"], entry="tree_traverse_spread")
    return out[0] if squeeze else out
