"""The device trainer's per-level split-search histograms.

Replaces ``repro/kernels/histogram.py::_hist_kernel`` (Pallas TPU).  The
trainer (``forest/grow.py``) reduces each level of tree induction to one
tensor: per-(tree, node, feature, bin, class) weighted sample counts
``[T, nodes, F, n_bins, C]`` fp32, from which every candidate split's gain
falls out of a cumsum.  Four parts:

``histogram_level_cuda``
    The hand-written CUDA kernel (``csrc/histogram.cu``): a per-block
    shared-memory histogram that writes each cell once.  A tile is the
    rows of (tree, a group of nodes) at a group of features, as
    :func:`tile_plan` cuts them to fit a block's shared memory; one block,
    or a cluster of up to 8 blocks that merge their copies through
    distributed shared memory, owns it, adds its samples' weights with
    shared-memory atomics and writes the tile once into a ``torch.empty``
    ``[T, nodes*C, F*n_bins]`` buffer, which is then viewed as
    ``[T, nodes, F, n_bins, C]``.  The TPU kernel forms the same sum as a
    one-hot matmul; on Hopper the native form is a scatter-add.  No fill
    kernel and no global atomic; the source's header says what bounds it
    and what holds its deep levels back.
``histogram_level_ref``
    Its plain version: the TPU kernel's one-hot contraction in PyTorch
    (rows one-hot in ``node*C + y`` weighted by the bootstrap multiplicity,
    columns one-hot in ``(feature, bin)``).  The CPU path and the checks
    use it; nothing on the card's main path does.
``histogram_level_scatter``
    The segment-sum twin (the JAX package's XLA path, not a Pallas kernel):
    ``index_add_`` of each sample's precomputed weighted ``(feature, bin)``
    one-hot row (:func:`onehot_rows`) into its ``node*C + y`` row.
``histogram_level``
    The dispatcher: the kernel (its plain version on the CPU) while the
    level's ``nodes * n_classes`` rows are at most ``matmul_max_r``, else
    the scatter twin.  The crossover comes from
    :func:`repro_torch.kernels.autotune.best_hist_config`.

Weighted counts are integer-valued, so fp32 sums are exact below 2**24
samples per cell: every path, in any summation order (atomics included),
gives the same bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

__all__ = ["TilePlan", "histogram_level", "histogram_level_cuda",
           "histogram_level_ref", "histogram_level_scatter", "onehot_rows",
           "tile_plan"]

# CUDA threads per block when nothing chooses one (the block
# autotune.tune_histogram picks at the gate signature on an H100, PERF.md)
DEFAULT_BLOCK = 512
# a tile's shared memory (4 nodes at the gate config), unless one node's
# classes at one feature need more
TILE_BYTES = 48 * 1024
# the largest portable thread-block cluster
MAX_CLUSTER = 8
# samples a thread of the kernel checks per round of its scan
# (csrc/histogram.cu::SCAN_PER_THREAD)
SCAN_PER_THREAD = 4


@dataclass(frozen=True)
class TilePlan:
    """How ``csrc/histogram.cu`` cuts one level: tiles of (tree,
    ``nodes_per_block`` nodes, ``features_per_block`` features), each owned
    by a cluster of ``cluster`` blocks that split the tree's samples into
    contiguous ranges; ``grid`` is (cluster, node groups x feature groups,
    trees) and ``smem_bytes`` one block's shared memory: the tile in whole
    16-byte units, then a round's list of samples."""
    nodes_per_block: int
    features_per_block: int
    cluster: int
    grid: tuple[int, int, int]
    smem_bytes: int


def tile_plan(T: int, N: int, F: int, n_bins: int, n_classes: int,
              n_nodes: int, *, block: int = DEFAULT_BLOCK, n_sm: int = 132,
              smem_limit: int = 232_448) -> TilePlan:
    """The tile plan of one level: as many features, then as many nodes,
    as fit ``TILE_BYTES`` of shared memory (one node's classes at one
    feature at the least, up to ``smem_limit``), and clusters of up to
    ``MAX_CLUSTER`` blocks while the tiles alone give the card's ``n_sm``
    multiprocessors fewer than one block each (and each block keeps at
    least ``block`` samples)."""
    row = n_classes * n_bins * 4
    if row > smem_limit:
        raise ValueError(
            f"histogram: one node's {n_classes} classes x {n_bins} bins at "
            f"one feature need {row} B of shared memory, the card allows "
            f"{smem_limit}")
    budget = max(TILE_BYTES, row)
    fpb = min(F, budget // row)
    npb = min(n_nodes, budget // (row * fpb)) if fpb == F else 1
    groups = -(-n_nodes // npb) * -(-F // fpb)
    if groups > 65535 or T > 65535:
        raise ValueError(f"histogram launches {groups} tiles per tree and "
                         f"{T} trees, at most 65535 each")
    tiles = T * groups
    cluster = max(1, min(MAX_CLUSTER, -(-n_sm // tiles), -(-N // block)))
    # the tile in whole 16-byte units, then a round's list of samples
    # (SCAN_PER_THREAD a thread: ids, tile rows, weights) and its length
    smem = (-(-npb * fpb * n_classes * n_bins // 4) * 16
            + block * SCAN_PER_THREAD * 12 + 16)
    if smem > smem_limit:
        raise ValueError(f"histogram: a block needs {smem} B of shared "
                         f"memory at block={block}, the card allows "
                         f"{smem_limit}")
    return TilePlan(npb, fpb, cluster, (cluster, groups, T), smem)


def _as_level(hist: torch.Tensor, n_nodes: int, n_classes: int,
              n_features: int, n_bins: int) -> torch.Tensor:
    """[T, nodes*C, F*n_bins] -> [T, nodes, F, n_bins, C] (a view)."""
    T = hist.shape[0]
    return hist.view(T, n_nodes, n_classes, n_features,
                     n_bins).permute(0, 1, 3, 4, 2)


def histogram_level_cuda(node: torch.Tensor, y: torch.Tensor,
                         w: torch.Tensor, bins: torch.Tensor, *,
                         n_nodes: int, n_bins: int, n_classes: int,
                         block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """[T,N] int32 node ids x [N] int32 labels x [T,N] fp32 weights x
    [N,F] uint8 bins (CUDA tensors) -> [T, n_nodes, F, n_bins, C] fp32
    counts, in one kernel launch that writes every cell (no fill).  Exact
    below 2**24 samples per cell.  ``block``: threads per block."""
    _build.check_block(block)
    for name, t, dt, nd in (("node", node, torch.int32, 2),
                            ("y", y, torch.int32, 1),
                            ("w", w, torch.float32, 2),
                            ("bins", bins, torch.uint8, 2)):
        _build.check_cuda(name, t, dt, nd)
    T, N = node.shape
    F = bins.shape[1]
    if w.shape != node.shape or y.shape != (N,) or bins.shape[0] != N:
        raise ValueError(f"shape mismatch: node {tuple(node.shape)}, y "
                         f"{tuple(y.shape)}, w {tuple(w.shape)}, bins "
                         f"{tuple(bins.shape)}")
    out = torch.empty((T, n_nodes * n_classes, F * n_bins),
                      dtype=torch.float32, device=node.device)
    if out.numel():
        plan = tile_plan(T, N, F, n_bins, n_classes, n_nodes, block=block,
                         n_sm=_build.sm_count(node.device),
                         smem_limit=_build.smem_optin(node.device))
        _build.launch("histogram", node.device, node.data_ptr(),
                      y.data_ptr(), w.data_ptr(), bins.data_ptr(),
                      out.data_ptr(), T, N, F, n_bins, n_classes, n_nodes,
                      plan.nodes_per_block, plan.features_per_block,
                      plan.cluster, block)
    return _as_level(out, n_nodes, n_classes, F, n_bins)


def _onehot_bins(bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """[N, F] bins -> [N, F*n_bins] fp32 one-hot columns."""
    N, F = bins.shape
    iota = torch.arange(n_bins, device=bins.device)
    return (bins.long()[:, :, None] == iota).to(torch.float32).reshape(
        N, F * n_bins)


def histogram_level_ref(node: torch.Tensor, y: torch.Tensor,
                        w: torch.Tensor, bins: torch.Tensor, *,
                        n_nodes: int, n_bins: int,
                        n_classes: int) -> torch.Tensor:
    """The kernel's plain version: the one-hot contraction of
    ``_hist_kernel``, ``onehot(node*C + y, weighted)^T @ onehot(bins)``
    per tree -> [T, n_nodes, F, n_bins, C] fp32."""
    T, N = node.shape
    F = bins.shape[1]
    R = n_nodes * n_classes
    row = node.long() * n_classes + y.long()[None, :]            # [T, N]
    iota = torch.arange(R, device=node.device)
    a = torch.where(row[:, :, None] == iota, w.to(torch.float32)[:, :, None],
                    0.0)                                          # [T, N, R]
    out = torch.matmul(a.transpose(1, 2), _onehot_bins(bins, n_bins))
    return _as_level(out, n_nodes, n_classes, F, n_bins)


def onehot_rows(bins: torch.Tensor, w: torch.Tensor,
                n_bins: int) -> torch.Tensor:
    """The level-invariant half of the scatter twin, built once per fit:
    ``wu[t, n] = w[t, n] * onehot(bins[n])``, each sample's weighted
    ``(feature, bin)`` one-hot row ``[F * n_bins]`` -> [T, N, F*n_bins]."""
    return w.to(torch.float32)[:, :, None] * _onehot_bins(bins, n_bins)[None]


def histogram_level_scatter(node: torch.Tensor, y: torch.Tensor,
                            w: torch.Tensor, bins: torch.Tensor, *,
                            n_nodes: int, n_bins: int, n_classes: int,
                            wu: torch.Tensor | None = None) -> torch.Tensor:
    """Segment-sum twin: the same [T, n_nodes, F, n_bins, C] counts by one
    ``index_add_`` of every sample's ``F * n_bins`` row into its
    ``node*C + y`` row.  ``wu`` is the precomputed :func:`onehot_rows`
    output (the trainer builds it once per fit)."""
    T, N = node.shape
    F = bins.shape[1]
    R = n_nodes * n_classes
    if wu is None:
        wu = onehot_rows(bins, w, n_bins)
    seg = node.long() * n_classes + y.long()[None, :]
    seg = seg + torch.arange(T, device=node.device)[:, None] * R
    out = torch.zeros((T * R, F * n_bins), dtype=torch.float32,
                      device=node.device)
    out.index_add_(0, seg.reshape(-1), wu.reshape(T * N, F * n_bins))
    return _as_level(out.view(T, R, F * n_bins), n_nodes, n_classes, F,
                     n_bins)


def histogram_level(node: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    bins: torch.Tensor, *, n_nodes: int, n_bins: int,
                    n_classes: int, matmul_max_r: int = 0,
                    block: int = DEFAULT_BLOCK,
                    wu: torch.Tensor | None = None) -> torch.Tensor:
    """The trainer's per-level histogram: the CUDA kernel (its plain
    version for CPU tensors) while ``n_nodes * n_classes <= matmul_max_r``,
    else the scatter twin.  ``matmul_max_r`` keeps the JAX package's name
    for the crossover; every path gives the same counts."""
    if n_nodes * n_classes <= matmul_max_r:
        if node.device.type == "cpu":
            return histogram_level_ref(node, y, w, bins, n_nodes=n_nodes,
                                       n_bins=n_bins, n_classes=n_classes)
        return histogram_level_cuda(node, y, w, bins, n_nodes=n_nodes,
                                    n_bins=n_bins, n_classes=n_classes,
                                    block=block)
    return histogram_level_scatter(node, y, w, bins, n_nodes=n_nodes,
                                   n_bins=n_bins, n_classes=n_classes, wu=wu)
