"""The device trainer's per-level split-search histograms.

Replaces ``repro/kernels/histogram.py::_hist_kernel`` (Pallas TPU).  The
trainer (``forest/grow.py``) reduces each level of tree induction to one
tensor: per-(tree, node, feature, bin, class) weighted sample counts
``[T, nodes, F, n_bins, C]`` fp32, from which every candidate split's gain
falls out of a cumsum.  Four parts:

``histogram_level_cuda``
    The hand-written CUDA kernel (``csrc/histogram.cu``): one thread per
    (tree, sample, feature) that skips zero weights and ``atomicAdd``s its
    weight into a zeroed ``[T, nodes*C, F*n_bins]`` buffer, which is then
    viewed as ``[T, nodes, F, n_bins, C]``.  The TPU kernel forms the same
    sum as a one-hot matmul; on Hopper the native form is a scatter-add.
    It is bound by its global atomics, one per weighted (tree, sample,
    feature), whatever the level: on an H100 (700 W) its time is flat over
    the levels of a gate fit while its bytes bound grows 30-fold (PERF.md).
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

import torch

from repro_torch.kernels import _build

__all__ = ["histogram_level", "histogram_level_cuda", "histogram_level_ref",
           "histogram_level_scatter", "onehot_rows"]

# CUDA threads per block when nothing chooses one
DEFAULT_BLOCK = 256


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
    counts, in one kernel launch.  Exact below 2**24 samples per cell."""
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
    out = torch.zeros((T, n_nodes * n_classes, F * n_bins),
                      dtype=torch.float32, device=node.device)
    if T and N and F:
        _build.launch("histogram", node.device, node.data_ptr(),
                      y.data_ptr(), w.data_ptr(), bins.data_ptr(),
                      out.data_ptr(), T, N, F, n_bins, n_classes, n_nodes,
                      block)
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
