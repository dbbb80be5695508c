"""Device forest trainer: level-wise histogram tree induction (port of
``repro.forest.grow``).

The numpy CART in :mod:`repro_torch.forest.train` expands one node at a
time.  This trainer grows ALL trees at once, one level per step, with
every per-level quantity a dense tensor on the device:

1. **Bin once.**  Features are quantile-binned on the host against the
   SAME candidate grid the host trainer searches (:func:`~repro_torch.
   forest.train.quantile_bin_edges` / :func:`~repro_torch.forest.train.
   bin_features`), so a split here is the split ``x > edges[f, j]`` there.
2. **Histogram per level.**  A ``[T, N]`` node-id tensor tracks where each
   sample sits in each tree; :func:`repro_torch.kernels.histogram.
   histogram_level` turns (node ids, labels, bootstrap weights, bins) into
   per-(tree, node, feature, bin, class) fp32 counts: the CUDA kernel, or
   the segment-sum twin above the autotuned crossover.
3. **All splits in one pass.**  A cumsum over the bin axis gives every
   candidate's left counts; gini gain (with the ``feature_cost`` penalty
   against a per-path paid-feature mask) is computed for the whole
   ``[T, nodes, F, q]`` block and argmaxed per node with the host
   trainer's tie order (lowest feature, then lowest threshold).
4. **Route by gather.**  ``node = 2*node + (bin > chosen_j)`` per sample.

The gain block repeats ``repro.forest.grow._grow`` term for term, in the
same order and in fp32, so the two packages pick the same splits from the
same draws.  Bootstrap resampling is per-tree multiplicity weights
(``w[t, i]`` = times sample i was drawn for tree t).

Randomness comes in from outside: ``weights`` ``[T, N]`` and
``feature_masks`` (one bool ``[T, 2**level, F]`` per level) may be given.
Without them the trainer draws from a ``torch.Generator`` on the device,
seeded with ``cfg.seed``: ``torch.randint`` -> ``bincount`` for the
bootstrap, then ``torch.rand`` -> ``topk`` per level for the feature
subsets.  Two same-seed runs on one device give bit-identical tables; the
JAX package's ``jax.random`` draws are other numbers, so a comparison
with it passes its draws in.

Conventions match the host trainer: complete depth-``d`` trees in heap
order, non-splitting nodes sealed with ``feature=0, threshold=+inf``,
sealed distributions replicated down to every leaf below them, empty-node
fallback ``1/C``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.forest.train import (GAIN_EPS, TrainConfig, bin_features,
                                      quantile_bin_edges,
                                      resolve_max_features)
from repro_torch.forest.tree import TensorForest
from repro_torch.kernels import autotune
from repro_torch.kernels.histogram import histogram_level, onehot_rows

__all__ = ["grow_forest", "bootstrap_weights", "feature_mask"]


def _gini(counts: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Gini impurity from weighted class counts [..., C] and their sum."""
    t = torch.clamp(total, min=1.0)
    return 1.0 - (counts * counts).sum(-1) / (t * t)


def bootstrap_weights(gen: torch.Generator, n_trees: int,
                      n_samples: int) -> torch.Tensor:
    """Per-tree bootstrap multiplicities [T, N] fp32 on the generator's
    device: N draws with replacement per tree, counted."""
    dev = gen.device
    idx = torch.randint(0, n_samples, (n_trees, n_samples), generator=gen,
                        device=dev)
    idx = idx + torch.arange(n_trees, device=dev)[:, None] * n_samples
    counts = torch.bincount(idx.reshape(-1), minlength=n_trees * n_samples)
    return counts.reshape(n_trees, n_samples).to(torch.float32)


def feature_mask(gen: torch.Generator, n_trees: int, n_nodes: int,
                 n_features: int, k: int) -> torch.Tensor:
    """A random ``k``-of-``F`` feature subset per (tree, node): bool
    [T, nodes, F] on the generator's device (the top ``k`` of uniform
    draws)."""
    u = torch.rand((n_trees, n_nodes, n_features), generator=gen,
                   device=gen.device)
    idx = torch.topk(u, k, dim=-1).indices
    mask = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    return mask.scatter_(-1, idx, True)


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A contiguous tensor on ``device``; host arrays are copied (they may
    be read-only views, e.g. of JAX arrays)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _grow(bins, edges, y, fcost, w, feature_masks, gen, *, depth, n_classes,
          msl, k_feat, cost_weight, hc):
    N, F = bins.shape
    q = edges.shape[1]
    n_bins = q + 1
    T = w.shape[0]
    C = n_classes
    dev = bins.device
    inf = torch.tensor(float("inf"), device=dev)
    wu = None                                    # built at first twin level
    node = torch.zeros((T, N), dtype=torch.int32, device=dev)
    alive = torch.ones((T, 1), dtype=torch.bool, device=dev)
    inherit = torch.full((T, 1, C), 1.0 / C, dtype=torch.float32, device=dev)
    paid = torch.zeros((T, 1, F), dtype=torch.bool, device=dev)
    f_iota = torch.arange(F, device=dev)
    sample = torch.arange(N, device=dev)[None, :]
    feats, thrs = [], []

    for level in range(depth):
        nodes = 1 << level
        if wu is None and nodes * C > hc.matmul_max_r:
            wu = onehot_rows(bins, w, n_bins)
        hist = histogram_level(node, y, w, bins, n_nodes=nodes,
                               n_bins=n_bins, n_classes=C,
                               matmul_max_r=hc.matmul_max_r, block=hc.block,
                               wu=wu)
        # per-node class counts: any feature's bins partition the node
        counts = hist[:, :, 0].sum(dim=2)                    # [T, nodes, C]
        total = counts.sum(-1)                               # [T, nodes]
        dist = torch.where((alive & (total > 0))[..., None],
                           counts / torch.clamp(total, min=1.0)[..., None],
                           inherit)
        pure = (counts > 0).sum(-1) <= 1
        can_split = alive & (total >= 2 * msl) & ~pure

        # candidate j sends bin <= j left; the right statistics follow from
        # the sum-of-squares expansion, in _grow's order:
        #   sum_c(right_c^2) = sum_c(counts_c^2) - 2*sum_c(counts_c*left_c)
        #                      + sum_c(left_c^2)
        left = torch.cumsum(hist, dim=3)[:, :, :, :q, :]     # [T,nodes,F,q,C]
        n_l = left.sum(-1)
        n_r = total[:, :, None, None] - n_l
        sq_l = (left * left).sum(-1)
        cross = (left * counts[:, :, None, None, :]).sum(-1)
        sq_c = (counts * counts).sum(-1)
        sq_r = sq_c[:, :, None, None] - 2.0 * cross + sq_l
        parent_imp = _gini(counts, total)
        child = (n_l - sq_l / torch.clamp(n_l, min=1.0)
                 + n_r - sq_r / torch.clamp(n_r, min=1.0))
        gain = (parent_imp[:, :, None, None]
                - child / torch.clamp(total, min=1.0)[:, :, None, None])
        if fcost is not None:
            gain = gain - (cost_weight * (fcost[None, None, :]
                                          * ~paid))[..., None]
        valid = (n_l >= msl) & (n_r >= msl)
        if feature_masks is not None:
            valid = valid & feature_masks[level][..., None]
        elif k_feat < F:
            valid = valid & feature_mask(gen, T, nodes, F, k_feat)[..., None]
        gain = torch.where(valid, gain, -inf)

        # first-max argmax over [F*q]: lowest feature, then lowest threshold
        flat = gain.reshape(T, nodes, F * q)
        bidx = torch.argmax(flat, dim=-1)
        bgain = torch.gather(flat, -1, bidx[..., None])[..., 0]
        split_ok = can_split & (bgain > GAIN_EPS)
        f_best = bidx // q
        j_best = bidx % q
        feat_l = torch.where(split_ok, f_best, 0).to(torch.int32)
        thr_l = torch.where(split_ok, edges[f_best, j_best], inf)
        feats.append(feat_l)
        thrs.append(thr_l)

        # route: right iff this sample's node split and its bin clears the
        # chosen edge index (bin > j  <=>  x > edges[f, j])
        nl = node.long()
        sf = torch.gather(feat_l, 1, nl).long()              # [T, N]
        sj = torch.gather(j_best, 1, nl)
        sok = torch.gather(split_ok, 1, nl)
        xb = bins[sample, sf]
        go_right = sok & (xb > sj)
        node = 2 * node + go_right.to(torch.int32)

        # children inherit path state; [m] -> [2m, 2m+1]
        newly = split_ok[..., None] & (f_iota == feat_l[..., None])
        paid = torch.repeat_interleave(paid | newly, 2, dim=1)
        alive = torch.repeat_interleave(split_ok, 2, dim=1)
        inherit = torch.repeat_interleave(dist, 2, dim=1)

    n_leaves = 1 << depth
    lc = torch.zeros((T, n_leaves, C), dtype=torch.float32, device=dev)
    tree = torch.arange(T, device=dev)[:, None].expand(T, N)
    lc.index_put_((tree, node.long(), y.long()[None, :].expand(T, N)), w,
                  accumulate=True)
    ltot = lc.sum(-1)
    leaf = torch.where((alive & (ltot > 0))[..., None],
                       lc / torch.clamp(ltot, min=1.0)[..., None], inherit)
    return torch.cat(feats, dim=1), torch.cat(thrs, dim=1), leaf


def grow_forest(x, y, n_classes: int, cfg: TrainConfig, *, device=None,
                weights=None, feature_masks=None) -> TensorForest:
    """Train ``cfg.n_trees`` trees simultaneously on ``device`` (default
    ``"cuda"``; ``"cpu"`` runs the kernels' plain versions).

    Same contract as the host path of :func:`~repro_torch.forest.train.
    train_random_forest`: complete depth-``cfg.max_depth`` trees over the
    shared quantile candidate grid.  ``weights`` ([T, N] bootstrap
    multiplicities) and ``feature_masks`` (a sequence of ``max_depth`` bool
    ``[T, 2**level, F]`` masks) replace the trainer's own draws; without
    them it draws from a generator seeded with ``cfg.seed``
    (``cfg.bootstrap=False`` means unit weights, ``max_features="all"``
    means no mask).  The crossover between the histogram paths comes from
    :func:`repro_torch.kernels.autotune.best_hist_config`.  Returns the
    forest's tensors on ``device``.
    """
    if cfg.min_samples_leaf < 1:
        raise ValueError("device trainer requires min_samples_leaf >= 1 "
                         f"(got {cfg.min_samples_leaf}); padded +inf "
                         "candidates rely on empty right children being "
                         "invalid")
    if cfg.max_depth < 1:
        raise ValueError(f"max_depth must be >= 1 (got {cfg.max_depth})")
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int32)
    N, F = x.shape
    T = cfg.n_trees
    edges = quantile_bin_edges(x, cfg.n_thresholds)
    bins = bin_features(x, edges)
    n_bins = edges.shape[1] + 1
    k_feat = resolve_max_features(cfg.max_features, F)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    if weights is not None:
        w = _tensor(weights, torch.float32, dev)
        if tuple(w.shape) != (T, N):
            raise ValueError(f"weights must be [n_trees, n_samples] = "
                             f"{(T, N)}, got {tuple(w.shape)}")
    elif cfg.bootstrap:
        w = bootstrap_weights(gen, T, N)
    else:
        w = torch.ones((T, N), dtype=torch.float32, device=dev)
    masks = None
    if feature_masks is not None:
        masks = [_tensor(m, torch.bool, dev) for m in feature_masks]
        want = [(T, 1 << level, F) for level in range(cfg.max_depth)]
        if [tuple(m.shape) for m in masks] != want:
            raise ValueError(f"feature_masks must be {cfg.max_depth} bool "
                             f"masks of shapes {want}, got "
                             f"{[tuple(m.shape) for m in masks]}")

    hc = autotune.best_hist_config(T, cfg.max_depth, F, n_bins, n_classes,
                                   dev)
    use_cost = cfg.feature_cost is not None and bool(cfg.cost_weight)
    fcost = (torch.as_tensor(np.asarray(cfg.feature_cost, np.float32),
                             device=dev) if use_cost else None)
    feature, threshold, leaf = _grow(
        torch.as_tensor(bins, device=dev), torch.as_tensor(edges, device=dev),
        torch.as_tensor(y, device=dev), fcost, w, masks, gen,
        depth=cfg.max_depth, n_classes=n_classes,
        msl=int(cfg.min_samples_leaf), k_feat=k_feat,
        cost_weight=torch.tensor(float(cfg.cost_weight), dtype=torch.float32,
                                 device=dev),
        hc=hc)
    return TensorForest(feature, threshold, leaf)
