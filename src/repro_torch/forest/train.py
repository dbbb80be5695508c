"""Random-forest training (port of ``repro.forest.train``'s host CART).

The paper trains with scikit-learn + the feature-budgeted criterion of
Nan/Wang/Saligrama (ICML'15).  Offline container => we implement CART
ourselves (training is offline in the paper too; only *evaluation* runs on
the accelerator).  The budgeted criterion is the ``feature_cost`` option:
split gain is penalized by the acquisition cost of features not yet paid
for on that root-to-node path, which is the essence of [11].

``trainer="host"`` is the numpy CART here: recursive node expansion, with
the split search vectorized across the whole ``[n, F_sub, q]`` (samples x
subsampled features x candidate thresholds) grid per node.  It draws from
``np.random.default_rng(cfg.seed)`` in the same order as the JAX package's
host CART, so both emit the same trees bit for bit.  ``trainer="device"``
is the level-wise histogram trainer of :mod:`repro_torch.forest.grow`,
which grows every tree at once on the device (by default the CUDA card)
and runs the histogram kernel at every level.

:func:`quantile_bin_edges` computes per-feature global quantile thresholds
ONCE per fit (deduplicated — a low-cardinality column's repeated quantiles
would otherwise produce redundant candidate masks — and padded with
``+inf``, which no sample exceeds, so padding candidates are never valid
splits).  Ties in the gain argmax break toward the lowest feature index,
then the lowest threshold.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.forest.tree import TensorForest, pad_forest

TRAINERS = ("host", "device")

# a split must beat the parent impurity by more than this to be taken
GAIN_EPS = 1e-12


@dataclasses.dataclass
class TrainConfig:
    n_trees: int = 16
    max_depth: int = 8
    min_samples_leaf: int = 2
    n_thresholds: int = 16        # candidate thresholds per feature (quantiles)
    bootstrap: bool = True
    max_features: str | int = "sqrt"
    feature_cost: np.ndarray | None = None  # [F] acquisition cost (budgeted RF)
    cost_weight: float = 0.0                 # lambda in gain - lambda*cost
    seed: int = 0
    trainer: str = "host"         # "host" (numpy CART) | "device" (grow.py)


def resolve_max_features(max_features: str | int, n_features: int) -> int:
    """The per-node feature-subsample size k (shared by both trainers)."""
    if max_features == "sqrt":
        return max(1, int(np.sqrt(n_features)))
    if max_features == "all":
        return n_features
    return min(int(max_features), n_features)


def quantile_bin_edges(x: np.ndarray, n_thresholds: int) -> np.ndarray:
    """Per-feature candidate split thresholds, shared by both trainers.

    Returns float32 ``[F, q]``: the ``linspace(0.05, 0.95, q)`` quantiles
    of each column over the FULL training matrix (computed once per fit —
    the device trainer bins against these, and the host trainer searches
    the same grid), deduplicated per feature and right-padded with ``+inf``.
    Dedup happens AFTER the float32 cast so two float64 quantiles that
    collapse at storage precision count as one candidate; ``+inf`` pads are
    inactive by construction (``x > +inf`` is never true, so the right
    child is empty and ``min_samples_leaf >= 1`` invalidates the split).
    """
    x = np.asarray(x, np.float64)
    qs = np.quantile(x, np.linspace(0.05, 0.95, n_thresholds), axis=0)
    qs = qs.T.astype(np.float32)                       # [F, q]
    edges = np.full_like(qs, np.inf)
    for f in range(qs.shape[0]):
        u = np.unique(qs[f])
        u = u[np.isfinite(u)]
        edges[f, : len(u)] = u
    return edges


def bin_features(x: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Bin index per (sample, feature): ``bin = #edges strictly below x``.

    With edges sorted ascending, ``x > edges[f, j]  <=>  bin[x] > j``.
    """
    x = np.asarray(x, np.float32)
    bins = (x[:, :, None] > edges[None, :, :]).sum(axis=-1)
    return bins.astype(np.uint8)


def _gini(counts: np.ndarray) -> np.ndarray:
    """Gini impurity for count vectors [..., C]."""
    n = counts.sum(axis=-1, keepdims=True)
    n = np.maximum(n, 1)
    p = counts / n
    return 1.0 - (p * p).sum(axis=-1)


def _best_split(x: np.ndarray, y: np.ndarray, n_classes: int,
                feat_ids: np.ndarray, cfg: TrainConfig,
                paid: np.ndarray, edges: np.ndarray,
                ) -> tuple[int, float, float] | None:
    """Split search over the shared candidate grid, one vectorized pass.

    The historical per-feature Python loop is hoisted into a single
    ``[n, F_sub, q]`` batched gain computation (right-mask -> einsum counts
    -> gini gain for every (feature, threshold) candidate at once).
    Ties break toward the lowest feature index then lowest threshold
    (``feat_ids`` are sorted first — the subsample's draw order must not
    leak into the pick, or the device trainer could never match it).
    Returns (feature, threshold, gain) or None if no split improves.
    """
    n = len(y)
    onehot = np.eye(n_classes, dtype=np.float64)[y]           # [n, C]
    parent_counts = onehot.sum(axis=0)
    parent_imp = _gini(parent_counts)

    feat_ids = np.sort(np.asarray(feat_ids))
    e = edges[feat_ids]                                       # [Fs, q]
    right = x[:, feat_ids, None] > e[None, :, :]              # [n, Fs, q]
    right_counts = np.einsum("nfq,nc->fqc", right.astype(np.float64), onehot)
    left_counts = parent_counts[None, None, :] - right_counts
    n_r = right_counts.sum(axis=-1)
    n_l = n - n_r
    valid = (n_r >= cfg.min_samples_leaf) & (n_l >= cfg.min_samples_leaf)
    if not valid.any():
        return None
    child_imp = (n_l * _gini(left_counts) + n_r * _gini(right_counts)) / n
    gain = parent_imp - child_imp                             # [Fs, q]
    if cfg.feature_cost is not None and cfg.cost_weight:
        unpaid = ~paid[feat_ids]
        gain = gain - (cfg.cost_weight * cfg.feature_cost[feat_ids]
                       * unpaid)[:, None]
    gain = np.where(valid, gain, -np.inf)
    flat = int(np.argmax(gain))                # first max: lowest f, then q
    if gain.flat[flat] <= GAIN_EPS:
        return None
    f_loc, j = divmod(flat, edges.shape[1])
    return int(feat_ids[f_loc]), float(e[f_loc, j]), float(gain.flat[flat])


def _train_tree(x: np.ndarray, y: np.ndarray, n_classes: int,
                cfg: TrainConfig, rng: np.random.Generator,
                edges: np.ndarray) -> TensorForest:
    """Train one tree; emit it as a depth-``cfg.max_depth`` complete tree."""
    d = cfg.max_depth
    n_internal = 2**d - 1
    n_leaves = 2**d
    feature = np.zeros((n_internal,), np.int32)
    threshold = np.full((n_internal,), np.inf, np.float32)  # default: go left
    leaf = np.zeros((n_leaves, n_classes), np.float32)

    k_feat = resolve_max_features(cfg.max_features, x.shape[1])

    def leaf_dist(idx: np.ndarray) -> np.ndarray:
        counts = np.bincount(y[idx], minlength=n_classes).astype(np.float32)
        s = counts.sum()
        return counts / s if s > 0 else np.full((n_classes,), 1.0 / n_classes, np.float32)

    def fill_leaves(node: int, depth: int, dist: np.ndarray) -> None:
        """Replicate ``dist`` across all leaf slots under ``node``."""
        first = node
        for _ in range(depth, d):
            first = 2 * first + 1
        first -= n_internal
        span = 2 ** (d - depth)
        leaf[first : first + span] = dist

    # iterative DFS: (node_id, depth, sample idx, paid-feature mask)
    stack = [(0, 0, np.arange(len(y)), np.zeros(x.shape[1], bool))]
    while stack:
        node, depth, idx, paid = stack.pop()
        ys = y[idx]
        if depth == d or len(idx) < 2 * cfg.min_samples_leaf or len(np.unique(ys)) == 1:
            dist = leaf_dist(idx)
            if depth == d:
                leaf[node - n_internal] = dist
            else:
                fill_leaves(node, depth, dist)
            continue
        feat_ids = rng.choice(x.shape[1], size=min(k_feat, x.shape[1]), replace=False)
        split = _best_split(x[idx], ys, n_classes, feat_ids, cfg, paid, edges)
        if split is None:
            fill_leaves(node, depth, leaf_dist(idx))
            continue
        f, thr, _ = split
        feature[node] = f
        threshold[node] = thr
        go_right = x[idx, f] > thr
        paid2 = paid.copy()
        paid2[f] = True
        stack.append((2 * node + 1, depth + 1, idx[~go_right], paid2))
        stack.append((2 * node + 2, depth + 1, idx[go_right], paid2))

    return TensorForest.from_numpy(feature[None], threshold[None],
                                   leaf[None])


def train_random_forest(x: np.ndarray, y: np.ndarray, n_classes: int,
                        cfg: TrainConfig, *, device=None) -> TensorForest:
    """RandomForestTrain(n, X, y) — Algorithm 1 line 2.

    ``cfg.trainer`` selects the implementation: ``"host"`` is the numpy
    CART below and returns CPU tensors; ``"device"`` dispatches to the
    level-wise histogram trainer (:func:`repro_torch.forest.grow.
    grow_forest`), which runs on ``device`` (default ``"cuda"``) and
    returns the forest there.  Both emit the same complete-tree
    ``TensorForest`` padding/sentinel conventions.
    """
    if cfg.trainer not in TRAINERS:
        raise ValueError(f"unknown trainer {cfg.trainer!r}; "
                         f"pick from {TRAINERS}")
    if cfg.trainer == "device":
        from repro_torch.forest.grow import grow_forest
        return grow_forest(x, y, n_classes, cfg, device=device)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int32)
    edges = quantile_bin_edges(x, cfg.n_thresholds)
    rng = np.random.default_rng(cfg.seed)
    trees = []
    for _ in range(cfg.n_trees):
        if cfg.bootstrap:
            idx = rng.integers(0, len(y), size=len(y))
        else:
            idx = np.arange(len(y))
        trees.append(_train_tree(x[idx], y[idx], n_classes, cfg, rng, edges))
    return pad_forest(trees)
