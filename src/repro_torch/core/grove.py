"""Algorithm 1 — constructing the Field of Groves classifier (port of
``repro.core.grove``).

GCTrain(n, k, X, y): pre-train a conventional RF of n trees, then Split it
into groves of k trees each.  The grove collection is one forest reshaped
to [n_groves, k, ...].
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.forest.train import TrainConfig, train_random_forest
from repro_torch.forest.tree import (TensorForest, grove_traverse,
                                     mean_over_trees)


@dataclasses.dataclass
class GroveCollection:
    """Split grove ensemble GC: [n_groves, k] trees."""

    feature: torch.Tensor    # int32   [G, k, 2**d - 1]
    threshold: torch.Tensor  # float32 [G, k, 2**d - 1]
    leaf: torch.Tensor       # float32 [G, k, 2**d, C]

    @property
    def n_groves(self) -> int:
        return self.feature.shape[0]

    @property
    def grove_size(self) -> int:
        return self.feature.shape[1]

    @property
    def depth(self) -> int:
        return int(np.log2(self.leaf.shape[2]) + 0.5)

    @property
    def n_classes(self) -> int:
        return self.leaf.shape[3]

    def as_forest(self) -> TensorForest:
        """Undo the split."""
        g, k = self.feature.shape[:2]
        return TensorForest(
            self.feature.reshape(g * k, -1),
            self.threshold.reshape(g * k, -1),
            self.leaf.reshape(g * k, *self.leaf.shape[2:]),
        )


def split(forest: TensorForest, k: int) -> GroveCollection:
    """Split(RF, k) — Algorithm 1 lines 5-15.  Trees [i..i+k) -> grove i/k."""
    stacked = forest.stack_groves(k)
    return GroveCollection(stacked.feature, stacked.threshold, stacked.leaf)


def gc_train(n: int, k: int, x: np.ndarray, y: np.ndarray, n_classes: int,
             train_cfg: TrainConfig | None = None) -> GroveCollection:
    """GCTrain(n, k, X, y) — Algorithm 1 lines 1-4."""
    cfg = dataclasses.replace(train_cfg or TrainConfig(), n_trees=n)
    rf = train_random_forest(x, y, n_classes, cfg)
    return split(rf, k)


def grove_predict_proba(gc: GroveCollection, g_idx: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """Grove(index).predict_prob(x) for a batch with per-example grove ids.

    g_idx: int [B]; x: [B, F]  ->  [B, C]
    """
    return mean_over_trees(
        grove_traverse(gc.feature, gc.threshold, gc.leaf, x, g_idx))
