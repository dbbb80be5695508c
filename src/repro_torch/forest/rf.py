"""Conventional random-forest evaluation, the paper's RF baseline (port of
``repro.forest.rf``).

Per §3.2.1: "in the conventional RF the DTs return class predictions, which
are later put to a majority vote", in contrast with FoG's probability
averaging.  Both functions run on the forest's device; ``x`` is moved
there.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.forest.tree import TensorForest, forest_proba, forest_votes


def _on(forest: TensorForest, x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=forest.feature.device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32),
                        device=forest.feature.device)


def rf_predict(forest: TensorForest, x) -> torch.Tensor:
    """Majority vote over per-tree hard predictions: [B] int32 labels
    (ties go to the lowest class)."""
    return torch.argmax(forest_votes(forest, _on(forest, x)),
                        dim=-1).to(torch.int32)


def rf_predict_proba(forest: TensorForest, x) -> torch.Tensor:
    """Mean per-tree distribution (what FoG groves average): [B, C]."""
    return forest_proba(forest, _on(forest, x))
