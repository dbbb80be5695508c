"""MLP baseline (paper §4.1), trained by baselines.train (port of
``repro.baselines.mlp``)."""
from __future__ import annotations

import math

import torch

from repro_torch.core.energy import mlp_energy_pj


def init_mlp(gen: torch.Generator, n_features: int, n_classes: int,
             hidden: tuple[int, ...] = (128, 64)):
    """He-initialized layers drawn from ``gen`` on its device."""
    sizes = (n_features, *hidden, n_classes)
    dev = gen.device
    return [{"w": torch.randn((a, b), generator=gen, device=dev)
             * math.sqrt(2.0 / a),
             "b": torch.zeros((b,), device=dev)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def mlp_logits(params, x: torch.Tensor) -> torch.Tensor:
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def mlp_energy_nj(n_features: int, n_classes: int,
                  hidden: tuple[int, ...] = (128, 64)) -> float:
    return mlp_energy_pj([n_features, *hidden, n_classes]) * 1e-3
