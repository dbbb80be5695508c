"""SVM baselines (paper §4.1): linear (multiclass hinge) and RBF (port of
``repro.baselines.svm``).

SVM_RBF is trained in the random-Fourier-feature lift (Rahimi-Recht): a
linear hinge model over D cosine features approximates the RBF kernel
machine.  Its energy is modeled as the paper measures it, the exact
kernel evaluation against n_sv support vectors (the retained support set:
training examples inside or violating the margin).

The initializers draw from a ``torch.Generator`` on its device; their
draws are the JAX package's in distribution only.  To start from JAX's
draws, carry them (:func:`repro_torch.baselines.carry.params_from_jax`).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.energy import svm_lr_energy_pj, svm_rbf_energy_pj


def init_linear_svm(gen: torch.Generator, n_features: int, n_classes: int):
    dev = gen.device
    return {"w": torch.randn((n_features, n_classes), generator=gen,
                             device=dev) * 0.01,
            "b": torch.zeros((n_classes,), device=dev)}


def linear_svm_scores(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def multiclass_hinge_loss(scores: torch.Tensor, y: torch.Tensor
                          ) -> torch.Tensor:
    """Crammer-Singer multiclass hinge.

    The true class's margin is replaced out of place, so autograd sees
    JAX's ``.at[...].set(0.0)``; ``torch.maximum`` and ``amax`` split a
    tie's gradient evenly, as JAX's ``maximum`` and ``max`` do
    (``clamp_min`` and ``max(dim)`` would not)."""
    B = scores.shape[0]
    rows = torch.arange(B, device=scores.device)
    correct = scores[rows, y]
    margins = scores - correct[:, None] + 1.0
    own = torch.nn.functional.one_hot(y.long(), scores.shape[1]).bool()
    margins = torch.where(own, torch.zeros_like(margins), margins)
    return torch.maximum(margins, torch.zeros_like(margins)).amax(-1).mean()


@dataclasses.dataclass
class RFFParams:
    omega: torch.Tensor   # [F, D] random projection
    phase: torch.Tensor   # [D]
    linear: dict          # linear svm over the lift


def init_rbf_svm(gen: torch.Generator, n_features: int, n_classes: int,
                 n_rff: int = 512, gamma: float | None = None) -> RFFParams:
    if gamma is None:
        gamma = 1.0 / n_features
    dev = gen.device
    omega = torch.randn((n_features, n_rff), generator=gen, device=dev) * (
        torch.sqrt(torch.tensor(2.0 * gamma, device=dev)))
    phase = torch.rand((n_rff,), generator=gen, device=dev) * (2 * math.pi)
    return RFFParams(omega=omega, phase=phase,
                     linear=init_linear_svm(gen, n_rff, n_classes))


def rff_lift(p: RFFParams, x: torch.Tensor) -> torch.Tensor:
    d = p.omega.shape[1]
    # JAX takes the square root in float32 (jnp.sqrt of a Python number)
    root = torch.sqrt(torch.tensor(2.0 / d, dtype=torch.float32,
                                   device=x.device))
    return root * torch.cos(x @ p.omega + p.phase)


def rbf_svm_scores(p: RFFParams, x: torch.Tensor) -> torch.Tensor:
    return linear_svm_scores(p.linear, rff_lift(p, x))


def count_support_vectors(scores: np.ndarray, y: np.ndarray) -> int:
    """Examples inside or violating the margin == retained support set."""
    B = scores.shape[0]
    correct = scores[np.arange(B), y]
    others = scores.copy()
    others[np.arange(B), y] = -np.inf
    margin = correct - others.max(axis=-1)
    return int((margin < 1.0).sum())


def svm_lr_energy_nj(n_features: int, n_classes: int) -> float:
    return svm_lr_energy_pj(n_features, n_classes) * 1e-3


def svm_rbf_energy_nj(n_features: int, n_classes: int, n_sv: int) -> float:
    return svm_rbf_energy_pj(n_features, n_classes, n_sv) * 1e-3
