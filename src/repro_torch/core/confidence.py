"""MaxDiff confidence (Algorithm 2, subroutine lines 16-19; port of
``repro.core.confidence``).

Confidence = |top1 - top2| of the (normalized) probability array.  For
multi-output classification the paper takes the Min over outputs of the
per-output margins.
"""
from __future__ import annotations

import torch


def top2(ar: torch.Tensor, dim: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Two largest values along ``dim`` without a full sort."""
    m1 = ar.amax(dim=dim)
    # mask out ONE occurrence of the max, then take the max again
    is_max = ar == m1.unsqueeze(dim)
    first_max = torch.cumsum(is_max.to(torch.int32), dim=dim) == 1
    masked = torch.where(is_max & first_max, float("-inf"), ar)
    return m1, masked.amax(dim=dim)


def maxdiff(ar: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """MaxDiff(ar) = |max1 - max2| along ``dim``."""
    m1, m2 = top2(ar, dim=dim)
    return (m1 - m2).abs()


def maxdiff_multioutput(ar: torch.Tensor) -> torch.Tensor:
    """Multi-output rule: ar is [..., n_outputs, C]; Min over outputs."""
    return maxdiff(ar, dim=-1).amin(dim=-1)
