"""Shared layers (port of ``repro.models.layers``): RMSNorm.

RoPE, attention and the gated FFN come with the attention path
(ROADMAP A10, B6).
"""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalise in fp32, cast back to ``x.dtype``, then ``* (1 + w)``."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + w)
