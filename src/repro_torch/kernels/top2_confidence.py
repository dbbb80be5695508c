"""MaxDiff confidence: the top-2 margin of each row, on the card.

Replaces ``repro/kernels/top2_confidence.py::_top2_kernel`` (Pallas TPU).
CUDA source: ``csrc/fog_kernels.cu::top2_confidence_kernel``, one thread
per row: it finds the first maximum, then the maximum over the other
entries, and writes ``|m1 - m2|``.  It is bound by the ``[B, C]`` bytes it
reads.  The plain version is :func:`top2_confidence_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import top2_confidence_ref

__all__ = ["top2_confidence_cuda", "top2_confidence_ref"]


def top2_confidence_cuda(prob: torch.Tensor, *,
                         block_b: int = 256) -> torch.Tensor:
    """[B, C] float32 CUDA tensor -> [B] margins (one kernel launch)."""
    _build.check_cuda("prob", prob, torch.float32, 2)
    _build.check_block(block_b)
    B, C = prob.shape
    out = torch.empty((B,), dtype=torch.float32, device=prob.device)
    if B and C:
        _build.launch("top2_confidence", prob.device,
                      prob.data_ptr(), out.data_ptr(), B, C, block_b)
    return out
