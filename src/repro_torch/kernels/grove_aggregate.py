"""One Algorithm-2 hop update (lines 7-11) in one pass, on the card.

Replaces ``repro/kernels/grove_aggregate.py::_aggregate_kernel`` (Pallas
TPU).  CUDA source: ``csrc/fog_kernels.cu::grove_aggregate_kernel``, one
thread per lane: ``prob += contrib * live``, ``hops += live``, divide by
``max(hops, 1)``, first-max MaxDiff, ``live &= margin < thresh``.  It reads
and writes each ``[B, C]`` row once and is bound by those bytes.  The
plain version is :func:`grove_aggregate_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import grove_aggregate_ref

__all__ = ["check_contrib", "grove_aggregate_cuda", "grove_aggregate_ref"]


def check_contrib(contrib: torch.Tensor) -> None:
    """The hop state accumulates in floating point: packed (integer)
    contributions must be dequantized first."""
    if not contrib.dtype.is_floating_point:
        raise ValueError(
            f"grove_aggregate accumulates in floating point; dequantize "
            f"packed contributions before the hop update (got "
            f"{contrib.dtype})")


def grove_aggregate_cuda(prob_acc: torch.Tensor, contrib: torch.Tensor,
                         live: torch.Tensor, hops: torch.Tensor, thresh, *,
                         block_b: int = 256):
    """Fused hop update on CUDA tensors (one kernel launch).

    prob_acc, contrib float32 [B, C]; live bool [B]; hops int32 [B];
    thresh a scalar or float32 [B] -> (prob, hops, live, margin).
    """
    _build.check_block(block_b)
    B, C = prob_acc.shape
    dev = prob_acc.device
    thresh = torch.as_tensor(thresh, dtype=torch.float32, device=dev)
    thresh = thresh.expand(B).contiguous()
    for name, t, dt, nd in (("prob_acc", prob_acc, torch.float32, 2),
                            ("contrib", contrib, torch.float32, 2),
                            ("live", live, torch.bool, 1),
                            ("hops", hops, torch.int32, 1)):
        _build.check_cuda(name, t, dt, nd)
    if contrib.shape != prob_acc.shape or live.shape != (B,) \
            or hops.shape != (B,):
        raise ValueError(f"shape mismatch: prob {tuple(prob_acc.shape)}, "
                         f"contrib {tuple(contrib.shape)}, live "
                         f"{tuple(live.shape)}, hops {tuple(hops.shape)}")
    prob_out = torch.empty_like(prob_acc)
    hops_out = torch.empty_like(hops)
    live_out = torch.empty_like(live)
    margin = torch.empty((B,), dtype=torch.float32, device=dev)
    if B and C:
        _build.launch("grove_aggregate", dev,
                      prob_acc.data_ptr(), contrib.data_ptr(),
                      live.data_ptr(), hops.data_ptr(), thresh.data_ptr(),
                      prob_out.data_ptr(), hops_out.data_ptr(),
                      live_out.data_ptr(), margin.data_ptr(), B, C, block_b)
    return prob_out, hops_out, live_out, margin
