"""Gradient compression with error feedback (port of
``repro.optim.compression``).

int8 per-tensor-scaled quantization; the quantization residual is carried
in an error-feedback buffer so the compression's bias does not accumulate
(Seide et al. / EF-SGD).  ``torch.round`` rounds half to even, as
``jnp.round`` does, so the codes equal the JAX package's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.optim.optim import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class CompressionState:
    error: Any   # tree of residuals, shaped like the grads


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: (q, scale)."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_compression(grads) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads))


def ef_compress_grads(grads, state: CompressionState | None):
    """Quantize grads with error feedback.  Returns (dequantized_grads,
    state): the round trip models what crosses the wire."""
    if state is None:
        state = init_compression(grads)
    out, err = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(state.error)):
        g32 = g.to(torch.float32) + e
        deq = decompress_int8(*compress_int8(g32))
        out.append(deq.to(g.dtype))
        err.append(g32 - deq)
    return (tree_unflatten(grads, out),
            CompressionState(error=tree_unflatten(state.error, err)))
