"""Mixture-of-Experts layer, grok-1 8e top-2, deepseek-v3 1+256e top-8,
jamba 16e top-2 (port of ``repro.models.moe``).

Token-choice top-k routing with a per-expert capacity (GShard): each
sequence routes its own S tokens; each expert then takes its top
``capacity`` tokens by gate and computes a dense ``[E, cap, d] x [E, d,
f]`` product over them; tokens past an expert's capacity are dropped
(their residual passes through) and unfilled slots carry a gate of zero.
The expert products are batched matrix products over the experts, as JAX
computes them outside any Pallas kernel.  The experts' activation is SiLU
whatever ``cfg.act`` says, as in JAX (grok's ``act`` is ``gelu``).

Order among equal values decides which tokens an expert keeps:
``jax.lax.top_k`` puts the lower index first, and the capacity pick ties
constantly, at 0, among the tokens not routed to the expert.
``torch.topk`` promises no order among ties, so both picks here are a
stable descending sort (:func:`top_k`).

JAX's ``_constrain`` (a sharding hint inside a mesh, a no-op outside
one) has no counterpart on one card.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import normal


class SharedExpert(nn.Module):
    """The always-on expert's weights: ``w_gate``/``w_up [d, f * n]``,
    ``w_down [f * n, d]``."""

    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        for name, t in (("w_gate", w_gate), ("w_up", w_up),
                        ("w_down", w_down)):
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))


class MoE(nn.Module):
    """One MoE FFN's weights, JAX's names: ``router [d, E]`` (fp32),
    ``w_gate``/``w_up [E, d, f]``, ``w_down [E, f, d]``, and ``shared``
    where the config has shared experts."""

    def __init__(self, router, w_gate, w_up, w_down,
                 shared: SharedExpert | None = None):
        super().__init__()
        for name, t in (("router", router), ("w_gate", w_gate),
                        ("w_up", w_up), ("w_down", w_down)):
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self.shared = shared


def _normal(generator, shape, dtype) -> torch.Tensor:
    """``normal(shape) / sqrt(shape[-2])`` in ``dtype``, drawn one slice of
    the leading axis at a time (an expert's fp32 draw is all the working
    memory: deepseek-v3's 256 experts at once would take 15 GB); on
    ``meta`` one allocation."""
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    if out.is_meta:
        return out
    for i in range(shape[0]):
        out[i] = normal(shape[1:], generator) / np.sqrt(shape[-2])
    return out


def init_moe(generator: torch.Generator, cfg: ArchConfig, dtype) -> MoE:
    """Random weights from JAX's distributions, drawn by ``generator``."""
    d, E = cfg.d_model, cfg.n_experts
    f = cfg.moe_d_ff or cfg.d_ff
    router = normal((d, E), generator) * 0.02
    shared = None
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        shared = SharedExpert(*(_normal(generator, (1, a, b), dtype)[0]
                                for a, b in ((d, fs), (d, fs), (fs, d))))
    return MoE(router, _normal(generator, (E, d, f), dtype),
               _normal(generator, (E, d, f), dtype),
               _normal(generator, (E, f, d), dtype), shared)


def _capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Tokens an expert takes from one sequence.  Padded to a multiple of
    8 as JAX pads it (for its TPU lanes, not for the card): the padding
    decides which tokens drop, so the port keeps it to drop the same."""
    cap = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor
              / max(cfg.n_experts, 1))
    cap = max(8, (cap + 7) // 8 * 8)
    return min(cap, n_tokens)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    the lower index first among equal values."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def moe_ffn(p: MoE, cfg: ArchConfig,
            x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (out [B, S, d] in x's dtype, the Switch load-balance
    loss, an fp32 scalar)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    cap = _capacity(S, cfg)

    probs = torch.softmax(x.to(torch.float32) @ p.router, dim=-1)  # [B,S,E]
    topv, topi = top_k(probs, k)
    # renormalise the selected gates (deepseek/mixtral convention)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    # token-choice gate matrix: probs masked to each token's top-k
    sel = torch.zeros((B, S, E), dtype=torch.float32,
                      device=x.device).scatter(-1, topi, topv)

    # per-(row, expert) capacity selection: the top-cap tokens of the row
    escore, eidx = top_k(sel.transpose(1, 2), cap)                 # [B,E,cap]
    egate = escore * (escore > 0.0)
    # gathered expert-major, [E, B, cap, d]: the experts' products are one
    # batched product over E, with no copy of the gathered tokens
    eidx = eidx.transpose(0, 1)
    rows = torch.arange(B, device=x.device)[None, :, None].expand_as(eidx)
    xe = x[rows, eidx].view(E, B * cap, d)
    h = F.silu(torch.bmm(xe, p.w_gate)).mul_(torch.bmm(xe, p.w_up))
    del xe
    ye = torch.bmm(h, p.w_down).view(E, B, cap, d)
    del h
    ye.mul_(egate.transpose(0, 1)[..., None].to(ye.dtype))
    # each token's contributions are added in expert order, as JAX's
    # scatter-add over [B, E, cap] adds them
    out = torch.zeros((B, S, d), dtype=ye.dtype, device=x.device)
    out.index_put_((rows, eidx), ye, accumulate=True)

    if p.shared is not None:
        sp = p.shared
        out = out + (F.silu(x @ sp.w_gate) * (x @ sp.w_up)) @ sp.w_down

    # load-balance auxiliary loss (Switch): E * sum_e f_e * P_e
    me = torch.zeros((B, S, E), dtype=torch.float32,
                     device=x.device).scatter(-1, topi, 1.0).mean((0, 1))
    pe = probs.mean((0, 1))
    return out.to(x.dtype), E * torch.sum(me * pe)
