"""Config-driven decoder assembly (port of ``repro.models.transformer``)
for the layers that are Mamba-2 mixers.

Parameters are an :class:`LM` module whose names are the JAX package's
dict keys: ``embed``, ``out_norm``, ``unembed``, ``prefix`` (a list of
layers) and ``stack`` (one ``{"pos{j}": layer}`` block per repeat of the
period; the JAX package stacks these on a leading ``[n_repeat]`` axis and
scans, the port keeps a list and loops).  The cache mirrors it:
``{"prefix": [layer cache], "stack": [{"pos{j}": layer cache}]}`` with a
Mamba layer cache ``{"state": [B,H,P,N], "conv": (tx, tB, tC)}``.

Attention, MLA and MoE layers wait for the attention slice (ROADMAP A10
and B6): building or loading a config that has them raises.  The mesh's
``constrain_batch`` has no counterpart on one card, ``chunked_ce`` /
``lm_loss`` are training, which comes later, and the ``embeds`` inputs of
the JAX functions serve only the audio/VLM front ends of attention
configs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import mamba2
from repro_torch.models.layers import rmsnorm


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str   # attn | mla | mamba
    ffn: str     # dense | moe


def layer_plan(cfg: ArchConfig) -> tuple[list[LayerSpec], list[LayerSpec], int]:
    """(prefix_specs, period_specs, n_repeat)."""
    def spec(i: int) -> LayerSpec:
        if cfg.ssm and not cfg.is_attn_layer(i):
            mixer = "mamba"
        elif cfg.mla:
            mixer = "mla"
        else:
            mixer = "attn"
        return LayerSpec(mixer, "moe" if cfg.is_moe_layer(i) else "dense")

    n_prefix = cfg.moe_first_k_dense
    prefix = [spec(i) for i in range(n_prefix)]
    rem = cfg.n_layers - n_prefix
    if cfg.ssm and cfg.attn_layer_period:
        R = cfg.attn_layer_period
    elif cfg.moe and cfg.moe_period > 1:
        R = cfg.moe_period
    else:
        R = 1
    if rem % R:
        raise ValueError(f"{cfg.name}: {rem} layers after the prefix do not "
                         f"divide into periods of {R}")
    period = [spec(n_prefix + j) for j in range(R)]
    return prefix, period, rem // R


def check_ported(cfg: ArchConfig) -> None:
    """Raise unless every layer of ``cfg`` is a Mamba-2 mixer without an
    FFN, the only layer the port has."""
    prefix, period, _ = layer_plan(cfg)
    other = sorted({s.mixer for s in prefix + period} - {"mamba"})
    if other or cfg.attn_layer_period:
        raise NotImplementedError(
            f"{cfg.name}: the port runs Mamba-2 layers only; its "
            f"{', '.join(other) or 'FFN'} layers wait for the attention "
            f"slice (ROADMAP A10 and B6)")


class Layer(nn.Module):
    """One decoder layer: ``ln1`` and its ``mamba`` mixer."""

    def __init__(self, ln1: torch.Tensor, mamba: mamba2.Mamba):
        super().__init__()
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.mamba = mamba


class LM(nn.Module):
    """The whole decoder's weights (serving only)."""

    def __init__(self, embed: torch.Tensor, out_norm: torch.Tensor,
                 unembed: torch.Tensor | None, prefix: list[Layer],
                 stack: list[dict[str, Layer]]):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.out_norm = nn.Parameter(out_norm, requires_grad=False)
        self.unembed = (None if unembed is None
                        else nn.Parameter(unembed, requires_grad=False))
        self.prefix = nn.ModuleList(prefix)
        self.stack = nn.ModuleList(nn.ModuleDict(blk) for blk in stack)


# ---------------------------------------------------------------- params ---
def _init_layer(generator, cfg: ArchConfig, dtype) -> Layer:
    return Layer(torch.zeros((cfg.d_model,), dtype=dtype,
                             device=generator.device),
                 mamba2.init_mamba(generator, cfg, dtype))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16, device=None) -> LM:
    """Random weights from JAX's distributions, drawn by ``generator``,
    which must live on ``device`` (default: the card)."""
    check_ported(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"weights go to {dev}")
    prefix, period, n_rep = layer_plan(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    g = generator.device
    embed = (torch.randn((V, d), generator=generator, device=g)
             * 0.02).to(dtype)
    unembed = None
    if not cfg.tie_embeddings:
        unembed = (torch.randn((d, V), generator=generator, device=g)
                   / np.sqrt(d)).to(dtype)
    return LM(embed, torch.zeros((d,), dtype=dtype, device=g), unembed,
              [_init_layer(generator, cfg, dtype) for _ in prefix],
              [{f"pos{j}": _init_layer(generator, cfg, dtype)
                for j in range(len(period))} for _ in range(n_rep)])


# --------------------------------------------------------------- forward ---
def _layers(params: LM, cfg: ArchConfig):
    """Every (layer, spec) pair in order: the prefix, then each block."""
    prefix, period, _ = layer_plan(cfg)
    yield from zip(params.prefix, prefix)
    for blk in params.stack:
        for j, s in enumerate(period):
            yield blk[f"pos{j}"], s


def embed_tokens(params: LM, cfg: ArchConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    h = params.embed[tokens.long()]
    # the scale is cast to the working dtype before the multiply
    return h * torch.tensor(np.sqrt(cfg.d_model), dtype=h.dtype,
                            device=h.device)


def unembed(params: LM, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 from the product in the working dtype."""
    h = rmsnorm(h, params.out_norm)
    w = params.embed.T if cfg.tie_embeddings else params.unembed
    return (h @ w).to(torch.float32)


def forward(params: LM, cfg: ArchConfig,
            tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (hidden [B,S,d], moe_aux scalar)."""
    h = embed_tokens(params, cfg, tokens)
    for p, _ in _layers(params, cfg):
        mixed, _ = mamba2.mamba_forward(p.mamba, cfg, rmsnorm(h, p.ln1))
        h = h + mixed
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


# ---------------------------------------------------------------- decode ---
def _cache_init_layer(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    state, tail = mamba2.mamba_state_init(cfg, batch, dtype, device)
    return {"state": state, "conv": tail}


def cache_init(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Zero caches for ``batch`` lanes (a Mamba layer keeps no per-position
    entries, so ``max_seq`` sizes nothing)."""
    check_ported(cfg)
    dev = resolve_device(device)
    prefix, period, n_rep = layer_plan(cfg)
    return {"prefix": [_cache_init_layer(cfg, batch, dtype, dev)
                       for _ in prefix],
            "stack": [{f"pos{j}": _cache_init_layer(cfg, batch, dtype, dev)
                       for j in range(len(period))} for _ in range(n_rep)]}


def _apply_layer_decode(p: Layer, cfg: ArchConfig, s: LayerSpec, h, cache,
                        length):
    mixed, (st, tail) = mamba2.mamba_decode(p.mamba, cfg, rmsnorm(h, p.ln1),
                                            cache["state"], cache["conv"])
    return h + mixed, {"state": st, "conv": tail}


def decode_step(params: LM, cfg: ArchConfig, token, cache, length):
    """One decode step.  token [B] int; returns (logits [B,V] fp32,
    new_cache)."""
    prefix, period, _ = layer_plan(cfg)
    h = embed_tokens(params, cfg, token[:, None])
    new_prefix = []
    for p, s, c in zip(params.prefix, prefix, cache["prefix"]):
        h, c = _apply_layer_decode(p, cfg, s, h, c, length)
        new_prefix.append(c)
    new_stack = []
    for blk, blk_cache in zip(params.stack, cache["stack"]):
        nc = {}
        for j, s in enumerate(period):
            h, nc[f"pos{j}"] = _apply_layer_decode(
                blk[f"pos{j}"], cfg, s, h, blk_cache[f"pos{j}"], length)
        new_stack.append(nc)
    return unembed(params, cfg, h[:, 0]), {"prefix": new_prefix,
                                           "stack": new_stack}


def prefill(params: LM, cfg: ArchConfig, tokens: torch.Tensor,
            max_seq: int | None = None):
    """Prefill: full forward, caches populated for positions [0, S).

    Returns (last-position logits [B,V] fp32, cache); decode continues at
    length=S.  ``max_seq`` (default S) must be at least S; a Mamba cache
    holds no per-position entries, so it sizes nothing.
    """
    prefix, period, _ = layer_plan(cfg)
    S = tokens.shape[1]
    if max_seq is not None and max_seq < S:
        raise ValueError(f"max_seq {max_seq} < prompt length {S}")
    h = embed_tokens(params, cfg, tokens)

    def mix_with_cache(p: Layer, h):
        mixed, (st, tail) = mamba2.mamba_forward(p.mamba, cfg,
                                                 rmsnorm(h, p.ln1))
        return h + mixed, {"state": st, "conv": tail}

    new_prefix = []
    for p in params.prefix:
        h, c = mix_with_cache(p, h)
        new_prefix.append(c)
    new_stack = []
    for blk in params.stack:
        caches = {}
        for j in range(len(period)):
            h, caches[f"pos{j}"] = mix_with_cache(blk[f"pos{j}"], h)
        new_stack.append(caches)
    return unembed(params, cfg, h[:, -1]), {"prefix": new_prefix,
                                            "stack": new_stack}
