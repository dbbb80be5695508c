"""Multi-head Latent Attention, MiniCPM3 / DeepSeek-V3 (port of
``repro.models.mla``).

The full-sequence path expands K and V from the compressed latent and runs
``layers.flash_attention`` (the CUDA ``flash_attention`` kernel on the
card) with query/key heads of ``dn + dr`` and value heads of ``dv``: D =
96, Dv = 64 for minicpm3-4b and D = 192, Dv = 128 for deepseek-v3, both
on the kernel's tensor-core route in bf16 (``flash_attention.SM90_PAIRS``)
and its SIMT route in fp32.  Decode uses the ABSORBED form: W_UK is folded
into the query and W_UV into the output, so attention runs against the
cached latent ``c_kv`` (rank r_kv) and the shared ``k_rope``, a cache of
``[B, S, r_kv + d_rope]`` in place of ``[B, S, H, dn + dr + dv]``.

JAX's absorbed products take the cache's storage dtype with
``preferred_element_type=f32``: fp32 accumulation of the stored values.
The port computes them as fp32 products of the upcast operands (products
of bf16 values are exact in fp32) with TF32 off, as JAX's CPU
computes them.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (apply_rope, flash_attention, normal,
                                       rmsnorm, write_cache_rows)

PARAM_NAMES = ("w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_uk", "w_uv",
               "w_o")


class MLA(nn.Module):
    """One MLA mixer's weights, JAX's names: ``w_dq [d, rq]``, ``q_norm
    [rq]``, ``w_uq [rq, H, dn + dr]``, ``w_dkv [d, rkv + dr]``, ``kv_norm
    [rkv]``, ``w_uk [rkv, H, dn]``, ``w_uv [rkv, H, dv]``, ``w_o [H, dv,
    d]``."""

    def __init__(self, weights: dict):
        super().__init__()
        for name in PARAM_NAMES:
            self.register_parameter(
                name, nn.Parameter(weights[name], requires_grad=False))


def init_mla(generator: torch.Generator, cfg: ArchConfig, dtype) -> MLA:
    """Random weights from JAX's distributions (normal over the square
    root of the first dimension; norms zero), drawn by ``generator``."""
    d, H = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    g = generator.device

    def init(*sh):
        return (normal(sh, generator) / np.sqrt(sh[0])).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=g)

    return MLA({"w_dq": init(d, rq), "q_norm": zeros(rq),
                "w_uq": init(rq, H, dn + dr), "w_dkv": init(d, rkv + dr),
                "kv_norm": zeros(rkv), "w_uk": init(rkv, H, dn),
                "w_uv": init(rkv, H, dv), "w_o": init(H, dv, d)})


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., a] times w [a, *out] as one matrix product: [..., *out]."""
    return (x @ w.reshape(w.shape[0], -1)).view(*x.shape[:-1], *w.shape[1:])


def _project_q(p: MLA, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor):
    """(q_nope [B, S, H, dn], q_rope [B, S, H, dr] after RoPE)."""
    dn = cfg.qk_nope_head_dim
    cq = rmsnorm(x @ p.w_dq, p.q_norm)
    q = _proj(cq, p.w_uq)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _compress_kv(p: MLA, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """(c_kv [B, S, rkv] normalised, k_rope [B, S, dr] after RoPE)."""
    rkv = cfg.kv_lora_rank
    ckv_rope = x @ p.w_dkv
    c_kv = rmsnorm(ckv_rope[..., :rkv], p.kv_norm)
    k_rope = apply_rope(ckv_rope[..., None, rkv:], positions, cfg.rope_theta)
    return c_kv, k_rope[..., 0, :]


def mla_forward(p: MLA, cfg: ArchConfig, x: torch.Tensor):
    """Full-sequence path over x [B, S, d]: (output [B, S, d], c_kv, k_rope
    for the cache).  K/V expanded from the latent, ``k_rope`` broadcast
    over the heads, one ``flash_attention`` at scale ``1/sqrt(dn + dr)``."""
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    H = cfg.n_heads
    pos = torch.arange(S, device=x.device).expand(B, S)
    q_nope, q_rope = _project_q(p, cfg, x, pos)
    c_kv, k_rope = _compress_kv(p, cfg, x, pos)
    k_nope = _proj(c_kv, p.w_uk)
    v = _proj(c_kv, p.w_uv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)],
                  dim=-1)
    out = flash_attention(q, k, v, causal=True,
                          scale=1.0 / np.sqrt(dn + dr))      # [B,S,H,dv]
    o = out.reshape(B, S, -1) @ p.w_o.reshape(-1, p.w_o.shape[-1])
    return o, c_kv, k_rope


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def mla_kv_update(p: MLA, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                  length: int) -> dict:
    """The cache with x [B, 1, d]'s latent and rope key at ``length``."""
    pos = torch.full((x.shape[0], 1), length, device=x.device)
    c_kv, k_rope = _compress_kv(p, cfg, x, pos)
    return write_cache_rows(cache, length, {"c_kv": c_kv, "k_rope": k_rope})


def mla_attention_decode(p: MLA, cfg: ArchConfig, x: torch.Tensor,
                         cache: dict, length: int):
    """Absorbed single-step decode against the compressed cache.

    x [B, 1, d]; cache {"c_kv": [B, S, rkv], "k_rope": [B, S, dr]}, the
    positions ``<= length`` attended.  Returns (out [B, 1, d], new
    cache)."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    pos = torch.full((x.shape[0], 1), length, device=x.device)
    q_nope, q_rope = _project_q(p, cfg, x, pos)
    cache = mla_kv_update(p, cfg, x, cache, length)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    f32 = torch.float32
    with _no_tf32():
        q_lat = torch.einsum("bhe,rhe->bhr", q_nope[:, 0].to(f32),
                             p.w_uk.to(f32))
        s_lat = torch.einsum("bhr,bsr->bhs",
                             q_lat.to(c_kv.dtype).to(f32), c_kv.to(f32))
        s_rope = torch.einsum("bhe,bse->bhs", q_rope[:, 0].to(f32),
                              k_rope.to(f32))
        # JAX divides by the scale as an fp32 scalar (a Python scalar would
        # be taken through its reciprocal on the card)
        s = (s_lat + s_rope) / torch.tensor(np.sqrt(dn + dr), dtype=f32,
                                            device=x.device)
        keep = torch.arange(s.shape[-1], device=x.device) <= length
        attn = torch.softmax(torch.where(keep, s, float("-inf")), dim=-1)
        ctx_lat = torch.einsum("bhs,bsr->bhr",
                               attn.to(c_kv.dtype).to(f32), c_kv.to(f32))
        ctx = torch.einsum("bhr,rhe->bhe",
                           ctx_lat.to(p.w_uv.dtype).to(f32),
                           p.w_uv.to(f32))
    out = ctx.to(x.dtype).reshape(x.shape[0], -1) @ p.w_o.reshape(
        -1, p.w_o.shape[-1])
    return out[:, None, :], cache


def mla_cache_init(cfg: ArchConfig, batch: int, max_seq: int, dtype,
                   device) -> dict:
    return {"c_kv": torch.zeros((batch, max_seq, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_seq, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device)}
