"""Shared transformer layers (port of ``repro.models.layers``): RMSNorm,
RoPE, GQA/MQA attention for prefill and for decode, the gated FFN.

The model's attention for a whole sequence is :func:`flash_attention`
with ``use_kernels=True``: ``ops.flash_attention`` (the CUDA kernel on a
CUDA tensor, its plain version on a CPU tensor), which computes what the
TPU kernel and ``repro.kernels.ref.flash_attention_ref`` compute.
``use_kernels=False`` is JAX's blocked form (``layers.py::flash_attention``),
which rounds q·k to the inputs' dtype before the softmax; the two are the
same function in fp32 and differ slightly in bf16.  Decode
attention is plain PyTorch, as JAX computes it outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import softmax_scale


# ----------------------------------------------------------------- draws ---
class MetaDraws:
    """What the weight initialisers take in place of a ``torch.Generator``
    to build a model on the ``meta`` device, which has no generator: each
    draw is then an allocation without values (``launch.dryrun``)."""
    device = torch.device("meta")


def normal(shape, generator) -> torch.Tensor:
    """A float32 ``N(0, 1)`` draw of ``shape`` by ``generator`` on its
    device; on ``meta`` (:class:`MetaDraws`) an allocation."""
    if generator.device.type == "meta":
        return torch.empty(shape, device=generator.device)
    return torch.randn(shape, generator=generator, device=generator.device)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalise in fp32, cast back to ``x.dtype``, then ``* (1 + w)``."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + w)


# ------------------------------------------------------------------ RoPE ---
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S].  The
    half-split layout (the first and second halves of D rotate together),
    angles in fp32, the result in x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)       # [D/2]
    angles = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------- causal attention ---
def _flash_blocked(q, k, v, *, causal: bool, blk_q: int, blk_k: int,
                   scale: float) -> torch.Tensor:
    """JAX's blocked online softmax: q·k rounded to q's dtype, then fp32;
    the causal scan bounded at each q block's last live key block."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    Dv = v.shape[3]
    G = H // K
    blk_q, blk_k = min(blk_q, Sq), min(blk_k, Sk)
    if Sq % blk_q or Sk % blk_k:
        raise ValueError(f"blocked attention needs Sq % blk_q == 0 and "
                         f"Sk % blk_k == 0, got {(Sq, blk_q, Sk, blk_k)}")
    nq, nk = Sq // blk_q, Sk // blk_k
    qb = q.reshape(B, nq, blk_q, K, G, D)
    kb = k.reshape(B, nk, blk_k, K, D)
    vb = v.reshape(B, nk, blk_k, K, Dv)
    f32 = torch.float32
    outs = []
    for iq in range(nq):
        acc = torch.zeros((B, K, G, blk_q, Dv), dtype=f32, device=q.device)
        m = torch.full((B, K, G, blk_q), float("-inf"), device=q.device)
        l = torch.zeros((B, K, G, blk_q), device=q.device)
        n_live = (min((iq * blk_q + blk_q + blk_k - 1) // blk_k, nk)
                  if causal else nk)
        for jk in range(n_live):
            # the product in q's dtype, scaled in fp32 (JAX's scale is a
            # numpy float64, which promotes a bf16 product to fp32)
            s = torch.einsum("bqkgd,bpkd->bkgqp", qb[:, iq],
                             kb[:, jk]).to(f32) * scale
            if causal:
                qpos = iq * blk_q + torch.arange(blk_q, device=q.device)
                kpos = jk * blk_k + torch.arange(blk_k, device=q.device)
                s = torch.where(qpos[:, None] >= kpos[None, :], s,
                                float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            # p in q's dtype, accumulated in fp32 (products of bf16 values
            # are exact in fp32)
            pv = torch.einsum("bkgqp,bpkd->bkgqd", p.to(q.dtype).to(f32),
                              vb[:, jk].to(f32))
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs, dim=3).reshape(B, K, G, Sq, Dv)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, blk_q: int = 512, blk_k: int = 1024,
                    scale: float | None = None,
                    use_kernels: bool = True) -> torch.Tensor:
    """Attention over a whole sequence: q [B, Sq, H, D], k [B, Sk, K, D],
    v [B, Sk, K, Dv] with H % K == 0 -> [B, Sq, H, Dv] in q's dtype.

    ``use_kernels=True`` (the model's path) calls ``ops.flash_attention``
    on contiguous inputs; any Sq, Sk.  ``use_kernels=False`` is JAX's
    blocked jnp form, which needs Sq and Sk divisible by its blocks.
    """
    if use_kernels:
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   scale=scale)
    return _flash_blocked(q, k, v, causal=causal, blk_q=blk_q, blk_k=blk_k,
                          scale=softmax_scale(q.shape[-1], scale))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length, *,
                     scale: float | None = None) -> torch.Tensor:
    """Single-step decode.  q [B, 1, H, D]; caches [B, S, K, D] attended at
    positions ``< length``; returns [B, 1, H, D] in q's dtype.

    The cache stays stored in its dtype; each product takes it upcast to
    fp32, which is JAX's fp32 accumulation of the stored values
    (``preferred_element_type``).  The softmax runs in fp32 and ``p`` is
    rounded to the cache's dtype before ``p·v``.
    """
    B, _, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    f32 = torch.float32
    qg = q.reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(f32),
                     k_cache.to(f32)) * softmax_scale(D, scale)
    pos = torch.arange(S, device=q.device)
    s = torch.where(pos < length, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).to(f32),
                       v_cache.to(f32))
    return out.reshape(B, 1, H, D).to(q.dtype)


def write_cache_rows(cache: dict, length: int, rows: dict) -> dict:
    """A new cache: ``cache``'s tensors ``[B, S, ...]`` with ``rows[name]
    [B, 1, ...]`` at position ``length`` (K/V, or MLA's latent and rope
    key).  The given cache is left as it was: the FoG mask selects
    between the two."""
    size = next(iter(cache.values())).shape[1]
    if not 0 <= length < size:
        raise ValueError(f"length {length} outside the KV cache's "
                         f"[0, {size})")
    out = {}
    for name, row in rows.items():
        t = cache[name].clone()
        t[:, length] = row[:, 0].to(t.dtype)
        out[name] = t
    return out


# ------------------------------------------------------------- gated FFN ---
def gated_ffn(x: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor | None, w_down: torch.Tensor,
              act: str) -> torch.Tensor:
    """SwiGLU/GeGLU when w_up is present; a plain 2-matrix MLP when None.
    GELU is the tanh form, as ``jax.nn.gelu`` computes it by default."""
    g = x @ w_gate
    a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    if w_up is not None:
        a = a * (x @ w_up)
    return a @ w_down
