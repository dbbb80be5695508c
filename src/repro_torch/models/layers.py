"""Shared transformer layers (port of ``repro.models.layers``): RMSNorm,
RoPE, GQA/MQA attention for prefill and for decode, the gated FFN, and a
mesh rank's place along ``model`` for a tensor-parallel step
(:class:`ModelGroup`: the sum of partial products over ``model``).

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
import torch.distributed as dist
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


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            tp: "ModelGroup | None" = None) -> torch.Tensor:
    """Normalise in fp32, cast back to ``x.dtype``, then ``* (1 + w)``.
    With ``tp``, ``x`` and ``w`` are a mesh rank's block of the features,
    and the variance is over every rank's (:meth:`ModelGroup.mean_square`)."""
    x32 = x.to(torch.float32)
    var = (torch.mean(torch.square(x32), dim=-1, keepdim=True) if tp is None
           else tp.mean_square(x32))
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

    Both products are batched over (lane, KV head), with each head's keys
    and values laid out ``[S, D]``: every batch entry is the same matrix
    product whatever the lanes and heads beside it, so the attention of a
    slice of the lanes or of the KV heads (with their query heads) is the
    same slice of the whole call, bit for bit.  A mesh rank attends its
    own heads so (``serve.decode``); an ``einsum`` here batched the heads
    otherwise and moved a bit when a slice held one KV head.
    """
    B, _, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    f32 = torch.float32

    def by_head(c):
        """[B, S, K, D] -> [B * K, S, D] in fp32."""
        return c.permute(0, 2, 1, 3).reshape(B * K, S, D).to(f32)

    qg = q.reshape(B * K, H // K, D).to(f32)
    s = torch.bmm(qg, by_head(k_cache).transpose(1, 2)) * softmax_scale(
        D, scale)
    pos = torch.arange(S, device=q.device)
    s = torch.where(pos < length, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.bmm(p.to(v_cache.dtype).to(f32), by_head(v_cache))
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


# ----------------------------------------------------- tensor parallelism ---
def role(share, name: str) -> str | None:
    """The role of leaf ``name``'s block along ``model`` in a mesh step
    (``share.roles``, ``launch.sharding.model_role``); None off a mesh."""
    return None if share is None else share.roles.get(name)


class ModelGroup:
    """A mesh rank's place along ``model`` in a tensor-parallel step: rank
    ``m`` of ``size`` in ``group`` (``serve.decode``).  Every reduction is
    an all-gather followed by arithmetic in rank order, never a backend's
    ``all_reduce``: the ``model`` ranks then hold identical bits whatever
    the backend, and a step is bit-equal run to run.  With ``size`` 1
    each is the identity."""

    def __init__(self, m: int, size: int, group):
        self.m, self.size, self.group = m, size, group

    def parts(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t``, in rank order."""
        if self.size == 1:
            return [t]
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return out

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` joined along ``dim`` in rank order (the
        features of a column-parallel product, the top-2 partials)."""
        return t if self.size == 1 else torch.cat(self.parts(t), dim=dim)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The partial products of a row-parallel product summed over
        ``model``: added in rank order into an fp32 zero and cast to
        ``t``'s dtype (``train.loop.mesh_grads``' arithmetic)."""
        if self.size == 1:
            return t
        acc = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
        for part in self.parts(t):
            acc.add_(part)
        return acc.to(t.dtype)

    def mean_square(self, x32: torch.Tensor) -> torch.Tensor:
        """The mean of the squares of fp32 ``x32`` over its last dimension,
        which is this rank's block of ``size`` equal blocks: each rank's
        sum of squares, summed over ``model`` (:meth:`sum`), over the
        whole width ([..., 1], a norm's variance)."""
        n = x32.shape[-1] * self.size
        return self.sum(torch.square(x32).sum(-1, keepdim=True)) / n

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of every rank's ``t``."""
        return t if self.size == 1 else torch.stack(self.parts(t)).amax(0)

    def block(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``size`` equal blocks of ``t`` along
        ``dim`` (the input features of a row-parallel product)."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.m * n, n)


# ------------------------------------------------------------- gated FFN ---
def gated_ffn(x: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor | None, w_down: torch.Tensor,
              act: str, tp: ModelGroup | None = None) -> torch.Tensor:
    """SwiGLU/GeGLU when w_up is present; a plain 2-matrix MLP when None.
    GELU is the tanh form, as ``jax.nn.gelu`` computes it by default.
    With ``tp`` the weights are a rank's ``d_ff`` columns of ``w_gate`` /
    ``w_up`` and rows of ``w_down``, and the partial outputs are summed
    over ``model``."""
    g = x @ w_gate
    a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    if w_up is not None:
        a = a * (x @ w_up)
    out = a @ w_down
    return out if tp is None else tp.sum(out)
