"""Config-driven decoder assembly (port of ``repro.models.transformer``)
for every layer kind of the assigned architectures: attention (GQA/MQA
with RoPE) or MLA or Mamba-2 mixers, dense or MoE FFNs, in the periods of
``layer_plan`` (deepseek's dense prefix, jamba's hybrid period of Mamba
layers that keep an FFN around one attention layer, MoE every
``moe_period`` layers).

Parameters are an :class:`LM` module whose names are the JAX package's
dict keys: ``embed``, ``out_norm``, ``unembed``, ``prefix`` (a list of
layers) and ``stack`` (one ``{"pos{j}": layer}`` block per repeat of the
period; the JAX package stacks these on a leading ``[n_repeat]`` axis and
scans, the port keeps a list and loops).  A layer holds ``ln1`` and its
mixer -- ``attn`` (an :class:`Attn`: ``wq [d, H, hd]``, ``wk``/``wv [d,
K, hd]``, ``wo [H, hd, d]``; or an ``mla.MLA``) or ``mamba`` -- then,
where it has an FFN, ``ln2`` and ``ffn`` (an :class:`FFN`: ``w_gate``,
``w_up``, ``w_down``; or a ``moe.MoE``).  The cache mirrors the
parameters: ``{"prefix": [layer cache], "stack": [{"pos{j}": layer
cache}]}`` with an attention layer cache ``{"k", "v": [B, max_seq, K,
hd]}`` (keys after RoPE), an MLA layer cache ``{"c_kv": [B, max_seq,
rkv], "k_rope": [B, max_seq, dr]}`` and a Mamba layer cache ``{"state":
[B,H,P,N], "conv": (tx, tB, tC)}``.

A decode step writes its cache row into a new cache tensor, never into the
one it was given: ``decode_step_fog`` keeps an exited lane's old cache
through a masked select of the new cache against the old, and an in-place
write would make them one tensor.

``forward``, ``prefill`` and ``decode_step`` take token ids or, as JAX's
do, ``embeds`` ([B, S, d] or [B, 1, d] in the working dtype), which then
take the place of the token embedding: the audio and VLM configs
(``cfg.frontend``) are served from their front ends' embeddings.
``forward`` returns the MoE layers' load-balance loss summed, as JAX's.

On a mesh (``share``: ``serve.decode``'s ``MeshShare`` for the model and
a ``LayerShare`` for each layer) the serving functions are
tensor-parallel over ``model``, as JAX's sharded program: ``params``
holds the rank's blocks, and each product runs by the role of its
weight's block (``launch.sharding.model_role``): a column-parallel weight
gives the rank's block of the outputs, a row-parallel one a partial
product summed over ``model`` (``layers.ModelGroup.sum``), a weight the
plan keeps whole the whole product.  Attention runs on the rank's heads;
the embedding is a masked lookup of the rank's vocabulary rows and the
unembedding gives the rank's block of the logits (both on ``d_model``
where the vocabulary does not divide); the MoE and MLA/Mamba layers as
their modules say.

Training: ``forward(..., remat=True)`` wraps each block of the stack in
``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` of its scan body; the
prefix layers are not wrapped, as in JAX), which changes no number;
``chunked_ce`` is JAX's chunked cross-entropy, each chunk's logits
recomputed in the backward; ``lm_loss`` adds the MoE load-balance loss and
deepseek's multi-token-prediction term.  The model's weights are frozen
as built or carried (serving); ``train.loop`` turns gradients on for the
parameters it trains.  The mesh's ``constrain_batch`` has no counterpart
on one card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import mamba2, mla, moe
from repro_torch.models.layers import (apply_rope, decode_attention,
                                       flash_attention, gated_ffn, normal,
                                       rmsnorm, write_cache_rows)


def role(share, name: str) -> str | None:
    """The role of leaf ``name``'s block along ``model`` in a mesh step
    (``share.roles``, ``launch.sharding.model_role``); None off a mesh."""
    return None if share is None else share.roles.get(name)


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


def _frozen(module: nn.Module, tensors: dict) -> None:
    for name, t in tensors.items():
        module.register_parameter(
            name, None if t is None else nn.Parameter(t, requires_grad=False))


class Attn(nn.Module):
    """One attention mixer's weights: ``wq [d, H, hd]``, ``wk`` and ``wv``
    ``[d, K, hd]``, ``wo [H, hd, d]``."""

    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        _frozen(self, {"wq": wq, "wk": wk, "wv": wv, "wo": wo})


class FFN(nn.Module):
    """One dense FFN's weights: ``w_gate``/``w_up [d, f]``, ``w_down
    [f, d]``; ``w_up`` is None for a plain 2-matrix MLP."""

    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        _frozen(self, {"w_gate": w_gate, "w_up": w_up, "w_down": w_down})


class Layer(nn.Module):
    """One decoder layer: ``ln1`` and its mixer (``attn``: an
    :class:`Attn` or an ``mla.MLA``; or ``mamba``), then ``ln2`` and
    ``ffn`` (an :class:`FFN` or a ``moe.MoE``) where the layer has an
    FFN."""

    def __init__(self, ln1: torch.Tensor, *,
                 mamba: mamba2.Mamba | None = None,
                 attn: Attn | mla.MLA | None = None,
                 ln2: torch.Tensor | None = None,
                 ffn: FFN | moe.MoE | None = None):
        super().__init__()
        _frozen(self, {"ln1": ln1, "ln2": ln2})
        self.mamba, self.attn, self.ffn = mamba, attn, ffn


class LM(nn.Module):
    """The whole decoder's weights.  ``mtp`` holds deepseek's
    multi-token-prediction head (``proj [2d, d]``, ``ln [d]``), which only
    ``lm_loss`` uses."""

    def __init__(self, embed: torch.Tensor, out_norm: torch.Tensor,
                 unembed: torch.Tensor | None, prefix: list[Layer],
                 stack: list[dict[str, Layer]], mtp: dict | None = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.out_norm = nn.Parameter(out_norm, requires_grad=False)
        self.unembed = (None if unembed is None
                        else nn.Parameter(unembed, requires_grad=False))
        self.prefix = nn.ModuleList(prefix)
        self.stack = nn.ModuleList(nn.ModuleDict(blk) for blk in stack)
        self.mtp = None
        if mtp is not None:
            self.mtp = nn.ParameterDict(
                {k: nn.Parameter(v, requires_grad=False)
                 for k, v in mtp.items()})


# ---------------------------------------------------------------- params ---
def _init_attn(generator, cfg: ArchConfig, dtype) -> Attn:
    d, H, K, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                   cfg.resolved_head_dim)
    def init(*sh, fan_in=d):
        return (normal(sh, generator) / np.sqrt(fan_in)).to(dtype)

    return Attn(init(d, H, hd), init(d, K, hd), init(d, K, hd),
                init(H, hd, d, fan_in=H * hd))


def _init_ffn(generator, cfg: ArchConfig, dtype) -> FFN:
    d, f = cfg.d_model, cfg.d_ff
    def init(a, b):
        return (normal((a, b), generator) / np.sqrt(a)).to(dtype)

    return FFN(init(d, f), init(d, f) if cfg.gated_ffn else None, init(f, d))


def _init_layer(generator, cfg: ArchConfig, s: LayerSpec, dtype) -> Layer:
    def zeros():
        return torch.zeros((cfg.d_model,), dtype=dtype,
                           device=generator.device)

    ln1 = zeros()
    if s.mixer == "mamba":
        mixer = {"mamba": mamba2.init_mamba(generator, cfg, dtype)}
    elif s.mixer == "mla":
        mixer = {"attn": mla.init_mla(generator, cfg, dtype)}
    else:
        mixer = {"attn": _init_attn(generator, cfg, dtype)}
    # Mamba blocks are mixer-only in mamba2; the hybrid (jamba) keeps the FFN
    if s.mixer == "mamba" and not cfg.attn_layer_period:
        return Layer(ln1, **mixer)
    ffn = (moe.init_moe(generator, cfg, dtype) if s.ffn == "moe"
           else _init_ffn(generator, cfg, dtype))
    return Layer(ln1, **mixer, ln2=zeros(), ffn=ffn)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16, device=None) -> LM:
    """Random weights from JAX's distributions, drawn by ``generator``,
    which must live on ``device`` (default: the card).  On ``meta``,
    ``layers.MetaDraws()`` takes the generator's place: the model's
    shapes and dtypes without values."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"weights go to {dev}")
    prefix, period, n_rep = layer_plan(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    g = generator.device
    embed = (normal((V, d), generator) * 0.02).to(dtype)
    unembed = None
    if not cfg.tie_embeddings:
        unembed = (normal((d, V), generator) / np.sqrt(d)).to(dtype)
    layers = ([_init_layer(generator, cfg, s, dtype) for s in prefix],
              [{f"pos{j}": _init_layer(generator, cfg, s, dtype)
                for j, s in enumerate(period)} for _ in range(n_rep)])
    mtp = None
    if cfg.mtp:
        mtp = {"proj": (normal((2 * d, d), generator)
                        / np.sqrt(2 * d)).to(dtype),
               "ln": torch.zeros((d,), dtype=dtype, device=g)}
    return LM(embed, torch.zeros((d,), dtype=dtype, device=g), unembed,
              *layers, mtp)


# --------------------------------------------------------------- forward ---
def _layers(params: LM, cfg: ArchConfig):
    """Every (layer, spec) pair in order: the prefix, then each block."""
    prefix, period, _ = layer_plan(cfg)
    yield from zip(params.prefix, prefix)
    for blk in params.stack:
        for j, s in enumerate(period):
            yield blk[f"pos{j}"], s


def embed_tokens(params: LM, cfg: ArchConfig, tokens: torch.Tensor,
                 share=None) -> torch.Tensor:
    """The tokens' embedding times ``sqrt(d_model)``.  On a mesh the
    rank's vocabulary rows give a masked lookup (zeros outside the block)
    summed over ``model``: one term is not zero, so the sum is the whole
    lookup bit for bit; the rank's ``d_model`` columns give its block of
    each embedding, gathered."""
    tokens = tokens.long()
    where = role(share, "embed")
    if where == "out":
        n = params.embed.shape[0]
        local = tokens - share.tp.m * n
        inside = ((local >= 0) & (local < n))[..., None]
        h = F.embedding(local.clamp(0, n - 1), params.embed)
        h = share.tp.sum(torch.where(inside, h, 0.0))
    else:
        # a lookup whose backward sums each row's gradients in a fixed
        # order on both devices (indexing's backward accumulates in
        # parallel on the CPU, and training's resume must be bit-exact)
        h = F.embedding(tokens, params.embed)
        if where == "in":
            h = share.tp.gather(h, -1)
    # the scale is cast to the working dtype before the multiply
    return h * torch.tensor(np.sqrt(cfg.d_model), dtype=h.dtype,
                            device=h.device)


def embed_inputs(params: LM, cfg: ArchConfig, tokens: torch.Tensor | None,
                 embeds: torch.Tensor | None, share=None) -> torch.Tensor:
    """The first hidden state: ``embeds`` when given, else the tokens'
    embedding."""
    if embeds is not None:
        return embeds
    if tokens is None:
        raise ValueError("give tokens or embeds")
    return embed_tokens(params, cfg, tokens, share)


def unembed(params: LM, cfg: ArchConfig, h: torch.Tensor,
            share=None) -> torch.Tensor:
    """Logits in fp32 from the product in the working dtype.  Tied
    embeddings take it as ``embed @ h^T``, transposed back: the CPU's
    product of ``h`` by a transposed ``embed`` rounds a row by the number
    of rows beside it, which would part a mesh rank's lanes from the same
    lanes of the whole batch (``serve.decode``).  On a mesh: the rank's
    block of the vocabulary's logits, or, where the weight is split on
    ``d_model``, the partial logits of the rank's features summed over
    ``model``."""
    h = rmsnorm(h, params.out_norm)
    where = role(share, "unembed" if not cfg.tie_embeddings else "embed")
    if where == "in":
        h = share.tp.block(h, -1)
    if not cfg.tie_embeddings:
        out = h @ params.unembed
    else:
        flat = h.reshape(-1, h.shape[-1])
        out = (params.embed @ flat.T).T.reshape(*h.shape[:-1], -1)
    if where == "in":
        out = share.tp.sum(out)
    return out.to(torch.float32, memory_format=torch.contiguous_format)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,d...->...", x, w)``: x [..., d] times w [d, *out]
    as one matrix product, contiguous [..., *out]."""
    return (x @ w.reshape(w.shape[0], -1)).view(*x.shape[:-1], *w.shape[1:])


def _kv(p: Attn, cfg: ArchConfig, x: torch.Tensor, pos: torch.Tensor):
    """Keys after RoPE and values of x [B, S, d] at positions [B, S]."""
    return apply_rope(_proj(x, p.wk), pos, cfg.rope_theta), _proj(x, p.wv)


def _q(p: Attn, x: torch.Tensor, share=None) -> torch.Tensor:
    """The queries before RoPE: every head, or on a mesh the rank's heads
    (``wq``'s heads on ``model``), or every head summed over the ranks'
    ``d_model`` blocks (``wq`` on ``d_model`` where the heads do not
    divide)."""
    if role(share, "attn.wq") == "in":
        return share.tp.sum(_proj(share.tp.block(x, -1), p.wq))
    return _proj(x, p.wq)


def _kv_for_q(k: torch.Tensor, v: torch.Tensor, H: int, share=None):
    """The keys and values the query heads read: ``k`` and ``v`` as they
    are, except on a mesh whose rank holds a block of the H query heads
    with every KV head (``wk``/``wv`` whole: their heads do not divide):
    then the KV heads of the rank's query heads, the one they share, or
    each query head's own."""
    if (role(share, "attn.wq") != "out"
            or role(share, "attn.wk") == "out"):
        return k, v
    K = k.shape[2]
    group, n = H // K, H // share.tp.size
    lo = share.tp.m * n
    if group % n == 0:
        return k.narrow(2, lo // group, 1), v.narrow(2, lo // group, 1)
    idx = torch.div(torch.arange(lo, lo + n, device=k.device), group,
                    rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


def _attn_out(p: Attn, out: torch.Tensor, share=None) -> torch.Tensor:
    """``einsum("bshe,hed->bsd", out, wo)`` as one matrix product; on a
    mesh the rank's heads' rows of ``wo`` summed over ``model``, or
    (``wo`` on ``d_model``) the rank's block of the features, gathered."""
    y = out.reshape(*out.shape[:2], -1) @ p.wo.reshape(-1, p.wo.shape[-1])
    where = role(share, "attn.wo")
    if where == "in":
        return share.tp.sum(y)
    return share.tp.gather(y, -1) if where == "out" else y


def _attn_train(p: Attn, cfg: ArchConfig, x: torch.Tensor, share=None):
    """Causal self-attention over x [B, S, d]: (output [B, S, d], the keys
    after RoPE and the values, for the cache).  On a mesh (``share``)
    tensor-parallel: the rank's query heads against their KV heads, the
    keys and values returned its KV heads (its block of the cache) where
    they are on ``model``, else every KV head."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device).expand(B, S)
    q = apply_rope(_q(p, x, share), pos, cfg.rope_theta)
    k, v = _kv(p, cfg, x, pos)
    out = flash_attention(q, *_kv_for_q(k, v, cfg.n_heads, share),
                          causal=True)
    return _attn_out(p, out, share), k, v


def _ffn(p: Layer, cfg: ArchConfig, s: LayerSpec, h: torch.Tensor,
         share=None):
    """The residual FFN block, where the layer has one: (h after it, the
    MoE load-balance loss or None); on a mesh tensor-parallel."""
    if p.ffn is None:
        return h, None
    x = rmsnorm(h, p.ln2)
    if s.ffn == "moe":
        y, aux = moe.moe_ffn(p.ffn, cfg, x, share)
        return h + y, aux
    f = p.ffn
    tp = share.tp if role(share, "ffn.w_down") == "in" else None
    return h + gated_ffn(x, f.w_gate, f.w_up, f.w_down, cfg.act, tp), None


def _layer_seq(p: Layer, cfg: ArchConfig, s: LayerSpec, h: torch.Tensor,
               share=None):
    """One layer over a whole sequence: (h after it, its cache: the keys
    after RoPE and the values, the MLA latent and rope key, or the Mamba
    state and conv tails; the MoE loss or None).  ``share``: the layer's
    share of a mesh step (attention and the FFN tensor-parallel)."""
    x = rmsnorm(h, p.ln1)
    if s.mixer == "mamba":
        mixed, (st, tail) = mamba2.mamba_forward(p.mamba, cfg, x)
        cache = {"state": st, "conv": tail}
    elif s.mixer == "mla":
        mixed, c_kv, k_rope = mla.mla_forward(p.attn, cfg, x)
        cache = {"c_kv": c_kv, "k_rope": k_rope}
    else:
        mixed, k, v = _attn_train(p.attn, cfg, x, share)
        cache = {"k": k, "v": v}
    h, aux = _ffn(p, cfg, s, h + mixed, share)
    return h, cache, aux


def _block_seq(blk, cfg: ArchConfig, period: list[LayerSpec],
               h: torch.Tensor, total: torch.Tensor):
    """One block of the stack (one period of layers) over a sequence:
    (h after it, the MoE losses added to ``total``)."""
    for j, s in enumerate(period):
        h, _, aux = _layer_seq(blk[f"pos{j}"], cfg, s, h)
        if aux is not None:
            total = total + aux
    return h, total


def forward(params: LM, cfg: ArchConfig, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None, remat: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward over tokens [B, S] or embeds [B, S, d].
    Returns (hidden [B,S,d], moe_aux scalar).  ``remat`` recomputes each
    block of the stack in the backward instead of keeping its
    activations (``lm_loss`` passes True, as JAX's does)."""
    prefix, period, _ = layer_plan(cfg)
    h = embed_inputs(params, cfg, tokens, embeds)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for p, s in zip(params.prefix, prefix):
        h, _, aux = _layer_seq(p, cfg, s, h)
        if aux is not None:
            total = total + aux
    for blk in params.stack:
        if remat:
            h, total = checkpoint(_block_seq, blk, cfg, period, h, total,
                                  use_reentrant=False)
        else:
            h, total = _block_seq(blk, cfg, period, h, total)
    return h, total


def _ce_chunk(params: LM, cfg: ArchConfig, h: torch.Tensor,
              labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(unembed(params, cfg, h), dim=-1)
    ce = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return (ce * mask).sum()


def chunked_ce(params: LM, cfg: ArchConfig, h: torch.Tensor,
               labels: torch.Tensor, chunk: int = 512,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy of ``unembed(h)`` against labels [B, S] over the
    positions ``mask`` keeps, without the whole [B, S, V] fp32 logits:
    sequence chunks of ``min(chunk, S)`` (the whole sequence when that
    does not divide S), each chunk's logits recomputed in the backward
    (``torch.utils.checkpoint``, JAX's ``nothing_saveable`` scan body) and
    the chunks' sums added in order."""
    B, S = labels.shape
    c = min(chunk, S)
    if S % c:
        c = S
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, c):
        total = total + checkpoint(_ce_chunk, params, cfg, h[:, i:i + c],
                                   labels[:, i:i + c], mask[:, i:i + c],
                                   use_reentrant=False)
    return total / torch.clamp(mask.sum(), min=1.0)


def lm_loss(params: LM, cfg: ArchConfig, tokens: torch.Tensor | None = None,
            labels: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None, aux_coef: float = 0.01,
            remat: bool = True) -> torch.Tensor:
    """JAX's training loss: ``chunked_ce`` of the forward against labels,
    plus for ``cfg.mtp`` 0.3 x the multi-token-prediction term (position t
    predicts label t + 1 from ``rmsnorm(h_t, mtp.ln) ‖ embed(label_t)``
    times ``mtp.proj``; the last position masked), plus ``aux_coef`` x the
    MoE load-balance loss."""
    h, aux = forward(params, cfg, tokens=tokens, embeds=embeds, remat=remat)
    loss = chunked_ce(params, cfg, h, labels)
    if cfg.mtp:
        mtp = params.mtp
        mixed = torch.cat([rmsnorm(h, mtp["ln"]),
                           embed_tokens(params, cfg, labels)], dim=-1)
        labels2 = torch.roll(labels, -1, dims=1)
        mask2 = torch.ones(labels2.shape, dtype=torch.float32,
                           device=h.device)
        mask2[:, -1] = 0.0
        loss = loss + 0.3 * chunked_ce(params, cfg, mixed @ mtp["proj"],
                                       labels2, mask=mask2)
    return loss + aux_coef * aux


# ---------------------------------------------------------------- decode ---
def _cache_init_layer(cfg: ArchConfig, s: LayerSpec, batch: int,
                      max_seq: int, dtype, device) -> dict:
    if s.mixer == "mamba":
        state, tail = mamba2.mamba_state_init(cfg, batch, dtype, device)
        return {"state": state, "conv": tail}
    if s.mixer == "mla":
        return mla.mla_cache_init(cfg, batch, max_seq, dtype, device)
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_init(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Zero caches for ``batch`` lanes: ``max_seq`` positions of K/V per
    attention layer, of latent and rope key per MLA layer (a Mamba layer
    keeps no per-position entries)."""
    dev = resolve_device(device)
    prefix, period, n_rep = layer_plan(cfg)
    return {"prefix": [_cache_init_layer(cfg, s, batch, max_seq, dtype, dev)
                       for s in prefix],
            "stack": [{f"pos{j}": _cache_init_layer(cfg, s, batch, max_seq,
                                                    dtype, dev)
                       for j, s in enumerate(period)} for _ in range(n_rep)]}


def _attn_decode(p: Attn, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                 length: int, share=None):
    """One position's attention against the cache.  On a mesh
    (:func:`_attn_train`) ``cache`` holds the rank's KV heads where they
    are on ``model`` (the new rows of its heads are written there and
    attention reads only that block), else every KV head."""
    B = x.shape[0]
    pos = torch.full((B, 1), length, device=x.device)
    q = apply_rope(_q(p, x, share), pos, cfg.rope_theta)
    k, v = _kv(p, cfg, x, pos)
    cache = write_cache_rows(cache, length, {"k": k, "v": v})
    out = decode_attention(q, *_kv_for_q(cache["k"], cache["v"],
                                         cfg.n_heads, share), length + 1)
    return _attn_out(p, out, share), cache


def _apply_layer_decode(p: Layer, cfg: ArchConfig, s: LayerSpec, h, cache,
                        length, share=None):
    """One layer's decode step: (h after it, its new cache).  ``share``
    (a mesh rank's share of the layer, ``serve.decode``) holds ``cache``
    as the rank's blocks: an attention layer whose KV heads the plan puts
    on ``model`` attends its own heads in its block; any other layer's
    leaves are gathered whole, the layer runs on them and the rank keeps
    its block of each new leaf.  Attention and the FFN run
    tensor-parallel; MLA and Mamba mixers on their whole parameters."""
    gathered = share is not None and not share.kv_heads
    if gathered:
        cache = share.whole(cache)
    x = rmsnorm(h, p.ln1)
    if s.mixer == "mamba":
        mixed, (st, tail) = mamba2.mamba_decode(p.mamba, cfg, x,
                                                cache["state"], cache["conv"])
        cache = {"state": st, "conv": tail}
    elif s.mixer == "mla":
        mixed, cache = mla.mla_attention_decode(p.attn, cfg, x, cache,
                                                int(length))
    else:
        mixed, cache = _attn_decode(p.attn, cfg, x, cache, int(length),
                                    share)
    if gathered:
        cache = share.block(cache)
    return _ffn(p, cfg, s, h + mixed, share)[0], cache


def layer_shares(share, cfg: ArchConfig):
    """``share``'s per-layer shares as ``(prefix list, stack list of
    {"pos{j}": share})``, the cache's structure; Nones without a share."""
    if share is not None:
        return share.prefix, share.stack
    prefix, period, n_rep = layer_plan(cfg)
    return ([None] * len(prefix),
            [{f"pos{j}": None for j in range(len(period))}] * n_rep)


def decode_step(params: LM, cfg: ArchConfig, token, cache, length,
                embeds=None, share=None):
    """One decode step at position ``length`` (an int, the same for every
    lane).  token [B] int (or None with embeds [B, 1, d]); returns
    (logits [B,V] fp32, new_cache).  ``share``: a mesh rank's share of
    the step (``serve.decode``), which holds ``cache`` as its blocks."""
    prefix, period, _ = layer_plan(cfg)
    pre_share, stack_share = layer_shares(share, cfg)
    h = embed_inputs(params, cfg, None if token is None else token[:, None],
                     embeds, share)
    new_prefix = []
    for p, s, c, sh in zip(params.prefix, prefix, cache["prefix"],
                           pre_share):
        h, c = _apply_layer_decode(p, cfg, s, h, c, length, sh)
        new_prefix.append(c)
    new_stack = []
    for blk, blk_cache, blk_share in zip(params.stack, cache["stack"],
                                         stack_share):
        nc = {}
        for j, s in enumerate(period):
            key = f"pos{j}"
            h, nc[key] = _apply_layer_decode(blk[key], cfg, s, h,
                                             blk_cache[key], length,
                                             blk_share[key])
        new_stack.append(nc)
    return unembed(params, cfg, h[:, 0], share), {"prefix": new_prefix,
                                                  "stack": new_stack}


def prefill(params: LM, cfg: ArchConfig, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None, max_seq: int | None = None,
            share=None):
    """Prefill of tokens [B, S] or embeds [B, S, d]: full forward, caches
    populated for positions [0, S).

    Returns (last-position logits [B,V] fp32, cache); decode continues at
    length=S.  Attention and MLA caches are padded with zeros to
    ``max_seq`` positions (default S, which leaves decode no room);
    ``max_seq`` must be at least S.  A Mamba cache holds no per-position
    entries.  With ``share`` (a mesh rank's share, ``serve.decode``) the
    step is tensor-parallel and the cache returned is the rank's blocks:
    an attention layer whose KV heads the plan puts on ``model`` computes
    its own heads (:func:`_attn_train`), every other leaf is computed
    whole and cut.
    """
    prefix, period, _ = layer_plan(cfg)
    pre_share, stack_share = layer_shares(share, cfg)
    h = embed_inputs(params, cfg, tokens, embeds, share)
    B, S = h.shape[:2]
    max_seq = S if max_seq is None else max_seq
    if max_seq < S:
        raise ValueError(f"max_seq {max_seq} < prompt length {S}")

    def mix_with_cache(p: Layer, s: LayerSpec, h, sh):
        h, cache, _ = _layer_seq(p, cfg, s, h, sh)
        if s.mixer != "mamba":    # padded to max_seq positions
            cache = {k: torch.cat([a, a.new_zeros((B, max_seq - S)
                                                  + a.shape[2:])], dim=1)
                     for k, a in cache.items()}
        if sh is not None and not sh.kv_heads:
            cache = sh.block(cache)
        return h, cache

    new_prefix = []
    for p, s, sh in zip(params.prefix, prefix, pre_share):
        h, c = mix_with_cache(p, s, h, sh)
        new_prefix.append(c)
    new_stack = []
    for blk, blk_share in zip(params.stack, stack_share):
        caches = {}
        for j, s in enumerate(period):
            key = f"pos{j}"
            h, caches[key] = mix_with_cache(blk[key], s, h, blk_share[key])
        new_stack.append(caches)
    return unembed(params, cfg, h[:, -1], share), {"prefix": new_prefix,
                                                   "stack": new_stack}
