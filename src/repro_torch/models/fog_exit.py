"""FoG for LMs: confidence-gated layer-grove early exit (port of
``repro.models.fog_exit``).

The layer stack is split into ``cfg.fog_groups`` groves of consecutive
blocks.  After each grove the shared unembedding gives logits, and the
MaxDiff margin of their softmax (top-1 minus top-2 probability, the
paper's Algorithm 2 line 9) is compared with the lane's threshold; lanes
that clear it stop.  ``hops`` counts the groves each lane used.

A grove runs when any lane is live (one device sync per grove, where JAX
uses ``lax.cond``); exited lanes keep their hidden state, logits and cache
through a masked select (an attention layer's decode writes its K/V row
into a new tensor, so the old cache the mask selects is untouched: an
exited lane's row at this position stays as it was, zeros from the
prefill's padding).  When no lane is live the grove takes JAX's skip
branch, CALM-style: each layer's cache is filled from the unchanged hidden
state (K/V projections for attention, the latent and rope key for MLA,
the full ``mamba_decode`` for a Mamba layer), and the mask then keeps
every lane's old cache, since no lane is live, so that fill is discarded
as in JAX (ROADMAP §C).

On a mesh (``share``, ``serve.decode``) a rank holds only its lanes and
runs the layers tensor-parallel over ``model`` (``models.transformer``),
and the skip is JAX's ``lax.cond`` on the whole batch: the rank's
``live.any()`` is reduced over the dp ranks
(``serve.decode.MeshShare.any_live``), so every rank takes the same
branch and the collectives of the layers stay matched.  Where the rank
holds its block of the vocabulary's logits ``[B_r, V / M]``, no rank
builds a whole row: the softmax takes the row's max and exp-sum reduced
over ``model``, and the margin comes from the top-2 partials of the
rank's block of probabilities (``core.engine.confidence_partials``: the
``top2_confidence`` kernel's partials entry) gathered over ``model`` in
rank order and merged (``merged_margin``: its merge entry).  The max is
exact and the sum and the merge are computed alike on every rank from the
same gathered values, so ``live`` and ``hops`` are bit-identical across
the ``model`` ranks, as the collectives of the next grove need.  The
masks on the cache, the hidden state, the logits and the hops stay per
lane, on the rank's lanes.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, param_count
from repro_torch.core.energy import E_FP32_MAC, E_SRAM_R32, AffineEnergy
from repro_torch.core.engine import (confidence_margin, confidence_partials,
                                     merged_margin)
from repro_torch.core.policy import FogPolicy, margin_backend
from repro_torch.models import mamba2, mla
from repro_torch.models import transformer as T
from repro_torch.models.layers import rmsnorm, write_cache_rows


def grove_boundaries(cfg: ArchConfig) -> list[int]:
    """Split the stack's n_repeat blocks into fog_groups groves: sizes."""
    _, _, n_rep = T.layer_plan(cfg)
    g = max(1, min(cfg.fog_groups, n_rep))
    base, extra = divmod(n_rep, g)
    return [base + (1 if i < extra else 0) for i in range(g)]


def lm_hop_energy(cfg: ArchConfig) -> AffineEnergy:
    """Price one layer-grove hop: the grove's share of the active per-token
    MACs at the shared per-op energies (a FLOP-proportional proxy)."""
    _, active = param_count(cfg)
    per_grove_macs = active / max(1, len(grove_boundaries(cfg)))
    return AffineEnergy(per_hop_pj=per_grove_macs * (E_FP32_MAC + E_SRAM_R32))


def _mask_cache(new, old, live: torch.Tensor):
    """Per-lane cache select over a layer cache's tensors ([B, ...])."""
    if isinstance(new, dict):
        return {k: _mask_cache(new[k], old[k], live) for k in new}
    if isinstance(new, (tuple, list)):
        return type(new)(_mask_cache(n, o, live) for n, o in zip(new, old))
    mask = live.reshape((-1,) + (1,) * (new.ndim - 1))
    return torch.where(mask, new, old)


def _kv_only_update(p: T.Layer, cfg: ArchConfig, s: T.LayerSpec, h, cache,
                    length, share=None):
    """Fill a skipped layer's cache from the propagated hidden state
    (projections only: K/V, or the MLA latent and rope key).  ``share``
    as in ``transformer._apply_layer_decode``: the rank's heads' rows
    (from its ``wk``/``wv`` columns) written into its block, or the
    leaves gathered whole and cut."""
    if share is not None and not share.kv_heads:
        return share.block(_kv_fill(p, cfg, s, h, share.whole(cache),
                                    length))
    return _kv_fill(p, cfg, s, h, cache, length)


def _kv_fill(p: T.Layer, cfg: ArchConfig, s: T.LayerSpec, h, cache,
             length):
    x = rmsnorm(h, p.ln1)
    if s.mixer == "mamba":
        # the recurrent state advance is the cheap part of a Mamba layer:
        # the full decode-state update, its output discarded
        _, (st, tail) = mamba2.mamba_decode(p.mamba, cfg, x, cache["state"],
                                            cache["conv"])
        return {"state": st, "conv": tail}
    length = int(length)
    if s.mixer == "mla":
        return mla.mla_kv_update(p.attn, cfg, x, cache, length)
    pos = torch.full((x.shape[0], 1), length, device=x.device)
    k, v = T._kv(p.attn, cfg, x, pos)
    return write_cache_rows(cache, length, {"k": k, "v": v})


def _gate_margin(logits: torch.Tensor, backend: str, share=None):
    """The MaxDiff margin of the softmax of each lane's logits: of the
    whole row, or on a mesh rank that holds its vocabulary block (the
    module docstring) from the block's partials merged over ``model``."""
    if share is None or not share.vocab_block:
        return confidence_margin(torch.softmax(logits, dim=-1),
                                 backend=backend)
    tp = share.tp
    e = torch.exp(logits - tp.max(logits.amax(-1))[:, None])
    probs = e / tp.sum(e.sum(-1))[:, None]
    parts = confidence_partials(probs, tp.m * logits.shape[-1],
                                backend=backend)
    return merged_margin(tp.gather(parts, -1), backend=backend)


def decode_step_fog(params: T.LM, cfg: ArchConfig, token, cache, length,
                    thresh, embeds=None, *, backend: str = "reference",
                    share=None):
    """FoG decode step from token [B] (or None with embeds [B, 1, d]).
    Returns (logits [B,V], new_cache, hops [B] int32).

    ``thresh`` is a :class:`FogPolicy` (per-lane ``[B]`` thresholds and hop
    budgets serve mixed-QoS batches) or a bare scalar / ``[B]`` threshold.
    A lane whose hop budget is spent exits even while unconfident.
    ``backend`` picks the margin ("reference" or the "pallas" top-2
    kernel); a policy's ``backend`` knob overrides it.  ``share``: a mesh
    rank's share of the step (``serve.decode``; the module docstring).
    """
    prefix, period, _ = T.layer_plan(cfg)
    pre_share, stack_share = T.layer_shares(share, cfg)
    sizes = grove_boundaries(cfg)
    B = token.shape[0] if token is not None else embeds.shape[0]
    policy = thresh if isinstance(thresh, FogPolicy) else FogPolicy(
        threshold=thresh)
    if policy.backend is not None:
        backend = margin_backend(policy.backend)
    dev = params.embed.device
    thresh = policy.lane_thresholds(B, device=dev)
    budget = (policy.lane_budgets(B, device=dev)
              if policy.hop_budget is not None else None)
    h = T.embed_inputs(params, cfg,
                       None if token is None else token[:, None], embeds,
                       share)

    new_prefix = []
    for p, s, c, sh in zip(params.prefix, prefix, cache["prefix"],
                           pre_share):
        h, c = T._apply_layer_decode(p, cfg, s, h, c, length, sh)
        new_prefix.append(c)

    live = torch.ones((B,), dtype=torch.bool, device=dev)
    hops = torch.zeros((B,), dtype=torch.int32, device=dev)
    logits = None
    new_stack = []
    start = 0
    for g, size in enumerate(sizes):
        blocks = zip(params.stack[start:start + size],
                     cache["stack"][start:start + size],
                     stack_share[start:start + size])
        run = bool(live.any() if share is None else share.any_live(live))
        h_new, grove_cache = h, []
        for bp, bc, bs in blocks:
            nc = {}
            for j, s in enumerate(period):
                key = f"pos{j}"
                if run:
                    h_new, nc[key] = T._apply_layer_decode(
                        bp[key], cfg, s, h_new, bc[key], length, bs[key])
                else:
                    nc[key] = _kv_only_update(bp[key], cfg, s, h, bc[key],
                                              length, bs[key])
            grove_cache.append(_mask_cache(nc, bc, live))
        new_stack.extend(grove_cache)
        # masked select per lane: exited lanes keep their old hidden state
        h = torch.where(live[:, None, None], h_new, h)
        hops = hops + live.to(torch.int32)

        g_logits = T.unembed(params, cfg, h[:, 0], share)
        # every lane is live at the first grove
        logits = (g_logits if logits is None
                  else torch.where(live[:, None], g_logits, logits))
        if g < len(sizes) - 1:
            live = live & (_gate_margin(g_logits, backend, share) < thresh)
            if budget is not None:   # per-lane energy cap
                live = live & (hops < budget)
        start += size
    return logits, {"prefix": new_prefix, "stack": new_stack}, hops


def fog_flops_per_token(cfg: ArchConfig, mean_hops: float) -> float:
    """Modeled decode FLOPs per token under FoG (hops x grove cost)."""
    _, active = param_count(cfg)
    frac = mean_hops / max(1, min(cfg.fog_groups, T.layer_plan(cfg)[2]))
    return 2.0 * active * frac
