"""Serving steps: prefill, decode and FoG early-exit decode (port of
``repro.serve.decode``).

The JAX package builds jitted, sharded programs for a mesh and reads the
batch and sequence length from the training loop's ``SHAPES`` table.  On
one card a ``device`` takes the place of the mesh and the batch and
lengths are given directly.  Each factory returns ``(fn, inputs)``:
``inputs`` maps every per-call input to its ``(shape, dtype)``, and ``fn``
keeps JAX's contract::

    prefill:  fn(params, tokens [B, S]) -> (logits [B, V], cache)
    decode:   fn(params, cache, token [B], length) -> (logits, cache)
    FoG:      fn(params, cache, token [B], length, thresh [B], budget [B])
              -> (logits, cache, hops [B])

``params`` comes from ``models.transformer.init_params`` or
``models.carry.params_from_jax``, the cache from the prefill (or
``models.transformer.cache_init``).  Configs whose layers are attention
with dense FFNs or Mamba-2 build; MLA, MoE and hybrid periods raise
(``check_ported``).  An attention cache holds ``max_seq`` positions, so a
prefill that decode continues takes the decode steps' ``max_seq``.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import FogPolicy, margin_backend
from repro_torch.models import transformer as T
from repro_torch.models.fog_exit import decode_step_fog


def _check_input(name: str, t: torch.Tensor, shape: tuple,
                 device: torch.device) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if t.device.type != device.type:
        raise ValueError(f"{name} is on {t.device}, the step runs on "
                         f"{device}")


def make_serve_step(cfg: ArchConfig, device=None, *, batch: int,
                    max_seq: int, fog: bool = False,
                    policy: FogPolicy | None = None):
    """One-token decode for ``batch`` lanes on ``device`` (default: the
    card), at lengths below ``max_seq``.

    With ``fog=True`` the step takes the per-lane knobs as tensors,
    ``fn(params, cache, token, length, thresh [B], budget [B])``, so one
    step serves mixed-QoS traffic.  ``policy`` supplies the static knobs
    (the gate's backend; default the plain margin).  JAX's legacy
    ``fog_thresh`` / ``fog_backend`` keywords are not ported: the
    threshold comes with every call and the backend with the policy.
    """
    T.check_ported(cfg)
    dev = resolve_device(device)
    policy = FogPolicy() if policy is None else policy
    gate_backend = margin_backend(policy.backend)
    inputs = {"token": ((batch,), torch.int32)}

    def check(token, length):
        _check_input("token", token, (batch,), dev)
        if not 0 <= int(length) < max_seq:
            raise ValueError(f"length {int(length)} outside the cache's "
                             f"[0, {max_seq})")

    if fog:
        inputs["fog_thresh"] = ((batch,), torch.float32)
        inputs["fog_budget"] = ((batch,), torch.int32)

        @torch.no_grad()
        def step(params, cache, token, length, thresh, budget):
            check(token, length)
            _check_input("thresh", thresh, (batch,), dev)
            _check_input("budget", budget, (batch,), dev)
            lane_policy = policy.replace(threshold=thresh, hop_budget=budget)
            return decode_step_fog(params, cfg, token, cache, length,
                                   lane_policy, backend=gate_backend)
    else:
        @torch.no_grad()
        def step(params, cache, token, length):
            check(token, length)
            return T.decode_step(params, cfg, token, cache, length)
    return step, inputs


def make_prefill_step(cfg: ArchConfig, device=None, *, batch: int,
                      seq_len: int, max_seq: int | None = None):
    """Prefill of ``batch`` prompts of ``seq_len`` tokens on ``device``
    (default: the card): ``fn(params, tokens) -> (logits [B, V], cache)``,
    decode continuing at ``length=seq_len``.  Attention caches are padded
    to ``max_seq`` positions (default ``seq_len``): give the decode steps'
    ``max_seq`` to decode after the prompt."""
    T.check_ported(cfg)
    dev = resolve_device(device)
    inputs = {"tokens": ((batch, seq_len), torch.int32)}

    @torch.no_grad()
    def step(params, tokens):
        _check_input("tokens", tokens, (batch, seq_len), dev)
        return T.prefill(params, cfg, tokens=tokens, max_seq=max_seq)
    return step, inputs
