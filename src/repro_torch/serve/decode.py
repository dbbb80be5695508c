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

For the audio and VLM configs (``cfg.frontend``) the steps take the front
end's embeddings in place of token ids, as JAX's do: ``embeds [B, S, d]``
for the prefill and ``embeds [B, 1, d]`` for a decode step, in
``param_dtype``, under the ``inputs`` key ``"embeds"``.  Every input is
checked for its shape, dtype and device before the step runs.

``params`` comes from ``models.transformer.init_params`` or
``models.carry.params_from_jax``, the cache from the prefill (or
``models.transformer.cache_init``); every assigned config builds
(attention, MLA, Mamba-2 and hybrid mixers, dense and MoE FFNs).  An
attention or MLA cache holds ``max_seq`` positions, so a prefill that
decode continues takes the decode steps' ``max_seq``.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import FogPolicy, margin_backend
from repro_torch.models import transformer as T
from repro_torch.models.fog_exit import decode_step_fog


def _check_input(name: str, t: torch.Tensor, spec: tuple,
                 device: torch.device) -> None:
    """Raise unless ``t`` has the ``(shape, dtype)`` of ``spec`` and lies
    on ``device``."""
    shape, dtype = spec
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device.type != device.type:
        raise ValueError(f"{name} is on {t.device}, the step runs on "
                         f"{device}")


def make_serve_step(cfg: ArchConfig, device=None, *, batch: int,
                    max_seq: int, fog: bool = False,
                    policy: FogPolicy | None = None,
                    param_dtype: torch.dtype = torch.bfloat16):
    """One-token decode for ``batch`` lanes on ``device`` (default: the
    card), at lengths below ``max_seq``.

    With ``fog=True`` the step takes the per-lane knobs as tensors,
    ``fn(params, cache, token, length, thresh [B], budget [B])``, so one
    step serves mixed-QoS traffic.  ``policy`` supplies the static knobs
    (the gate's backend; default the plain margin).  JAX's legacy
    ``fog_thresh`` / ``fog_backend`` keywords are not ported: the
    threshold comes with every call and the backend with the policy.
    For ``cfg.frontend`` the step takes ``embeds [B, 1, d]`` (in
    ``param_dtype``) in place of ``token``.
    """
    dev = resolve_device(device)
    policy = FogPolicy() if policy is None else policy
    gate_backend = margin_backend(policy.backend)
    key = "embeds" if cfg.frontend else "token"
    inputs = {key: ((batch, 1, cfg.d_model), param_dtype) if cfg.frontend
              else ((batch,), torch.int32)}

    def split(x, length):
        """(token, embeds) from the step's input, once it is checked."""
        _check_input(key, x, inputs[key], dev)
        if not 0 <= int(length) < max_seq:
            raise ValueError(f"length {int(length)} outside the cache's "
                             f"[0, {max_seq})")
        return (None, x) if cfg.frontend else (x, None)

    if fog:
        inputs["fog_thresh"] = ((batch,), torch.float32)
        inputs["fog_budget"] = ((batch,), torch.int32)

        @torch.no_grad()
        def step(params, cache, x, length, thresh, budget):
            token, embeds = split(x, length)
            _check_input("thresh", thresh, inputs["fog_thresh"], dev)
            _check_input("budget", budget, inputs["fog_budget"], dev)
            lane_policy = policy.replace(threshold=thresh, hop_budget=budget)
            return decode_step_fog(params, cfg, token, cache, length,
                                   lane_policy, embeds=embeds,
                                   backend=gate_backend)
    else:
        @torch.no_grad()
        def step(params, cache, x, length):
            token, embeds = split(x, length)
            return T.decode_step(params, cfg, token, cache, length,
                                 embeds=embeds)
    return step, inputs


def make_prefill_step(cfg: ArchConfig, device=None, *, batch: int,
                      seq_len: int, max_seq: int | None = None,
                      param_dtype: torch.dtype = torch.bfloat16):
    """Prefill of ``batch`` prompts of ``seq_len`` tokens on ``device``
    (default: the card): ``fn(params, tokens) -> (logits [B, V], cache)``,
    decode continuing at ``length=seq_len``.  Attention caches are padded
    to ``max_seq`` positions (default ``seq_len``): give the decode steps'
    ``max_seq`` to decode after the prompt.  For ``cfg.frontend`` the step
    takes ``embeds [B, S, d]`` (in ``param_dtype``) in place of tokens."""
    dev = resolve_device(device)
    key = "embeds" if cfg.frontend else "tokens"
    inputs = {key: ((batch, seq_len, cfg.d_model), param_dtype)
              if cfg.frontend else ((batch, seq_len), torch.int32)}

    @torch.no_grad()
    def step(params, x):
        _check_input(key, x, inputs[key], dev)
        return T.prefill(params, cfg, max_seq=max_seq, **{key: x})
    return step, inputs
