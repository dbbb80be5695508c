"""The LM train step on one device (port of ``repro.train.loop``).

``make_train_step(cfg, ...)`` returns ``(train_step, init_opt)``.  A step
is JAX's body op for op: the value and gradient of
``transformer.lm_loss(remat=True)``, ``clip_by_global_norm``, optionally
``ef_compress_grads(grads, None)`` (the int8 wire format of cross-pod
gradients, its residual recomputed each step as JAX's is; one scale per
JAX leaf, so over a period position's stacked repeats), then AdamW
(``b1 = 0.9, b2 = 0.95, weight_decay = 0.1``) at ``linear_warmup_cosine``
-- all from the port's ``optim``.  Products run in full float32 (TF32
off), so that fp32 is fp32 on the card.

``params`` is the port's model (``transformer.LM``); the step turns
gradients on for its parameters and replaces each one's tensor with the
updated one (tensors taken from the model before the step keep their
values).  The optimizer state keys its moments by parameter name
(``dict(params.named_parameters())``), which ``models.carry`` maps to
JAX's layout for checkpoints.

JAX's mesh, shardings and buffer donation have no counterpart on one
card; ``SHAPES``, ``input_specs``, ``shape_supported`` and
``make_train_step_lowerable`` (gradient accumulation) are the dry-run
tools, not ported (ROADMAP A6).  Mamba layers have no backward yet: a
config whose layer plan holds one is refused on every device (ROADMAP
A5b).
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.baselines.train import fp32_products
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.optim import (OptState, adamw, clip_by_global_norm,
                               ef_compress_grads, linear_warmup_cosine)


def check_trainable(cfg: ArchConfig) -> None:
    """Raise for a config the port cannot train: Mamba layers (their
    ``ssd_chunk`` kernel has no backward yet)."""
    prefix, period, _ = T.layer_plan(cfg)
    if any(s.mixer == "mamba" for s in prefix + period):
        raise NotImplementedError(
            f"{cfg.name} has Mamba layers: Mamba training waits for a "
            f"backward of the ssd_chunk kernel (ROADMAP A5b)")


def trainable(params: T.LM) -> dict[str, torch.nn.Parameter]:
    """The model's parameters by name, each turned to require grad."""
    named = dict(params.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    return named


def loss_and_grads(params: T.LM, cfg: ArchConfig, batch: dict
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """``lm_loss(remat=True)`` of ``batch`` (``tokens`` or ``embeds``, and
    ``labels``) and its gradient by parameter name (zeros for a parameter
    the loss does not reach, as ``jax.grad`` gives), products in fp32."""
    check_trainable(cfg)
    named = trainable(params)
    dev = next(iter(named.values())).device
    batch = {k: v.to(dev) for k, v in batch.items()}
    with fp32_products():
        loss = T.lm_loss(params, cfg, tokens=batch.get("tokens"),
                         labels=batch["labels"], embeds=batch.get("embeds"),
                         remat=True)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(named.items(), grads)}


def compress_like_jax(grads: dict[str, torch.Tensor]
                      ) -> dict[str, torch.Tensor]:
    """``ef_compress_grads(grads, None)`` over JAX's leaves: each period
    position's gradients stacked over the repeats
    (``stack.{r}.pos{j}.…``) share one int8 scale, as JAX's stacked leaf
    does."""
    groups: dict[str, list[str]] = {}
    for name in grads:
        parts = name.split(".")
        key = ".".join(parts[:1] + parts[2:]) if parts[0] == "stack" else name
        groups.setdefault(key, []).append(name)
    out, _ = ef_compress_grads(
        {key: torch.stack([grads[n] for n in names])
         for key, names in groups.items()}, None)
    return {n: out[key][r] for key, names in groups.items()
            for r, n in enumerate(names)}


def make_train_step(cfg: ArchConfig, *, lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, clip_norm: float = 1.0,
                    compress_pod_grads: bool = False, device=None):
    """Returns ``(train_step, init_opt)``.

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics ``{"loss", "grad_norm", "step"}``;
    ``init_opt(params) -> OptState``.  ``device`` (default: the card) is
    where the step runs; the model and the state must live there."""
    check_trainable(cfg)
    dev = resolve_device(device)
    init, update = adamw(lr=linear_warmup_cosine(lr, warmup, total_steps),
                         b1=0.9, b2=0.95, weight_decay=0.1)

    def init_opt(params: T.LM) -> OptState:
        return init({k: p.detach() for k, p in params.named_parameters()})

    def train_step(params: T.LM, opt_state: OptState, batch: dict):
        named = dict(params.named_parameters())
        if next(iter(named.values())).device.type != dev.type:
            raise ValueError(f"the model is not on {dev}")
        loss, grads = loss_and_grads(params, cfg, batch)
        with torch.no_grad(), fp32_products():
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            if compress_pod_grads:
                grads = compress_like_jax(grads)
            new, opt_state = update(
                grads, opt_state, {k: p.detach() for k, p in named.items()})
            for k, p in named.items():
                p.data = new[k]
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "step": opt_state.step}

    return train_step, init_opt
