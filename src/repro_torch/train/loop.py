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

A bf16 model trains as JAX's bf16 step does (``make_train_step`` is
given a model whose parameters are bf16; nothing else changes): the
gradients come out bf16, ``clip_leaf`` multiplies each by the fp32 clip
factor and so promotes it to fp32, the moments are fp32
(``adamw(moment_dtype=torch.float32)``), and each update is taken in
fp32 and rounded to bf16 once, where JAX's ``adamw`` rounds it
(``repro/optim/optim.py``: ``(p - lr_t * delta.astype(p.dtype))
.astype(p.dtype)`` with a scheduled, so fp32, rate).

``params`` is the port's model (``transformer.LM``); the step turns
gradients on for its parameters and replaces each one's tensor with the
updated one (tensors taken from the model before the step keep their
values).  The optimizer state keys its moments by parameter name
(``dict(params.named_parameters())``), which ``models.carry`` maps to
JAX's layout for checkpoints.

The update frees as it goes, the one-card counterpart of JAX's
``donate_argnums=(0, 1)``: the global norm is taken over every gradient
first, then clip, the optional compression and AdamW (the per-leaf
arithmetic of the port's ``optim.adamw`` ``update``) run leaf by leaf,
and each leaf's gradient, old parameter tensor and old moments are
released before the next leaf is done.  So the step holds the
parameters, their gradients and two moments (16 bytes a parameter in
fp32, 12 in bf16: 2 + 2 + 4 + 4) and one leaf's temporaries (fp32),
never a second tree of any of them.
The optimizer state passed in is consumed: its moment dicts are updated
in place and returned.  The numbers are those of the whole-tree update
bit for bit (compression takes its int8 scale per JAX leaf, so a period
position's stacked repeats are done together).

Attention trains through ``ops.FlashAttention`` (on the card the
tensor-core backward ``csrc/flash_attention_bwd_sm90.cu`` for bf16 at
head sizes 64 and 128, ``csrc/flash_attention_bwd.cu`` otherwise), Mamba
layers through ``ops.SsdChunk`` (``csrc/ssd_chunk_bwd.cu``).  The
backward kernels take fp32 and bf16: an fp16 model is refused
(:func:`check_trainable`).

Gradient accumulation (``make_train_step(..., accum_steps=k)``) is JAX's
``make_train_step_lowerable``'s arithmetic on one card: the batch is
reshaped to ``[k, B / k, ...]`` and the microbatches run in order, their
losses summed from a float32 zero and their gradients added into one
float32 tree beside the parameters (a bf16 gradient promoted by the add,
as JAX's ``grad_acc + g``), each microbatch's gradients freed as they
are added; both are then multiplied by ``1 / k`` and go through the same
update.  So the step holds one float32 tree more than without it, and
one microbatch's activations.  ``k`` must divide the batch.

``SHAPES``, ``input_specs`` and ``shape_supported`` are JAX's cells of
(arch x shape); ``launch.dryrun`` reads them.  JAX's mesh and shardings
have no counterpart on one card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import resolve_device
from repro_torch.baselines.train import fp32_products
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.optim import (OptState, adamw, clip_leaf, clip_scale,
                               ef_compress_grads, global_norm,
                               linear_warmup_cosine)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def input_specs(cfg: ArchConfig, shape: str | ShapeSpec,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Every model input of a cell (a ``SHAPES`` name, or a
    :class:`ShapeSpec`) as ``{name: (shape, dtype)}`` (the convention of
    ``serve.decode``'s ``inputs``); nothing is allocated.  ``embeds`` take
    the place of token ids for ``cfg.frontend``; a decode cell's
    ``length`` is a scalar."""
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    B, S = sp.global_batch, sp.seq_len
    i32 = torch.int32
    if sp.kind == "train":
        if cfg.frontend:
            return {"embeds": ((B, S, cfg.d_model), dtype),
                    "labels": ((B, S), i32)}
        return {"tokens": ((B, S), i32), "labels": ((B, S), i32)}
    if sp.kind == "prefill":
        if cfg.frontend:
            return {"embeds": ((B, S, cfg.d_model), dtype)}
        return {"tokens": ((B, S), i32)}
    # decode: one new token against a seq_len cache
    if cfg.frontend:
        return {"embeds": ((B, 1, cfg.d_model), dtype), "length": ((), i32)}
    return {"token": ((B,), i32), "length": ((), i32)}


def shape_supported(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs (``cfg.long_context``); the
    reason is JAX's, word for word."""
    if shape == "long_500k" and not cfg.long_context:
        return False, ("full-attention arch: 512k-token decode cell skipped "
                       "by design (see DESIGN.md §5)")
    return True, ""


def check_trainable(cfg: ArchConfig, dtype: torch.dtype = torch.float32
                    ) -> None:
    """Raise for what the port cannot train: parameters in a dtype the
    backward kernels do not take (fp16), since every config's mixers run
    ``flash_attention`` or ``ssd_chunk``, whose backward kernels take fp32
    and bf16.  (float64 runs on the CPU's plain versions.)"""
    if dtype in (torch.float32, torch.bfloat16, torch.float64):
        return
    prefix, period, _ = T.layer_plan(cfg)
    mixers = sorted({s.mixer for s in prefix + period})
    raise NotImplementedError(
        f"{cfg.name} in {dtype}: its {'/'.join(mixers)} layers' backward "
        f"kernels (flash_attention, ssd_chunk) take fp32 or bf16, not "
        f"{dtype}")


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
    named = trainable(params)
    check_trainable(cfg, next(iter(named.values())).dtype)
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


def microbatches(batch: dict, accum_steps: int) -> dict:
    """``batch`` reshaped to ``[accum_steps, B / accum_steps, ...]`` (views);
    raises unless ``accum_steps`` divides the batch."""
    n = next(iter(batch.values())).shape[0]
    if accum_steps < 1 or n % accum_steps:
        raise ValueError(f"accum_steps={accum_steps} does not divide the "
                         f"batch of {n}")
    return {k: v.reshape(accum_steps, n // accum_steps, *v.shape[1:])
            for k, v in batch.items()}


def accumulated_grads(params: T.LM, cfg: ArchConfig, batch: dict,
                      accum_steps: int
                      ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The loss and gradients of ``batch`` over ``accum_steps``
    microbatches (the module docstring): ``loss_and_grads`` of each
    ``[B / k]`` slice in order, the losses summed from a float32 zero and
    the gradients added into one float32 tree, each microbatch's popped as
    it is added; both times ``1 / k``.  ``accum_steps=1`` is
    ``loss_and_grads`` of the whole batch."""
    micro = microbatches(batch, accum_steps)
    if accum_steps == 1:
        return loss_and_grads(params, cfg, batch)
    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
           for k, p in named.items()}
    for i in range(accum_steps):
        l, grads = loss_and_grads(params, cfg,
                                  {k: v[i] for k, v in micro.items()})
        loss = loss + l
        for k in named:
            acc[k].add_(grads.pop(k))
        del grads
    inv = 1.0 / accum_steps
    with torch.no_grad():
        for a in acc.values():
            a.mul_(inv)
    return loss * inv, acc


def jax_leaves(names) -> dict[str, list[str]]:
    """Parameter names grouped by JAX leaf: each period position's
    parameters stacked over the repeats (``stack.{r}.pos{j}.…``) are one
    leaf of JAX's tree (compression scales it as one), every other
    parameter a leaf of its own."""
    groups: dict[str, list[str]] = {}
    for name in names:
        parts = name.split(".")
        key = ".".join(parts[:1] + parts[2:]) if parts[0] == "stack" else name
        groups.setdefault(key, []).append(name)
    return groups


def apply_update(named: dict[str, torch.nn.Parameter],
                 grads: dict[str, torch.Tensor], opt_state: OptState,
                 update, *, clip_norm: float = 1.0,
                 compress: bool = False) -> torch.Tensor:
    """The step's update, freeing as it goes (the module docstring): the
    global norm over ``grads``, the step's scalars once, then leaf by leaf
    (or JAX leaf by JAX leaf, with ``compress``) clip, compression and
    ``update.leaf`` (an ``optim.adamw`` update's per-leaf arithmetic),
    each new tensor put in its parameter's and moments' place and each
    gradient popped from ``grads``.  Advances ``opt_state.step`` and
    returns the global norm."""
    with torch.no_grad(), fp32_products():
        gnorm = global_norm(grads)
        scale = clip_scale(gnorm, clip_norm)
        sc = update.scalars(opt_state.step)
        mu, nu = opt_state.mu, opt_state.nu
        for names in (jax_leaves(named).values() if compress
                      else ([k] for k in named)):
            g = [clip_leaf(grads.pop(k), scale) for k in names]
            if compress:
                # ef_compress_grads(grads, None) with one int8 scale per
                # JAX leaf, as JAX's stacked leaf has
                g = ef_compress_grads(torch.stack(g), None)[0].unbind()
            for k, gk in zip(names, g):
                named[k].data, mu[k], nu[k] = update.leaf(
                    gk, mu[k], nu[k], named[k].detach(), sc)
            del g, gk
        opt_state.step = sc[0]
    return gnorm


def make_train_step(cfg: ArchConfig, *, lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, clip_norm: float = 1.0,
                    compress_pod_grads: bool = False, device=None,
                    accum_steps: int = 1):
    """Returns ``(train_step, init_opt)``.

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics ``{"loss", "grad_norm", "step"}``;
    ``init_opt(params) -> OptState``.  ``device`` (default: the card) is
    where the step runs; the model and the state must live there.  The
    step consumes ``opt_state`` (see the module docstring).
    ``accum_steps`` microbatches make one step (:func:`accumulated_grads`;
    it must divide the batch)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be at least 1, got {accum_steps}")
    dev = resolve_device(device)
    init, update = adamw(lr=linear_warmup_cosine(lr, warmup, total_steps),
                         b1=0.9, b2=0.95, weight_decay=0.1)

    def init_opt(params: T.LM) -> OptState:
        return init({k: p.detach() for k, p in params.named_parameters()})

    def train_step(params: T.LM, opt_state: OptState, batch: dict):
        named = dict(params.named_parameters())
        if next(iter(named.values())).device.type != dev.type:
            raise ValueError(f"the model is not on {dev}")
        loss, grads = accumulated_grads(params, cfg, batch, accum_steps)
        gnorm = apply_update(named, grads, opt_state, update,
                             clip_norm=clip_norm,
                             compress=compress_pod_grads)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "step": opt_state.step}

    return train_step, init_opt
