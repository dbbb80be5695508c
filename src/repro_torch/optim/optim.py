"""Optimizers: AdamW and momentum SGD, global-norm clipping, LR schedules
(port of ``repro.optim.optim``).

Functional ``(init, update)`` pairs over nested dicts, lists and tuples of
tensors; ``update(grads, state, params) -> (new_params, new_state)``
returns new tensors and changes none in place.  The arithmetic is the JAX
package's, op for op: ``b2 = 0.95`` by default, bias corrections
``1 - b ** step`` with ``step`` in float32, ``eps`` added after
``sqrt(vhat)``, weight decay added to the update direction before the
whole of it is scaled by the learning rate, and SGD's weight decay added
to the gradient.  ``torch.optim.AdamW`` differs on each of these, so it
is not used.

JAX's dtype rules are kept where they decide a rounding: a constant
learning rate is a weakly typed Python number, so a bf16 parameter's step
is taken in bf16 (the rate rounded to bf16 first); a scheduled rate is a
float32 array, so the step is taken in float32 and rounded to the
parameter's dtype once.  Divisions by a computed scalar divide by a 0-d
tensor on the operand's device (CUDA divides by a Python number through
its reciprocal).  AdamW's square root is the correctly rounded one, as
XLA's and CUDA's are (:func:`sqrt_rn`): torch's CPU kernel is an ulp off
for about 0.7 % of float32 inputs, which moves a bf16 parameter's step
where its direction sits on a rounding tie (its CUDA kernel is exact:
10^7 inputs on an H100 equal the float64 root rounded).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

F32 = torch.float32


def tree_leaves(tree) -> list:
    """The leaves of a dict / list / tuple tree in the JAX package's order
    (a dict's keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in
    :func:`tree_leaves`' order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of trees shaped like it."""
    out = [fn(*a) for a in zip(tree_leaves(tree),
                                *(tree_leaves(r) for r in rest))]
    return tree_unflatten(tree, out)


@dataclasses.dataclass
class OptState:
    step: torch.Tensor   # int32, 0-d
    mu: Any              # first moment (or momentum buffer for sgd)
    nu: Any              # second moment (0-d zeros for sgd)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(F32)))
    return torch.sqrt(total)


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that brings a global norm ``norm`` to at most
    ``max_norm``."""
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_leaf(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """One leaf times the clip factor, in its dtype promoted with float32,
    as JAX's product with the float32 scale does."""
    return g.to(torch.promote_types(g.dtype, F32)) * scale


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` to a global norm of at most ``max_norm``; returns
    (clipped, norm); each leaf by :func:`clip_leaf`."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: clip_leaf(g, scale), grads), norm


def _as_step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=F32)


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        step = _as_step(step)
        t = torch.clamp(step, max=total_steps) / _scalar(
            max(total_steps, 1), step)
        return base_lr * (min_frac + (1 - min_frac) * 0.5
                          * (1 + torch.cos(math.pi * t)))
    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def lr(step):
        step = _as_step(step)
        w = torch.clamp(step / _scalar(max(warmup, 1), step), max=1.0)
        return torch.where(step < warmup, base_lr * w, cos(step - warmup))
    return lr


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root: ``torch.sqrt`` on CUDA (IEEE's,
    nvcc's default) and for other dtypes than float32; a float32 tensor
    elsewhere is rooted in float64 and rounded once, which is exact (53 >=
    2 * 24 + 2 bits)."""
    if x.dtype != F32 or x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(F32)


def _take_step(p: torch.Tensor, lr_t, direction: torch.Tensor
               ) -> torch.Tensor:
    """``(p - lr_t * direction.astype(p.dtype)).astype(p.dtype)`` under
    JAX's promotion: a Python rate is weak (the step stays in p's dtype),
    a tensor rate is float32 (the step is taken in float32)."""
    d = direction.to(p.dtype)
    if isinstance(lr_t, torch.Tensor):
        return (p.to(F32) - lr_t * d.to(F32)).to(p.dtype)
    return p - _scalar(lr_t, p) * d


def _lr_fn(lr) -> Callable:
    return lr if callable(lr) else (lambda _: lr)


def adamw(lr: float | Callable = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          moment_dtype=torch.float32):
    """Returns (init_fn, update_fn).  update: (grads, state, params) ->
    (new_params, new_state)."""
    lr_fn = _lr_fn(lr)

    def init(params) -> OptState:
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                      device=p.device)
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return OptState(step=step, mu=tree_map(zeros, params),
                        nu=tree_map(zeros, params))

    def scalars(step: torch.Tensor) -> tuple:
        """The step's scalars from the state's step count: (step + 1,
        its bias corrections, its learning rate)."""
        step = step + 1
        stepf = step.to(F32)
        return step, 1 - b1 ** stepf, 1 - b2 ** stepf, lr_fn(stepf)

    def leaf(g, m, v, p, sc):
        """One leaf's (new param, new m, new v) at the scalars ``sc``."""
        _, bc1, bc2, lr_t = sc
        g32 = g.to(F32)
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * torch.square(g32)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (sqrt_rn(vhat) + eps) + weight_decay * p.to(F32)
        return _take_step(p, lr_t, delta), m, v

    def update(grads, state: OptState, params):
        sc = scalars(state.step)
        new_p, new_m, new_v = [], [], []
        for g, m, v, p in zip(*map(tree_leaves, (grads, state.mu, state.nu,
                                                  params))):
            p, m, v = leaf(g, m, v, p, sc)
            new_p.append(p)
            new_m.append(m)
            new_v.append(v)
        return tree_unflatten(params, new_p), OptState(
            step=sc[0], mu=tree_unflatten(state.mu, new_m),
            nu=tree_unflatten(state.nu, new_v))

    # the pieces of ``update``, for a caller that updates leaf by leaf
    # (train.loop): the scalars once a step, then ``leaf`` per leaf
    update.scalars, update.leaf = scalars, leaf
    return init, update


def sgd(lr: float | Callable = 1e-2, momentum: float = 0.9,
        weight_decay: float = 0.0):
    lr_fn = _lr_fn(lr)

    def init(params) -> OptState:
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return OptState(
            step=step,
            mu=tree_map(lambda p: torch.zeros_like(p, dtype=F32), params),
            nu=tree_map(lambda p: torch.zeros((), dtype=F32,
                                              device=p.device), params))

    def update(grads, state: OptState, params):
        step = state.step + 1
        lr_t = lr_fn(step.to(F32))
        new_p, new_m = [], []
        for g, m, p in zip(*map(tree_leaves, (grads, state.mu, params))):
            g32 = g.to(F32) + weight_decay * p.to(F32)
            m = momentum * m + g32
            new_p.append(_take_step(p, lr_t, m))
            new_m.append(m)
        return tree_unflatten(params, new_p), OptState(
            step=step, mu=tree_unflatten(state.mu, new_m), nu=state.nu)

    return init, update
