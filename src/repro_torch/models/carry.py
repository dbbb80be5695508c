"""Carry the JAX package's parameters, caches and optimizer state into
the port, and the port's parameters and optimizer state back.

The JAX side is its pytree as numpy arrays (``jax.tree.map(np.asarray,
tree)``): bf16 leaves arrive as numpy's ``bfloat16`` extension dtype and
are moved bit for bit.  The JAX tree stacks each period position on a
leading ``[n_repeat]`` axis (``stack``, from ``jax.vmap`` of the layer
init, or from the decode ``lax.scan``); the port splits that axis into
one block per repeat, and :func:`params_to_jax` stacks it again.  The
port's optimizer state keys its moments by the model's parameter names
(``dict(lm.named_parameters())``: ``"stack.3.pos0.attn.wq"``), which
:func:`tree_to_named` and :func:`named_to_tree` map to and from JAX's
layout.  Training checkpoints (``train/checkpoint.py``) are written in
JAX's layout, so that either package restores what the other wrote; they
hold a bf16 leaf as 2-byte void elements of the same bits (:func:`to_host`),
as numpy stores JAX's, so that neither writing nor reading one needs
``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import mamba2, mla, moe
from repro_torch.models.transformer import FFN, LM, Attn, Layer, layer_plan
from repro_torch.optim import OptState


# how a checkpoint holds a bf16 leaf: 2-byte void elements of its bits
BF16_BITS = np.dtype("V2")


def to_tensor(a, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``; numpy's ``bfloat16`` and
    2-byte void elements (:data:`BF16_BITS`, a checkpoint's bf16 leaf)
    become bf16 bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == BF16_BITS:
        bits = torch.from_numpy(np.array(a.view(np.uint16)))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _index(tree, r: int):
    """Leaf ``[r]`` of every array in a dict/tuple/list tree."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_index(v, r) for v in tree)
    return np.asarray(tree)[r]


def _layer(tree: dict, device) -> Layer:
    def t(a):
        return to_tensor(a, device)

    kw = {}
    if "mamba" in tree:
        kw["mamba"] = mamba2.Mamba({k: t(tree["mamba"][k])
                                    for k in mamba2.PARAM_NAMES})
    elif "w_dq" in tree["attn"]:
        kw["attn"] = mla.MLA({k: t(tree["attn"][k])
                              for k in mla.PARAM_NAMES})
    else:
        a = tree["attn"]
        kw["attn"] = Attn(t(a["wq"]), t(a["wk"]), t(a["wv"]), t(a["wo"]))
    if "ffn" in tree:
        f = tree["ffn"]
        kw["ln2"] = t(tree["ln2"])
        if "router" in f:
            shared = None
            if "shared" in f:
                shared = moe.SharedExpert(*(t(f["shared"][k]) for k in (
                    "w_gate", "w_up", "w_down")))
            kw["ffn"] = moe.MoE(t(f["router"]), t(f["w_gate"]),
                                t(f["w_up"]), t(f["w_down"]), shared)
        else:
            kw["ffn"] = FFN(t(f["w_gate"]),
                            t(f["w_up"]) if "w_up" in f else None,
                            t(f["w_down"]))
    return Layer(t(tree["ln1"]), **kw)


def _n_repeat(tree: dict) -> int:
    """The stack's leading axis in a JAX tree (0 when it has no stack)."""
    stack = tree.get("stack") or {}
    for leaf in _leaves(stack):
        return int(np.shape(leaf)[0])
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def lm_from_tree(tree: dict, device) -> LM:
    """The port's model from a JAX-layout tree (numpy leaves), its depth and
    period read from the tree itself."""
    stack = tree.get("stack") or {}
    return LM(to_tensor(tree["embed"], device),
              to_tensor(tree["out_norm"], device),
              (to_tensor(tree["unembed"], device) if "unembed" in tree
               else None),
              [_layer(layer, device) for layer in tree["prefix"]],
              [{f"pos{j}": _layer(_index(stack[f"pos{j}"], r), device)
                for j in range(len(stack))} for r in range(_n_repeat(tree))],
              ({k: to_tensor(v, device) for k, v in tree["mtp"].items()}
               if "mtp" in tree else None))


def params_from_jax(tree: dict, cfg: ArchConfig, device=None) -> LM:
    """The port's model from JAX's ``init_params`` tree (numpy leaves),
    deepseek's ``mtp`` head included."""
    dev = resolve_device(device)
    _, period, n_rep = layer_plan(cfg)
    if (len(tree.get("stack") or {}), _n_repeat(tree)) != (len(period),
                                                          n_rep):
        raise ValueError(f"the tree's stack is not {cfg.name}'s: "
                         f"{n_rep} repeats of a period of {len(period)}")
    return lm_from_tree(tree, dev)


def is_dtensor(t: torch.Tensor) -> bool:
    """Whether ``t`` is a ``torch.distributed`` ``DTensor``."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor as a numpy array on the host (never sharing the
    tensor's memory), bf16 as numpy's ``bfloat16`` extension dtype bit for
    bit (registered by whoever loaded ``ml_dtypes``, as JAX does; raises
    when none is)."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return np.array(t.numpy())
    try:
        bf16 = np.dtype("bfloat16")
    except TypeError:
        raise TypeError("a bf16 tensor goes to numpy only as the bfloat16 "
                        "dtype that ml_dtypes registers; none is loaded "
                        "(checkpoints of training hold fp32)") from None
    return np.array(t.view(torch.int16).numpy()).view(bf16)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor as a numpy array on the host, a bf16 tensor as
    :data:`BF16_BITS` elements holding its bits (no ``ml_dtypes``
    needed): how checkpoints hold it.  A ``DTensor`` is gathered whole
    first (``full_tensor()``, a collective: every rank of its mesh
    calls it)."""
    t = t.detach()
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.cpu()
    if t.dtype != torch.bfloat16:
        return np.array(t.numpy())
    return np.array(t.view(torch.int16).numpy()).view(BF16_BITS)


def named_to_tree(named: dict, host=to_numpy) -> dict:
    """JAX's layout from tensors or arrays keyed by the port's parameter
    names: ``prefix.{i}.…`` into the list ``prefix``, ``stack.{r}.pos{j}.…``
    stacked on a leading ``[n_repeat]`` axis under ``stack/pos{j}``, the
    rest nested by the dots.  Tensors go to numpy by ``host``
    (:func:`to_numpy`, or :func:`to_host` for a checkpoint)."""
    tree: dict = {}
    stacked: dict = {}
    for name, value in named.items():
        a = host(value) if isinstance(value, torch.Tensor) else value
        parts = name.split(".")
        if parts[0] == "stack":
            stacked.setdefault((parts[2], *parts[3:]), {})[int(parts[1])] = a
            continue
        if parts[0] == "prefix":
            prefix = tree.setdefault("prefix", [])
            i = int(parts[1])
            prefix.extend({} for _ in range(i + 1 - len(prefix)))
            node, parts = prefix[i], parts[2:]
        else:
            node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = a
    tree.setdefault("prefix", [])
    for path, by_repeat in stacked.items():
        node = tree.setdefault("stack", {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([by_repeat[r]
                                   for r in range(len(by_repeat))])
    return tree


def tree_to_named(tree: dict, device, dtypes: dict | None = None) -> dict:
    """Tensors on ``device`` keyed by the port's parameter names from a
    JAX-layout tree (the inverse of :func:`named_to_tree`), each cast to
    ``dtypes[name]`` where given."""
    named = dict(lm_from_tree(tree, device).named_parameters())
    dtypes = dtypes or {}
    return {k: v.detach().to(dtypes.get(k, v.dtype))
            for k, v in named.items()}


def params_to_jax(lm: LM, cfg: ArchConfig | None = None, *,
                  host=to_numpy) -> dict:
    """JAX's ``init_params`` tree (numpy leaves, by ``host``) from the
    port's model: the inverse of :func:`params_from_jax`, ``stack``
    stacked on a leading ``[n_repeat]`` axis."""
    if cfg is not None:
        _, period, n_rep = layer_plan(cfg)
        if (len(lm.stack), len(lm.stack[0]) if len(lm.stack) else 0) != (
                n_rep, len(period) if n_rep else 0):
            raise ValueError(f"the model's stack is not {cfg.name}'s")
    return named_to_tree(dict(lm.named_parameters()), host)


def opt_state_to_jax(state: OptState, *, host=to_numpy) -> dict:
    """JAX's ``OptState`` fields as a dict (``step``, ``mu``, ``nu`` in
    JAX's layout, numpy leaves by ``host``) from the port's, whose
    moments are keyed by parameter name."""
    return {"step": host(state.step), "mu": named_to_tree(state.mu, host),
            "nu": named_to_tree(state.nu, host)}


def opt_state_from_jax(tree, device=None) -> OptState:
    """The port's ``OptState`` from JAX's (its dataclass, or a dict of
    its fields; numpy leaves)."""
    dev = resolve_device(device)
    get = (tree.get if isinstance(tree, dict)
           else lambda k: getattr(tree, k))
    return OptState(step=to_tensor(get("step"), dev),
                    mu=tree_to_named(get("mu"), dev),
                    nu=tree_to_named(get("nu"), dev))


def _layer_cache(tree: dict, device) -> dict:
    if "state" not in tree:       # attention {"k", "v"}, MLA {"c_kv", ...}
        return {k: to_tensor(v, device) for k, v in tree.items()}
    return {"state": to_tensor(tree["state"], device),
            "conv": tuple(to_tensor(t, device) for t in tree["conv"])}


def cache_from_jax(tree: dict, cfg: ArchConfig, device=None) -> dict:
    """The port's cache from a JAX ``prefill`` / ``decode_step`` /
    ``cache_init`` cache (numpy leaves)."""
    dev = resolve_device(device)
    _, period, n_rep = layer_plan(cfg)
    return {"prefix": [_layer_cache(c, dev) for c in tree["prefix"]],
            "stack": [{f"pos{j}": _layer_cache(
                _index(tree["stack"][f"pos{j}"], r), dev)
                for j in range(len(period))} for r in range(n_rep)]}
