"""Carry the JAX package's parameters and caches into the port.

Both take the JAX pytree as numpy arrays (``jax.tree.map(np.asarray,
tree)``): bf16 leaves arrive as numpy's ``bfloat16`` extension dtype and
are moved bit for bit.  The JAX tree stacks each period position on a
leading ``[n_repeat]`` axis (``stack``, from ``jax.vmap`` of the layer
init, or from the decode ``lax.scan``); the port splits that axis into
one block per repeat.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import mamba2, mla, moe
from repro_torch.models.transformer import FFN, LM, Attn, Layer, layer_plan


def to_tensor(a, device) -> torch.Tensor:
    """A numpy array (bf16 included) as a tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
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


def params_from_jax(tree: dict, cfg: ArchConfig, device=None) -> LM:
    """The port's model from JAX's ``init_params`` tree (numpy leaves),
    deepseek's ``mtp`` head included."""
    dev = resolve_device(device)
    _, period, n_rep = layer_plan(cfg)
    return LM(to_tensor(tree["embed"], dev), to_tensor(tree["out_norm"], dev),
              (to_tensor(tree["unembed"], dev) if "unembed" in tree
               else None),
              [_layer(layer, dev) for layer in tree["prefix"]],
              [{f"pos{j}": _layer(_index(tree["stack"][f"pos{j}"], r), dev)
                for j in range(len(period))} for r in range(n_rep)],
              ({k: to_tensor(v, dev) for k, v in tree["mtp"].items()}
               if "mtp" in tree else None))


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
