"""Carry the JAX package's baseline parameters into the port.

``params_from_jax(name, tree)`` takes a baseline's parameter tree as the
JAX package's ``init_*`` made it, with numpy leaves
(``jax.tree.map(np.asarray, tree)``), and returns the port's tree on
``device``: the same numbers, in the port's layout.  The only layout that
differs is the CNN's conv weights, HWIO in JAX and OIHW here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.baselines.svm import RFFParams


def _get(tree, key: str):
    return tree[key] if isinstance(tree, dict) else getattr(tree, key)


def params_from_jax(name: str, tree, device=None):
    """The port's parameters for baseline ``name`` ("svm_lr", "svm_rbf",
    "mlp", "cnn") from JAX's tree of numpy arrays."""
    dev = resolve_device(device)

    def t(a, perm=None):
        a = np.asarray(a, np.float32)
        if perm is not None:
            a = a.transpose(perm)
        return torch.tensor(np.ascontiguousarray(a), device=dev)

    def dense(layer):
        return {"w": t(_get(layer, "w")), "b": t(_get(layer, "b"))}

    if name == "svm_lr":
        return dense(tree)
    if name == "svm_rbf":
        return RFFParams(omega=t(_get(tree, "omega")),
                         phase=t(_get(tree, "phase")),
                         linear=dense(_get(tree, "linear")))
    if name == "mlp":
        return [dense(layer) for layer in tree]
    if name == "cnn":
        out = {k: dense(tree[k]) for k in ("fc1", "fc2")}
        for k in ("conv1", "conv2"):                    # HWIO -> OIHW
            out[k] = {"w": t(tree[k]["w"], (3, 2, 0, 1)),
                      "b": t(tree[k]["b"])}
        return {k: out[k] for k in ("conv1", "conv2", "fc1", "fc2")}
    raise ValueError(f"unknown baseline {name!r}; pick from "
                     "('svm_lr', 'svm_rbf', 'mlp', 'cnn')")
