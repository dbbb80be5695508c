"""Fault-tolerant checkpoints in the JAX package's layout (port of
``repro.train.checkpoint``).

Layout, as JAX writes it on one host:

  <dir>/step_<N>/shard_0.npz   every leaf, keyed by its JAX tree path
                               ("0/stack/pos0/attn/wq", "1/mu/embed", ...)
  <dir>/step_<N>/meta.json     step, keys, shapes, dtypes, time
  <dir>/step_<N>/COMMIT        written LAST -> atomic visibility

The tree is written in JAX's layout (``models.carry``: the model's
``stack`` stacked on a leading ``[n_repeat]`` axis, the optimizer's
moments nested as the parameters are), so either package restores a
checkpoint the other wrote, as with the ``ForestPack`` ``.npz``.

  * atomicity: a step directory without COMMIT is removed on restore (a
    writer died mid-write); restore picks the newest committed step.
  * async: ``save(..., async_write=True)`` copies the tree to host memory
    at once and writes it on a thread.
  * from a mesh: a tree holding ``DTensor``s (the state of the mesh
    train step, or of ``restore(..., shardings=, mesh=)``) is saved by
    every rank of the process group: each leaf is gathered whole
    (``full_tensor()``) on every rank, rank 0 alone writes, and every
    rank returns after the commit marker (a barrier), so the file is
    leaf for leaf the one that one process writes for the same state.
    Such a save is synchronous.
  * ``keep``: only the newest ``keep`` committed steps stay.
  * elastic re-mesh: ``restore(..., shardings=specs, mesh=device_mesh)``
    places each restored leaf on a ``DeviceMesh`` by its spec
    (``launch.sharding``), whatever mesh wrote the file, as JAX's
    ``restore(..., shardings=)`` does.
  * bf16 leaves are stored as JAX's ``np.savez`` stores them: 2-byte void
    elements of the same bits (``'<V2'`` in the ``.npy`` header) and
    ``"bfloat16"`` in ``meta.json``'s ``dtypes``, so the port's file
    equals JAX's leaf by leaf; ``restore`` reads the dtype from
    ``meta.json``.  Neither needs ``ml_dtypes``.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
import zipfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.sharding import shard_tree
from repro_torch.models.carry import (BF16_BITS, is_dtensor, lm_from_tree,
                                      opt_state_to_jax, params_to_jax,
                                      to_host, to_tensor, tree_to_named)
from repro_torch.models.transformer import LM
from repro_torch.optim import OptState


def _jax_tree(tree):
    """``tree`` with every model and optimizer state in JAX's layout and
    every tensor a host numpy array (bf16 as :data:`BF16_BITS`)."""
    if isinstance(tree, LM):
        return params_to_jax(tree, host=to_host)
    if isinstance(tree, OptState):
        return opt_state_to_jax(tree, host=to_host)
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_jax_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return to_host(tree)
    return np.asarray(tree)


def _tensors(tree):
    """Every tensor of ``tree`` (models, optimizer states, tensors, in
    dicts, tuples and lists)."""
    if isinstance(tree, LM):
        yield from tree.parameters()
    elif isinstance(tree, OptState):
        yield tree.step
        yield from tree.mu.values()
        yield from tree.nu.values()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _dtype_name(a: np.ndarray) -> str:
    """A leaf's dtype as JAX's ``meta.json`` names it."""
    return "bfloat16" if a.dtype == BF16_BITS else str(a.dtype)


def _savez(path: Path, host: dict[str, np.ndarray]) -> None:
    """``np.savez(path, **host)``, byte for byte, but a bf16 leaf's header
    names ``'<V2'``, as numpy writes JAX's bf16 leaves (a plain void array
    would give ``'|V2'``)."""
    fmt = np.lib.format
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, a in host.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if a.dtype != BF16_BITS:
                    fmt.write_array(f, a, allow_pickle=False)
                    continue
                header = fmt.header_data_from_array_1_0(a)
                header["descr"] = "<V2"
                fmt.write_array_header_1_0(f, header)
                f.write(np.ascontiguousarray(a).tobytes())


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Leaves by JAX's key path (``jax.tree_util`` keys joined by "/")."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def save(step: int, tree, directory, *, async_write: bool = False,
         keep: int = 3) -> threading.Thread | None:
    """Write a committed checkpoint of ``tree`` (models, optimizer states,
    tensors, in dicts, tuples and lists) for ``step``.  Returns the writer
    thread if async.  A tree holding ``DTensor``s is saved from its mesh
    (the module docstring): every rank calls ``save``, and
    ``async_write`` is refused."""
    directory = Path(directory)
    step_dir = directory / f"step_{step:08d}"
    tmp_dir = directory / f".tmp_step_{step:08d}"
    on_mesh = any(is_dtensor(t) for t in _tensors(tree))
    if on_mesh and async_write:
        raise ValueError("a tree on a mesh is saved synchronously: every "
                         "rank meets the others after the commit marker")
    # snapshot to host memory NOW (the caller may update in place), write
    # later; on a mesh every rank gathers each leaf
    host = _flatten(_jax_tree(tree))

    def write():
        if tmp_dir.exists():
            shutil.rmtree(tmp_dir)
        tmp_dir.mkdir(parents=True)
        _savez(tmp_dir / "shard_0.npz", host)
        meta = {"step": step, "keys": sorted(host),
                "shapes": {k: list(v.shape) for k, v in host.items()},
                "dtypes": {k: _dtype_name(v) for k, v in host.items()},
                "time": time.time()}
        (tmp_dir / "meta.json").write_text(json.dumps(meta))
        if step_dir.exists():
            shutil.rmtree(step_dir)
        tmp_dir.rename(step_dir)
        (step_dir / "COMMIT").touch()          # commit marker LAST
        _gc(directory, keep)

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    if not on_mesh:
        write()
        return None
    try:
        if dist.get_rank() == 0:
            write()
    finally:
        dist.barrier()
    return None


def _gc(directory: Path, keep: int) -> None:
    steps = sorted(d for d in directory.glob("step_*")
                   if (d / "COMMIT").exists())
    for d in steps[:-keep]:
        shutil.rmtree(d, ignore_errors=True)
    for d in directory.glob(".tmp_step_*"):
        shutil.rmtree(d, ignore_errors=True)


def latest_step(directory) -> int | None:
    directory = Path(directory)
    steps = [int(d.name.split("_")[1]) for d in directory.glob("step_*")
             if (d / "COMMIT").exists()]
    return max(steps) if steps else None


def _nested(data: dict, prefix: str) -> dict:
    """The JAX-layout subtree under key path ``prefix`` of the file's
    leaves (``prefix`` is a list of layers, the rest dicts)."""
    tree: dict = {}
    head = f"{prefix}/" if prefix else ""
    for key in data:
        if not key.startswith(head):
            continue
        node = tree
        parts = key[len(head):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = data[key]
    tree["prefix"] = [tree["prefix"][str(i)]
                      for i in range(len(tree.get("prefix", {})))]
    return tree


def _leaf(data, key: str, like: torch.Tensor) -> torch.Tensor:
    arr = data[key]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: {tuple(arr.shape)} in the checkpoint, "
                         f"{tuple(like.shape)} wanted")
    return to_tensor(arr, like.device).to(like.dtype)


def _check_named(named: dict, like: dict, what: str) -> dict:
    if set(named) != set(like):
        raise ValueError(f"{what}: the checkpoint's parameters differ: "
                         f"{sorted(set(named) ^ set(like))[:4]}")
    for k, t in named.items():
        if tuple(t.shape) != tuple(like[k].shape):
            raise ValueError(f"{what} {k}: {tuple(t.shape)} in the "
                             f"checkpoint, {tuple(like[k].shape)} wanted")
    return named


def _rebuild(like, data, prefix: str):
    """A tree shaped like ``like`` from the file's leaves under
    ``prefix``, each leaf on its like's device in its like's dtype."""
    def sub(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(like, LM):
        like_named = dict(like.named_parameters())
        device = next(iter(like_named.values())).device
        lm = lm_from_tree(_nested(data, prefix), device)
        named = _check_named(dict(lm.named_parameters()), like_named, "model")
        for k, p in named.items():
            p.data = p.data.to(like_named[k].dtype)
        return lm
    if isinstance(like, OptState):
        device = like.step.device
        mu, nu = (_check_named(
            tree_to_named(_nested(data, sub(m)), device,
                          {k: t.dtype for k, t in getattr(like, m).items()}),
            getattr(like, m), m) for m in ("mu", "nu"))
        return OptState(step=_leaf(data, sub("step"), like.step), mu=mu,
                        nu=nu)
    if isinstance(like, dict):
        return {k: _rebuild(v, data, sub(k)) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, data, sub(i))
                          for i, v in enumerate(like))
    return _leaf(data, prefix, like)


def restore(tree_like, directory, step: int | None = None, *,
            shardings=None, mesh=None):
    """Restore into the structure of ``tree_like`` (models, optimizer
    states and tensors that give each leaf's device and dtype).
    Uncommitted step directories are removed first (crash cleanup).
    With ``shardings`` (a spec tree of ``launch.sharding``, shaped as
    ``tree_like``), each leaf becomes a ``DTensor`` on the
    ``DeviceMesh`` ``mesh`` by its spec (``sharding.shard_tree``).
    Returns ``(tree, step)``."""
    if (shardings is None) != (mesh is None):
        raise ValueError("restore: give shardings and mesh together")
    directory = Path(directory)
    for d in directory.glob("step_*"):
        if not (d / "COMMIT").exists():
            shutil.rmtree(d, ignore_errors=True)
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {directory}")
    step_dir = directory / f"step_{step:08d}"
    dtypes = json.loads((step_dir / "meta.json").read_text())["dtypes"]
    with np.load(step_dir / "shard_0.npz") as f:
        data = {k: _file_leaf(f[k], dtypes.get(k)) for k in f.files}
    tree = _rebuild(tree_like, data, "")
    if shardings is not None:
        tree = shard_tree(tree, mesh, shardings)
    return tree, step


def _file_leaf(a: np.ndarray, dtype: str | None) -> np.ndarray:
    """A leaf as the file holds it, a ``"bfloat16"`` one (2-byte void
    elements, or numpy's bfloat16 where ``ml_dtypes`` is loaded) as
    :data:`BF16_BITS` (which ``to_tensor`` takes as bf16 bits)."""
    if dtype != "bfloat16":
        return a
    if a.dtype.itemsize != 2:
        raise ValueError(f"a bfloat16 leaf of {a.dtype} in the checkpoint")
    return a.view(BF16_BITS)
