"""Sharding rules (port of ``repro.launch.sharding``): which dimension of
each parameter, optimizer and cache leaf goes on the ``pod``, ``data`` or
``model`` axis of a mesh, as ``torch.distributed`` placements.

Policy (as JAX's):
  * TP on the ``model`` axis: attention heads, d_ff, vocab, MoE experts
    (EP), Mamba d_inner/state/heads.  A dim the axis size does not divide
    stays whole (e.g. MQA's single KV head).
  * FSDP (ZeRO-3) on the ``data`` axis for archs of at least
    :data:`FSDP_THRESHOLD` parameters (``configs.base.param_count``):
    each large weight's remaining dim is also split over ``data``.
  * The ``pod`` axis is pure DP: parameters replicated across pods.
  * MoE with fewer experts than the model axis (grok's 8 on 16), or
    ``cfg.moe_tp_within_expert``, shards each expert's d_ff instead.

A :class:`Spec` has one entry per tensor dimension: None (whole), an axis
name, or a tuple of axis names (the dimension split over their product,
the first the major factor): the meaning of JAX's ``PartitionSpec``, so
the two compare by value.  :func:`placements` turns a spec into one
``Shard(d)`` / ``Replicate()`` per mesh dimension for ``DTensor``, and
:func:`shard_tree` places a tree by its specs (JAX's ``device_put(tree,
shardings)``).

The port's trees differ from JAX's in one way the rules see: the stack
is a list of blocks, not a leading ``[n_repeat]`` axis, so a stack
leaf's spec is JAX's without its leading None, the same for every
repeat.  Parameters are keyed by ``LM.named_parameters()`` names
(``"stack.3.pos0.attn.wq"``), the keys of the port's ``OptState``.

What a rank computes in a tensor-parallel step follows from each
parameter's spec: :func:`model_role` says how the leaf's block along
``model`` enters its product (JAX's GSPMD program reads the same from the
``PartitionSpec``), and :func:`step_block` is the rank's block of a placed
leaf for the step, gathered along the dp axes only.
"""
from __future__ import annotations

import copy
import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, param_count
from repro_torch.launch.mesh import MeshShape, dp_axes, model_axis_size
from repro_torch.models.transformer import LM
from repro_torch.optim import OptState

FSDP_THRESHOLD = 8e9   # params; above this, weights are FSDP-sharded


class Spec(tuple):
    """One entry per tensor dimension: None, an axis name or a tuple of
    axis names (a one-name tuple is stored as the name, as JAX's
    ``PartitionSpec`` stores it)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else
            (None if p == () else p) for p in parts))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _axes(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def shards(spec: Spec, mesh) -> int:
    """How many pieces ``spec`` cuts a leaf into on ``mesh``."""
    size = MeshShape.of(mesh).shape
    return math.prod(size[a] for part in spec for a in _axes(part))


def local_numel(shape, spec: Spec, mesh) -> int:
    """Elements of one device's block of a leaf of ``shape``."""
    size = MeshShape.of(mesh).shape
    if len(spec) != len(shape) or any(
            n % math.prod(size[a] for a in _axes(part))
            for n, part in zip(shape, spec)):
        raise ValueError(f"{tuple(shape)} does not split by {spec}")
    return math.prod(shape) // shards(spec, mesh)


def local_bytes(tree, specs, mesh) -> int:
    """Bytes of one device's blocks of ``tree``'s leaves by their specs
    (dicts, lists and tuples leaf by leaf; a model by its parameter
    names)."""
    if isinstance(tree, LM):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return sum(local_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v, s, mesh)
                   for v, s in zip(tree, specs, strict=True))
    return local_numel(tree.shape, specs, mesh) * tree.element_size()


def placements(spec: Spec, mesh) -> tuple:
    """``spec`` as ``DTensor`` placements: one a mesh dimension,
    ``Shard(d)`` where tensor dimension ``d`` names its axis, else
    ``Replicate()``.  A dimension on several axes (the batch on
    ``("pod", "data")``) takes ``Shard(d)`` on each; DTensor splits mesh
    dimensions in the mesh's order, the first the major factor, so the
    spec must name them in that order."""
    from torch.distributed.tensor import Replicate, Shard

    names = MeshShape.of(mesh).axis_names
    on = {}
    for d, part in enumerate(spec):
        axes = _axes(part)
        for a in axes:
            if a not in names or a in on:
                raise ValueError(f"{spec}: axis {a!r} not in the mesh "
                                 f"{names} or named twice")
            on[a] = d
        if [names.index(a) for a in axes] != sorted(
                names.index(a) for a in axes):
            raise ValueError(f"{spec}: {axes} out of the mesh's order "
                             f"{names} (DTensor splits in mesh order)")
    return tuple(Shard(on[a]) if a in on else Replicate() for a in names)


def _maybe(axis: str | None, dim: int, axis_size: int):
    """Use `axis` for a dim only if it divides evenly."""
    if axis is None or axis_size <= 1 or dim % axis_size != 0:
        return None
    return axis


def use_fsdp(cfg: ArchConfig) -> bool:
    return param_count(cfg)[0] >= FSDP_THRESHOLD


def _leaf_spec(name: str, shape: tuple[int, ...], cfg: ArchConfig, mesh,
               fsdp: bool) -> Spec:
    """JAX's ``_leaf_spec`` for a leaf whose last key is ``name``, on its
    shape without the stack's leading axis (the port has none)."""
    msize = model_axis_size(mesh)
    dsize = MeshShape.of(mesh).shape.get("data", 1)
    d_axis = "data" if fsdp else None

    def spec(*parts) -> Spec:
        assert len(parts) == len(shape), (name, parts, shape)
        return Spec(*parts)

    def m(i):
        return _maybe("model", shape[i], msize)

    def dd(i):
        return _maybe(d_axis, shape[i], dsize)

    # ---- embeddings ----
    if name == "embed":
        # odd vocabularies (minicpm3 73448, mamba2 50280) don't divide 16:
        # fall back to sharding d_model
        if _maybe("model", shape[0], msize):
            return spec("model", dd(1))
        return spec(dd(0), m(1))
    if name == "unembed":
        if _maybe("model", shape[1], msize):
            return spec(dd(0), "model")
        return spec(m(0), dd(1))
    # ---- vectors / norms ----
    if len(shape) == 1:
        if name in ("A_log", "D", "dt_bias", "conv_b_x", "norm"):
            return spec(m(0))
        return spec(None)
    # ---- attention ----
    if name == "wq":
        # few-head models (gemma: 8 heads < 16-way TP): shard d_model
        if _maybe("model", shape[1], msize):
            return spec(dd(0), "model", None)
        return spec(m(0), None, None)
    if name in ("wk", "wv"):
        return spec(dd(0), m(1), None)
    if name in ("wo", "w_o"):
        if _maybe("model", shape[0], msize):
            return spec("model", None, dd(2))
        return spec(None, None, m(2))
    # ---- MLA ----
    # head counts that don't divide the TP width (minicpm3: 40 heads on a
    # 16-wide axis) fall back to sharding the lora rank / d_model
    if name == "w_dq":
        return spec(dd(0), m(1))
    if name == "w_dkv":
        # packed [d, rkv + dr]: dim 1 stays whole (the c_kv / k_rope split
        # at rkv would not align with shard boundaries)
        return spec(dd(0), None)
    if name in ("w_uq", "w_uk", "w_uv"):
        if _maybe("model", shape[1], msize):
            return spec(dd(0), "model", None)
        return spec(m(0), None, None)
    # ---- MoE ----
    if name == "router":
        # [d, E]: shard the expert dim
        return spec(None, m(1))
    if len(shape) == 3 and name in ("w_gate", "w_up", "w_down"):
        E = shape[0]
        if E % msize == 0 and not cfg.moe_tp_within_expert:  # EP
            if name == "w_down":
                return spec("model", None, dd(2))
            return spec("model", dd(1), None)
        # TP within an expert (grok: 8 experts on a 16-wide axis)
        if name == "w_down":
            return spec(None, m(1), dd(2))
        return spec(None, dd(1), m(2))
    # ---- dense FFN / shared expert, Mamba projections, MTP ----
    if name in ("w_gate", "w_up", "in_z", "in_x", "in_B", "in_C", "in_dt",
                "proj"):
        return spec(dd(0), m(1))
    if name in ("w_down", "out_proj"):
        return spec(m(0), dd(1))
    if name in ("conv_x", "conv_B", "conv_C"):
        return spec(None, m(1))
    return spec(*([None] * len(shape)))


def param_shardings(cfg: ArchConfig, mesh, params: LM,
                    fsdp: bool | None = None) -> dict[str, Spec]:
    """``{name: Spec}`` over ``params.named_parameters()`` (a model on
    any device, ``meta`` included)."""
    if fsdp is None:
        fsdp = use_fsdp(cfg)
    return {k: _leaf_spec(k.rsplit(".", 1)[-1], tuple(p.shape), cfg, mesh,
                          fsdp)
            for k, p in params.named_parameters()}


def opt_shardings(cfg: ArchConfig, mesh, params: LM,
                  fsdp: bool | None = None) -> OptState:
    """The AdamW state's specs: the moments take the parameters', the
    step is replicated (JAX's ``OptState(step=P(), mu=p, nu=p)``)."""
    p = param_shardings(cfg, mesh, params, fsdp)
    return OptState(step=Spec(), mu=p, nu=dict(p))


def batch_spec(mesh) -> Spec:
    return Spec(dp_axes(mesh))


def act_spec(mesh) -> Spec:
    """[B, S, ...] activations: batch over dp axes."""
    return Spec(dp_axes(mesh), None)


def cache_shardings(cfg: ArchConfig, mesh, cache):
    """The port's cache tree (``transformer.cache_init``'s dicts, lists and
    the Mamba conv tuple) with a :class:`Spec` at each leaf: batch over
    the dp axes where their product divides it; K/V heads on ``model``
    when they divide, else the sequence (SP: MQA / MLA long context).
    As in JAX, a leaf's name is its dict key, "" under a list or tuple:
    each of Mamba's conv tails ``(tx, tB, tC)`` takes the last rule.  On
    a mesh without a ``model`` axis (the host mesh) no leaf names it,
    where JAX's rule would name an axis the mesh lacks."""
    msize = model_axis_size(mesh)
    dp = dp_axes(mesh)
    dp_size = math.prod(MeshShape.of(mesh).shape[a] for a in dp)
    heads = "model" if "model" in MeshShape.of(mesh).axis_names else None

    def leaf(name: str, shape) -> Spec:
        batch_first = dp if shape[0] % dp_size == 0 else None
        if name in ("k", "v"):             # [B, S, K, hd]
            if shape[2] % msize == 0:
                return Spec(batch_first, None, heads, None)
            return Spec(batch_first, _maybe("model", shape[1], msize), None,
                        None)
        if name in ("c_kv", "k_rope"):     # [B, S, r]: SP over seq
            return Spec(batch_first, _maybe("model", shape[1], msize), None)
        if name == "state":                # [B, H, P, N]
            return Spec(batch_first, _maybe("model", shape[1], msize), None,
                        None)
        return Spec(batch_first, None,     # conv tails [B, K-1, C]
                    _maybe("model", shape[2], msize))

    def walk(tree, name: str):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, "") for v in tree)
        return leaf(name, tuple(tree.shape))

    return walk(cache, "")


def map_leaves(fn, tree, *others):
    """``fn`` of each leaf of ``tree`` and the leaves at the same place in
    ``others`` (trees of its structure: dicts, lists and tuples; a
    :class:`Spec` is a leaf), as a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return type(tree)(map_leaves(fn, *parts) for parts in zip(
            tree, *others, strict=True))
    return fn(tree, *others)


def model_dim(spec: Spec) -> int | None:
    """The dimension ``spec`` puts on ``model`` (alone or in a tuple of
    axes), or None."""
    return next((d for d, part in enumerate(spec)
                 if "model" in _axes(part)), None)


# the leading dimensions of a weight that its product contracts with the
# input (``x @ W``): ``wo``'s heads and head dim, any other weight's first
_CONTRACTED = {"wo": 2, "w_o": 2}


def model_role(name: str, spec: Spec) -> str | None:
    """How the block along ``model`` of a leaf whose last key is ``name``
    enters its product, by :func:`model_dim` of its ``spec``:

    * ``"out"``: an output dimension (column-parallel): the rank computes
      its block of the outputs (``wq``/``wk``/``wv``'s heads, ``d_ff`` of
      ``w_gate``/``w_up``, the vocabulary of ``unembed``; a vector's
      features);
    * ``"in"``: a contracted dimension (row-parallel): the rank multiplies
      its block of the input features and the partial products are summed
      over ``model`` (``wo``'s heads, ``w_down``'s ``d_ff``, the
      ``d_model`` fallbacks of ``wq`` and ``unembed``);
    * ``"expert"``: an MoE weight's experts (``[E, ., .]``);
    * None: the spec names no ``model``.

    ``embed [V, d]`` reads as the tied unembedding ``h @ embed^T``: its
    vocabulary rows ``"out"``, ``d_model`` ``"in"``."""
    d = model_dim(spec)
    if d is None:
        return None
    if name == "embed":
        return "out" if d == 0 else "in"
    if len(spec) == 3 and name in ("w_gate", "w_up", "w_down"):
        return ("expert", "in", "out")[d]
    if len(spec) == 1:
        return "out"
    return "in" if d < _CONTRACTED.get(name, 1) else "out"


def step_block(d) -> torch.Tensor:
    """The rank's block of a placed ``DTensor`` for a tensor-parallel
    step: redistributed to ``Replicate()`` on the dp axes (FSDP's
    ``data`` split gathered on use, as XLA does; ``pod`` is replicated
    already) and kept as its block along ``model``; no communication where
    the dp axes hold it whole."""
    from torch.distributed.tensor import Replicate

    mesh = d.device_mesh
    dp = dp_axes(mesh)
    want = tuple(Replicate() if name in dp else p for name, p in zip(
        mesh.mesh_dim_names, d.placements))
    if want != tuple(d.placements):
        d = d.redistribute(mesh, want)
    return d.to_local()


def local_block(full: torch.Tensor, like) -> torch.Tensor:
    """The block of ``full`` (a whole leaf, the same on every rank) that
    this rank holds of the ``DTensor`` ``like`` of the same shape, as a
    view: each mesh dimension's ``Shard(d)`` cuts dimension ``d`` into
    equal chunks, in the mesh's order (the first the major factor), as
    DTensor splits it."""
    mesh = like.device_mesh
    coord = mesh.get_coordinate()
    for i, p in enumerate(like.placements):
        if p.is_shard():
            full = full.chunk(mesh.size(i), dim=p.dim)[coord[i]]
        elif not p.is_replicate():
            raise ValueError(f"a block of a {p} placement")
    if full.shape != like.to_local().shape:
        raise ValueError(f"a block of {tuple(full.shape)} for a local "
                         f"{tuple(like.to_local().shape)} of {like.placements}")
    return full


def placed_like(local: torch.Tensor, like):
    """``local`` (this rank's block) as a ``DTensor`` placed as ``like``
    is, no communication."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def rebuild(params: LM, tensors: dict) -> LM:
    """A new model of ``params``' structure holding ``tensors`` (its
    parameter names -> tensors or DTensors, of any shape: a rank's blocks
    too); ``params`` is not changed and its weights are not copied."""
    memo = {id(p): nn.Parameter(torch.empty(tensors[k].shape,
                                            dtype=tensors[k].dtype,
                                            device="meta"),
                                requires_grad=False)
            for k, p in params.named_parameters()}
    lm = copy.deepcopy(params, memo)
    lm.load_state_dict(tensors, strict=True, assign=True)
    return lm


def shard_tree(tree, device_mesh, specs):
    """``distribute_tensor`` of each leaf of ``tree`` by its spec in
    ``specs`` (JAX's ``device_put(tree, shardings)``): dicts, lists and
    tuples leaf by leaf, a model by :func:`param_shardings`' names (a new
    model holding DTensors), an ``OptState`` by :func:`opt_shardings`'.
    The data comes from rank 0 of each mesh dimension's group."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, LM):
        return rebuild(tree, {k: shard_tree(p.detach(), device_mesh, specs[k])
                              for k, p in tree.named_parameters()})
    if isinstance(tree, OptState):
        return OptState(*(shard_tree(getattr(tree, f), device_mesh,
                                     getattr(specs, f))
                          for f in ("step", "mu", "nu")))
    if isinstance(tree, dict):
        return {k: shard_tree(v, device_mesh, specs[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, device_mesh, s)
                          for v, s in zip(tree, specs, strict=True))
    if not isinstance(specs, Spec) or len(specs) != tree.dim():
        raise ValueError(f"a {tuple(tree.shape)} leaf against {specs!r}")
    return distribute_tensor(tree, device_mesh,
                             placements(specs, device_mesh))
