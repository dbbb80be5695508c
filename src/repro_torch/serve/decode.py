"""Serving steps: prefill, decode and FoG early-exit decode (port of
``repro.serve.decode``).

The JAX package builds jitted, sharded programs for a mesh and reads the
batch and sequence length from the training loop's ``SHAPES`` table.
Here the batch and lengths are given directly, and the steps run on one
device (``device``) or on a mesh (``mesh=``, below).  Each factory
returns ``(fn, inputs)``: ``inputs`` maps every per-call input to its
global ``(shape, dtype)``, and ``fn`` keeps JAX's contract::

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

On a mesh (``mesh=``: a ``torch.distributed`` ``DeviceMesh`` over
``pod`` / ``data`` / ``model`` axes, its device type the step's) the
steps are JAX's ``in_shardings`` / ``out_shardings`` programs, which are
tensor-parallel over ``model``:

  * the parameters are ``DTensor``s placed by
    ``launch.sharding.param_shardings`` (``shard_tree``; FSDP automatic
    or forced).  Each step takes the rank's block of every leaf along
    ``model``, gathered along the dp axes only (:func:`step_params`), and
    computes on it by the role of the block in its product
    (``sharding.model_role``; ``models.transformer``): attention on the
    rank's query heads from its columns of ``wq``/``wk``/``wv`` and its
    rows of ``wo``; MLA on its heads of ``w_uq``/``w_uk``/``w_uv`` and
    its rows of ``w_o`` (``cq`` from its ``rq`` columns of ``w_dq``,
    gathered), or, where the heads do not divide, every head from its
    LoRA-rank rows summed and its ``d_model`` columns of ``w_o``
    (``models.mla``); Mamba-2 on its columns of the projections, its
    channels of the convs and its heads of the SSD, with B and C gathered
    whole and ``out_proj``'s rows summed (``models.mamba2``); the dense
    FFN on its ``d_ff`` columns and rows, MoE on its experts or its
    ``d_ff`` of each expert, the embedding and the unembedding on its
    vocabulary block (on ``d_model`` where the vocabulary does not
    divide).  A row-parallel product's partial outputs, and a norm's sums
    of squares over a split feature dimension, are summed over ``model``
    (``layers.ModelGroup.sum``: gathered and added in rank order in
    fp32), so every ``model`` rank holds the same residual stream bit for
    bit.  Where the plan keeps a weight whole (``wk``/``wv`` of one KV
    head, MLA's ``w_dkv`` and norms) the rank computes it whole; no
    parameter is gathered along ``model``;
  * every rank is given the global inputs and takes its dp slice, rows
    ``[r B / n, (r + 1) B / n)`` for its coordinate ``r`` along the dp
    axes (``pod`` the major factor; ``launch.mesh.dp_rank``), or the
    whole batch where ``n`` does not divide ``B`` (JAX's replicated
    ``bdp = ()``: ``long_500k``'s one lane);
  * the cache arrives and returns as ``DTensor``s placed by
    ``launch.sharding.cache_shardings`` (a cache not so placed raises).
    Where the plan puts an attention layer's KV heads on ``model``, rank
    ``m`` of ``M`` owns KV heads ``[m K / M, (m + 1) K / M)``, which its
    own ``wk``/``wv`` columns compute, and such a K/V leaf is never
    gathered; nor is a Mamba layer's state (the rank's heads) or conv
    tails (its channels), which its own blocks compute
    (:class:`LayerShare`'s ``own``).  The other leaves (K/V with the
    sequence on ``model``, MLA's latent and rope key) are gathered over
    ``model`` layer by layer, the layer runs on them and the rank keeps
    its block of each new leaf;
  * FoG's grove skip is decided over the whole batch (the rank's
    ``live.any()`` reduced over the dp ranks), as JAX's ``lax.cond``, and
    its gate works on the rank's block of the logits
    (``models.fog_exit``): no rank holds a whole row of them;
  * the outputs are placed as JAX's ``out_specs``: logits on ``(bdp,
    "model")`` where ``model`` divides the vocabulary (each rank computed
    its block of the logits of its rows), else ``(bdp, None)``; hops on
    ``(bdp,)``; the cache by the plan.

What is divided: the parameters at rest and in the step, the products
of attention, MLA, Mamba-2, the FFNs, the embedding and the unembedding,
the SSD's heads, the cache at rest and in the step (its head-sharded K/V
and every Mamba leaf never gathered), and the logits.  What is not: the
residual stream and the layer norms (whole on every ``model`` rank, as
in JAX's program), MLA's latent and rope key (computed whole, their
sequence-sharded cache gathered layer by layer), Mamba's B and C
(gathered whole: one group), and what the plan keeps whole where a
dimension does not divide.  With ``model`` of size 1 every product is the one-device
product, and a mesh step equals the one-device step bit for bit on the
CPU (``decode_attention`` and the tied unembedding are laid out for it;
a one-row slice does not: the CPU's product of one row is a
matrix-vector product, which sums in another order than the same row of
a larger product).  With ``model`` > 1 the split products round
differently from one device's, as in JAX's own sharded program; the
tests hold the outputs to fp32 and bf16 bars.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import FogPolicy, margin_backend
from repro_torch.launch.mesh import dp_axes, dp_rank, model_rank
from repro_torch.launch.sharding import (Spec, cache_shardings, map_leaves,
                                         model_dim, model_role,
                                         param_shardings, placements,
                                         rebuild, step_block)
from repro_torch.models import transformer as T
from repro_torch.models.carry import is_dtensor
from repro_torch.models.fog_exit import decode_step_fog
from repro_torch.models.layers import MetaDraws, ModelGroup
from repro_torch.train.loop import check_on_mesh


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


def _cut(t: torch.Tensor, dim: int, m: int, size: int) -> torch.Tensor:
    """Block ``m`` of ``size`` equal blocks of ``t`` along ``dim``, as a
    tensor of its own."""
    n = t.shape[dim] // size
    return t.narrow(dim, m * n, n).clone(memory_format=torch.contiguous_format)


def step_params(cfg: ArchConfig, mesh, params: T.LM) -> T.LM:
    """The rank's parameters for a tensor-parallel serving step on
    ``mesh``: each leaf's block along ``model`` gathered along the dp
    axes (``sharding.step_block``).  Raises unless every leaf is a
    ``DTensor`` on ``mesh`` placed along ``model`` as the plan places it
    (``param_shardings``; FSDP's ``data`` either way)."""
    check_on_mesh(params, mesh)
    specs = param_shardings(cfg, mesh, params)
    at = mesh.mesh_dim_names.index("model") if (
        "model" in mesh.mesh_dim_names) else None
    out = {}
    for k, p in params.named_parameters():
        if at is not None and (p.placements[at]
                               != placements(specs[k], mesh)[at]):
            raise ValueError(f"{k} is placed {p.placements}, off the plan "
                             f"along model ({specs[k]})")
        out[k] = step_block(p)
    return rebuild(params, out)


class LayerShare:
    """A rank's share of one layer of a mesh step, read by
    ``models.transformer``, ``models.moe``, ``models.mla``,
    ``models.mamba2`` and ``models.fog_exit``:

    * ``tp``: the rank's :class:`~repro_torch.models.layers.ModelGroup`;
    * ``roles``: the role of each of the layer's leaves' block along
      ``model`` (``sharding.model_role``), by its name within the layer
      (``"attn.wq"``, ``"mamba.in_x"``, ``"ffn.shared.w_down"``);
    * from the cache's specs, ``own``: whether the rank's blocks of the
      layer's cache are the ones its own blocks of the weights compute
      (K/V with the KV heads on ``model``; Mamba's state on the heads and
      its conv tails on the channels, or whole where the plan keeps them
      whole), so that no cache leaf is gathered; else (K/V with the
      sequence on ``model``, MLA's latent and rope key) :meth:`whole`
      gathers each cache leaf along its dimension on ``model`` and
      :meth:`block` cuts the rank's block of each."""

    def __init__(self, specs: dict, roles: dict, tp: ModelGroup):
        self.tp, self.roles = tp, roles
        self.dims = map_leaves(model_dim, specs)
        self.own = "state" in specs or ("k" in specs and self.dims["k"] == 2)

    def whole(self, cache):
        return map_leaves(lambda t, d: t if d is None else self.tp.gather(
            t, d), cache, self.dims)

    def block(self, cache):
        return map_leaves(lambda t, d: t if d is None else _cut(
            t, d, self.tp.m, self.tp.size), cache, self.dims)


class MeshShare:
    """A rank's share of a serving step on ``mesh``: ``tp`` and the roles
    of the model's own leaves (``embed``, ``unembed``), ``vocab_block``
    (the rank computes its block of the vocabulary's logits), a
    :class:`LayerShare` per layer in the cache's structure (``prefix``,
    ``stack``), and the FoG skip's reduction over the dp ranks."""

    def __init__(self, cfg: ArchConfig, mesh, specs: dict, param_specs: dict):
        self.mesh = mesh
        m, size = model_rank(mesh)
        self.tp = ModelGroup(m, size,
                             mesh.get_group("model") if size > 1 else None)
        roles = {k: model_role(k.rsplit(".", 1)[-1], spec)
                 for k, spec in param_specs.items()}
        self.roles = {k: r for k, r in roles.items() if "." not in k}
        self.vocab_block = self.roles.get(
            "embed" if cfg.tie_embeddings else "unembed") == "out"

        def layer(at, sp):
            return LayerShare(sp, {k[len(at):]: r for k, r in roles.items()
                                   if k.startswith(at)}, self.tp)

        self.prefix = [layer(f"prefix.{i}.", sp)
                       for i, sp in enumerate(specs["prefix"])]
        self.stack = [{k: layer(f"stack.{r}.{k}.", sp)
                       for k, sp in blk.items()}
                      for r, blk in enumerate(specs["stack"])]

    def any_live(self, live: torch.Tensor) -> bool:
        """Whether any lane of the whole batch is live: the rank's
        ``live.any()`` reduced (max) along each dp axis."""
        t = live.any().to(torch.int32)
        for axis in dp_axes(self.mesh):
            if self.mesh.size(self.mesh.mesh_dim_names.index(axis)) > 1:
                dist.all_reduce(t, op=dist.ReduceOp.MAX,
                                group=self.mesh.get_group(axis))
        return bool(t)


class _OnMesh:
    """What a mesh factory fixes: the rank's rows of a ``batch`` (its dp
    slice, or all of them where the dp size does not divide ``batch``),
    the cache's specs and global shapes (at ``max_seq`` positions, in
    ``param_dtype``), the rank's :class:`MeshShare`, and how the inputs
    and outputs are checked and placed."""

    def __init__(self, cfg: ArchConfig, mesh, dev: torch.device, batch: int,
                 max_seq: int, param_dtype: torch.dtype):
        if mesh.device_type != dev.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the step "
                             f"runs on {dev}")
        self.cfg, self.mesh, self.batch = cfg, mesh, batch
        r, n = dp_rank(mesh)
        self.bdp = dp_axes(mesh) if batch % n == 0 else None
        self.rows = (slice(r * batch // n, (r + 1) * batch // n)
                     if self.bdp else slice(None))
        self.like = T.cache_init(cfg, batch, max_seq, param_dtype,
                                 device="meta")
        self.specs = cache_shardings(cfg, mesh, self.like)
        self.share = MeshShare(cfg, mesh, self.specs, param_shardings(
            cfg, mesh, T.init_params(cfg, MetaDraws(), param_dtype,
                                     device="meta")))
        _, size = model_rank(mesh)
        self.vocab_m = ("model" in mesh.mesh_dim_names
                        and cfg.vocab_size % size == 0)

    def params(self, params: T.LM) -> T.LM:
        """The rank's parameters of a model placed on the mesh
        (:func:`step_params`)."""
        return step_params(self.cfg, self.mesh, params)

    def local_cache(self, cache):
        """The rank's blocks of a cache placed by the plan; raises
        unless each leaf is a ``DTensor`` on the mesh placed by
        ``cache_shardings``."""
        def check(d, spec, like):
            if (not is_dtensor(d) or d.device_mesh != self.mesh
                    or d.placements != placements(spec, self.mesh)
                    or d.shape != like.shape):
                raise ValueError(
                    f"a cache leaf of {tuple(d.shape)} is not placed by the "
                    f"plan ({spec}): place the cache first, "
                    f"sharding.shard_tree(cache, mesh, "
                    f"cache_shardings(cfg, mesh, cache))")
            return d.to_local()
        return map_leaves(check, cache, self.specs, self.like)

    def _placed(self, local, spec: Spec, shape):
        from torch.distributed.tensor import DTensor

        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, self.mesh,
                                  placements(spec, self.mesh),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=stride)

    def outputs(self, logits, cache, hops=None):
        """The step's outputs as ``DTensor``s placed as JAX's
        ``out_specs``: the logits are the rank's block of the vocabulary
        where ``model`` divides it (the unembedding computed that block
        alone), else whole."""
        B, V = self.batch, self.cfg.vocab_size
        out = (self._placed(logits, Spec(self.bdp, "model" if self.vocab_m
                                         else None), (B, V)),
               map_leaves(lambda t, spec, like: self._placed(
                   t, spec, like.shape), cache, self.specs, self.like))
        if hops is not None:
            out += (self._placed(hops, Spec(self.bdp), (B,)),)
        return out


def make_serve_step(cfg: ArchConfig, device=None, *, batch: int,
                    max_seq: int, fog: bool = False,
                    policy: FogPolicy | None = None,
                    param_dtype: torch.dtype = torch.bfloat16, mesh=None):
    """One-token decode for ``batch`` lanes on ``device`` (default: the
    card), at lengths below ``max_seq``; with ``mesh`` on a ``DeviceMesh``
    (the module docstring: the parameters and the cache placed by the
    plan, the outputs ``DTensor``s).

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
    on = None if mesh is None else _OnMesh(cfg, mesh, dev, batch, max_seq,
                                           param_dtype)
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
            if on is None:
                lane_policy = policy.replace(threshold=thresh,
                                             hop_budget=budget)
                return decode_step_fog(params, cfg, token, cache, length,
                                       lane_policy, embeds=embeds,
                                       backend=gate_backend)
            lane_policy = policy.replace(threshold=thresh[on.rows],
                                         hop_budget=budget[on.rows])
            return on.outputs(*decode_step_fog(
                on.params(params), cfg, rows(token), on.local_cache(cache),
                length, lane_policy, embeds=rows(embeds),
                backend=gate_backend, share=on.share))
    else:
        @torch.no_grad()
        def step(params, cache, x, length):
            token, embeds = split(x, length)
            if on is None:
                return T.decode_step(params, cfg, token, cache, length,
                                     embeds=embeds)
            return on.outputs(*T.decode_step(
                on.params(params), cfg, rows(token), on.local_cache(cache),
                length, embeds=rows(embeds), share=on.share))

    def rows(t):
        return None if t is None else t[on.rows]
    return step, inputs


def make_prefill_step(cfg: ArchConfig, device=None, *, batch: int,
                      seq_len: int, max_seq: int | None = None,
                      param_dtype: torch.dtype = torch.bfloat16, mesh=None):
    """Prefill of ``batch`` prompts of ``seq_len`` tokens on ``device``
    (default: the card): ``fn(params, tokens) -> (logits [B, V], cache)``,
    decode continuing at ``length=seq_len``.  Attention caches are padded
    to ``max_seq`` positions (default ``seq_len``): give the decode steps'
    ``max_seq`` to decode after the prompt.  For ``cfg.frontend`` the step
    takes ``embeds [B, S, d]`` (in ``param_dtype``) in place of tokens.
    With ``mesh`` the step runs on a ``DeviceMesh`` (the module
    docstring): the parameters placed by the plan, the logits and the
    cache returned as ``DTensor``s, the cache placed by the plan."""
    dev = resolve_device(device)
    key = "embeds" if cfg.frontend else "tokens"
    inputs = {key: ((batch, seq_len, cfg.d_model), param_dtype)
              if cfg.frontend else ((batch, seq_len), torch.int32)}
    on = None if mesh is None else _OnMesh(
        cfg, mesh, dev, batch, seq_len if max_seq is None else max_seq,
        param_dtype)

    @torch.no_grad()
    def step(params, x):
        _check_input(key, x, inputs[key], dev)
        if on is None:
            return T.prefill(params, cfg, max_seq=max_seq, **{key: x})
        return on.outputs(*T.prefill(on.params(params), cfg,
                                     max_seq=max_seq, share=on.share,
                                     **{key: x[on.rows]}))
    return step, inputs
