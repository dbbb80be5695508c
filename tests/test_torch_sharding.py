"""repro_torch's sharding plan (``launch/sharding.py``, ``launch/mesh.py``)
against the JAX package's on the CPU, with no ranks: every parameter and
cache leaf's spec equal to JAX's ``PartitionSpec`` for all 10 configs at
JAX's production meshes (16 x 16, 2 x 16 x 16) and a small (2, 4) one,
FSDP automatic and forced each way (a stack leaf per repeat, less JAX's
leading ``[n_repeat]`` axis); ``use_fsdp``, ``batch_spec``, ``act_spec``,
the mesh helpers and the optimizer's specs; the spec's placements; and
``dryrun --mesh``'s per-device parameter bytes against the sum over
JAX's specs and leaf shapes."""
import functools
import json
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import sharding as js  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.launch.mesh import (MeshShape, dp_axes,  # noqa: E402
                                     make_host_mesh, model_axis_size,
                                     production_mesh_shape)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import MetaDraws  # noqa: E402
from repro_torch.optim import OptState  # noqa: E402

ARCHS = sorted(JARCHS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
# the cache shapes of tests/test_sharding.py, and a batch of one
CACHES = ((128, 1024), (1, 1024))


def meshes(name):
    """(JAX's AbstractMesh, the port's MeshShape) of one shape."""
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), MeshShape(axes, sizes)


@functools.lru_cache(maxsize=None)
def trees(arch):
    """(JAX's eval_shape params, the port's model on meta), bf16 at full
    width."""
    jcfg = JARCHS[arch]
    jp = jax.eval_shape(lambda k: JT.init_params(jcfg, k, jnp.bfloat16),
                        jax.random.key(0))
    return jp, T.init_params(get_arch(arch), MetaDraws(), torch.bfloat16,
                             device="meta")


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))


def jax_leaves(tree, is_leaf=None) -> dict:
    """JAX leaves by their path's keys."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {tuple(_key(k) for k in path): leaf for path, leaf in flat}


def jax_specs(specs) -> dict:
    return {k: tuple(v) for k, v in
            jax_leaves(specs, lambda x: isinstance(x, P)).items()}


def jax_key(parts: tuple) -> tuple:
    """The JAX path of a port path: a stack's repeat index dropped."""
    return (parts[0], *parts[2:]) if parts[0] == "stack" else parts


def port_leaves(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_leaves(v, (*path, str(k))))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, S.Spec):
        out = {}
        for i, v in enumerate(tree):
            out.update(port_leaves(v, (*path, str(i))))
        return out
    return {path: tree}


def assert_specs_equal(port: dict, jax_: dict):
    """Each port leaf's spec == JAX's, a stack leaf's less its leading
    None; every JAX leaf reached."""
    seen = set()
    for parts, spec in port.items():
        key = jax_key(parts)
        want = jax_[key]
        if parts[0] == "stack":
            assert want[0] is None, (key, want)
            want = want[1:]
        assert isinstance(spec, S.Spec), (parts, spec)
        assert tuple(spec) == want, (parts, spec, want)
        seen.add(key)
    assert seen == set(jax_), sorted(set(jax_) ^ seen)[:4]


@pytest.mark.parametrize("arch", ARCHS)
def test_use_fsdp_equals_jax(arch):
    assert S.use_fsdp(get_arch(arch)) == js.use_fsdp(JARCHS[arch])
    assert S.FSDP_THRESHOLD == js.FSDP_THRESHOLD


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, mesh):
    """Every parameter leaf, FSDP automatic and forced each way."""
    jp, lm = trees(arch)
    am, ms = meshes(mesh)
    for fsdp in (None, True, False):
        got = S.param_shardings(get_arch(arch), ms, lm, fsdp=fsdp)
        assert list(got) == [k for k, _ in lm.named_parameters()]
        want = jax_specs(js.param_shardings(JARCHS[arch], am, jp, fsdp=fsdp))
        assert_specs_equal({tuple(k.split(".")): v for k, v in got.items()},
                           want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(arch, mesh):
    """Every cache leaf at batch 128 and 1 (1024 positions)."""
    am, ms = meshes(mesh)
    cfg, jcfg = get_arch(arch), JARCHS[arch]
    for batch, seq in CACHES:
        cache = T.cache_init(cfg, batch, seq, torch.bfloat16, device="meta")
        jc = jax.eval_shape(functools.partial(JT.cache_init, jcfg, batch, seq,
                                              jnp.bfloat16))
        got = port_leaves(S.cache_shardings(cfg, ms, cache))
        shapes = port_leaves(cache)
        jshapes = jax_leaves(jc)
        for parts, t in shapes.items():
            want = jshapes[jax_key(parts)].shape
            assert tuple(t.shape) == (want[1:] if parts[0] == "stack"
                                      else want), parts
        assert_specs_equal(got, jax_specs(js.cache_shardings(jcfg, am, jc)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_helpers_batch_and_act_specs_equal_jax(mesh):
    am, ms = meshes(mesh)
    assert dp_axes(ms) == jmesh.dp_axes(am)
    assert model_axis_size(ms) == jmesh.model_axis_size(am)
    assert ms.shape == dict(am.shape) and ms.axis_names == am.axis_names
    assert tuple(S.batch_spec(ms)) == tuple(js.batch_spec(am))
    assert tuple(S.act_spec(ms)) == tuple(js.act_spec(am))


def test_production_mesh_shapes():
    assert production_mesh_shape() == MeshShape(("data", "model"), (16, 16))
    assert production_mesh_shape(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    assert MeshShape.of(production_mesh_shape()) == production_mesh_shape()
    with pytest.raises(ValueError, match="mesh of axes"):
        MeshShape(("data", "data"), (2, 2))
    with pytest.raises(ValueError, match="mesh of axes"):
        MeshShape(("data",), (2, 2))


def test_host_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        make_host_mesh()


def test_placements():
    """The batch on ("pod", "data") takes Shard(0) on both, in the mesh's
    order; an axis out of that order, unknown or named twice raises."""
    from torch.distributed.tensor import Replicate, Shard

    multi = production_mesh_shape(multi_pod=True)
    assert S.placements(S.batch_spec(multi), multi) == (
        Shard(0), Shard(0), Replicate())
    assert S.placements(S.Spec(None, "model", "data"), multi) == (
        Replicate(), Shard(2), Shard(1))
    assert S.placements(S.Spec(), multi) == (Replicate(),) * 3
    for bad in (S.Spec(("data", "pod")), S.Spec("pipe"),
                S.Spec("data", "data")):
        with pytest.raises(ValueError):
            S.placements(bad, multi)


def test_spec_is_partition_spec_by_value():
    for parts in ((("data",), None), (("pod", "data"),), ((), "model"),
                  (None, None, "model")):
        assert tuple(S.Spec(*parts)) == tuple(P(*parts)), parts
    assert S.Spec(("data",)) == S.Spec("data")
    assert repr(S.Spec("data", None)) == "Spec('data', None)"
    multi = production_mesh_shape(multi_pod=True)
    assert S.shards(S.Spec(("pod", "data"), "model"), multi) == 512
    assert S.local_numel((64, 32), S.Spec(("pod", "data"), "model"),
                         multi) == 4
    with pytest.raises(ValueError, match="does not split"):
        S.local_numel((48, 32), S.Spec(("pod", "data"), None), multi)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "grok-1-314b"])
def test_opt_specs_equal_jax(arch):
    """JAX's train step: ``OptState(step=P(), mu=p_specs, nu=p_specs)``."""
    _, lm = trees(arch)
    ms = production_mesh_shape()
    specs = S.opt_shardings(get_arch(arch), ms, lm)
    p = S.param_shardings(get_arch(arch), ms, lm)
    assert isinstance(specs, OptState) and tuple(specs.step) == tuple(P())
    assert specs.mu == p and specs.nu == p


def _spec(arch, mesh, name, fsdp=None):
    return S.param_shardings(get_arch(arch), meshes(mesh)[1],
                             trees(arch)[1], fsdp=fsdp)[name]


def test_named_fallbacks_reached():
    """The fallbacks JAX names, at 16 x 16 (each also held to JAX's spec
    above)."""
    m = "16x16"
    # one KV head (granite-34b, gemma-2b): the heads stay whole
    assert _spec("granite-34b", m, "stack.0.pos0.attn.wk")[1] is None
    assert get_arch("gemma-2b").n_kv_heads == 1
    assert _spec("gemma-2b", m, "stack.0.pos0.attn.wk") == (None,) * 3
    # 8 query heads on 16 (gemma), 40 (minicpm3's MLA): d_model / the rank
    assert _spec("gemma-2b", m, "stack.0.pos0.attn.wq") == (
        "model", None, None)
    assert _spec("minicpm3-4b", m, "stack.0.pos0.attn.w_uq") == (
        "model", None, None)
    # odd vocabularies: the embedding shards d_model
    for arch in ("minicpm3-4b", "mamba2-2.7b"):
        assert _spec(arch, m, "embed") == (None, "model"), arch
    assert _spec("tinyllama-1.1b", m, "embed") == ("model", None)
    # grok's 8 experts on 16: TP within an expert, FSDP on d_model
    assert _spec("grok-1-314b", m, "stack.0.pos0.ffn.w_gate") == (
        None, "data", "model")
    assert _spec("deepseek-v3-671b", m, "stack.0.pos0.ffn.w_gate") == (
        "model", "data", None)
    # the shared expert is 2-D: the dense rule
    assert _spec("deepseek-v3-671b", m,
                 "stack.0.pos0.ffn.shared.w_down") == ("model", "data")
    # w_dkv's packed dim stays whole
    assert _spec("deepseek-v3-671b", m, "prefix.0.attn.w_dkv") == (
        "data", None)
    assert _spec("deepseek-v3-671b", m, "prefix.0.attn.w_dkv",
                 fsdp=False) == (None, None)


def test_cache_batch_of_one_replicates():
    cfg = get_arch("tinyllama-1.1b")
    ms = production_mesh_shape(multi_pod=True)
    one = S.cache_shardings(cfg, ms, T.cache_init(cfg, 1, 1024,
                                                  device="meta"))
    many = S.cache_shardings(cfg, ms, T.cache_init(cfg, 32, 1024,
                                                   device="meta"))
    assert one["stack"][0]["pos0"]["k"][0] is None
    assert many["stack"][0]["pos0"]["k"][0] == ("pod", "data")
    # mamba's conv tails (a tuple) take the last rule, not one on "conv"
    mcfg = get_arch("mamba2-2.7b")
    c = S.cache_shardings(mcfg, ms, T.cache_init(mcfg, 32, 1024,
                                                 device="meta"))
    conv = c["stack"][0]["pos0"]["conv"]
    assert isinstance(conv, tuple) and [tuple(s) for s in conv] == [
        (("pod", "data"), None, "model")] * 3


def jax_local_bytes(specs, shapes, sizes: dict) -> int:
    """Sum over JAX's leaves of numel / the spec's shards x itemsize."""
    total = 0
    for key, leaf in jax_leaves(shapes).items():
        n = math.prod(sizes[a] for part in specs[key] if part is not None
                      for a in (part if isinstance(part, tuple) else (part,)))
        assert math.prod(leaf.shape) % n == 0, key
        total += math.prod(leaf.shape) // n * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_param_bytes_equal_jax(arch, mesh):
    """``dryrun --mesh``'s per-device parameter bytes, exactly."""
    jp, lm = trees(arch)
    am, _ = meshes(mesh)
    rec = dryrun.per_device_state(get_arch(arch), mesh, lm, {})
    want = jax_local_bytes(
        jax_specs(js.param_shardings(JARCHS[arch], am, jp)), jp,
        dict(am.shape))
    assert rec["param_bytes"] == want
    assert rec["grad_bytes"] == rec["moment_bytes"] == rec["cache_bytes"] == 0
    assert rec["fsdp"] == js.use_fsdp(JARCHS[arch])
    assert rec["activations_divided"] is False


def test_dryrun_mesh_cli(tmp_path, capsys):
    """A train cell's record with ``--mesh``: grads as the params, the
    fp32 moments twice their numel's, each under the plan; the one-card
    figures unchanged beside them."""
    out = tmp_path / "cells.jsonl"
    assert dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k",
                        "--mesh", "2x16x16", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    pd = rec["per_device"]
    _, lm = trees("tinyllama-1.1b")
    ms = production_mesh_shape(multi_pod=True)
    specs = S.param_shardings(get_arch("tinyllama-1.1b"), ms, lm)
    numel = sum(S.local_numel(p.shape, specs[k], ms)
                for k, p in lm.named_parameters())
    assert pd["mesh"] == "2x16x16" and pd["fsdp"] is False
    assert pd["param_bytes"] == pd["grad_bytes"] == 2 * numel
    assert pd["moment_bytes"] == 2 * 4 * numel
    assert pd["state_bytes"] == 12 * numel and pd["cache_bytes"] == 0
    assert pd["activations_divided"] is False
    # no FSDP at 1.1B: the model axis alone splits, so 16-way at most
    assert rec["param_bytes"] / 16 <= pd["param_bytes"] < rec["param_bytes"]
    assert "on 2x16x16 (FSDP off)" in capsys.readouterr().out
