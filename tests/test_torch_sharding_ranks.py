"""repro_torch's sharding plan in action on spawned gloo ranks (CPU): 4
ranks on a (2, 2) ``("data", "model")`` ``DeviceMesh`` place narrowed
configs' parameters, optimizer states and caches by the plan
(``launch.sharding.shard_tree``, and ``train.checkpoint.restore(...,
shardings=, mesh=)`` for a model), and each rank's local block must be
the block that JAX's ``PartitionSpec`` assigns to its mesh coordinates,
``full_tensor()`` the leaf bit for bit; a ``("pod", "data")`` mesh shows
``pod`` as the batch's major factor.  Then JAX's elastic re-mesh
(``tests/test_elastic.py``): a checkpoint restored onto a 4-rank and a
2-rank ``("data",)`` mesh, from a file the port wrote and from one JAX
wrote.

The JAX side (specs, the JAX checkpoint) is computed in the test process;
the ranks import only the port, as spawned children re-import this
module."""
import functools
import math
import time
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.launch.mesh import MeshShape, make_host_mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import OptState  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

# seconds a test of spawned gloo ranks may take before it fails (as
# tests/test_torch_ring.py)
RANKS_TIMEOUT_S = 120
MESH = ((2, 2), ("data", "model"))
# narrowed so that some dims divide 2 and some do not: an odd vocabulary
# (the embedding shards d_model), one KV head, 3 experts (TP within an
# expert) beside jamba's 8 (expert parallel); Mamba, attention, MLA, MoE
# with a shared expert, the dense prefix and the MTP head
NARROW = {"jamba-1.5-large-398b": dict(vocab_size=509, n_kv_heads=1),
          "deepseek-v3-671b": dict(vocab_size=509, n_experts=3)}
CACHES = (2, 3)          # a batch the data axis divides, and one it does not
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def port_cfg(arch):
    return smoke_config(arch).scaled(**NARROW[arch])


def block(full: torch.Tensor, spec, coord: dict, sizes: dict):
    """The block of ``full`` that ``spec`` (JAX's entries) gives the device
    at mesh coordinates ``coord``: each dim split over its axes' sizes, the
    first axis the major factor."""
    index = []
    for n, part in zip(full.shape, spec):
        axes = () if part is None else (
            part if isinstance(part, tuple) else (part,))
        i, k = 0, 1
        for a in axes:
            i, k = i * sizes[a] + coord[a], k * sizes[a]
        index.append(slice(i * n // k, (i + 1) * n // k))
    return full[tuple(index)]


def check_leaf(what, d, full, spec, mesh) -> None:
    from torch.distributed.tensor import DTensor

    assert isinstance(d, DTensor), what
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    want = block(full, spec, coord, sizes)
    local = d.to_local()
    assert local.dtype == full.dtype and torch.equal(local, want), (
        what, spec, coord, tuple(local.shape), tuple(want.shape))
    assert torch.equal(d.full_tensor(), full), what


def randomized(tree, gen):
    """``tree`` with each tensor replaced by normal draws in its dtype."""
    if isinstance(tree, dict):
        return {k: randomized(v, gen) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(randomized(v, gen) for v in tree)
    return torch.randn(tree.shape, generator=gen).to(tree.dtype)


def jax_key(name: str) -> tuple:
    parts = tuple(name.split("."))
    return (parts[0], *parts[2:]) if parts[0] == "stack" else parts


def flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, (*path, str(k)))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, S.Spec):
        for i, v in enumerate(tree):
            yield from flat(v, (*path, str(i)))
    else:
        yield path, tree


def jax_spec(specs: dict, path: tuple):
    """JAX's spec of a port leaf: a stack leaf's less its leading None."""
    want = specs[jax_key(".".join(path))]
    return want[1:] if path[0] == "stack" else want


# ------------------------------------------------------------ the ranks

def _plan_rank(rank, world, case, out_dir):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", MESH[0], mesh_dim_names=MESH[1])
    shape = MeshShape.of(mesh)
    dtype = DTYPES[case["dtype"]]
    n = 0
    for arch, want in case["jax"].items():
        cfg = port_cfg(arch)
        lm = T.init_params(cfg, torch.Generator().manual_seed(0), dtype,
                           device="cpu")
        named = {k: p.detach() for k, p in lm.named_parameters()}
        specs = S.param_shardings(cfg, shape, lm, fsdp=True)
        for k, s in specs.items():
            assert tuple(s) == jax_spec(want["params"], (*k.split("."),)), k
        # the model by shard_tree, and by restore from a checkpoint
        placed = S.shard_tree(lm, mesh, specs)
        if rank == 0:
            ckpt.save(1, lm, f"{out_dir}/{arch}-{case['dtype']}")
        dist.barrier()
        restored, step = ckpt.restore(lm, f"{out_dir}/{arch}-{case['dtype']}",
                                      shardings=specs, mesh=mesh)
        assert step == 1 and isinstance(restored, T.LM)
        for model in (placed, restored):
            got = dict(model.named_parameters())
            assert list(got) == list(named)
            for k, full in named.items():
                spec = jax_spec(want["params"], (*k.split("."),))
                check_leaf(f"{arch} {k}", got[k].data, full, spec, mesh)
                n += 1
        # the optimizer's state: the moments by the parameters' specs
        gen = torch.Generator().manual_seed(1)
        opt = OptState(step=torch.tensor(5, dtype=torch.int32),
                       mu={k: torch.randn(p.shape, generator=gen)
                           for k, p in named.items()},
                       nu={k: torch.rand(p.shape, generator=gen)
                           for k, p in named.items()})
        got = S.shard_tree(opt, mesh, S.opt_shardings(cfg, shape, lm,
                                                      fsdp=True))
        check_leaf("step", got.step, opt.step, (), mesh)
        for m in ("mu", "nu"):
            for k, full in getattr(opt, m).items():
                spec = jax_spec(want["params"], (*k.split("."),))
                check_leaf(f"{arch} {m} {k}", getattr(got, m)[k], full, spec,
                           mesh)
                n += 1
        # caches whose batch the data axis divides, and one it does not
        for batch in CACHES:
            cache = randomized(T.cache_init(cfg, batch, 16, dtype,
                                            device="cpu"),
                               torch.Generator().manual_seed(batch))
            cspecs = S.cache_shardings(cfg, shape, cache)
            got = dict(flat(S.shard_tree(cache, mesh, cspecs)))
            for path, full in flat(cache):
                spec = jax_spec(want["cache"][batch], path)
                assert tuple(dict(flat(cspecs))[path]) == spec, path
                check_leaf(f"{arch} cache {batch} {path}", got[path], full,
                           spec, mesh)
                n += 1
    # pod is the batch's major factor: rank (pod, data) holds block
    # pod * 2 + data of the rows
    pods = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    rows = torch.arange(24.0).reshape(8, 3)
    spec = S.act_spec(MeshShape.of(pods))
    assert S.placements(spec, pods)[0] == S.placements(spec, pods)[1]
    d = S.shard_tree(rows, pods, spec)
    pod, data = pods.get_coordinate()
    assert torch.equal(d.to_local(), rows[2 * (2 * pod + data):][:2])
    check_leaf("batch", d, rows, (("pod", "data"), None), pods)
    torch.save({"leaves": n, "coord": (pod, data)}, f"{out_dir}/rank{rank}.pt")


def _elastic_rank(rank, world, case, out_dir):
    from torch.distributed.tensor import Shard

    mesh = make_host_mesh()
    assert MeshShape.of(mesh) == MeshShape(("data",), (world,))
    assert mesh.device_type == "cpu"
    want = torch.arange(64.0).reshape(8, 8)
    like = {"w": torch.zeros(8, 8), "step": torch.zeros((), dtype=torch.int32)}
    specs = {"w": S.Spec("data", None), "step": S.Spec()}
    for src in ("port", "jax"):
        tree, step = ckpt.restore(like, f"{out_dir}/{src}", shardings=specs,
                                  mesh=mesh)
        assert step == 3
        assert tree["w"].placements == (Shard(0),)
        assert tree["w"].device_mesh.shape == (world,)
        check_leaf(f"{src} w", tree["w"], want, ("data", None), mesh)
        assert int(tree["step"].full_tensor()) == 3
    torch.save({"leaves": 2}, f"{out_dir}/rank{rank}.pt")


def _rank_main(rank, world, init_file, fn, case, out_dir):
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        torch.set_num_threads(1)
        fn(rank, world, case, out_dir)
    finally:
        dist.destroy_process_group()


def run_ranks(world, fn, case, tmp_path):
    """Spawn ``world`` gloo ranks on the CPU; their records in rank
    order."""
    ctx = mp.start_processes(
        _rank_main, args=(world, str(tmp_path / "init"), fn, case,
                          str(tmp_path)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"{world} gloo ranks did not finish in "
                            f"{RANKS_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(5)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


# ------------------------------------------------------------- the tests

@functools.lru_cache(maxsize=None)
def jax_specs(arch) -> dict:
    """JAX's parameter specs (FSDP on) and cache specs at each batch of
    ``CACHES`` for the narrowed config, by JAX path."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh, PartitionSpec as P

    from repro.configs import smoke_config as jsmoke
    from repro.launch import sharding as js
    from repro.models import transformer as JT

    def by_path(tree):
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]
        return {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): tuple(s) for path, s in leaves}

    jcfg = jsmoke(arch).scaled(**NARROW[arch])
    am = AbstractMesh(*MESH)
    jp = jax.eval_shape(lambda k: JT.init_params(jcfg, k, jnp.float32),
                        jax.random.key(0))
    cache = {b: by_path(js.cache_shardings(jcfg, am, jax.eval_shape(
        functools.partial(JT.cache_init, jcfg, b, 16, jnp.float32))))
        for b in CACHES}
    return {"params": by_path(js.param_shardings(jcfg, am, jp, fsdp=True)),
            "cache": cache}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plan_places_jax_blocks_on_4_ranks(tmp_path, dtype):
    case = {"dtype": dtype, "jax": {a: jax_specs(a) for a in NARROW}}
    # the cases reach specs that split a dim, and ones that keep it whole
    parts = [p for a in NARROW for s in case["jax"][a]["params"].values()
             for p in s]
    assert {"data", "model", None} <= set(parts)
    got = run_ranks(4, _plan_rank, case, tmp_path)
    assert sorted(r["coord"] for r in got) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    n_params = sum(len(list(T.init_params(
        port_cfg(a), torch.Generator().manual_seed(0), DTYPES[dtype],
        device="cpu").parameters())) for a in NARROW)
    assert all(r["leaves"] > 4 * n_params for r in got)


@pytest.mark.parametrize("world", [4, 2])
def test_elastic_restore(tmp_path, world):
    """JAX's ``tests/test_elastic.py`` scenario: a checkpoint restored onto
    a ("data",) mesh of ``world`` ranks, from the port's file and JAX's."""
    import jax.numpy as jnp

    from repro.train import checkpoint as jckpt

    ckpt.save(3, {"w": torch.arange(64.0).reshape(8, 8),
                  "step": torch.tensor(3, dtype=torch.int32)},
              tmp_path / "port")
    jckpt.save(3, {"w": jnp.arange(64.0).reshape(8, 8),
                   "step": jnp.int32(3)}, str(tmp_path / "jax"))
    for src in ("port", "jax"):
        with np.load(tmp_path / src / "step_00000003" / "shard_0.npz") as f:
            assert f["w"].dtype == np.float32 and math.prod(f["w"].shape) == 64
    assert len(run_ranks(world, _elastic_rank, {}, tmp_path)) == world
