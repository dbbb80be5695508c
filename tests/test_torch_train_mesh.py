"""repro_torch's train step on a mesh (``make_train_step(..., mesh=)``),
the training CLI on the host mesh and checkpoints saved from a mesh, on
spawned gloo ranks on the CPU.

The oracle: data parallelism over ``n`` dp ranks is, in arithmetic,
``n``-step gradient accumulation (each rank takes one microbatch of the
global batch, and the ranks' gradients are summed in rank order into a
float32 zero, then times ``1 / n``), and the one-process step with
``accum_steps=n`` is held to JAX's step body (below, and in
``tests/test_torch_train_accum.py``).  JAX's own sharded step cannot run
here (``constrain_batch`` asserts under explicit mesh axes in jax 0.9,
ROADMAP §C), so it is not the oracle.

Cases, one spawn per mesh shape:
  * 4 ranks on ``("data",)``: tinyllama's smoke config in fp32 and bf16,
    two steps, bit-equal to the one-process ``accum_steps=4`` steps
    (loss, grad norm, every parameter and moment, local block and
    whole); the state saved from the mesh is the one-process file leaf
    for leaf, and JAX's ``restore`` reads the fp32 one.
  * 4 ranks on ``(2, 2)`` ``("data", "model")``: narrowed jamba and
    deepseek (``tests/test_torch_sharding_ranks.py``'s), FSDP automatic
    and forced: each rank's block of every parameter and moment is the
    block JAX's ``PartitionSpec`` gives its coordinates of the
    one-process ``accum_steps=2`` state.
  * 4 ranks on ``(2, 2)`` ``("pod", "data")`` with ``compress_pod_grads``:
    bit-equal to the one-process ``accum_steps=4`` step; ``pod`` is the
    batch's major factor.
  * 2 ranks through ``launch.train.main`` (``torchrun``'s environment,
    ``--device cpu --smoke``): the losses equal the one-process run's at
    ``accum_steps=2``; a run stopped after its step-2 checkpoint and
    resumed on 2 ranks equals the uninterrupted one bit for bit (losses
    and the step-4 file); the 4-rank file restores onto the 2-rank mesh.

The ranks import only the port (spawned children re-import this module);
the JAX side is computed in the test process."""
import functools
import json
import os
import socket
import time
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data.lm_data import DataConfig  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.launch.mesh import dp_rank, make_host_mesh  # noqa: E402
from repro_torch.launch.train import step_batch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.loop import make_train_step  # noqa: E402

# seconds a spawn of gloo ranks may take before it fails (as
# tests/test_torch_sharding_ranks.py)
RANKS_TIMEOUT_S = 120
CPU = torch.device("cpu")
ARCH = "tinyllama-1.1b"
B, SEQ, STEPS = 8, 32, 2
LR, WARMUP, TOTAL = 5e-3, 1, 30
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# tests/test_torch_sharding_ranks.py's narrowed configs: an odd
# vocabulary, one KV head, 3 experts (TP within an expert) beside jamba's
# 8; Mamba, attention, MLA, MoE with a shared expert, the dense prefix and
# the MTP head
NARROW = {"jamba-1.5-large-398b": dict(vocab_size=509, n_kv_heads=1),
          "deepseek-v3-671b": dict(vocab_size=509, n_experts=3)}
GRID = ((2, 2), ("data", "model"))
GRID_B = 2               # a row a dp rank
FSDP = {"auto": None, "forced": True}
CLI_ARGS = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
            "--seq", str(SEQ), "--lr", "5e-2", "--log-every", "1",
            "--ckpt-every", "2"]
CLI_STEPS = 4


def narrow_cfg(arch):
    return smoke_config(arch).scaled(**NARROW[arch])


def fresh(cfg, dtype):
    return T.init_params(cfg, torch.Generator().manual_seed(0), dtype,
                         device="cpu")


def run_steps(cfg, step_fn, params, opt, batch_size, steps=STEPS):
    """``steps`` steps from ``params`` on ``step_batch``'s batches;
    (params, opt, losses, grad norms)."""
    dcfg = DataConfig(cfg.vocab_size, SEQ, batch_size, seed=0)
    losses, norms = [], []
    for i in range(steps):
        params, opt, m = step_fn(params, opt, step_batch(cfg, dcfg, i, CPU))
        losses.append(m["loss"].clone())
        norms.append(m["grad_norm"].clone())
    return params, opt, losses, norms


def one_and_mesh(cfg, dtype, mesh, n, batch_size, **kw):
    """The one-process run at ``accum_steps=n`` and the mesh run at
    ``accum_steps=1`` from the same init."""
    kw = dict(lr=LR, warmup=WARMUP, total_steps=TOTAL, device="cpu", **kw)
    step1, init1 = make_train_step(cfg, accum_steps=n, **kw)
    p = fresh(cfg, dtype)
    one = run_steps(cfg, step1, p, init1(p), batch_size)
    p = fresh(cfg, dtype)
    placed = S.shard_tree(p, mesh, S.param_shardings(cfg, mesh, p))
    stepm, initm = make_train_step(cfg, mesh=mesh, **kw)
    return one, run_steps(cfg, stepm, placed, initm(placed), batch_size)


def same_run(what, mesh_run, one_run) -> int:
    """Losses and grad norms equal bit for bit, and every parameter and
    moment's local block and whole tensor; returns the leaves checked."""
    pm, om, lm, nm = mesh_run
    p1, o1, l1, n1 = one_run
    for a, b in zip(lm + nm, l1 + n1, strict=True):
        assert torch.equal(a, b), (what, a, b)
    whole = {k: p.detach() for k, p in p1.named_parameters()}
    n = 0
    for tree, want in ((dict(pm.named_parameters()), whole),
                       (om.mu, o1.mu), (om.nu, o1.nu)):
        assert list(tree) == list(want), what
        for k, d in tree.items():
            assert d.dtype == want[k].dtype, (what, k)
            assert torch.equal(d.to_local(), S.local_block(want[k], d)), (
                what, k)
            assert torch.equal(d.full_tensor(), want[k]), (what, k)
            n += 1
    assert int(om.step.full_tensor()) == int(o1.step) == STEPS
    return n


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


def jax_spec(specs: dict, name: str):
    """JAX's spec of a port parameter: a stack leaf's less its leading
    None."""
    parts = tuple(name.split("."))
    if parts[0] == "stack":
        return specs[(parts[0], *parts[2:])][1:]
    return specs[parts]


def leaves_of(directory, step) -> dict:
    with np.load(f"{directory}/step_{step:08d}/shard_0.npz") as f:
        return {k: f[k] for k in f.files}


# ------------------------------------------------------------ the ranks

def _data_rank(rank, world, case, out_dir):
    """4 ranks on ("data",): tinyllama smoke, fp32 and bf16."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    cfg = smoke_config(ARCH)
    rec = {"dp": dp_rank(mesh), "leaves": {}, "losses": {}}
    for name, dtype in DTYPES.items():
        one, on_mesh = one_and_mesh(cfg, dtype, mesh, world, B)
        rec["leaves"][name] = same_run(name, on_mesh, one)
        rec["losses"][name] = [float(x) for x in on_mesh[2]]
        # the fault the repair closes: a DTensor does not go to numpy
        # (what checkpoint.save did with every leaf)
        d = next(on_mesh[0].parameters())
        try:
            d.detach().cpu().numpy()
            rec["numpy_error"] = None
        except RuntimeError as e:
            rec["numpy_error"] = str(e)
        ckpt.save(STEPS, on_mesh[:2], f"{out_dir}/{name}-mesh")
        if rank == 0:
            ckpt.save(STEPS, one[:2], f"{out_dir}/{name}-one")
        dist.barrier()
    # a model not placed on the mesh is refused
    step_fn, _ = make_train_step(cfg, device="cpu", mesh=mesh)
    try:
        step_fn(fresh(cfg, torch.float32), None, {})
        rec["refused"] = None
    except ValueError as e:
        rec["refused"] = str(e)
    torch.save(rec, f"{out_dir}/rank{rank}.pt")


def _grid_rank(rank, world, case, out_dir):
    """4 ranks on (2, 2) ("data", "model"): each rank's blocks are JAX's."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", GRID[0], mesh_dim_names=GRID[1])
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    r, n = dp_rank(mesh)
    assert (r, n) == (coord["data"], 2)
    rec = {"coord": (coord["data"], coord["model"]), "leaves": {}}
    for arch in NARROW:
        cfg = narrow_cfg(arch)
        step1, init1 = make_train_step(cfg, lr=LR, warmup=WARMUP,
                                       total_steps=TOTAL, device="cpu",
                                       accum_steps=n)
        p = fresh(cfg, torch.float32)
        pw, ow, lw, nw = run_steps(cfg, step1, p, init1(p), GRID_B)
        whole = {k: t.detach() for k, t in pw.named_parameters()}
        for label, fsdp in FSDP.items():
            specs = case[arch][label]
            p = fresh(cfg, torch.float32)
            placed = S.shard_tree(p, mesh,
                                  S.param_shardings(cfg, mesh, p, fsdp))
            stepm, initm = make_train_step(cfg, lr=LR, warmup=WARMUP,
                                           total_steps=TOTAL, device="cpu",
                                           mesh=mesh)
            pm, om, lm, nm = run_steps(cfg, stepm, placed, initm(placed),
                                       GRID_B)
            for a, b in zip(lm + nm, lw + nw, strict=True):
                assert torch.equal(a, b), (arch, label, a, b)
            count = 0
            for tree, want in ((dict(pm.named_parameters()), whole),
                               (om.mu, ow.mu), (om.nu, ow.nu)):
                for k, d in tree.items():
                    spec = jax_spec(specs, k)
                    got = d.to_local()
                    assert torch.equal(got, block(want[k], spec, coord,
                                                  sizes)), (arch, label, k,
                                                            spec)
                    count += 1
            rec["leaves"][f"{arch}-{label}"] = count
    torch.save(rec, f"{out_dir}/rank{rank}.pt")


def _pod_rank(rank, world, case, out_dir):
    """4 ranks on (2, 2) ("pod", "data"), compressed gradients."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    pod, data = mesh.get_coordinate()
    one, on_mesh = one_and_mesh(smoke_config(ARCH), torch.float32, mesh,
                                world, B, compress_pod_grads=True)
    leaves = same_run("compressed", on_mesh, one)
    torch.save({"coord": (pod, data), "dp": dp_rank(mesh), "leaves": leaves},
               f"{out_dir}/rank{rank}.pt")


def _cli_rank(rank, world, case, out_dir):
    """2 ranks through the CLI's own process group (torchrun's
    environment), then the 4-rank file restored onto a 2-rank mesh."""
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1")
    runs = {}
    for (name, extra), port in zip((
            ("straight", ["--steps", str(CLI_STEPS), "--ckpt-dir",
                          f"{out_dir}/cli-straight"]),
            ("first", ["--steps", "2", "--ckpt-dir",
                       f"{out_dir}/cli-resumed"]),
            ("resumed", ["--steps", str(CLI_STEPS), "--resume",
                         "--ckpt-dir", f"{out_dir}/cli-resumed"])),
            case["ports"]):
        os.environ["MASTER_PORT"] = str(port)
        got = cli.main(CLI_ARGS + extra)
        assert not dist.is_initialized()
        runs[name] = {"steps": got["steps"], "losses": got["losses"]}
    # the one-process run at accum_steps=2, as the CLI runs it
    cfg = smoke_config(ARCH)
    step_fn, init_opt = make_train_step(cfg, lr=5e-2, total_steps=CLI_STEPS,
                                        device="cpu", accum_steps=world)
    p = T.init_params(cfg, torch.Generator(device=CPU).manual_seed(0),
                      torch.float32, device=CPU)
    o = init_opt(p)
    dcfg = DataConfig(cfg.vocab_size, SEQ, 4, seed=0)
    runs["one"] = {"losses": []}
    for i in range(CLI_STEPS):
        p, o, m = step_fn(p, o, step_batch(cfg, dcfg, i, CPU))
        runs["one"]["losses"].append(float(m["loss"]))
    # the file 4 ranks wrote, restored onto this 2-rank mesh
    dist.init_process_group("gloo", init_method=f"file://{case['init']}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    mesh = make_host_mesh()
    p = fresh(cfg, torch.float32)
    like = (p, make_train_step(cfg, device="cpu")[1](p))
    want, _ = ckpt.restore(like, f"{out_dir}/fp32-one")
    specs = (S.param_shardings(cfg, mesh, p), S.opt_shardings(cfg, mesh, p))
    got, step = ckpt.restore(like, f"{out_dir}/fp32-mesh", shardings=specs,
                             mesh=mesh)
    n = 0
    for tree, ref in ((dict(got[0].named_parameters()),
                       dict(want[0].named_parameters())),
                      (got[1].mu, want[1].mu), (got[1].nu, want[1].nu)):
        for k, d in tree.items():
            assert d.device_mesh.shape == (world,), k
            assert torch.equal(d.to_local(), S.local_block(ref[k].detach(),
                                                           d)), k
            n += 1
    assert step == STEPS and int(got[1].step.full_tensor()) == STEPS
    runs["restored_leaves"] = n
    torch.save(runs, f"{out_dir}/rank{rank}.pt")


def _rank_main(rank, world, init_file, fn, case, out_dir):
    if fn is not _cli_rank:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=60))
    try:
        torch.set_num_threads(1)
        fn(rank, world, case, out_dir)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(world, fn, case, out_dir):
    """Spawn ``world`` gloo ranks on the CPU; their records in rank
    order."""
    ctx = mp.start_processes(
        _rank_main, args=(world, str(out_dir / f"init-{fn.__name__}"), fn,
                          case, str(out_dir)),
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
    return [torch.load(out_dir / f"rank{r}.pt") for r in range(world)]


def free_ports(n: int) -> list[int]:
    """``n`` distinct free TCP ports on localhost, for the CLI's
    ``MASTER_PORT`` (``torchrun``'s rendezvous)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


# ------------------------------------------------------------ the spawns

@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh")


@pytest.fixture(scope="module")
def data_ranks(out_dir):
    where = out_dir / "data"
    where.mkdir()
    return where, run_ranks(4, _data_rank, {}, where)


@functools.lru_cache(maxsize=None)
def jax_param_specs(arch: str, fsdp: bool | None) -> dict:
    """JAX's parameter specs of the narrowed config on ``GRID``, by JAX
    path."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh, PartitionSpec as P

    from repro.configs import smoke_config as jsmoke
    from repro.launch import sharding as js
    from repro.models import transformer as JT

    jcfg = jsmoke(arch).scaled(**NARROW[arch])
    jp = jax.eval_shape(lambda k: JT.init_params(jcfg, k, jnp.float32),
                        jax.random.key(0))
    leaves = jax.tree_util.tree_flatten_with_path(
        js.param_shardings(jcfg, AbstractMesh(*GRID), jp, fsdp=fsdp),
        is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in path): tuple(s) for path, s in leaves}


@pytest.fixture(scope="module")
def grid_ranks(out_dir):
    case = {a: {label: jax_param_specs(a, fsdp)
                for label, fsdp in FSDP.items()} for a in NARROW}
    # the cases reach specs that split on each axis, and ones that do not
    parts = {p for a in NARROW for s in case[a]["forced"].values()
             for p in s}
    assert {"data", "model", None} <= parts
    auto = {p for a in NARROW for s in case[a]["auto"].values() for p in s}
    assert "data" not in auto          # smoke configs are under FSDP's bar
    where = out_dir / "grid"
    where.mkdir()
    return run_ranks(4, _grid_rank, case, where)


@pytest.fixture(scope="module")
def cli_ranks(out_dir, data_ranks):
    where, _ = data_ranks
    return where, run_ranks(2, _cli_rank, {"ports": free_ports(3),
                                           "init": str(out_dir / "init-cli")},
                            where)


# ------------------------------------------------------------- the tests

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_data_mesh_step_equals_accumulated_step(data_ranks, dtype):
    """4 ranks on ("data",), two steps: loss, grad norm, every parameter
    and moment bit-equal to the one-process ``accum_steps=4`` steps."""
    _, recs = data_ranks
    assert [r["dp"] for r in recs] == [(r, 4) for r in range(4)]
    n_params = len(list(fresh(smoke_config(ARCH), torch.float32)
                        .parameters()))
    assert all(r["leaves"][dtype] == 3 * n_params for r in recs)
    assert len({tuple(r["losses"][dtype]) for r in recs}) == 1
    assert all("not a DTensor on the step's mesh" in r["refused"]
               for r in recs)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_checkpoint_saved_from_the_mesh_is_the_one_process_file(data_ranks,
                                                                dtype):
    """Before the repair a DTensor leaf raised on its way to numpy; the
    file 4 ranks save is the one-process file, leaf for leaf."""
    where, recs = data_ranks
    assert all("tensor subclasses" in r["numpy_error"] for r in recs)
    got = leaves_of(where / f"{dtype}-mesh", STEPS)
    want = leaves_of(where / f"{dtype}-one", STEPS)
    assert list(got) == list(want) and len(got) > 3
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), k


def test_jax_restores_the_fp32_file_saved_from_the_mesh(data_ranks):
    import jax
    import jax.numpy as jnp

    from repro import optim as jopt
    from repro.configs import smoke_config as jsmoke
    from repro.models import transformer as JT
    from repro.train import checkpoint as jckpt

    where, _ = data_ranks
    jcfg = jsmoke(ARCH)
    jp = jax.eval_shape(lambda k: JT.init_params(jcfg, k, jnp.float32),
                        jax.random.key(0))
    js = jax.eval_shape(jopt.adamw()[0], jp)
    (rp, ro), step = jckpt.restore((jp, js), where / "fp32-mesh")
    assert step == STEPS and int(ro.step) == STEPS
    want = leaves_of(where / "fp32-one", STEPS)
    for tree, head in ((rp, "0"), (ro.mu, "1/mu"), (ro.nu, "1/nu")):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert len(flat) > 3
        for path, leaf in flat:
            key = "/".join([head] + [str(getattr(p, "key", getattr(
                p, "idx", p))) for p in path])
            assert np.asarray(leaf).tobytes() == want[key].tobytes(), key


@pytest.mark.parametrize("arch", sorted(NARROW))
@pytest.mark.parametrize("fsdp", sorted(FSDP))
def test_grid_blocks_are_jax_blocks(grid_ranks, arch, fsdp):
    """(2, 2) ("data", "model"): each rank's blocks of every parameter and
    moment after two mesh steps are the blocks JAX's spec gives its
    coordinates of the one-process ``accum_steps=2`` state."""
    assert sorted(r["coord"] for r in grid_ranks) == [(0, 0), (0, 1),
                                                       (1, 0), (1, 1)]
    n_params = len(list(fresh(narrow_cfg(arch), torch.float32)
                        .parameters()))
    assert all(r["leaves"][f"{arch}-{fsdp}"] == 3 * n_params
               for r in grid_ranks)


def test_pod_data_compressed_step_equals_accumulated_step(out_dir):
    """(2, 2) ("pod", "data") with ``compress_pod_grads``: bit-equal to
    the one-process ``accum_steps=4`` step; rank (pod, data) takes slice
    ``2 pod + data``."""
    where = out_dir / "pod"
    where.mkdir()
    recs = run_ranks(4, _pod_rank, {}, where)
    for r in recs:
        pod, data = r["coord"]
        assert r["dp"] == (2 * pod + data, 4)
        assert r["leaves"] > 3


def test_cli_on_two_ranks_equals_the_accumulated_run(cli_ranks):
    """``launch.train.main`` under torchrun's environment on 2 gloo ranks:
    each rank's losses equal the one-process run's at ``accum_steps=2``
    bit for bit; each rank beat its own heartbeat."""
    where, recs = cli_ranks
    for r in recs:
        assert r["straight"]["steps"] == list(range(CLI_STEPS))
        assert r["straight"]["losses"] == r["one"]["losses"]
    for rank in range(2):
        beat = json.loads((where / "cli-straight" / f"hb_host{rank}.json")
                          .read_text())
        assert beat["host"] == f"host{rank}" and beat["step"] == CLI_STEPS - 1


def test_cli_resume_on_two_ranks_is_bit_exact(cli_ranks):
    """A run stopped after its step-2 checkpoint and resumed on 2 ranks
    equals the uninterrupted one: the losses of steps 2 and 3 and the
    step-4 file, bit for bit (JAX's ``test_checkpoint_resume_bit_exact``
    on a mesh)."""
    where, recs = cli_ranks
    for r in recs:
        assert r["first"]["steps"] == [0, 1]
        assert r["first"]["losses"] == r["straight"]["losses"][:2]
        assert r["resumed"]["steps"] == [2, 3]
        assert r["resumed"]["losses"] == r["straight"]["losses"][2:]
    got = leaves_of(where / "cli-resumed", CLI_STEPS)
    want = leaves_of(where / "cli-straight", CLI_STEPS)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].tobytes() == w.tobytes(), k


def test_four_rank_file_restores_onto_two_ranks(cli_ranks):
    """The fp32 file 4 ranks saved, restored onto a 2-rank host mesh by
    the plan: each rank's blocks are the one-process state's."""
    _, recs = cli_ranks
    n_params = len(list(fresh(smoke_config(ARCH), torch.float32)
                        .parameters()))
    assert all(r["restored_leaves"] == 3 * n_params for r in recs)


def test_one_process_accumulated_step_matches_jax():
    """The link to JAX: the one-process ``accum_steps=4`` step the mesh
    step is held to, at its config and batch, against JAX's step body
    composed outside a mesh, within ``tests/test_torch_train_accum.py``'s
    bars: the loss and the grad norm within rtol 1e-5, every accumulated
    gradient leaf within 1e-5 of its scale, the moments within 1e-3 of a
    leaf's scale plus 1e-7; the params within that bar of JAX's update of
    the port's accumulated gradients.  (Against JAX's update of its own
    gradients the params are not held: an embedding entry whose clipped
    gradient is ~4e-8 in one package and ~1e-7 in the other, both within
    1e-6 of the leaf's scale, moves by ``lr g / (|g| + 1e-8)``, which
    differs by ~0.1 lr.)"""
    import jax
    import jax.numpy as jnp

    import test_torch_train_accum as acc
    from repro.configs import smoke_config as jsmoke
    from repro.models import transformer as JT
    from repro_torch.models.carry import (named_to_tree, opt_state_to_jax,
                                          params_from_jax, params_to_jax)
    from repro_torch.train.loop import accumulated_grads

    assert (acc.LR, acc.WARMUP, acc.TOTAL) == (LR, WARMUP, TOTAL)
    jcfg, tcfg = jsmoke(ARCH), smoke_config(ARCH)
    b = step_batch(tcfg, DataConfig(tcfg.vocab_size, SEQ, B, seed=0), 0, CPU)
    jp = jax.jit(lambda k: JT.init_params(jcfg, k, jnp.float32))(
        jax.random.key(0))
    jloss, jgrads, _ = acc.jax_accumulate(
        jcfg, jp, {k: v.numpy() for k, v in b.items()}, 4)
    init, update = jax.jit(acc.jax_update(1.0)[0]), jax.jit(
        acc.jax_update(1.0)[1])
    _, js2, jnorm = update(jp, init(jp), jgrads)

    step, tinit = make_train_step(tcfg, lr=LR, warmup=WARMUP,
                                  total_steps=TOTAL, device="cpu",
                                  accum_steps=4)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tp = params_from_jax(acc.np_tree(jp), tcfg, device="cpu")
        tloss, tgrads = accumulated_grads(tp, tcfg, b, 4)
        tp, ts, m = step(tp, tinit(tp), b)
    finally:
        torch.set_num_threads(n)
    assert float(m["loss"]) == float(tloss)
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=acc.LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jnorm),
                               rtol=acc.LOSS_RTOL)
    tgrads = named_to_tree(tgrads)
    acc.leaf_close(tgrads, jgrads, acc.GRAD_TOL, what="grads")
    to = opt_state_to_jax(ts)
    acc.leaf_close(to["mu"], js2.mu, acc.STEP_TOL, acc.STEP_ATOL, "mu")
    acc.leaf_close(to["nu"], js2.nu, acc.STEP_TOL, acc.STEP_ATOL, "nu")
    jp3, _, _ = update(jp, init(jp), jax.tree.map(jnp.asarray, tgrads))
    acc.leaf_close(params_to_jax(tp), jp3, acc.STEP_TOL, acc.STEP_ATOL,
                   "params")
