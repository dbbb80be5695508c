"""repro_torch's serving steps on a mesh (``make_prefill_step`` /
``make_serve_step(..., mesh=)``) on spawned gloo ranks on the CPU, and
the pieces they stand on, in one process.

The oracle: JAX's own sharded serve step cannot run here (its embedding
gather raises ``ShardingTypeError`` under explicit mesh axes in jax 0.9,
ROADMAP §C), so the chain is: the one-process steps are held to JAX
(``tests/test_torch_lm.py``, ``test_torch_attn_lm.py``,
``test_torch_lm_configs.py``, ``test_torch_frontend_lm.py``); the mesh
steps on ``("data",)`` equal them bit for bit (logits, hops, every cache
leaf, whole and block by block); on ``(2, 2)`` the steps are
tensor-parallel over ``model`` (``serve.decode``: the products split as
in JAX's own sharded program), so their outputs are held to the fp32 bar
of ``tests/test_torch_serve_tp.py`` (within 1e-5 of each output's scale,
or twice the one-process step's own distance from a float64 run where
that is larger) and their hops are equal; and each rank's cache block is
the block that JAX's ``repro.launch.sharding.cache_shardings``
``PartitionSpec`` gives its coordinates, in shape and position, computed
in the test process.

Cases, one spawn per mesh shape:
  * 4 ranks on ``("data",)``: tinyllama's smoke config in fp32 and bf16,
    a prefill, 3 decode steps and 4 FoG steps: in three, one dp slice's
    lanes all exit after the first grove while others stay live (the
    grove runs on every rank: the skip is decided over the whole batch),
    in the fourth every lane exits (every rank skips).  Then one lane
    (B = 1): the batch replicated, as JAX's ``bdp = ()``, and a cache not
    placed by the plan, refused.
  * 4 ranks on ``(2, 2)`` ``("data", "model")``: tinyllama smoke (two KV
    heads: one a rank, head-parallel attention), gemma-2b smoke (one KV
    head: the sequence on ``model``), and ``test_torch_train_mesh.py``'s
    narrowed deepseek (MLA latent, shared expert) and jamba (Mamba state
    and conv tails, attention with one KV head, MoE), FSDP automatic and
    forced.  Each decode step's gathers are recorded: where the heads are
    on ``model`` none is K/V-sized.  (``tests/test_torch_serve_tp.py``
    holds the tensor-parallel steps to every bar, JAX's step included.)

The ranks import only the port (spawned children re-import this module);
the JAX side is computed in the test process.  Each rank gets at least 2
lanes where the batch is split: the CPU's product of one row is a
matrix-vector product, which rounds otherwise (``serve.decode``)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

import test_torch_train_mesh as TM  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.policy import FogPolicy  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.launch.mesh import (MeshShape, dp_rank,  # noqa: E402
                                     model_rank)
from repro_torch.models import fog_exit  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import (decode_attention,  # noqa: E402
                                       flash_attention)
from repro_torch.serve.decode import (make_prefill_step,  # noqa: E402
                                      make_serve_step)

ARCH = "tinyllama-1.1b"
SEQ, MAX_SEQ, N_DECODE = 16, 24, 3
DATA_B = 8                # 2 lanes a dp rank on 4 ranks
GRID_B = 4                # 2 lanes a dp rank on (2, 2)
GRID = TM.GRID
GRID_ARCHS = {"tinyllama-1.1b": {}, "gemma-2b": {}, **TM.NARROW}
FRONTEND = "musicgen-large"   # served from embeds
# per lane: rank 0's lanes (0, 1) exit after the first grove, lanes 2-5
# never do (lane 5 stops at its budget of one grove), 6 and 7 by margin
THRESH = [0.0, 0.0, 2.0, 2.0, 2.0, 2.0, 0.0, 2.0]
BUDGET = [9, 9, 9, 9, 9, 1, 9, 9]
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def grid_cfg(arch):
    return smoke_config(arch).scaled(**GRID_ARCHS[arch])


def fresh(cfg, dtype):
    return T.init_params(cfg, torch.Generator().manual_seed(0), dtype,
                         device="cpu")


def prompt(cfg, batch, dtype=torch.float32):
    """Token ids, or for ``cfg.frontend`` the front end's embeddings."""
    g = torch.Generator().manual_seed(1)
    if cfg.frontend:
        return torch.randn(batch, SEQ, cfg.d_model, generator=g).to(dtype)
    return torch.randint(0, cfg.vocab_size, (batch, SEQ), dtype=torch.int32,
                         generator=g)


def next_input(cfg, logits, i, dtype):
    """A decode step's input: the last step's argmax, or for
    ``cfg.frontend`` step ``i``'s embeddings."""
    if cfg.frontend:
        return torch.randn(logits.shape[0], 1, cfg.d_model,
                           generator=torch.Generator().manual_seed(
                               2 + i)).to(dtype)
    return logits.argmax(-1).to(torch.int32)


def knobs(batch, thresh=None):
    th = THRESH if thresh is None else [thresh] * len(THRESH)
    return (torch.tensor(th[:batch], dtype=torch.float32),
            torch.tensor(BUDGET[:batch], dtype=torch.int32))


def leaves(tree, path=()):
    """``(path, leaf)`` of each leaf of a cache tree (or of its specs: a
    ``Spec`` is a leaf), in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, S.Spec):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def run_steps(cfg, dtype, batch, mesh=None, params=None, record=None,
              tokens=None):
    """A prefill, ``N_DECODE`` decode steps and ``N_DECODE + 1`` FoG steps
    (the last at threshold 0 for every lane), each token the last step's
    argmax (or ``tokens``' decode inputs where given), on one process or
    on ``mesh`` (``params`` placed by the plan); with ``record`` (a
    :class:`Recorder`'s log) an entry opened before each decode step.
    Returns [(what, logits, cache, hops or None)]."""
    kw = dict(param_dtype=dtype, mesh=mesh)
    pre, _ = make_prefill_step(cfg, "cpu", batch=batch, seq_len=SEQ,
                               max_seq=MAX_SEQ, **kw)
    dec, _ = make_serve_step(cfg, "cpu", batch=batch, max_seq=MAX_SEQ, **kw)
    fog, _ = make_serve_step(cfg, "cpu", batch=batch, max_seq=MAX_SEQ,
                             fog=True,
                             policy=FogPolicy(backend="pallas"), **kw)
    logits, cache = pre(params, prompt(cfg, batch, dtype))
    out = [("prefill", logits, cache, None)]
    whole = (lambda t: t) if mesh is None else (lambda t: t.full_tensor())
    length = SEQ
    steps = [("decode", dec, ())] * N_DECODE + [
        ("fog", fog, knobs(batch))] * N_DECODE + [
        ("fog all exit", fog, knobs(batch, 0.0))]
    for i, (what, fn, extra) in enumerate(steps):
        token = (next_input(cfg, whole(logits), i, dtype) if tokens is None
                 else next_input(cfg, tokens[i][1], i, dtype))
        if record is not None:
            record.append({"gathers": [], "skipped": 0})
        res = fn(params, cache, token, length, *extra)
        logits, cache = res[0], res[1]
        out.append((f"{what} {i}", logits, cache,
                    res[2] if len(res) > 2 else None))
        length += 1
    return out


class Recorder:
    """Records the shapes every ``dist.all_gather`` and every
    ``DTensor.full_tensor`` of a 4-D tensor (a K/V leaf's rank) takes
    while it is on, into ``log[-1]["gathers"]``, and counts the calls of
    FoG's skip branch (``_kv_only_update``) into ``log[-1]["skipped"]``."""

    def __init__(self):
        from torch.distributed.tensor import DTensor

        self.log = []
        self.saved = (dist.all_gather, DTensor.full_tensor,
                      fog_exit._kv_only_update)
        gather, full, kv_only = self.saved

        def all_gather(parts, t, *a, **kw):
            if self.log:
                self.log[-1]["gathers"].append(tuple(t.shape))
            return gather(parts, t, *a, **kw)

        def full_tensor(d, *a, **kw):
            if self.log and d.dim() == 4:
                self.log[-1]["gathers"].append(tuple(d.shape))
            return full(d, *a, **kw)

        def skipped(*a, **kw):
            if self.log:
                self.log[-1]["skipped"] += 1
            return kv_only(*a, **kw)

        dist.all_gather = all_gather
        DTensor.full_tensor = full_tensor
        fog_exit._kv_only_update = skipped

    def close(self):
        from torch.distributed.tensor import DTensor

        dist.all_gather, DTensor.full_tensor, fog_exit._kv_only_update = (
            self.saved)


FP32_BAR = 1e-5


def close_steps(what, mesh_run, one_run, f64_run, block_of) -> int:
    """Every output of the tensor-parallel mesh run, whole
    (``full_tensor()``), within ``FP32_BAR`` of its scale of the
    one-process run's (or twice the one-process run's distance from
    ``f64_run``, its float64 twin, where that is larger); hops equal; each
    leaf's ``to_local()`` the block of its whole that DTensor and JAX's
    spec (``block_of(path, whole)``) give the rank, in shape and position.
    Returns the leaves checked."""
    def err(a, b):
        return float((a.double() - b.double()).abs().max()) / max(
            float(b.abs().max()), 1e-30)

    n = 0
    for (step, lm, cm, hm), (_, l1, c1, h1), (_, l64, c64, _) in zip(
            mesh_run, one_run, f64_run, strict=True):
        whole = lm.full_tensor()
        assert err(whole, l1) <= max(FP32_BAR, 2 * err(l1, l64)), (
            what, step, "logits")
        assert torch.equal(lm.to_local(), S.local_block(whole, lm)), (
            what, step, "logits block")
        if h1 is not None:
            assert torch.equal(hm.full_tensor(), h1), (what, step, "hops")
        for (path, d), (_, t), (_, t64) in zip(leaves(cm), leaves(c1),
                                               leaves(c64), strict=True):
            whole = d.full_tensor()
            assert err(whole, t) <= max(FP32_BAR, 2 * err(t, t64)), (
                what, step, path)
            assert torch.equal(d.to_local(), S.local_block(whole, d)), (
                what, step, path)
            assert torch.equal(d.to_local(), block_of(path, whole)), (
                what, step, path, "JAX's block")
            n += 1
    return n


def same_steps(what, mesh_run, one_run, block_of=None) -> int:
    """Every output of the mesh run == the one-process run's bit for bit,
    whole (``full_tensor()``); with ``block_of(path, whole)`` each cache
    leaf's ``to_local()`` == that block too.  Returns the leaves checked."""
    n = 0
    for (step, lm, cm, hm), (_, l1, c1, h1) in zip(mesh_run, one_run,
                                                   strict=True):
        assert torch.equal(lm.full_tensor(), l1), (what, step, "logits")
        assert torch.equal(lm.to_local(), S.local_block(l1, lm)), (
            what, step, "logits block")
        if h1 is not None:
            assert torch.equal(hm.full_tensor(), h1), (what, step, "hops")
        for (path, d), (_, t) in zip(leaves(cm), leaves(c1), strict=True):
            assert torch.equal(d.full_tensor(), t), (what, step, path)
            assert torch.equal(d.to_local(), S.local_block(t, d)), (
                what, step, path)
            if block_of is not None:
                assert torch.equal(d.to_local(), block_of(path, t)), (
                    what, step, path, "JAX's block")
            n += 1
    return n


# ------------------------------------------------------------ the ranks

def _data_rank(rank, world, case, out_dir):
    """4 ranks on ("data",): tinyllama smoke fp32 and bf16; one lane; a
    cache not placed."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    cfg = smoke_config(ARCH)
    rec = {"dp": dp_rank(mesh), "model": model_rank(mesh), "leaves": {},
           "hops": {}, "skipped": {}, "placements": {}}
    for name, dtype in DTYPES.items():
        p = fresh(cfg, dtype)
        one = run_steps(cfg, dtype, DATA_B, params=p)
        placed = S.shard_tree(p, mesh, S.param_shardings(cfg, mesh, p))
        record = Recorder()
        try:
            on_mesh = run_steps(cfg, dtype, DATA_B, mesh, placed,
                                record=record.log)
        finally:
            record.close()
        rec["leaves"][name] = same_steps(name, on_mesh, one)
        rec["hops"][name] = [h.tolist() for _, _, _, h in one
                             if h is not None]
        rec["skipped"][name] = [r["skipped"] for r in record.log]
        rec["placements"][name] = {
            "logits": str(on_mesh[-1][1].placements),
            "k": str(on_mesh[-1][2]["stack"][0]["pos0"]["k"].placements)}
    # a front end's embeddings in place of tokens
    cfg_e = smoke_config(FRONTEND)
    p = fresh(cfg_e, torch.float32)
    one = run_steps(cfg_e, torch.float32, DATA_B, params=p)
    placed = S.shard_tree(p, mesh, S.param_shardings(cfg_e, mesh, p))
    rec["leaves"]["embeds"] = same_steps(
        "embeds", run_steps(cfg_e, torch.float32, DATA_B, mesh, placed), one)
    # one lane: every rank serves it whole
    p = fresh(cfg, torch.float32)
    one = run_steps(cfg, torch.float32, 1, params=p)
    placed = S.shard_tree(p, mesh, S.param_shardings(cfg, mesh, p))
    lone = run_steps(cfg, torch.float32, 1, mesh, placed)
    rec["leaves"]["one lane"] = same_steps("one lane", lone, one)
    rec["placements"]["one lane"] = {
        "logits": str(lone[-1][1].placements),
        "k": str(lone[-1][2]["stack"][0]["pos0"]["k"].placements),
        "local k": tuple(lone[-1][2]["stack"][0]["pos0"]["k"]
                         .to_local().shape)}
    # a cache not placed by the plan is refused
    dec, _ = make_serve_step(cfg, "cpu", batch=DATA_B, max_seq=MAX_SEQ,
                             param_dtype=torch.float32, mesh=mesh)
    placed = S.shard_tree(p, mesh, S.param_shardings(cfg, mesh, p))
    plain = T.cache_init(cfg, DATA_B, MAX_SEQ, torch.float32, device="cpu")
    token = torch.zeros((DATA_B,), dtype=torch.int32)
    refused = {}
    for what, cache in (("plain", plain), ("replicated", S.map_leaves(
            lambda t: S.shard_tree(t, mesh, S.Spec(*[None] * t.dim())),
            plain))):
        try:
            dec(placed, cache, token, SEQ)
            refused[what] = None
        except ValueError as e:
            refused[what] = str(e)
    rec["refused"] = refused
    torch.save(rec, f"{out_dir}/rank{rank}.pt")


def _grid_rank(rank, world, case, out_dir):
    """4 ranks on (2, 2) ("data", "model"): the outputs within the fp32
    bar of one process, each cache block == JAX's, no K/V-sized gather
    where the heads are on model."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", GRID[0], mesh_dim_names=GRID[1])
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    rec = {"coord": (coord["data"], coord["model"]),
           "model": model_rank(mesh), "leaves": {}, "kv_gathers": {},
           "gathers": {}, "heads": {}, "round_trip": {}}

    def block_of(arch):
        def get(path, whole):
            spec = case[arch][path[:1] + path[2:] if path[0] == "stack"
                              else path]
            return TM.block(whole, spec, coord, sizes)
        return get

    for arch in GRID_ARCHS:
        cfg = grid_cfg(arch)
        p = fresh(cfg, torch.float32)
        one = run_steps(cfg, torch.float32, GRID_B, params=p)
        p64 = S.rebuild(p, {k: v.detach() if k.endswith("router")
                            else v.detach().double()
                            for k, v in p.named_parameters()})
        f64 = run_steps(cfg, torch.float64, GRID_B, params=p64,
                        tokens=one[:-1])
        # the one-process prefill's cache placed by the plan round-trips
        cache = one[0][2]
        placed_cache = S.shard_tree(cache, mesh,
                                    S.cache_shardings(cfg, mesh, cache))
        n = 0
        for (path, d), (_, t) in zip(leaves(placed_cache), leaves(cache),
                                     strict=True):
            assert torch.equal(d.full_tensor(), t), (arch, path)
            assert torch.equal(d.to_local(), block_of(arch)(path, t)), (
                arch, path)
            n += 1
        rec["round_trip"][arch] = n
        kv_len = {MAX_SEQ, MAX_SEQ // sizes["model"]}
        for label, fsdp in TM.FSDP.items():
            placed = S.shard_tree(p, mesh,
                                  S.param_shardings(cfg, mesh, p, fsdp))
            record = Recorder()
            try:
                on_mesh = run_steps(cfg, torch.float32, GRID_B, mesh, placed,
                                    record=record.log)
            finally:
                record.close()
            key = f"{arch}-{label}"
            rec["leaves"][key] = close_steps(key, on_mesh, one, f64,
                                             block_of(arch))
            # the decode steps' gathers of K/V-sized tensors (a position
            # axis of the cache's length)
            rec["kv_gathers"][key] = sum(
                1 for r in record.log for s in r["gathers"]
                if len(s) == 4 and s[1] in kv_len)
            rec["gathers"][key] = sum(len(r["gathers"]) for r in record.log)
            k = on_mesh[-1][2]["stack"][0]["pos0"].get("k")
            rec["heads"][key] = None if k is None else (
                str(k.placements), tuple(k.to_local().shape))
    torch.save(rec, f"{out_dir}/rank{rank}.pt")


# ------------------------------------------------------------ the spawns

@pytest.fixture(scope="module")
def data_ranks(tmp_path_factory):
    return TM.run_ranks(4, _data_rank, {}, tmp_path_factory.mktemp("data"))


@functools.lru_cache(maxsize=None)
def jax_cache_specs(arch: str) -> dict:
    """JAX's cache specs of the grid config on ``GRID`` at ``GRID_B``
    lanes and ``MAX_SEQ`` positions, by the port's cache path (a stack
    leaf's less its leading None, keyed without the repeat's index)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh, PartitionSpec as P

    from repro.configs import smoke_config as jsmoke
    from repro.launch import sharding as js
    from repro.models import transformer as JT

    jcfg = jsmoke(arch).scaled(**GRID_ARCHS[arch])
    shape = jax.eval_shape(lambda: JT.cache_init(jcfg, GRID_B, MAX_SEQ,
                                                 jnp.float32))
    flat = jax.tree_util.tree_flatten_with_path(
        js.cache_shardings(jcfg, AbstractMesh(*GRID), shape),
        is_leaf=lambda x: isinstance(x, P))[0]
    out = {}
    for path, spec in flat:
        key = tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)
        out[key] = tuple(spec)[1:] if key[0] == "stack" else tuple(spec)
    return out


@pytest.fixture(scope="module")
def grid_ranks(tmp_path_factory):
    case = {a: jax_cache_specs(a) for a in GRID_ARCHS}
    # the cases put heads, the sequence and Mamba's heads and channels on
    # model, and the batch on data
    parts = {(i, p) for a in GRID_ARCHS for s in case[a].values()
             for i, p in enumerate(s) if p is not None}
    assert {(0, "data"), (1, "model"), (2, "model")} <= parts
    return TM.run_ranks(4, _grid_rank, case, tmp_path_factory.mktemp("grid"))


# ------------------------------------------------------------- the tests

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_data_mesh_steps_equal_one_process(data_ranks, dtype):
    """4 ranks on ("data",): the prefill, 3 decode and 4 FoG steps' logits,
    hops and every cache leaf (whole and the rank's block) == the
    one-process steps' bit for bit; the lanes exit at different groves."""
    assert [r["dp"] for r in data_ranks] == [(r, 4) for r in range(4)]
    assert all(r["model"] == (0, 1) for r in data_ranks)
    n_layers = smoke_config(ARCH).n_layers
    assert all(r["leaves"][dtype] == (2 + 2 * N_DECODE) * 2 * n_layers
               for r in data_ranks)
    hops = data_ranks[0]["hops"][dtype]
    assert hops[0][:6] == [1, 1, 2, 2, 2, 1] and hops[-1] == [1] * DATA_B
    assert all(r["placements"][dtype] == {
        "logits": "(Shard(dim=0),)", "k": "(Shard(dim=0),)"}
        for r in data_ranks)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_data_mesh_fog_skip_is_decided_over_the_batch(data_ranks, dtype):
    """Rank 0's lanes all exit after the first grove while other ranks'
    stay live: rank 0 still runs the second grove (no skipped layer), as
    the one-process step does; when every lane exits every rank skips
    (each of the second grove's layers once)."""
    per_grove = smoke_config(ARCH).n_layers // 2
    for r in data_ranks:
        assert r["skipped"][dtype] == ([0] * (2 * N_DECODE)
                                       + [per_grove]), r["skipped"]


def test_data_mesh_steps_from_embeddings(data_ranks):
    """musicgen's smoke config (``cfg.frontend``): the steps take
    ``embeds`` ([B, S, d], then [B, 1, d]) and each rank its rows of them;
    every output == the one-process steps' bit for bit."""
    n_layers = smoke_config(FRONTEND).n_layers
    assert all(r["leaves"]["embeds"] == (2 + 2 * N_DECODE) * 2 * n_layers
               for r in data_ranks)


def test_one_lane_is_replicated_over_the_dp_ranks(data_ranks):
    """B = 1 on 4 dp ranks: every rank serves the lane (JAX's ``bdp =
    ()``), the cache's batch axis and the logits are not sharded, and
    the outputs == the one-process steps'."""
    n_layers = smoke_config(ARCH).n_layers
    for r in data_ranks:
        assert r["leaves"]["one lane"] == (2 + 2 * N_DECODE) * 2 * n_layers
        assert r["placements"]["one lane"] == {
            "logits": "(Replicate(),)", "k": "(Replicate(),)",
            "local k": (1, MAX_SEQ, 2, 32)}


def test_a_cache_not_placed_by_the_plan_is_refused(data_ranks):
    for r in data_ranks:
        for what in ("plain", "replicated"):
            assert "is not placed by the plan" in r["refused"][what]
            assert "cache_shardings(cfg, mesh, cache)" in r["refused"][what]


@pytest.mark.parametrize("arch", sorted(GRID_ARCHS))
@pytest.mark.parametrize("fsdp", sorted(TM.FSDP))
def test_grid_steps_equal_one_process_in_jax_blocks(grid_ranks, arch, fsdp):
    """(2, 2) ("data", "model"), tensor-parallel over ``model``: every
    output within the fp32 bar of the one-process steps' (``close_steps``),
    the hops equal, and each rank's block of every cache leaf after each
    step is the block JAX's ``cache_shardings`` spec gives its
    coordinates, in shape and position."""
    assert sorted(r["coord"] for r in grid_ranks) == [(0, 0), (0, 1),
                                                       (1, 0), (1, 1)]
    assert all(r["model"] == (r["coord"][1], 2) for r in grid_ranks)
    n = sum(1 for _ in leaves(T.cache_init(grid_cfg(arch), 1, 2,
                                           device="meta")))
    assert all(r["leaves"][f"{arch}-{fsdp}"] == (2 + 2 * N_DECODE) * n
               for r in grid_ranks)


@pytest.mark.parametrize("arch", sorted(GRID_ARCHS))
def test_grid_cache_placed_by_the_plan_round_trips(grid_ranks, arch):
    """``shard_tree`` of the one-process cache by ``cache_shardings``
    (dicts, lists, Mamba's conv tuple): each ``to_local()`` is JAX's block
    and ``full_tensor()`` the leaf."""
    n = sum(1 for _ in leaves(T.cache_init(grid_cfg(arch), 1, 2,
                                           device="meta")))
    assert all(r["round_trip"][arch] == n for r in grid_ranks)


@pytest.mark.parametrize("fsdp", sorted(TM.FSDP))
def test_head_parallel_decode_never_gathers_kv(grid_ranks, fsdp):
    """tinyllama's 2 KV heads on a model axis of 2: a rank's K/V block is
    its one head, and no decode step gathers a K/V-sized tensor (the
    partial outputs of ``wo`` and the FFN are gathered to be summed);
    gemma's one KV head puts the sequence on model, and there the steps
    gather the K/V leaves layer by layer, which the recorder sees."""
    for r in grid_ranks:
        key = f"tinyllama-1.1b-{fsdp}"
        assert r["heads"][key] == ("(Shard(dim=0), Shard(dim=2))",
                                   (2, MAX_SEQ, 1, 32))
        assert r["kv_gathers"][key] == 0
        assert r["gathers"][key] > 0
        gemma = f"gemma-2b-{fsdp}"
        assert r["heads"][gemma] == ("(Shard(dim=0), Shard(dim=1))",
                                     (2, MAX_SEQ // 2, 1, 32))
        assert r["kv_gathers"][gemma] > 0


# ------------------------------------------------ the pieces, one process

GQA = {1: (4, 4), 2: (8, 4), 8: (16, 2)}    # ratio -> (H, K)


@pytest.mark.parametrize("ratio", sorted(GQA))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["decode", "flash"])
def test_attention_on_a_head_slice_is_that_slice_of_the_whole(ratio, dtype,
                                                               kind):
    """``decode_attention`` and the plain ``flash_attention`` on the KV
    heads of each rank of 2 (and of each KV head alone) and their query
    heads == the same slice of the whole call, bit for bit."""
    H, K = GQA[ratio]
    g = torch.Generator().manual_seed(ratio)
    dt = DTYPES[dtype]
    B, Sq, D = 3, 1 if kind == "decode" else 40, 32
    Sk = 48 if kind == "decode" else Sq
    q = torch.randn(B, Sq, H, D, generator=g).to(dt)
    k = torch.randn(B, Sk, K, D, generator=g).to(dt)
    v = torch.randn(B, Sk, K, D, generator=g).to(dt)

    def attend(q, k, v):
        if kind == "decode":
            return decode_attention(q, k, v, 37)
        return flash_attention(q, k, v, causal=True)

    whole = attend(q, k, v)
    for ranks in sorted({2, K}):
        for m in range(ranks):
            hq = slice(m * H // ranks, (m + 1) * H // ranks)
            hk = slice(m * K // ranks, (m + 1) * K // ranks)
            got = attend(q[:, :, hq], k[:, :, hk], v[:, :, hk])
            assert torch.equal(got, whole[:, :, hq]), (ranks, m)


def test_cache_shardings_on_a_mesh_without_a_model_axis():
    """On the host mesh (``("data",)``) no cache leaf names ``model``;
    on a mesh with one the rules are JAX's (``test_torch_sharding.py``):
    heads where they divide, else the sequence."""
    cfg = smoke_config("jamba-1.5-large-398b")
    cache = T.cache_init(cfg, 4, MAX_SEQ, device="meta")
    host = S.cache_shardings(cfg, MeshShape(("data",), (4,)), cache)
    for _, spec in leaves(host):
        assert "model" not in spec and spec[0] == "data", spec
    grid = S.cache_shardings(cfg, MeshShape(*GRID[::-1]), cache)
    attn = next(c for blk in grid["stack"] for c in blk.values()
                if "k" in c)
    assert attn["k"] == S.Spec("data", None, "model", None)


def test_map_leaves_keeps_the_structure():
    tree = {"a": [torch.ones(2), (torch.zeros(1), torch.ones(3))]}
    specs = {"a": [S.Spec(None), (S.Spec(None), S.Spec("data"))]}
    got = S.map_leaves(lambda t, s: (t.shape[0], s), tree, specs)
    assert got == {"a": [(2, S.Spec(None)),
                         ((1, S.Spec(None)), (3, S.Spec("data")))]}
    assert isinstance(got["a"][1], tuple)


def test_one_process_steps_are_unchanged_without_a_mesh():
    """``mesh=None`` is the one-device step: the same function of the
    same inputs as ``transformer.prefill`` / ``decode_step``."""
    cfg = smoke_config(ARCH)
    p = fresh(cfg, torch.float32)
    tokens = prompt(cfg, 2)
    pre, _ = make_prefill_step(cfg, "cpu", batch=2, seq_len=SEQ,
                               max_seq=MAX_SEQ, param_dtype=torch.float32)
    logits, cache = pre(p, tokens)
    want, want_cache = T.prefill(p, cfg, tokens, max_seq=MAX_SEQ)
    assert torch.equal(logits, want)
    dec, _ = make_serve_step(cfg, "cpu", batch=2, max_seq=MAX_SEQ,
                             param_dtype=torch.float32)
    token = logits.argmax(-1).to(torch.int32)
    got, _ = dec(p, cache, token, SEQ)
    assert torch.equal(got, T.decode_step(p, cfg, token, want_cache,
                                          SEQ)[0])
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("arch", sorted(GRID_ARCHS))
def test_a_cache_tree_placed_in_one_process_round_trips(arch):
    """``shard_tree`` of a prefill's cache by ``cache_shardings`` on a
    (1, 1, 1) mesh of a one-rank gloo group: the dicts, lists and Mamba's
    conv tuple kept, each leaf placed by its spec, ``to_local()`` and
    ``full_tensor()`` == the leaf."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = grid_cfg(arch)
    _, cache = T.prefill(fresh(cfg, torch.float32), cfg,
                         prompt(cfg, GRID_B), max_seq=MAX_SEQ)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1, 1),
                                mesh_dim_names=("pod", "data", "model"))
        specs = S.cache_shardings(cfg, mesh, cache)
        placed = S.shard_tree(cache, mesh, specs)
        got = list(leaves(placed))
        for (path, d), (_, t), (_, spec) in zip(
                got, leaves(cache), leaves(specs), strict=True):
            assert d.placements == S.placements(spec, mesh), path
            assert torch.equal(d.to_local(), t), path
            assert torch.equal(d.full_tensor(), t), path
        conv = [c["conv"] for blk in placed["stack"] for c in blk.values()
                if "conv" in c]
        assert all(isinstance(c, tuple) and len(c) == 3 for c in conv)
        assert bool(conv) == bool(cfg.ssm) and len(got) > 3
    finally:
        dist.destroy_process_group()
