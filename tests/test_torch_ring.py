"""repro_torch's grove ring against the JAX package's reference loop.

The JAX ring itself cannot be the oracle here: under jax 0.9 it raises
``ShardingTypeError`` (ROADMAP §C).  It is specified to equal Algorithm 2's
reference loop bit for bit from the same stratified starts
(``repro/core/fog_ring.py`` and ``tests/test_fog_ring.py::RING_SCRIPT``),
so the port's ring is held to ``repro.core.engine._eval_core(...,
"reference", ...)`` fed JAX's own ``sample_starts(key, B, G, n)`` draws:
hops and labels equal, proba within rtol 1e-6 / atol 1e-7 (the engine bar
of tests/test_engine_conformance.py).  The ring over a gloo process group
runs in spawned CPU ranks and must equal the stacked ring bit for bit.
"""
import pytest

torch = pytest.importorskip("torch")

import time  # noqa: E402
from datetime import timedelta  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core.engine import _eval_core  # noqa: E402
from repro.core.engine import sample_starts as jax_starts  # noqa: E402
from repro.core.fog_ring import _grove_order as jax_order  # noqa: E402
from repro.forest import ForestPack as JPack  # noqa: E402
from repro.forest import forest_proba as jax_forest_proba  # noqa: E402
from repro_torch.core import RingMesh, ring_eval  # noqa: E402
from repro_torch.core.fog_ring import _grove_order, reorder_tables  # noqa: E402
from repro_torch.core.policy import NO_BUDGET  # noqa: E402
from repro_torch.forest import ForestPack as TPack  # noqa: E402
from repro_torch.forest import TensorForest, forest_proba  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

PRECISIONS = ["fp32", "bf16", "int8"]
SHARDS = [1, 2, 4, 8]
FIELDS = ("feature", "threshold", "leaf", "thr_scale", "leaf_scale")
B = 512
TOL = {"rtol": 1e-6, "atol": 1e-7}
# seconds a test of spawned gloo ranks may take before it fails
RANKS_TIMEOUT_S = 120


def np_bits(a):
    """Comparable host array: bf16 as its uint16 bits, else numpy."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16).numpy().view(np.uint16)
                if a.dtype == torch.bfloat16 else a.numpy())
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def lane_policies():
    """RING_SCRIPT's per-lane vectors: two thresholds, every other lane on
    a budget of 2 hops."""
    tvec = np.where(np.arange(B) < B // 2, 0.05, 0.6).astype(np.float32)
    bvec = np.where(np.arange(B) % 2 == 0, 2, NO_BUDGET).astype(np.int32)
    return tvec, bvec


@pytest.fixture(scope="module")
def field(trained):
    """The 16-tree depth-6 penbased forest split 8 x 2: (x, forest, JAX
    packs, port packs over the same packed arrays)."""
    ds, rf = trained
    jgc = jcore.split(rf, 2)
    jpacks = {p: JPack.from_groves(jgc, p) for p in PRECISIONS}
    tpacks = {p: TPack.from_numpy(*(np.asarray(getattr(jpacks[p], f))
                                    for f in FIELDS), p)
              for p in PRECISIONS}
    return ds.x_test[:B], rf, jpacks, tpacks


@pytest.fixture(scope="module")
def jax_ref(field):
    """Memoized JAX reference loop keyed by (precision, n, per_lane,
    max_hops), from JAX's stratified starts for n shards."""
    x, _, jpacks, _ = field
    cache = {}

    def run(precision, n, per_lane=False, max_hops=8):
        key = (precision, n, per_lane, max_hops)
        if key not in cache:
            start = jax_starts(jax.random.key(0), B, 8, n)
            tvec, bvec = lane_policies() if per_lane else (
                np.full(B, 0.3, np.float32), np.full(B, NO_BUDGET, np.int32))
            res = _eval_core(jpacks[precision], jnp.asarray(x), start,
                             jnp.asarray(tvec), jnp.asarray(bvec), max_hops,
                             "reference", 256, False)
            cache[key] = (np.asarray(start), res)
        return cache[key]
    return run


def assert_conforms(proba, hops, want):
    np.testing.assert_array_equal(hops.numpy(), np.asarray(want.hops))
    np.testing.assert_array_equal(
        torch.argmax(proba, -1).numpy(), np.asarray(want.label))
    np.testing.assert_allclose(proba.numpy(), np.asarray(want.proba), **TOL)
    assert hops.dtype == torch.int32 and proba.dtype == torch.float32


# ------------------------------------------------------------ the layout

@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_ring_layout_equals_jax(field, precision, n):
    _, _, jpacks, tpacks = field
    np.testing.assert_array_equal(_grove_order(8, n), jax_order(8, n))
    got = tpacks[precision].layout("ring", n)
    want = jpacks[precision].layout("ring", n)
    assert len(got) == len(want) == 5
    for f, g, w in zip(FIELDS, got, want):
        assert tuple(g.shape) == tuple(w.shape), f
        np.testing.assert_array_equal(np_bits(g), np_bits(w), err_msg=f)
    assert tpacks[precision].layout("ring", n) is got      # cached


def two_heads(rf):
    gc = tcore.split(TensorForest.from_numpy(rf.feature, rf.threshold,
                                             rf.leaf), 2)
    return gc, gc


def test_ring_layout_rejects_what_jax_rejects(field):
    _, rf, _, tpacks = field
    with pytest.raises(ValueError, match="divide"):
        tpacks["fp32"].layout("ring", 3)
    two = TPack.from_groves(two_heads(rf))
    with pytest.raises(NotImplementedError, match="single-output"):
        two.layout("ring", 2)
    with pytest.raises(ValueError, match="unknown layout"):
        tpacks["fp32"].layout("spiral")


# ------------------------------------------------------ the start draws

@pytest.mark.parametrize("n", [2, 4, 8])
def test_stratified_starts(n):
    g = torch.Generator().manual_seed(1)
    start = tcore.sample_starts(g, 4096, 16, n_shards=n)
    assert start.dtype == torch.int32 and start.shape == (4096,)
    counts = torch.bincount(start.long() % n, minlength=n)
    assert (counts == 4096 // n).all()
    # uniform over all 16 groves: each within 5 sigma of 256
    freq = torch.bincount(start.long(), minlength=16).numpy()
    assert (np.abs(freq - 256) < 5 * np.sqrt(256)).all(), freq
    with pytest.raises(ValueError, match="divide"):
        tcore.sample_starts(g, 4095, 16, n_shards=n)
    with pytest.raises(ValueError, match="divide"):
        tcore.sample_starts(g, 4096, 2 * n + 1, n_shards=n)


def test_one_shard_keeps_the_plain_draw():
    got = tcore.sample_starts(torch.Generator().manual_seed(9), 1000, 8,
                              n_shards=1)
    want = torch.randint(0, 8, (1000,), generator=torch.Generator(
        ).manual_seed(9), dtype=torch.int32)
    assert torch.equal(got, want)
    assert torch.equal(got, tcore.sample_starts(
        torch.Generator().manual_seed(9), 1000, 8))


# ------------------------------------------- the ring against the oracle

@pytest.mark.parametrize("max_hops", [8, 5])
@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_ring_eval_matches_jax_reference(field, jax_ref, precision, n,
                                         max_hops):
    """ring_eval on RingMesh(n), packed tables; max_hops 5 leaves lanes
    mid-ring (5 % n != 0) so the rotate-back is exercised."""
    x, _, _, tpacks = field
    start, want = jax_ref(precision, n, max_hops=max_hops)
    proba, hops = ring_eval(tpacks[precision], torch.as_tensor(x), start,
                            0.3, max_hops, RingMesh(n),
                            use_kernels=n == 8)
    assert_conforms(proba, hops, want)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_engine_ring_per_lane_vectors(field, jax_ref, precision, n):
    """FogEngine(backend="ring") with RING_SCRIPT's per-lane threshold and
    budget vectors riding with their lanes."""
    x, _, _, tpacks = field
    start, want = jax_ref(precision, n, per_lane=True)
    tvec, bvec = lane_policies()
    eng = tcore.FogEngine(tpacks[precision], backend="ring",
                          mesh=RingMesh(n), use_kernels=n == 8, device="cpu")
    res = eng.eval(x, start=start, policy=tcore.FogPolicy(
        threshold=torch.as_tensor(tvec), hop_budget=torch.as_tensor(bvec),
        max_hops=8))
    assert_conforms(res.proba, res.hops, want)
    assert torch.equal(res.label, torch.argmax(res.proba, -1).to(torch.int32))
    assert (res.hops[::2] <= 2).all()
    assert torch.equal(res.energy_pj, res.model.lane_pj(res.hops))


@pytest.mark.parametrize("n", SHARDS)
def test_ring_max_equals_the_whole_forest(field, n):
    """Threshold 1.1 never fires: every lane walks all 8 groves and its
    proba is the whole forest's."""
    x, rf, _, tpacks = field
    start = tcore.sample_starts(torch.Generator().manual_seed(2), B, 8,
                                n_shards=n)
    proba, hops = ring_eval(tpacks["fp32"], torch.as_tensor(x), start, 1.1,
                            8, RingMesh(n))
    assert (hops == 8).all()
    want = np.asarray(jax_forest_proba(rf, jnp.asarray(x)))
    np.testing.assert_allclose(proba.numpy(), want, rtol=1e-5, atol=1e-6)
    mine = forest_proba(TensorForest.from_numpy(rf.feature, rf.threshold,
                                                rf.leaf), torch.as_tensor(x))
    np.testing.assert_allclose(proba.numpy(), mine.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_paths_agree(field, precision):
    """The kernel path equals the plain path, the ring equals the port's
    reference backend from the same starts, and the gather path over an fp32
    GroveCollection equals the packed one."""
    x, rf, _, tpacks = field
    pack = tpacks[precision]
    pol = tcore.FogPolicy(threshold=0.3, max_hops=8)
    ref = tcore.FogEngine(pack, device="cpu")
    for n in SHARDS:
        start = tcore.sample_starts(torch.Generator().manual_seed(n), B, 8,
                                    n_shards=n)
        want = ref.eval(x, start=start, policy=pol)
        kinds = (False, True) if n == 8 else (False,)
        for use_kernels in kinds:
            before = dict(ops.launches)
            got = tcore.FogEngine(pack, backend="ring", mesh=RingMesh(n),
                                  use_kernels=use_kernels,
                                  device="cpu").eval(x, start=start,
                                                     policy=pol)
            assert ops.launches == before    # the CPU launches no kernel
            for f in ("hops", "label", "proba"):
                assert torch.equal(getattr(got, f), getattr(want, f)), (n, f)
    gc = tcore.split(TensorForest.from_numpy(rf.feature, rf.threshold,
                                             rf.leaf), 2)
    start = tcore.sample_starts(torch.Generator().manual_seed(4), B, 8,
                                n_shards=4)
    by_gc = ring_eval(gc, torch.as_tensor(x), start, 0.3, 8, RingMesh(4),
                      tables=reorder_tables(gc, 4))
    by_pack = ring_eval(tpacks["fp32"], torch.as_tensor(x), start, 0.3, 8,
                        RingMesh(4))
    for a, b in zip(by_gc, by_pack):
        assert torch.equal(a, b)


def test_engine_draws_stratified_starts(field):
    x, _, _, tpacks = field
    eng = tcore.FogEngine(tpacks["fp32"], backend="ring", mesh=RingMesh(8),
                          use_kernels=True, device="cpu")
    pol = tcore.FogPolicy(threshold=0.3)
    got = eng.eval(x, torch.Generator().manual_seed(3), policy=pol)
    start = tcore.sample_starts(torch.Generator().manual_seed(3), B, 8,
                                n_shards=8)
    want = tcore.FogEngine(tpacks["fp32"], device="cpu").eval(
        x, start=start, policy=pol)
    assert eng.n_shards == 8
    assert torch.equal(got.hops, want.hops)
    assert torch.equal(got.proba, want.proba)


# ----------------------------------------------------------- the errors

def test_ring_errors(field):
    x, rf, _, tpacks = field
    pack = tpacks["fp32"]
    E, P = tcore.FogEngine, tcore.FogPolicy
    with pytest.raises(ValueError, match="mesh"):
        E(pack, backend="ring", device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        E(pack, backend="ring", mesh=RingMesh(3), device="cpu")
    with pytest.raises(ValueError, match="one grove per shard"):
        E(pack, backend="ring", mesh=RingMesh(4), use_kernels=True,
          device="cpu")
    with pytest.raises(ValueError, match="ring backend only"):
        E(pack, backend="fused", use_kernels=True, device="cpu")
    for kw in (dict(lazy=True), dict(chunk_b=64)):
        with pytest.raises(ValueError, match="lazy/chunk_b"):
            E(pack, backend="ring", mesh=RingMesh(2), device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="single-output"):
        E(two_heads(rf), backend="ring", mesh=RingMesh(2), device="cpu")
    eng = E(pack, backend="ring", mesh=RingMesh(2), device="cpu")
    with pytest.raises(ValueError, match="lazy/chunk_b"):
        eng.eval(x, start=np.zeros(B, np.int32), policy=P(lazy=True))
    # a policy asking for the ring on an engine built without a mesh
    with pytest.raises(ValueError, match="mesh"):
        E(pack, device="cpu").eval(x, torch.Generator(),
                                   policy=P(backend="ring"))
    with pytest.raises(ValueError, match="sample_starts"):
        eng.eval(x, start=np.zeros(B, np.int32))
    with pytest.raises(ValueError, match="divide over 2"):
        ring_eval(pack, torch.as_tensor(x[:B - 1]), np.arange(B - 1) % 8,
                  0.3, 8, RingMesh(2))
    with pytest.raises(ValueError, match=r"\[0, 8\)"):
        ring_eval(pack, torch.as_tensor(x), np.arange(B) % 8 + 8, 0.3, 8,
                  RingMesh(2))
    with pytest.raises(ValueError, match="at least one shard"):
        RingMesh(0)


# --------------------------------------- the ring over a process group

def _rank_main(rank, world, init_file, payload, out_dir):
    """One gloo rank: evaluate the payload's ring with RingMesh(world, the
    default group) and save its result."""
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        pack = TPack.from_numpy(*payload["tables"], payload["precision"])
        eng = tcore.FogEngine(pack, backend="ring",
                              mesh=RingMesh(world, dist.group.WORLD),
                              use_kernels=payload["use_kernels"],
                              device="cpu")
        res = eng.eval(payload["x"], start=payload["start"],
                       policy=tcore.FogPolicy(**payload["policy"]))
        torch.save({"proba": res.proba, "hops": res.hops,
                    "label": res.label}, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(world, payload, tmp_path):
    """Spawn ``world`` gloo ranks on the CPU; their results in rank order."""
    ctx = mp.start_processes(
        _rank_main, args=(world, str(tmp_path / "init"), payload,
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


@pytest.mark.parametrize("world,grove_size,precision", [
    (4, 4, "int8"),     # a 4 x 4 field: one grove per rank, the kernel path
    (2, 2, "bf16"),     # the 8-grove field: four groves per rank, gathered
])
def test_process_group_ring_equals_stacked_ring(trained, tmp_path, world,
                                                grove_size, precision):
    ds, rf = trained
    gc = tcore.split(TensorForest.from_numpy(rf.feature, rf.threshold,
                                             rf.leaf), grove_size)
    pack = TPack.from_groves(gc, precision)
    use_kernels = gc.n_groves == world
    x = ds.x_test[:B]
    start = tcore.sample_starts(torch.Generator().manual_seed(world), B,
                                gc.n_groves, n_shards=world)
    tvec, bvec = lane_policies()
    policy = dict(threshold=torch.as_tensor(tvec),
                  hop_budget=torch.as_tensor(bvec), max_hops=5)
    want = tcore.FogEngine(pack, backend="ring", mesh=RingMesh(world),
                           use_kernels=use_kernels, device="cpu").eval(
        x, start=start, policy=tcore.FogPolicy(**policy))
    payload = {"tables": [getattr(pack, f).view(torch.int16).numpy()
                          .view(np.uint16) if precision == "bf16"
                          and f in ("threshold", "leaf")
                          else getattr(pack, f).numpy() for f in FIELDS],
               "precision": precision, "use_kernels": use_kernels,
               "x": x, "start": start, "policy": policy}
    for rank, got in enumerate(run_ranks(world, payload, tmp_path)):
        for f in ("proba", "hops", "label"):
            assert torch.equal(got[f], getattr(want, f)), (rank, f)
