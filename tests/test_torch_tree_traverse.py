"""repro_torch's tree_traverse (on the CPU: its plain version) against the
JAX package's reference and its Pallas kernel in interpret mode, on packs
made with numpy from a seed, plus the shared-memory sizing of the CUDA
kernel.

Tolerances: the port sums the trees in order and divides by t, as the
eager JAX reference does, so the two are equal.  The jitted Pallas path
may sum more than two trees in another order, and XLA:CPU contracts the
int8 leaf dequantize into an FMA there (ROADMAP §C): it is equal for two
fp32/bf16 trees, and otherwise within rtol 1e-6 / atol 1e-7 (the engine
bar of tests/test_engine_conformance.py).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.kernels.ops as jops  # noqa: E402
import repro.kernels.ref as jref  # noqa: E402
from repro.forest.pack import ForestPack as JPack  # noqa: E402
from repro_torch.forest.pack import ForestPack as TPack  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.tree_traverse import (check_smem,  # noqa: E402
                                               smem_bytes)

PRECISIONS = ["fp32", "bf16", "int8"]
# (t, d, C, F, B): the bench grove at the test set's size, and two
# unaligned batches with more trees
SHAPES = [(2, 8, 10, 16, 1000), (4, 5, 7, 16, 83), (8, 6, 3, 12, 37)]
TOL = {"rtol": 1e-6, "atol": 1e-7}
FIELDS = ("feature", "threshold", "leaf", "thr_scale", "leaf_scale")
# cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100
H100_SMEM_OPTIN = 232_448


def grove_packs(rng, precision, t, d, C, F, G=1):
    """(JAX pack, port pack) of G groves of t trees, from the same packed
    arrays, with +inf and -inf padding nodes in play."""
    N = 2**d - 1
    feat = rng.integers(0, F, (1, G, t, N)).astype(np.int32)
    thr = rng.normal(size=(1, G, t, N)).astype(np.float32)
    thr[rng.random(thr.shape) < 0.15] = np.inf
    thr[rng.random(thr.shape) < 0.05] = -np.inf
    leaf = rng.dirichlet(np.ones(C), size=(1, G, t, 2**d)).astype(np.float32)
    jp = JPack._pack(jnp.asarray(feat), jnp.asarray(thr), jnp.asarray(leaf),
                     precision)
    tp = TPack.from_numpy(*(np.asarray(getattr(jp, f)) for f in FIELDS),
                          precision)
    return jp, tp


def grove(pack, g=0):
    return tuple(getattr(pack, f)[0, g] for f in FIELDS)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("precision", PRECISIONS)
def test_port_matches_jax_reference_and_pallas(precision, shape):
    t, d, C, F, B = shape
    rng = np.random.default_rng(sum(shape))
    jp, tp = grove_packs(rng, precision, t, d, C, F)
    x = rng.normal(size=(B, F)).astype(np.float32)
    feat, thr, leaf, ts, ls = grove(tp)
    got = ops.tree_traverse(feat, thr, leaf, torch.as_tensor(x), ts, ls,
                            block_b=128)
    assert got.dtype == torch.float32 and got.shape == (B, C)
    jfeat, jthr, jleaf, jts, jls = grove(jp)
    eager = jref.tree_traverse_ref(jfeat, jthr, jleaf, jnp.asarray(x), jts,
                                   jls)
    np.testing.assert_array_equal(got.numpy(), np.asarray(eager))
    pallas = jops.tree_traverse(jfeat, jthr, jleaf, jnp.asarray(x), jts, jls,
                                block_b=128)
    if t == 2 and precision != "int8":
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_stacked_shards_walk_their_own_grove(precision):
    """S stacked shards [S, b, F] in one call equal each shard's own call
    and the JAX reference on that shard's grove."""
    S, t, d, C, F, b = 8, 2, 6, 5, 9, 37
    rng = np.random.default_rng(5)
    jp, tp = grove_packs(rng, precision, t, d, C, F, G=S)
    x = rng.normal(size=(S, b, F)).astype(np.float32)
    got = ops.tree_traverse(*(getattr(tp, f)[0] for f in FIELDS[:3]),
                            torch.as_tensor(x),
                            *(getattr(tp, f)[0] for f in FIELDS[3:]))
    assert got.shape == (S, b, C)
    for s in range(S):
        feat, thr, leaf, ts, ls = grove(tp, s)
        one = ops.tree_traverse(feat, thr, leaf, torch.as_tensor(x[s]), ts,
                                ls)
        assert torch.equal(got[s], one)
        want = jref.tree_traverse_ref(*grove(jp, s)[:3], jnp.asarray(x[s]),
                                      *grove(jp, s)[3:])
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))


def test_omitted_scales_are_ones():
    rng = np.random.default_rng(3)
    _, tp = grove_packs(rng, "fp32", 4, 5, 7, 16)
    x = torch.as_tensor(rng.normal(size=(50, 16)).astype(np.float32))
    feat, thr, leaf, ts, ls = grove(tp)
    assert torch.equal(ops.tree_traverse(feat, thr, leaf, x),
                       ops.tree_traverse(feat, thr, leaf, x, ts, ls))


def test_smem_bytes_of_the_bench_grove():
    """One grove of the bench field (2 trees of depth 8 over 10 classes),
    the BENCH_engine.json table_bytes over its 8 groves."""
    assert [smem_bytes(2, 8, 10, s) for s in (4, 2, 1)] == [24_576, 13_316,
                                                            7_686]
    jp, _ = grove_packs(np.random.default_rng(0), "bf16", 2, 8, 10, 16, G=8)
    assert smem_bytes(2, 8, 10, 2) * 8 == jp.table_bytes
    check_smem(smem_bytes(2, 8, 10, 4), H100_SMEM_OPTIN, "bench grove")


def test_smem_rejects_the_oversized_forest():
    """tests/test_kernels.py's over-budget forest (t=32, d=12, C=30): its
    leaves alone are 15.7 MB, far over one block's shared memory."""
    need = smem_bytes(32, 12, 30, 4)
    assert need > 32 * 2**12 * 30 * 4
    with pytest.raises(ValueError, match=r"(?s)shared memory.*232448 B.*"
                                         r"int8.*smaller groves"):
        check_smem(need, H100_SMEM_OPTIN, "t=32, d=12, C=30")
    # int8 does not save this one either: still over
    with pytest.raises(ValueError, match=str(smem_bytes(32, 12, 30, 1))):
        check_smem(smem_bytes(32, 12, 30, 1), H100_SMEM_OPTIN, "int8")


# ------------------------------------------------- the spread kernel's plan

# an H100's SM count
H100_SMS = 132


@pytest.mark.parametrize("S,b", [(8, 125), (8, 37), (1, 1000), (8, 8192),
                                 (3, 1), (5, 1001)])
@pytest.mark.parametrize("block_b", [32, 128, 1024])
@pytest.mark.parametrize("n_sm", [H100_SMS, 7])
def test_lane_plan_serves_every_lane_once(S, b, block_b, n_sm):
    """Every lane of every shard falls in exactly one block of the grid,
    ragged b included; a block serves at most block_b lanes on at most
    1024 threads, a multiple of 32."""
    from repro_torch.kernels.tree_traverse import block_lanes, lane_plan
    plan = lane_plan(S, b, 2, 16, block_b, n_sm)
    seen = np.zeros((S, b), np.int64)
    for s, lane0, nl in block_lanes(plan, S, b):
        assert 1 <= nl <= plan["lanes"] <= block_b
        seen[s, lane0:lane0 + nl] += 1
    assert (seen == 1).all()
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 1024
    assert plan["threads"] >= min(1024, plan["lanes"] * 2)


@pytest.mark.parametrize("S,b", [(8, 125), (1, 1000)])
def test_grid_fills_the_sms_at_the_bench_batch(monkeypatch, S, b):
    """The ring's hop at B = 1000 (8 shards of 125) and one grove of 1000
    lanes: at least a block per SM of the 132 patched in as the card's."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.tree_traverse import lane_plan
    monkeypatch.setattr(_build, "sm_count", lambda device: H100_SMS)
    plan = lane_plan(S, b, 2, 16, 128,
                     _build.sm_count(torch.device("cuda")))
    assert plan["grid"][0] * plan["grid"][1] >= H100_SMS
    assert plan["lanes"] == 2 and plan["threads"] == 32


def test_lane_plan_at_the_ring_batches():
    """The plan's lane counts at the ring's batches on 132 SMs (2 lanes a
    block at B = 1000, 32 at 65,536), x staged, the shared memory the
    leaf rows and x rows take; a named lane count overrides the rule."""
    from repro_torch.kernels.tree_traverse import lane_plan
    for b, lanes in ((125, 2), (512, 2), (2048, 8), (8192, 32)):
        plan = lane_plan(8, b, 2, 16, 128, H100_SMS)
        assert plan["lanes"] == lanes and plan["stage_x"]
        assert plan["smem"] == lanes * (2 + 16) * 4
    plan = lane_plan(8, 125, 2, 16, 128, H100_SMS, lanes=7)
    assert plan["lanes"] == 7 and plan["grid"] == (18, 8)
    # mnist's 784 features at 32 lanes: 100 KB of x rows, gathered instead
    plan = lane_plan(8, 8192, 2, 784, 128, H100_SMS)
    assert not plan["stage_x"] and plan["smem"] == 32 * 2 * 4


def test_named_routes_are_the_declared_ones():
    """tree_traverse_on_route takes the spread kernel or the first port's
    kernel by name, and refuses any other name before it reads a tensor."""
    from repro_torch.kernels.tree_traverse import ROUTES, tree_traverse_on_route
    assert ROUTES == ("spread", "lane")
    with pytest.raises(ValueError, match="route must be one of"):
        tree_traverse_on_route(None, None, None, None, route="smem")


@pytest.mark.parametrize("shape", [(8, 2, 8, 10, 16, 125), (8, 2, 8, 10, 16,
                                                           37),
                                   (3, 4, 5, 7, 9, 50), (2, 8, 6, 3, 12, 1)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("precision", PRECISIONS)
def test_spread_replay_equals_plain(precision, shape):
    """The spread kernel's plan and tree-order sums, replayed: one walk
    per (lane, tree), each output entry summed in tree order, / t, written
    once -- torch.equal to tree_traverse_ref on stacked shards."""
    from repro_torch.kernels.tree_traverse import (
        lane_plan, tree_traverse_spread_replay)
    S, t, d, C, F, b = shape
    rng = np.random.default_rng(sum(shape))
    _, tp = grove_packs(rng, precision, t, d, C, F, G=S)
    tables = [getattr(tp, f)[0] for f in FIELDS]
    x = torch.as_tensor(rng.normal(size=(S, b, F)).astype(np.float32))
    plan = lane_plan(S, b, t, F, 128, H100_SMS)
    got = tree_traverse_spread_replay(*tables[:3], x, *tables[3:], plan)
    assert torch.equal(got, ref_traverse(tables, x))


def ref_traverse(tables, x):
    from repro_torch.kernels.ref import tree_traverse_ref
    return tree_traverse_ref(*tables[:3], x, *tables[3:])
