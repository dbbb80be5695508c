"""repro_torch's group fused_fog kernel, replayed on the CPU, against the
plain version and the JAX package's reference loop; and the route rule.

The group kernel (``csrc/fog_kernels.cu::fused_fog_group_kernel``) walks
the trees of K hops at once, then gates hop by hop in order, with each
head's classes split over the lane's group of threads and its MaxDiff
merged by shuffles.  ``fused_fog_group_replay`` replays that decomposition
in PyTorch; it must equal ``fused_fog_ref`` bit for bit (``torch.equal``:
the same operations on the same values in the same order), and JAX's
``_eval_core(..., "reference")`` fed the same starts at the engine bar
(hops and labels equal, proba within rtol 1e-6 / atol 1e-7; XLA:CPU may
contract the int8 leaf dequantize into an FMA, ROADMAP §C).  The kernel
itself runs only on the card (``tests/test_torch_cuda.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.engine import _eval_core  # noqa: E402
from repro.forest.pack import ForestPack as JPack  # noqa: E402
from repro_torch.forest.pack import ForestPack as TPack  # noqa: E402
from repro_torch.kernels import fused_fog as ff  # noqa: E402
from repro_torch.kernels.ref import top2_confidence_ref  # noqa: E402

PRECISIONS = ["fp32", "bf16", "int8"]
FIELDS = ("feature", "threshold", "leaf", "thr_scale", "leaf_scale")
TOL = {"rtol": 1e-6, "atol": 1e-7}
# the bench field: 8 groves of 2 trees of depth 8, 10 classes, 16 features
BENCH = {"G": 8, "t": 2, "d": 8, "C": 10, "F": 16}
# an H100: 132 SMs, cudaDevAttrMaxSharedMemoryPerBlockOptin
H100_SMS, H100_SMEM_OPTIN = 132, 232_448
# BENCH_engine.json's table_bytes of the bench field
TABLE_BYTES = {"fp32": 196_608, "bf16": 106_528, "int8": 61_488}


def packs(rng, precision, O, G, t, d, C, F):
    """(JAX pack, port pack) of O heads from the same packed arrays, with
    +inf and -inf padding nodes in play."""
    N = 2**d - 1
    feat = rng.integers(0, F, (O, G, t, N)).astype(np.int32)
    thr = rng.normal(size=(O, G, t, N)).astype(np.float32)
    thr[rng.random(thr.shape) < 0.15] = np.inf
    thr[rng.random(thr.shape) < 0.05] = -np.inf
    leaf = rng.dirichlet(np.ones(C) * 0.5, size=(O, G, t, 2**d)).astype(
        np.float32)
    jp = JPack._pack(jnp.asarray(feat), jnp.asarray(thr), jnp.asarray(leaf),
                     precision)
    tp = TPack.from_numpy(*(np.asarray(getattr(jp, f)) for f in FIELDS),
                          precision)
    return jp, tp


def lanes(rng, B, G, F, max_hops):
    """x, start, per-lane thresholds and budgets, as numpy."""
    return (rng.normal(size=(B, F)).astype(np.float32),
            rng.integers(0, G, B).astype(np.int32),
            (rng.random(B) * 0.8).astype(np.float32),
            rng.integers(1, max_hops + 1, B).astype(np.int32))


def fused_args(tp, x, start, thresh, budget):
    lay = tp.layout("fused")
    return (*lay[:3], *map(torch.as_tensor, (x, start, thresh, budget)),
            *lay[3:])


def replay(args, max_hops, K=None):
    O, _, t = args[0].shape[:3]
    C = args[2].shape[-1]
    B = args[3].shape[0]
    K = ff.walk_hops(B, max_hops, O, t, C, H100_SMS) if K is None else K
    return ff.fused_fog_group_replay(*args, max_hops=max_hops,
                                     hops_per_walk=K,
                                     group=ff.group_size(O, t, C, K))


@pytest.mark.parametrize("max_hops", range(1, 9))
@pytest.mark.parametrize("B", [1, 97, 1000])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_group_replay_equals_plain(precision, heads, B, max_hops):
    """The decomposition at the kernel's own K (``walk_hops``) and group
    size, per-lane thresholds and budgets: torch.equal to fused_fog_ref."""
    rng = np.random.default_rng(1000 * heads + B + max_hops)
    _, tp = packs(rng, precision, heads, **{k: v for k, v in BENCH.items()
                                             if k != "F"}, F=BENCH["F"])
    args = fused_args(tp, *lanes(rng, B, BENCH["G"], BENCH["F"], max_hops))
    pr, hr = ff.fused_fog_ref(*args, max_hops=max_hops)
    pk, hk = replay(args, max_hops)
    assert torch.equal(hk, hr)
    assert torch.equal(pk, pr)


@pytest.mark.parametrize("K", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("shape", [(1, 5, 3, 6, 7, 9), (2, 4, 4, 5, 26, 12),
                                   (1, 3, 8, 4, 3, 5)],
                         ids=lambda s: "x".join(map(str, s)))
def test_every_batch_size_k_equals_plain(shape, K):
    """Batches of K hops that do not divide max_hops, more trees than the
    group has threads (walk slots looped), C = 26 over two heads."""
    O, G, t, d, C, F = shape
    rng = np.random.default_rng(K + sum(shape))
    _, tp = packs(rng, "int8", O, G, t, d, C, F)
    args = fused_args(tp, *lanes(rng, 257, G, F, 8))
    pr, hr = ff.fused_fog_ref(*args, max_hops=8)
    pk, hk = replay(args, 8, K)
    assert torch.equal(hk, hr) and torch.equal(pk, pr)


@pytest.mark.parametrize("max_hops", [1, 4, 8])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_group_replay_matches_jax_reference(precision, heads, max_hops):
    """JAX's reference loop from the same starts, thresholds and budgets."""
    rng = np.random.default_rng(7 * heads + max_hops)
    jp, tp = packs(rng, precision, heads, **{k: v for k, v in BENCH.items()
                                             if k != "F"}, F=BENCH["F"])
    x, start, thresh, budget = lanes(rng, 97, BENCH["G"], BENCH["F"],
                                     max_hops)
    pk, hk = replay(fused_args(tp, x, start, thresh, budget), max_hops)
    want = _eval_core(jp, jnp.asarray(x), jnp.asarray(start),
                      jnp.asarray(thresh), jnp.asarray(budget), max_hops,
                      "reference", 256, False)
    proba = pk[:, 0] if heads == 1 else pk
    np.testing.assert_array_equal(hk.numpy(), np.asarray(want.hops))
    np.testing.assert_array_equal(proba.argmax(-1).numpy(),
                                  np.asarray(want.label))
    np.testing.assert_allclose(proba.numpy(), np.asarray(want.proba), **TOL)


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("C", [1, 2, 7, 10, 26, 33])
def test_group_margin_equals_top2_with_ties(group, C):
    """The shuffle merge masks only the first maximum, in any order: equal
    to the plain MaxDiff with repeated maxima and repeated seconds."""
    rng = np.random.default_rng(group * 100 + C)
    v = torch.as_tensor(rng.integers(0, 4, (300, C)).astype(np.float32) / 4)
    v[:20] = 0.5
    assert torch.equal(ff.group_margin(v, group), top2_confidence_ref(v))


def test_group_size_rule():
    """16 threads for the bench field's 8 hops x 2 trees; raised until each
    thread holds at most FUSED_ACC accumulators; None past 32."""
    assert ff.group_size(1, 2, 10, 8) == 16
    assert ff.group_size(1, 2, 10, 1) == 2
    assert ff.group_size(1, 2, 26, 1) == 4          # ceil(26 / 4) = 7
    assert ff.group_size(2, 8, 10, 8) == 32          # 128 walks, looped
    assert ff.group_size(2, 2, 128, 8) == 32         # 2 x 4 = FUSED_ACC
    assert ff.group_size(2, 2, 129, 8) is None       # 2 x 5 > FUSED_ACC
    for O, t, C, K in ((1, 2, 10, 8), (2, 3, 26, 4), (1, 1, 1, 1)):
        g = ff.group_size(O, t, C, K)
        assert g & (g - 1) == 0 and O * -(-C // g) <= ff.FUSED_ACC


def test_walk_hops_rule():
    """K = max_hops while the batch's groups fit one wave of the card's
    threads (132 x 2048), halved past it: 8 up to B = 16,384 at the bench
    field, 2 at 65,536; an odd max_hops halves upwards."""
    bench = (1, 2, 10, H100_SMS)
    assert [ff.walk_hops(B, 8, *bench) for B in (1, 1000, 16_384, 65_536)] \
        == [8, 8, 8, 2]
    assert ff.walk_hops(30_000, 5, *bench) == 3       # 5 -> 3: 8 threads
    assert ff.walk_hops(10**7, 8, *bench) == 1
    for B in (1000, 65_536):
        K = ff.walk_hops(B, 8, *bench)
        assert B * ff.group_size(1, 2, 10, K) <= H100_SMS * ff.SM_THREADS


@pytest.mark.parametrize("precision", PRECISIONS)
def test_route_rule_at_the_bench_field(precision):
    """The bench field's tables (BENCH_engine.json's 196,608 / 106,528 /
    61,488 B) plus region padding and the groups' rows fit one block's
    shared memory at every precision; with the engine's 128 threads the
    copies' traffic sends int8 at B = 1000 (125 copies, 7.7 MB) to "smem",
    fp32 and bf16 there (24.6 and 13.3 MB) and all three at 65,536 (a grid
    that loops) to "l1"; int8 and bf16 at B = 128 (3.9 and 6.8 MB) to
    "smem", fp32 there (12.6 MB) and all three at 2000 to "l1"."""
    itemsize = {"fp32": 4, "bf16": 2, "int8": 1}[precision]
    G, t, d, C, F = (BENCH[k] for k in ("G", "t", "d", "C", "F"))
    _, tp = packs(np.random.default_rng(0), precision, 1, G, t, d, C, F)
    assert tp.table_bytes == TABLE_BYTES[precision]
    need = ff.table_smem_bytes(1, G, t, d, C, itemsize)
    assert TABLE_BYTES[precision] < need <= TABLE_BYTES[precision] + 5 * 32
    for B in (1000, 65_536):
        p = ff.plan("smem", B, 1, G, t, d, C, F, itemsize, 8, 128, H100_SMS)
        assert p["smem"] <= H100_SMEM_OPTIN
    rule = (1, G, t, d, C, F, itemsize, 8, 128, H100_SMS, H100_SMEM_OPTIN)
    assert ff.route(1000, *rule) == ("smem" if precision == "int8"
                                     else "l1")
    assert ff.route(65_536, *rule) == "l1"
    # where the copy-bytes line falls (chip_smoke.py's BOUNDARY_GRID): 64
    # copies at B = 128, 250 at 2000
    assert ff.route(128, *rule) == ("l1" if precision == "fp32"
                                    else "smem")
    assert ff.route(2000, *rule) == "l1"
    p = ff.plan("smem", 1000, 1, G, t, d, C, F, itemsize, 8, 128, H100_SMS)
    assert p["grid"] == 125 and p["groups_per_block"] == 8
    assert (p["grid"] * need <= ff.SMEM_COPY_BYTES) == (precision == "int8")
    big = ff.plan("l1", 65_536, 1, G, t, d, C, F, itemsize, 8, 128,
                  H100_SMS)
    assert (big["K"], big["group"], big["threads"]) == (2, 4, 128)


def test_route_rule_beyond_the_bench_field():
    """Two fp32 heads (393 KB) are over shared memory: "l1" at any B; a
    lane state over the registers takes the lane route; a block runs at
    most 512 threads (the kernel's launch bound); mnist's 784 features
    gather x through L1 at 64 groups a block."""
    assert ff.table_smem_bytes(2, 8, 2, 8, 10, 4) > H100_SMEM_OPTIN
    for B in (1, 1000, 65_536):
        assert ff.route(B, 2, 8, 2, 8, 10, 16, 4, 8, 1024, H100_SMS,
                        H100_SMEM_OPTIN) == "l1"
    assert ff.route(65_536, 2, 4, 2, 5, 129, 16, 4, 8, 1024, H100_SMS,
                    H100_SMEM_OPTIN) == "lane"
    assert ff.plan("l1", 65_536, 1, 8, 2, 8, 10, 16, 4, 8, 1024,
                   H100_SMS)["threads"] == ff.GROUP_THREADS == 512
    p = ff.plan("l1", 1000, 1, 8, 2, 8, 10, 784, 4, 8, 1024, H100_SMS)
    assert p["groups_per_block"] == 8 and p["stage_x"] is False
    assert ff.plan("l1", 97, 1, 8, 2, 8, 10, 784, 4, 8, 1024,
                   H100_SMS)["stage_x"]             # two groups a block


def test_launch_plan_is_keyed_by_the_route_name():
    """A call's cached plan: the rule's route when none is named, else the
    named route, at the rule's K or a named one; equal to :func:`plan`."""
    shape = (1000, 1, 8, 2, 8, 10, 16, 1, 8, 128, H100_SMS)
    rule = ff.route(*shape, H100_SMEM_OPTIN)
    assert ff._launch_plan(None, *shape, H100_SMEM_OPTIN, None) == \
        ff.plan(rule, *shape)
    for name in ff.ROUTES:
        assert ff._launch_plan(name, *shape, H100_SMEM_OPTIN, None) == \
            ff.plan(name, *shape)
    p = ff._launch_plan("l1", *shape, H100_SMEM_OPTIN, 2)
    assert p["route"] == "l1" and p["K"] == 2 and p["group"] == 4
    with pytest.raises(ValueError, match="route must be one of"):
        ff.fused_fog_on_route(*[None] * 7, max_hops=8, route="global")


@pytest.mark.parametrize("B", [1, 97, 1000, 65_536])
@pytest.mark.parametrize("block_b", [32, 96, 128, 1024])
def test_plan_covers_the_batch(B, block_b):
    """Every plan's groups cover the batch: one lane a group on "l1", the
    grid's groups looping on "smem"; threads a multiple of 32 and of the
    group, at most block_b; the l1 grid gives every SM a block where the
    batch allows."""
    for name in ("l1", "smem"):
        p = ff.plan(name, B, 1, 8, 2, 8, 10, 16, 4, 8, block_b, H100_SMS)
        assert p["threads"] % 32 == 0
        assert p["threads"] <= min(block_b, ff.GROUP_THREADS)
        assert p["threads"] % p["group"] == 0
        assert p["groups_per_block"] == p["threads"] // p["group"]
        groups = p["grid"] * p["groups_per_block"]
        if name == "l1":
            assert groups >= B > groups - p["groups_per_block"]
            if B >= H100_SMS and block_b >= 128:
                assert p["grid"] >= min(H100_SMS,
                                        -(-B // p["groups_per_block"]))
        else:
            assert groups >= min(B, groups)
    lane = ff.plan("lane", B, 1, 8, 2, 8, 10, 16, 4, 8, block_b, H100_SMS)
    assert lane["threads"] == block_b
    assert lane["grid"] * block_b >= B
