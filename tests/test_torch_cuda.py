"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU (decided in the
``cuda`` fixture, never at import).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX: the card's machine has none.
"""
import pytest

torch = pytest.importorskip("torch")

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch.forest import ForestPack  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.fused_fog import fused_fog_ref  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda

PRECISIONS = ["fp32", "bf16", "int8"]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode "
                    "(their plain versions are tested on the CPU)")
    return torch.device("cuda")


def random_tables(rng, O=1, G=5, t=3, depth=6, C=7, F=9):
    N, L = 2**depth - 1, 2**depth
    feature = rng.integers(0, F, (O, G, t, N)).astype(np.int32)
    thr = rng.normal(size=(O, G, t, N)).astype(np.float32)
    thr[rng.random(thr.shape) < 0.2] = np.inf
    leaf = rng.random((O, G, t, L, C)).astype(np.float32)
    return tuple(map(torch.as_tensor, (feature, thr, leaf)))


def random_pack(rng, precision, **shape):
    return ForestPack._pack(*random_tables(rng, **shape), precision)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_packing_on_card_equals_cpu(cuda, precision):
    tables = random_tables(np.random.default_rng(9), O=2)
    tables[1][0, 0, 0, :3] = -np.inf               # the -127 sentinel too
    on_cpu = ForestPack._pack(*tables, precision)
    on_card = ForestPack._pack(*(a.to(cuda) for a in tables), precision)
    for f in ("feature", "threshold", "leaf", "thr_scale", "leaf_scale"):
        got, want = getattr(on_card, f), getattr(on_cpu, f)
        assert got.device.type == "cuda" and got.dtype == want.dtype
        assert torch.equal(got.cpu(), want), f


def test_top2_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    p = torch.as_tensor(rng.random((1031, 10), dtype=np.float32), device=cuda)
    p[:50, 2] = p[:50, 6] = 5.0                     # ties at the max
    p[50:60] = 0.5                                  # all equal
    before = ops.launches["top2_confidence"]
    got = ops.top2_confidence(p, block_b=128)
    assert ops.launches["top2_confidence"] == before + 1
    assert torch.equal(got, ref.top2_confidence_ref(p))
    assert (got[:60] == 0).all()


@pytest.mark.parametrize("per_lane", [False, True])
def test_grove_aggregate_kernel_matches_plain(cuda, per_lane):
    rng = np.random.default_rng(1)
    B, C = 777, 26
    prob = torch.as_tensor(rng.random((B, C), dtype=np.float32) * 3,
                           device=cuda)
    contrib = torch.as_tensor(rng.random((B, C), dtype=np.float32),
                              device=cuda)
    live = torch.as_tensor(rng.random(B) < 0.6, device=cuda)
    hops = torch.as_tensor(rng.integers(0, 5, B, dtype=np.int32), device=cuda)
    thresh = (torch.as_tensor(rng.random(B, dtype=np.float32), device=cuda)
              if per_lane else 0.2)
    got = ops.grove_aggregate(prob, contrib, live, hops, thresh, block_b=64)
    want = ref.grove_aggregate_ref(prob, contrib, live, hops, thresh)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_fused_kernel_matches_plain(cuda, precision, heads):
    rng = np.random.default_rng(2 + heads)
    pack = random_pack(rng, precision, O=heads).to(cuda)
    B = 1000
    x = torch.as_tensor(rng.normal(size=(B, 9)).astype(np.float32),
                        device=cuda)
    start = torch.as_tensor(rng.integers(0, 5, B, dtype=np.int32),
                            device=cuda)
    thresh = torch.as_tensor(rng.random(B, dtype=np.float32) * 0.5,
                             device=cuda)
    budget = torch.as_tensor(rng.integers(1, 6, B, dtype=np.int32),
                             device=cuda)
    args = (*pack.layout("fused")[:3], x, start, thresh, budget,
            *pack.layout("fused")[3:])
    pk, hk = ops.fused_fog(*args, max_hops=5, block_b=96)
    pr, hr = fused_fog_ref(*args, max_hops=5)
    assert torch.equal(hk, hr)
    torch.testing.assert_close(pk, pr, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_engine_backends_agree_on_card(cuda, trained_port, precision):
    ds, gc = trained_port
    x = torch.as_tensor(ds.x_test[:513], device=cuda)
    before = dict(ops.launches)
    res = {}
    for b in ("fused", "pallas", "reference"):
        eng = tcore.FogEngine(gc, backend=b, precision=precision,
                              device=cuda)
        res[b] = eng.eval(x, torch.Generator(device=cuda).manual_seed(5),
                          policy=tcore.FogPolicy(threshold=0.3))
    assert ops.launches["fused_fog"] == before["fused_fog"] + 1
    assert ops.launches["grove_aggregate"] == before["grove_aggregate"] + 8
    for b in ("fused", "pallas"):
        assert torch.equal(res[b].hops, res["reference"].hops)
        assert torch.equal(res[b].label, res["reference"].label)
        torch.testing.assert_close(res[b].proba, res["reference"].proba,
                                   rtol=1e-6, atol=1e-7)
    cpu = tcore.FogEngine(gc, precision=precision, device="cpu").eval(
        ds.x_test[:513], policy=tcore.FogPolicy(threshold=0.3),
        start=tcore.sample_starts(
            torch.Generator(device=cuda).manual_seed(5), 513, 8).cpu())
    assert torch.equal(res["fused"].hops.cpu(), cpu.hops)


@pytest.fixture(scope="module")
def trained_port():
    from repro_torch.data import make_dataset
    from repro_torch.forest import TrainConfig, train_random_forest
    ds = make_dataset("penbased")
    rf = train_random_forest(ds.x_train, ds.y_train, ds.n_classes,
                             TrainConfig(n_trees=16, max_depth=6, seed=1))
    return ds, tcore.split(rf, 2)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    p = torch.rand((64, 10), device=cuda)
    with pytest.raises(ValueError, match="threads per block"):
        ops.top2_confidence(p, block_b=48)
    with pytest.raises(ValueError, match="contiguous"):
        ops.top2_confidence(p.t())
    with pytest.raises(TypeError):
        ops.top2_confidence(p.double())
    with pytest.raises(ValueError, match="dequantize"):
        ops.grove_aggregate(p, p.to(torch.int8), torch.ones(64, dtype=bool,
                                                            device=cuda),
                            torch.zeros(64, dtype=torch.int32, device=cuda),
                            0.3)


# ------------------------------------------------ the trainer's histogram

# (T, N, F, n_bins, C, nodes): small, unaligned, and the gate signature's
# deepest level (32 trees, 4000 rows, 16 features, 17 bins, 10 classes,
# 128 nodes at level 7)
HIST_SHAPES = [(2, 96, 3, 5, 3, 4), (3, 1001, 16, 17, 10, 8),
               (32, 4000, 16, 17, 10, 128)]


def hist_inputs(rng, device, T, N, F, n_bins, C, nodes):
    return (torch.as_tensor(rng.integers(0, nodes, (T, N), dtype=np.int32),
                            device=device),
            torch.as_tensor(rng.integers(0, C, N, dtype=np.int32),
                            device=device),
            torch.as_tensor(rng.integers(0, 4, (T, N)).astype(np.float32),
                            device=device),
            torch.as_tensor(rng.integers(0, n_bins, (N, F), dtype=np.uint8),
                            device=device))


@pytest.mark.parametrize("shape", HIST_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_histogram_kernel_matches_plain(cuda, shape):
    from repro_torch.kernels import histogram
    T, N, F, n_bins, C, nodes = shape
    args = hist_inputs(np.random.default_rng(sum(shape)), cuda, *shape)
    kw = dict(n_nodes=nodes, n_bins=n_bins, n_classes=C)
    before = ops.launches["histogram"]
    got = ops.histogram_level(*args, matmul_max_r=nodes * C, **kw)
    assert ops.launches["histogram"] == before + 1
    assert got.shape == (T, nodes, F, n_bins, C)
    # integer-valued sums: exact in any order, so equal, not close
    assert torch.equal(got, histogram.histogram_level_ref(*args, **kw))
    assert torch.equal(got, histogram.histogram_level_scatter(*args, **kw))
    assert torch.equal(got.cpu(), histogram.histogram_level_ref(
        *(a.cpu() for a in args), **kw))


@pytest.mark.parametrize("level", range(8))
def test_histogram_kernel_at_every_gate_level(cuda, level):
    """The gate fit's shape at each of its 8 levels (32 trees, 4000 rows,
    16 features, 17 bins, 10 classes): bit-equal to the plain version and
    the scatter twin, whatever the level's tile plan (clusters of 8 blocks
    at level 0, one block per tile at level 7)."""
    from repro_torch.kernels import histogram
    shape = (32, 4000, 16, 17, 10, 1 << level)
    args = hist_inputs(np.random.default_rng(level), cuda, *shape)
    kw = dict(n_nodes=1 << level, n_bins=17, n_classes=10)
    got = histogram.histogram_level_cuda(*args, **kw)
    assert torch.equal(got, histogram.histogram_level_ref(*args, **kw))
    assert torch.equal(got, histogram.histogram_level_scatter(*args, **kw))


def test_histogram_writes_every_cell_in_one_launch(cuda):
    """The output comes from torch.empty: memory the caching allocator
    hands back still full of NaN must come out bit-equal to the plain
    version, and the call runs one device kernel (no fill)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import histogram
    shape = (32, 4000, 16, 17, 10, 128)
    args = hist_inputs(np.random.default_rng(1), cuda, *shape)
    kw = dict(n_nodes=128, n_bins=17, n_classes=10)
    want = histogram.histogram_level_ref(*args, **kw)
    torch.cuda.synchronize()
    junk = torch.full((32, 1280, 272), float("nan"), device=cuda)
    del junk
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = histogram.histogram_level_cuda(*args, **kw)
        torch.cuda.synchronize()
    assert torch.equal(got, want)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "histogram_kernel" in names[0], names


def test_histogram_kernel_ignores_out_of_range_like_the_one_hot(cuda):
    from repro_torch.kernels import histogram
    rng = np.random.default_rng(4)
    node, y, w, bins = hist_inputs(rng, cuda, 2, 300, 4, 6, 3, 4)
    node[0, :20] = 4                        # one past the last node
    bins[20:40, 1] = 6                      # one past the last bin
    kw = dict(n_nodes=4, n_bins=6, n_classes=3)
    assert torch.equal(histogram.histogram_level_cuda(node, y, w, bins, **kw),
                       histogram.histogram_level_ref(node, y, w, bins, **kw))


@pytest.fixture(scope="module")
def small_train():
    from repro_torch.data import make_dataset
    ds = make_dataset("penbased")
    return ds.x_train[:2000], ds.y_train[:2000], ds.n_classes


def test_card_fit_equals_cpu_fit_with_the_same_draws(cuda, small_train):
    from repro_torch.forest import TrainConfig, grow_forest
    x, y, C = small_train
    T, depth, F = 4, 4, x.shape[1]
    rng = np.random.default_rng(0)
    w = rng.multinomial(len(y), np.full(len(y), 1 / len(y)),
                        size=T).astype(np.float32)
    masks = [rng.random((T, 1 << lv, F)) < 0.3 for lv in range(depth)]
    cfg = TrainConfig(n_trees=T, max_depth=depth, seed=0,
                      cost_weight=0.01,
                      feature_cost=np.linspace(1, 2, F).astype(np.float32))
    before = ops.launches["histogram"]
    card = grow_forest(x, y, C, cfg, device=cuda, weights=w,
                       feature_masks=masks)
    assert ops.launches["histogram"] == before + depth   # one per level
    cpu = grow_forest(x, y, C, cfg, device="cpu", weights=w,
                      feature_masks=masks)
    for f in ("feature", "threshold", "leaf"):
        assert getattr(card, f).device.type == "cuda"
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f


def test_untied_card_fit_equals_host_cart(cuda, small_train):
    from repro_torch.forest import TrainConfig, train_random_forest
    x, y, C = small_train
    kw = dict(n_trees=3, max_depth=5, bootstrap=False, max_features="all")
    card = train_random_forest(x, y, C, TrainConfig(trainer="device", **kw),
                               device=cuda)
    host = train_random_forest(x, y, C, TrainConfig(trainer="host", **kw))
    assert torch.equal(card.feature.cpu(), host.feature)
    assert torch.equal(card.threshold.cpu(), host.threshold)
    torch.testing.assert_close(card.leaf.cpu(), host.leaf, rtol=0, atol=1e-6)


def test_facade_on_card_save_load(cuda, small_train, tmp_path):
    from repro_torch.sklearn import FogClassifier
    x, y, _ = small_train
    clf = FogClassifier(n_trees=8, grove_size=2, max_depth=6,
                        trainer="device").fit(x, y)
    assert clf.engine_.device.type == "cuda"
    assert clf.forest_.feature.device.type == "cuda"
    before = ops.launches["fused_fog"]
    want = clf.predict(x[:500])
    assert ops.launches["fused_fog"] == before + 1
    clf.quantize("int8")
    want8 = clf.predict(x[:500])
    got = FogClassifier.load(clf.save(tmp_path / "m.npz")).predict(x[:500])
    np.testing.assert_array_equal(got, want8)
    assert (want == y[:500]).mean() > 0.85


def test_tune_histogram_on_card(cuda):
    from repro_torch.kernels import autotune
    try:
        cfg = autotune.tune_histogram(8, 4, 16, 17, 10, n_samples=2000,
                                      persist=False, device=cuda)
        assert cfg.source == "measured" and cfg.measured_s > 0
        assert cfg.block in (128, 256, 512)
        assert cfg.matmul_max_r % 10 == 0 and cfg.matmul_max_r <= 80
        assert autotune.best_hist_config(8, 4, 16, 17, 10, cuda) == cfg
    finally:
        autotune.clear_cache()


# ------------------------------------------------- the ring's grove walk

@pytest.mark.parametrize("stacked,b", [(1, 1000), (8, 125), (8, 37),
                                       (1, 37)])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_tree_traverse_kernel_matches_plain(cuda, precision, stacked, b):
    """The bench grove (2 trees of depth 8, 10 classes, 16 features): one
    grove with 2-D tables, 8 stacked shards, and unaligned batches."""
    from repro_torch.kernels.tree_traverse import tree_traverse_cuda
    rng = np.random.default_rng(b + stacked)
    pack = random_pack(rng, precision, G=stacked, t=2, depth=8, C=10,
                       F=16).to(cuda)
    tables = [getattr(pack, f)[0] for f in ("feature", "threshold", "leaf",
                                            "thr_scale", "leaf_scale")]
    if stacked == 1:
        tables = [a[0] for a in tables]
        x = rng.normal(size=(b, 16))
    else:
        x = rng.normal(size=(stacked, b, 16))
    x = torch.as_tensor(x.astype(np.float32), device=cuda)
    before = ops.launches["tree_traverse"]
    got = ops.tree_traverse(*tables[:3], x, *tables[3:], block_b=128)
    assert ops.launches["tree_traverse"] == before + 1
    want = ref.tree_traverse_ref(*tables[:3], x, *tables[3:])
    assert got.shape == want.shape and torch.equal(got, want)
    assert torch.equal(got.cpu(), ref.tree_traverse_ref(
        *(a.cpu() for a in tables[:3]), x.cpu(),
        *(a.cpu() for a in tables[3:])))
    # a block size that is not the default serves the same lanes
    assert torch.equal(tree_traverse_cuda(*tables[:3], x, *tables[3:],
                                          block_b=64), got)


def test_tree_traverse_rejects_a_grove_over_shared_memory(cuda):
    t, depth, C = 32, 12, 30
    feature = torch.zeros((t, 2**depth - 1), dtype=torch.int32, device=cuda)
    threshold = torch.zeros((t, 2**depth - 1), device=cuda)
    leaf = torch.zeros((t, 2**depth, C), device=cuda)
    before = ops.launches["tree_traverse"]
    with pytest.raises(ValueError, match="shared memory"):
        ops.tree_traverse(feature, threshold, leaf,
                          torch.zeros((128, 8), device=cuda))
    assert ops.launches["tree_traverse"] == before


@pytest.mark.parametrize("precision", PRECISIONS)
def test_ring_on_card_equals_ring_on_cpu(cuda, trained_port, precision):
    ds, gc = trained_port
    B = 1000
    x = ds.x_test[:B]
    start = tcore.sample_starts(torch.Generator().manual_seed(1), B, 8,
                                n_shards=8)
    pol = tcore.FogPolicy(threshold=0.3, max_hops=8)
    card = tcore.FogEngine(gc, backend="ring", mesh=tcore.RingMesh(8),
                           use_kernels=True, precision=precision,
                           device=cuda)
    before = dict(ops.launches)
    got = card.eval(x, start=start, policy=pol)
    assert ops.launches["tree_traverse"] == before["tree_traverse"] + 8
    assert ops.launches["grove_aggregate"] == before["grove_aggregate"] + 8
    cpu = tcore.FogEngine(gc, backend="ring", mesh=tcore.RingMesh(8),
                          use_kernels=True, precision=precision,
                          device="cpu").eval(x, start=start, policy=pol)
    for f in ("proba", "hops", "label"):
        assert torch.equal(getattr(got, f).cpu(), getattr(cpu, f)), f
    want = tcore.FogEngine(gc, precision=precision, device=cuda).eval(
        x, start=start, policy=pol)
    assert torch.equal(got.hops, want.hops)
    assert torch.equal(got.label, want.label)
    torch.testing.assert_close(got.proba, want.proba, rtol=1e-6, atol=1e-7)


# -------------------- the group fused_fog and the spread tree_traverse

BENCH_SHAPE = {"G": 8, "t": 2, "depth": 8, "C": 10, "F": 16}


def fused_case(rng, precision, heads, B, device, **shape):
    """The bench field's shape (or ``shape``) at random values, per-lane
    thresholds and budgets, and the fused layout's arguments."""
    shape = {**BENCH_SHAPE, **shape}
    pack = random_pack(rng, precision, O=heads, **shape).to(device)
    G, F = shape["G"], shape["F"]
    x = torch.as_tensor(rng.normal(size=(B, F)).astype(np.float32),
                        device=device)
    start = torch.as_tensor(rng.integers(0, G, B, dtype=np.int32),
                            device=device)
    thresh = torch.as_tensor(rng.random(B, dtype=np.float32) * 0.6,
                             device=device)
    budget = torch.as_tensor(rng.integers(1, 9, B, dtype=np.int32),
                             device=device)
    lay = pack.layout("fused")
    return (*lay[:3], x, start, thresh, budget, *lay[3:])


@pytest.mark.parametrize("block_b", [128, 1024])
@pytest.mark.parametrize("B", [1, 97, 1000, 65_536])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_fused_group_routes_equal_plain(cuda, precision, heads, B, block_b):
    """Each group route (and the lane route) bit-equal to the plain
    version on proba and hops, with per-lane thresholds and budgets; the
    shared-memory route only where the field fits it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_fog as ff
    args = fused_case(np.random.default_rng(B + heads), precision, heads, B,
                      cuda)
    pr, hr = fused_fog_ref(*args, max_hops=8)
    fits = ff.table_smem_bytes(heads, 8, 2, 8, 10, args[1].element_size()) \
        < _build.smem_optin(cuda)
    names = ("smem", "l1", "lane") if fits else ("l1", "lane")
    for name in names:
        before = dict(_build.routes)
        n = ops.launches["fused_fog"]
        pk, hk = ff.fused_fog_on_route(*args, max_hops=8, block_b=block_b,
                                       route=name)
        torch.cuda.synchronize()
        entry = "fused_fog" if name == "lane" else f"fused_fog_{name}"
        assert _build.routes[entry] == before[entry] + 1
        assert ops.launches["fused_fog"] == n + 1
        assert torch.equal(hk, hr), name
        assert torch.equal(pk, pr), name


@pytest.mark.parametrize("precision", PRECISIONS)
def test_fused_route_rule_at_the_bench_field(cuda, precision):
    """The rule's picks at the bench field with the engine's 128 threads,
    counted by route: "smem" for int8 at B = 1000, "l1" for fp32 and bf16
    there and for all at 65,536; two fp32 heads (393 KB, over shared
    memory) take "l1"; each equal to plain."""
    from repro_torch.kernels import _build
    rng = np.random.default_rng(3)
    cases = [(1, 1000, "smem" if precision == "int8" else "l1"),
             (1, 65_536, "l1")]
    if precision == "fp32":
        cases.append((2, 65_536, "l1"))
    for heads, B, want in cases:
        args = fused_case(rng, precision, heads, B, cuda)
        before = dict(_build.routes)
        pk, hk = ops.fused_fog(*args, max_hops=8, block_b=128)
        torch.cuda.synchronize()
        got = {k for k in ("fused_fog", "fused_fog_smem", "fused_fog_l1")
               if _build.routes[k] != before[k]}
        assert got == {f"fused_fog_{want}"}, (heads, B, got)
        pr, hr = fused_fog_ref(*args, max_hops=8)
        assert torch.equal(hk, hr) and torch.equal(pk, pr)


def test_fused_lane_state_over_the_registers_takes_the_lane_route(cuda):
    """Two heads of 129 classes need 2 x ceil(129 / 32) = 10 registers a
    thread, over FUSED_ACC: the lane route, equal to plain."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_fog as ff
    assert ff.group_size(2, 2, 129, 8) is None
    args = fused_case(np.random.default_rng(4), "fp32", 2, 300, cuda, G=4,
                      depth=5, C=129)
    before = _build.routes["fused_fog"]
    pk, hk = ops.fused_fog(*args, max_hops=8)
    assert _build.routes["fused_fog"] == before + 1
    pr, hr = fused_fog_ref(*args, max_hops=8)
    assert torch.equal(hk, hr) and torch.equal(pk, pr)


def test_fused_and_traverse_wrappers_refuse_what_the_kernels_do_not_take(
        cuda):
    from repro_torch.kernels.fused_fog import (fused_fog_cuda,
                                               fused_fog_on_route)
    from repro_torch.kernels.tree_traverse import tree_traverse_cuda
    args = list(fused_case(np.random.default_rng(5), "fp32", 1, 64, cuda))
    before = dict(ops.launches)
    # two fp32 heads (393 KB) do not fit the shared-memory route
    two = fused_case(np.random.default_rng(6), "fp32", 2, 64, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fused_fog_on_route(*two, max_hops=8, route="smem")
    with pytest.raises(ValueError, match="threads per block"):
        fused_fog_cuda(*args, max_hops=8, block_b=48)
    bad = list(args)
    bad[3] = args[3].t().contiguous().t()          # x not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fused_fog_cuda(*bad, max_hops=8)
    bad = list(args)
    bad[4] = args[4].long()                       # start int64
    with pytest.raises(TypeError):
        fused_fog_cuda(*bad, max_hops=8)
    bad = list(args)
    bad[3] = args[3].cpu()
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_fog_cuda(*bad, max_hops=8)
    tables = [a[0, 0] for a in (args[0], args[1], args[2], args[7],
                                args[8])]
    x = torch.zeros((64, 16), device=cuda)
    with pytest.raises(ValueError, match="threads per block"):
        tree_traverse_cuda(*tables[:3], x, *tables[3:], block_b=20)
    with pytest.raises(TypeError):
        tree_traverse_cuda(*tables[:3], x.double(), *tables[3:])
    with pytest.raises(ValueError, match="inconsistent shapes"):
        tree_traverse_cuda(tables[0], tables[1][:, :7].contiguous(),
                           tables[2], x, *tables[3:])
    assert dict(ops.launches) == before


@pytest.mark.parametrize("S,b", [(8, 125), (8, 8192), (1, 1000), (8, 37),
                                 (1, 1)])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_tree_traverse_spread_routes_equal_plain(cuda, precision, S, b):
    """The spread kernel (and the lane route) bit-equal to the plain
    version: the ring's stacked inputs at B = 1000 and 65,536, one grove
    with 2-D tables, a ragged b and a single lane."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import tree_traverse as tt
    rng = np.random.default_rng(S * b)
    pack = random_pack(rng, precision, G=S, t=2, depth=8, C=10,
                       F=16).to(cuda)
    tables = [getattr(pack, f)[0] for f in ("feature", "threshold", "leaf",
                                            "thr_scale", "leaf_scale")]
    x = rng.normal(size=(S, b, 16)).astype(np.float32)
    if S == 1:
        tables = [a[0] for a in tables]
        x = x[0]
    x = torch.as_tensor(x, device=cuda)
    want = ref.tree_traverse_ref(*tables[:3], x, *tables[3:])
    for name in tt.ROUTES:
        before = dict(_build.routes)
        got = tt.tree_traverse_on_route(*tables[:3], x, *tables[3:],
                                        block_b=128, route=name)
        torch.cuda.synchronize()
        entry = "tree_traverse" if name == "lane" else f"tree_traverse_{name}"
        assert _build.routes[entry] == before[entry] + 1
        assert got.shape == want.shape and torch.equal(got, want), name


@pytest.mark.parametrize("S,b,want", [(8, 125, "spread"),
                                      (8, 8192, "spread"),
                                      (1, 1000, "spread")])
def test_tree_traverse_route_rule_at_the_ring(cuda, S, b, want):
    """The wrapper at the bench grove: the spread kernel at the ring's
    B = 1000 and 65,536 and for one grove; one counted launch on that
    route."""
    from repro_torch.kernels import _build
    pack = random_pack(np.random.default_rng(0), "fp32", G=S, t=2, depth=8,
                       C=10, F=16).to(cuda)
    tables = [getattr(pack, f)[0] for f in ("feature", "threshold", "leaf",
                                            "thr_scale", "leaf_scale")]
    x = torch.zeros((S, b, 16), device=cuda)
    before = dict(_build.routes)
    n = ops.launches["tree_traverse"]
    ops.tree_traverse(*tables[:3], x, *tables[3:], block_b=128)
    torch.cuda.synchronize()
    got = {k for k in ("tree_traverse", "tree_traverse_spread")
           if _build.routes[k] != before[k]}
    assert got == {f"tree_traverse_{want}"}
    assert ops.launches["tree_traverse"] == n + 1


def test_tree_traverse_over_shared_memory_raises_on_every_route(cuda):
    """The acceptance rule does not depend on the route: a grove over one
    block's shared memory raises before any launch, on the spread route
    (which reads the grove through L1) too."""
    from repro_torch.kernels import tree_traverse as tt
    t, depth, C = 32, 12, 30
    before = ops.launches["tree_traverse"]
    for name in tt.ROUTES:
        with pytest.raises(ValueError, match="shared memory"):
            tt.tree_traverse_on_route(
                torch.zeros((t, 2**depth - 1), dtype=torch.int32,
                            device=cuda),
                torch.zeros((t, 2**depth - 1), device=cuda),
                torch.zeros((t, 2**depth, C), device=cuda),
                torch.zeros((128, 8), device=cuda), route=name)
    assert ops.launches["tree_traverse"] == before


# ------------------------------------------------- the Mamba-2 SSD chunk

# (B, nc, Q, H, P, N): JAX's small cases, a ragged Q with P and N that are
# not multiples of the tiles, the serving chunk at full width (Q=256,
# H=80, P=64, N=128) and a ragged Q over two P and N tiles
SSD_SHAPES = [(1, 1, 8, 1, 4, 4), (2, 2, 64, 2, 32, 32),
              (1, 3, 37, 3, 16, 20), (1, 1, 256, 80, 64, 128),
              (2, 1, 200, 5, 72, 130)]


def ssd_inputs(rng, shape, dtype, device, decay=1.0):
    B, nc, Q, H, P, N = shape
    arrays = (rng.normal(size=(B, nc, Q, H, P)),
              -rng.uniform(0.01, 0.5, size=(B, nc, H, Q)) * decay,
              rng.normal(size=(B, nc, Q, N)), rng.normal(size=(B, nc, Q, N)))
    return [torch.as_tensor(a.astype(np.float32), device=device).to(dtype)
            for a in arrays]


def assert_ssd_close(got, want, route="simt"):
    """The bar of the route the call took (chip_smoke.ssd_close).  SIMT
    fp32: within 1e-4 of the output's largest magnitude (the kernel sums up
    to 256 x 128 fp32 terms in another order); SIMT bf16: within 2 bf16
    ulps of the plain version's cast (rtol 2**-6), plus the same fp32
    allowance for elements near a rounding boundary.  Tensor cores (bf16,
    P = 64, N in {64, 128}): within 2 bf16 ulps of the output's scale, the
    kernel rounding W and the decay-scaled x to bf16 as its operands
    (tests/test_torch_ssd_chunk.py sets the bar from that rounding's
    replay)."""
    chip_smoke.ssd_close("ssd_chunk", got, want, route)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_chunk_kernel_matches_plain(cuda, shape, dtype):
    from repro_torch.kernels.ssd_chunk import route, ssd_chunk_ref
    args = ssd_inputs(np.random.default_rng(sum(shape)), shape,
                      getattr(torch, dtype), cuda)
    before = ops.launches["ssd_chunk"]
    got = ops.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert ops.launches["ssd_chunk"] == before + 1
    r = route(args[0].dtype, *shape[2:3], *shape[4:])
    for g, w in zip(got, ssd_chunk_ref(*args)):
        assert_ssd_close(g, w, r)


def test_ssd_chunk_kernel_branches_above_the_diagonal(cuda):
    """Decays large enough that exp(cum_i - cum_j) overflows above the
    diagonal: the kernel must branch there, not multiply by a 0 mask."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_ref
    args = ssd_inputs(np.random.default_rng(3), (1, 2, 64, 2, 8, 8),
                      torch.float32, cuda, decay=200.0)
    for g, w in zip(ops.ssd_chunk(*args), ssd_chunk_ref(*args)):
        assert_ssd_close(g, w)


# (B, nc, Q, H, P, N), all bf16 on the tensor-core route: the serving
# chunk at full width, a ragged Q over two chunks, a Q in one row tile at
# N = 64, one row, a head count no group divides, and the main path's
# prefill layer (4 prompts of 2048 tokens)
SSD_SM90_SHAPES = [(1, 2, 256, 80, 64, 128), (2, 3, 200, 80, 64, 128),
                   (1, 3, 37, 3, 64, 64), (1, 2, 1, 5, 64, 128),
                   (2, 2, 64, 7, 64, 128), (4, 8, 256, 80, 64, 128)]


@pytest.mark.parametrize("shape", SSD_SM90_SHAPES, ids=str)
def test_ssd_chunk_sm90_matches_plain(cuda, shape):
    """One launch on the tensor-core route (none on the SIMT one), within
    2 bf16 ulps of the output's scale of the plain version, and within 1
    ulp of it of the route's rounding replayed in PyTorch (the two differ
    only in the order of fp32 sums and exp's last bits)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_chunk import (route, ssd_chunk_ref,
                                               ssd_chunk_sm90_replay)
    args = ssd_inputs(np.random.default_rng(sum(shape)), shape,
                      torch.bfloat16, cuda)
    assert route(torch.bfloat16, shape[2], shape[4], shape[5]) == "sm90"
    before = dict(_build.routes)
    got = ops.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert _build.routes["ssd_chunk_sm90"] == before["ssd_chunk_sm90"] + 1
    assert _build.routes["ssd_chunk"] == before["ssd_chunk"]
    for g, w, rp in zip(got, ssd_chunk_ref(*args),
                        ssd_chunk_sm90_replay(*args)):
        assert_ssd_close(g, w, "sm90")
        scale = float(rp.float().abs().max())
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        assert float((g.float() - rp.float()).abs().max()) <= ulp


def test_ssd_chunk_routes_by_dtype_and_shape(cuda):
    """fp32 at the serving widths, and bf16 at a head size or a state size
    the tensor-core kernel does not take, run the SIMT kernel."""
    from repro_torch.kernels import _build
    for shape, dtype in (((1, 1, 64, 2, 64, 128), torch.float32),
                         ((1, 1, 64, 2, 32, 128), torch.bfloat16),
                         ((1, 1, 64, 2, 64, 96), torch.bfloat16)):
        before = dict(_build.routes)
        ops.ssd_chunk(*ssd_inputs(np.random.default_rng(0), shape, dtype,
                                  cuda))
        torch.cuda.synchronize()
        assert _build.routes["ssd_chunk"] == before["ssd_chunk"] + 1
        assert _build.routes["ssd_chunk_sm90"] == before["ssd_chunk_sm90"]


def test_ssd_chunk_sm90_refuses_a_misaligned_pointer(cuda):
    """TMA needs 16-byte aligned bases: a view one element in raises
    before any launch."""
    x, a, Bm, Cm = ssd_inputs(np.random.default_rng(0),
                              (1, 1, 64, 2, 64, 128), torch.bfloat16, cuda)
    buf = torch.zeros(Bm.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = buf[1:].view(Bm.shape)
    before = ops.launches["ssd_chunk"]
    with pytest.raises(ValueError, match="16-byte boundary"):
        ops.ssd_chunk(x, a, shifted, Cm)
    assert ops.launches["ssd_chunk"] == before


def test_ssd_chunk_sm90_branches_above_the_diagonal(cuda):
    """The overflow case of test_ssd_chunk_kernel_branches_above_the_
    diagonal on the tensor-core route: W is 0 above the diagonal by a
    select, so no NaN."""
    from repro_torch.kernels.ssd_chunk import route, ssd_chunk_ref
    args = ssd_inputs(np.random.default_rng(3), (1, 2, 64, 2, 64, 64),
                      torch.bfloat16, cuda, decay=200.0)
    assert route(torch.bfloat16, 64, 64, 64) == "sm90"
    for g, w in zip(ops.ssd_chunk(*args), ssd_chunk_ref(*args)):
        assert_ssd_close(g, w, "sm90")


def wgmma_probe_ssd(c, b, x, d):
    """csrc/ssd_chunk_sm90.cu's fog_wgmma_probe_ssd: (C[192:256]
    B[64:128]^T, bf16(x d)^T b) in fp32 from the kernel's own product
    functions."""
    import ctypes

    from repro_torch.kernels import _build
    s = torch.empty((64, 64), dtype=torch.float32, device=c.device)
    st = torch.empty((64, 128), dtype=torch.float32, device=c.device)
    rc = _build.library().fog_wgmma_probe_ssd(
        c.data_ptr(), b.data_ptr(), x.data_ptr(), d.data_ptr(),
        s.data_ptr(), st.data_ptr(), ctypes.c_void_p(
            torch.cuda.current_stream(c.device).cuda_stream))
    assert rc == 0, _build.library().fog_error_string(rc)
    torch.cuda.synchronize()
    return s, st


def test_wgmma_ssd_forms_match_matmul(cuda):
    """The two product forms ssd_chunk_sm90 adds to flash's: the S product
    at N = 128 (two K-major chunks, row tiles 3 and 1), and the states
    product with A built in registers from the MN-major x tile scaled by
    d (rounded to bf16 once) and B MN-major in both 64-column halves of a
    [256, 128] tile, against torch.matmul in fp32 on the same bf16 values:
    products exact, only the order of fp32 sums differs."""
    g = torch.Generator(device=cuda).manual_seed(7)
    c, b = (torch.randn((256, 128), generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    x = torch.randn((256, 64), generator=g, device=cuda).to(torch.bfloat16)
    d = torch.rand((256,), generator=g, device=cuda)
    s, st = wgmma_probe_ssd(c, b, x, d)
    xd = (x.float() * d[:, None]).to(torch.bfloat16).float()
    for got, want in ((s, c[192:].float() @ b[64:128].float().T),
                      (st, xd.T @ b.float())):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def test_ssd_chunk_kernel_refuses_a_long_chunk(cuda):
    args = ssd_inputs(np.random.default_rng(0), (1, 1, 257, 1, 4, 4),
                      torch.float32, cuda)
    before = ops.launches["ssd_chunk"]
    with pytest.raises(ValueError, match="1 <= Q <= 256"):
        ops.ssd_chunk(*args)
    assert ops.launches["ssd_chunk"] == before


def test_mamba_decode_matches_forward_on_card(cuda):
    """The smoke Mamba-2 at fp32 on the card: one ssd_chunk launch per
    layer per prefill; decode after prefill reproduces the forward's
    logits at every position; the card's prefill equals the CPU's.
    Tolerance rtol/atol 1e-4, as the CPU tests hold the port to JAX."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("mamba2-2.7b")
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           torch.float32, device=cuda)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32), device=cuda)
    h, _ = T.forward(params, cfg, tokens)
    want = T.unembed(params, cfg, h)
    before = ops.launches["ssd_chunk"]
    logits, cache = T.prefill(params, cfg, tokens=tokens[:, :32])
    assert ops.launches["ssd_chunk"] == before + cfg.n_layers
    tol = {"rtol": 1e-4, "atol": 1e-4}
    torch.testing.assert_close(logits, want[:, 31], **tol)
    cpu_logits, _ = T.prefill(params.to("cpu"), cfg,
                              tokens=tokens[:, :32].cpu())
    torch.testing.assert_close(logits.cpu(), cpu_logits, **tol)
    params.to(cuda)
    for t in range(32, 64):
        logits, cache = T.decode_step(params, cfg, tokens[:, t], cache, t)
        torch.testing.assert_close(logits, want[:, t], **tol)


# (B, Sq, Sk, H, K, D, Dv, causal): JAX's five cases, a ragged length over
# several tiles, Sq != Sk both ways, MQA, MLA's widths (D = 192, Dv = 128),
# the largest tiles (D = Dv = 256) and tinyllama's layer at a short prompt
FLASH_SHAPES = [(1, 8, 8, 2, 1, 4, 4, True), (2, 64, 64, 4, 2, 16, 16, True),
                (2, 128, 128, 8, 8, 32, 32, True),
                (1, 64, 64, 4, 1, 32, 16, True),
                (2, 64, 64, 4, 2, 16, 16, False),
                (2, 200, 200, 8, 2, 64, 64, True),
                (1, 100, 300, 4, 4, 64, 64, True),
                (1, 300, 100, 4, 4, 64, 64, True),
                (2, 129, 65, 8, 1, 80, 40, False),
                (1, 96, 96, 4, 4, 192, 128, True),
                (1, 70, 70, 2, 2, 256, 256, True),
                (2, 256, 256, 32, 4, 64, 64, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_flash_attention_kernel_matches_plain(cuda, shape, dtype):
    """One launch; fp32 within rtol/atol 2e-5, bf16 within 2 bf16 ulps of
    the output's scale (chip_smoke.flash_close)."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    *dims, causal = shape
    args = chip_smoke.flash_inputs(np.random.default_rng(sum(dims)), dims,
                                   getattr(torch, dtype), cuda)
    before = ops.launches["flash_attention"]
    got = ops.flash_attention(*args, causal=causal)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == before + 1
    chip_smoke.flash_close(f"flash_attention {shape} {dtype}", got,
                           flash_attention_ref(*args, causal=causal))


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = chip_smoke.flash_inputs(np.random.default_rng(0),
                                      (1, 8, 8, 2, 1, 16, 16),
                                      torch.float32, cuda)
    before = ops.launches["flash_attention"]
    with pytest.raises(ValueError, match="head sizes up to 256"):
        ops.flash_attention(*chip_smoke.flash_inputs(
            np.random.default_rng(0), (1, 8, 8, 2, 1, 272, 16),
            torch.float32, cuda))
    with pytest.raises(TypeError, match="fp32 or bf16"):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v)
    assert ops.launches["flash_attention"] == before


def test_attention_decode_matches_forward_on_card(cuda):
    """The smoke tinyllama at fp32 on the card: one flash_attention launch
    per layer per prefill; decode after prefill reproduces the forward's
    logits at every position; the card's prefill equals the CPU's.
    Tolerance rtol/atol 1e-4, as the CPU tests hold the port to JAX."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("tinyllama-1.1b")
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           torch.float32, device=cuda)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32), device=cuda)
    h, _ = T.forward(params, cfg, tokens)
    want = T.unembed(params, cfg, h)
    before = ops.launches["flash_attention"]
    logits, cache = T.prefill(params, cfg, tokens=tokens[:, :32], max_seq=64)
    assert ops.launches["flash_attention"] == before + cfg.n_layers
    tol = {"rtol": 1e-4, "atol": 1e-4}
    torch.testing.assert_close(logits, want[:, 31], **tol)
    cpu_logits, _ = T.prefill(params.to("cpu"), cfg,
                              tokens=tokens[:, :32].cpu(), max_seq=64)
    torch.testing.assert_close(logits.cpu(), cpu_logits, **tol)
    params.to(cuda)
    for t in range(32, 64):
        logits, cache = T.decode_step(params, cfg, tokens[:, t], cache, t)
        torch.testing.assert_close(logits, want[:, t], **tol)


# ------------------------------------------- the tensor-core flash kernel
def wgmma_probe(a, b1, b2):
    """csrc/flash_attention_sm90.cu's fog_wgmma_probe: (a b1^T, a b2) in
    fp32 from one wgmma tile product of each form the kernel issues."""
    import ctypes

    from repro_torch.kernels import _build
    n = b1.shape[0]
    c1 = torch.empty((64, n), dtype=torch.float32, device=a.device)
    c2 = torch.empty_like(c1)
    rc = _build.library().fog_wgmma_probe(
        a.data_ptr(), b1.data_ptr(), b2.data_ptr(), c1.data_ptr(),
        c2.data_ptr(), n, ctypes.c_void_p(torch.cuda.current_stream(
            a.device).cuda_stream))
    assert rc == 0, _build.library().fog_error_string(rc)
    torch.cuda.synchronize()
    return c1, c2


@pytest.mark.parametrize("n", [64, 128])
def test_wgmma_single_tile_matches_matmul(cuda, n):
    """One m64nNk16 x 4 product with both operands K-major in shared memory
    (the kernel's q.k^T) and one with A from registers and B MN-major (its
    p.v), each through TMA and the 128-byte swizzle, against torch.matmul
    in fp32 on the same bf16 values.  bf16 products are exact in fp32, so
    only the order of 64 fp32 sums differs: within 1e-5 of the scale."""
    g = torch.Generator(device=cuda).manual_seed(n)
    a, b1, b2 = (torch.randn(sh, generator=g, device=cuda).to(torch.bfloat16)
                 for sh in ((64, 64), (n, 64), (64, n)))
    c1, c2 = wgmma_probe(a, b1, b2)
    for got, want in ((c1, a.float() @ b1.float().T),
                      (c2, a.float() @ b2.float())):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


# (B, Sq, Sk, H, K, D, Dv, causal), all bf16 on the tensor-core route: a
# ragged length, Sq != Sk both ways, non-causal, MQA, chameleon's heads
# (D = Dv = 128, 64 query heads, 8 KV heads), the mixed widths, one row,
# and tinyllama's layer at a prompt of 512
SM90_SHAPES = [(2, 200, 200, 32, 4, 64, 64, True),
               (2, 100, 300, 32, 4, 64, 64, True),
               (2, 300, 100, 32, 4, 64, 64, True),
               (2, 256, 256, 32, 4, 64, 64, False),
               (2, 256, 256, 32, 1, 64, 64, True),
               (1, 256, 256, 64, 8, 128, 128, True),
               (1, 300, 200, 16, 2, 128, 128, False),
               (1, 130, 70, 4, 2, 64, 128, False),
               (1, 70, 130, 4, 4, 128, 64, True),
               (1, 1, 1, 4, 2, 64, 64, True),
               (4, 512, 512, 32, 4, 64, 64, True)]


@pytest.mark.parametrize("shape", SM90_SHAPES, ids=str)
def test_flash_attention_sm90_matches_plain(cuda, shape):
    """One launch on the tensor-core route (and none on the SIMT one),
    within 2 bf16 ulps of the output's scale (chip_smoke.flash_close)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention_ref,
                                                     route)
    *dims, causal = shape
    args = chip_smoke.flash_inputs(np.random.default_rng(sum(dims)), dims,
                                   torch.bfloat16, cuda)
    assert route(torch.bfloat16, dims[5], dims[6]) == "sm90"
    before = dict(_build.routes)
    got = ops.flash_attention(*args, causal=causal)
    torch.cuda.synchronize()
    assert _build.routes["flash_attention_sm90"] == \
        before["flash_attention_sm90"] + 1
    assert _build.routes["flash_attention"] == before["flash_attention"]
    chip_smoke.flash_close(f"flash_attention_sm90 {shape}", got,
                           flash_attention_ref(*args, causal=causal))


def test_flash_attention_routes_by_dtype_and_head_size(cuda):
    """fp32 at D = 64 and bf16 at D = 80 take the SIMT kernel."""
    from repro_torch.kernels import _build
    for dims, dtype in (((1, 40, 40, 4, 2, 64, 64), torch.float32),
                        ((1, 40, 40, 4, 2, 80, 80), torch.bfloat16),
                        ((1, 40, 40, 4, 2, 64, 96), torch.bfloat16)):
        before = dict(_build.routes)
        ops.flash_attention(*chip_smoke.flash_inputs(
            np.random.default_rng(0), dims, dtype, cuda))
        torch.cuda.synchronize()
        assert _build.routes["flash_attention"] == \
            before["flash_attention"] + 1
        assert _build.routes["flash_attention_sm90"] == \
            before["flash_attention_sm90"]


def test_flash_attention_sm90_refuses_a_misaligned_pointer(cuda):
    """TMA needs 16-byte aligned bases: a view one element in raises
    before any launch."""
    q, k, v = chip_smoke.flash_inputs(np.random.default_rng(0),
                                      (1, 16, 16, 4, 2, 64, 64),
                                      torch.bfloat16, cuda)
    buf = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = buf[1:].view(q.shape)
    before = ops.launches["flash_attention"]
    with pytest.raises(ValueError, match="16-byte boundary"):
        ops.flash_attention(shifted, k, v)
    assert ops.launches["flash_attention"] == before


# ------------------------------------------------ top2 at the LM gates
@pytest.mark.parametrize("shape", [(4, 32000), (4, 50280), (1, 50280),
                                   (4, 7), (1000, 10), (3, 65), (300, 5000)],
                         ids=str)
def test_top2_kernel_matches_plain_with_ties(cuda, shape):
    """Both launches (one thread per row at C <= 64, blocks sharing a row
    above it) equal the plain version bit for bit, with ties of the
    maximum inside a block, across blocks, at the last entry and over a
    whole row; one counted launch per call."""
    from repro_torch.kernels.top2_confidence import row_blocks
    B, C = shape
    rng = np.random.default_rng(B + C)
    p = torch.as_tensor(rng.random((B, C), dtype=np.float32), device=cuda)
    p = torch.softmax(p * 8, dim=-1) if C > 64 else p
    top = float(p.max()) + 1.0
    p[0, 1] = p[0, C // 2] = top                 # a tie, maybe across blocks
    if B > 1:
        p[1, C - 1] = top                        # the maximum last
    if B > 2:
        p[2] = 0.25                              # a whole row equal
    if B > 3:
        p[3, 0] = p[3, 3] = top                  # a tie inside one block
    before = ops.launches["top2_confidence"]
    got = ops.top2_confidence(p)
    assert ops.launches["top2_confidence"] == before + 1
    want = ref.top2_confidence_ref(p)
    assert torch.equal(got, want), (row_blocks(B, C), got[:4], want[:4])
    assert got[0] == 0


# --------------------------------------------- the trainer's draws (C2)
DRAW_SEEDS, DRAW_TREES, DRAW_ROWS, DRAW_F, DRAW_K = 32, 8, 4000, 16, 4
DRAW_P = 1e-3


def trainer_draws(device):
    """Per seed, the draws ``grow_forest`` makes at the gate config (8
    trees, 4000 rows, 16 features, 4 per node, depth 8): bootstrap counts
    [T, N] and the feature masks of levels 0..7 [T, 2**level, F]."""
    from repro_torch.forest.grow import bootstrap_weights, feature_mask
    out = []
    for seed in range(DRAW_SEEDS):
        gen = torch.Generator(device=device).manual_seed(seed)
        w = bootstrap_weights(gen, DRAW_TREES, DRAW_ROWS)
        masks = [feature_mask(gen, DRAW_TREES, 2**lv, DRAW_F, DRAW_K)
                 for lv in range(8)]
        out.append((w.cpu(), [m.cpu() for m in masks]))
    return out


def test_card_trainer_draws_match_the_cpu_by_distribution(cuda):
    """The CUDA generator draws other numbers than the CPU's from one seed;
    its draws must have the same distribution.  Over 32 seeds x 8 trees on
    each device: the share of rows drawn at least once per tree (about
    1 - 1/e), the variance of the counts per tree (their mean is exactly
    1), and how often each feature is picked at a node: two-sample
    Kolmogorov-Smirnov tests between the devices at p > 1e-3, every share
    within 5 standard errors of 1 - (1 - 1/N)^N, exactly 4 features at
    every node."""
    from scipy import stats
    stat = {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", cuda)):
        draws = trainer_draws(dev)
        w = torch.stack([d[0] for d in draws])          # [seeds, T, N]
        assert torch.equal(w.sum(-1), torch.full(w.shape[:2],
                                                 float(DRAW_ROWS)))
        share = (w > 0).float().mean(-1).reshape(-1)
        var = w.var(-1).reshape(-1)
        picks = torch.zeros(DRAW_F)
        for _, masks in draws:
            for m in masks:
                assert (m.sum(-1) == DRAW_K).all()
                picks += m.reshape(-1, DRAW_F).sum(0)
        stat[name] = (share.numpy(), var.numpy(), picks.numpy())
    expect = 1 - (1 - 1 / DRAW_ROWS) ** DRAW_ROWS
    # Var(distinct rows) / N^2 for N draws into N bins, to first order
    se = np.sqrt((np.exp(-1) - 2 * np.exp(-2)) / DRAW_ROWS)
    for name, (share, var, picks) in stat.items():
        assert np.abs(share - expect).max() < 5 * se, (name, share.min(),
                                                      share.max())
        chi = stats.chisquare(picks)
        assert chi.pvalue > DRAW_P, (name, picks, chi.pvalue)
    for i, what in enumerate(("share drawn", "count variance")):
        ks = stats.ks_2samp(stat["cpu"][i], stat["card"][i])
        print(f"[draws] {what}: KS {ks.statistic:.4f}, p {ks.pvalue:.4f}")
        assert ks.pvalue > DRAW_P, (what, ks)
    picks = np.stack([stat["cpu"][2], stat["card"][2]])
    p_picks = stats.chi2_contingency(picks)[1]
    print(f"[draws] feature picks cpu vs card: chi2 p {p_picks:.4f}")
    assert p_picks > DRAW_P


# ------------------------------------------ the grove_aggregate tile kernel

# float outputs compared by their bits, so -0.0 != +0.0
bits = chip_smoke.bits

def aggregate_on_card(case, device, scalar_thresh):
    prob, contrib, live, hops, thresh = (torch.as_tensor(a, device=device)
                                         for a in case)
    return prob, contrib, live, hops, 0.2 if scalar_thresh else thresh


@pytest.mark.parametrize("route", ["tile", "lane"])
@pytest.mark.parametrize("C", chip_smoke.AGG_C)
@pytest.mark.parametrize("B", chip_smoke.AGG_B)
def test_grove_aggregate_routes_equal_plain(cuda, B, C, route):
    """Each route bit-equal to the plain version on all four outputs, in
    every kind of chip_smoke.aggregate_case (all-dead and all-live warps,
    ties at the maximum, -0.0 in dead lanes' rows), scalar and per-lane
    thresholds; one counted launch each, on the named route."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import grove_aggregate as ga
    for kind in chip_smoke.AGG_KINDS:
        case = chip_smoke.aggregate_case(np.random.default_rng(B + C), B, C,
                                         kind)
        for scalar in (True, False):
            args = aggregate_on_card(case, cuda, scalar)
            want = ref.grove_aggregate_ref(*args)
            before = dict(_build.routes)
            n = ops.launches["grove_aggregate"]
            got = ga.grove_aggregate_on_route(*args, route=route)
            torch.cuda.synchronize()
            entry = "grove_aggregate" + ("_tile" if route == "tile" else "")
            assert _build.routes[entry] == before[entry] + 1
            assert ops.launches["grove_aggregate"] == n + 1
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                assert torch.equal(bits(g), bits(w)), (kind, scalar)


@pytest.mark.parametrize("lanes", [32, 64, 128, 256, 1024])
@pytest.mark.parametrize("B", [1000, 65_536])
def test_grove_aggregate_tile_at_every_block_size(cuda, B, lanes):
    """The tile kernel at the sweep's lanes a block (and 1024) and the
    plan's, at the bench batch and 65,536, against the plain version."""
    from repro_torch.kernels import grove_aggregate as ga
    case = chip_smoke.aggregate_case(np.random.default_rng(lanes), B, 10,
                                     "mixed")
    args = aggregate_on_card(case, cuda, False)
    want = ref.grove_aggregate_ref(*args)
    for got in (ga.grove_aggregate_on_route(*args, route="tile", lanes=lanes,
                                            block_b=1024),
                ops.grove_aggregate(*args)):
        for g, w in zip(got, want):
            assert torch.equal(bits(g), bits(w))


@pytest.mark.parametrize("route", ["tile", "lane"])
def test_grove_aggregate_row_offset_view(cuda, route):
    """Row-offset views (prob, contrib off a 16-byte boundary: the tile
    kernel's scalar loads) and a dead lane's contrib of NaN (never read
    into a sum) equal the plain version."""
    from repro_torch.kernels import grove_aggregate as ga
    prob, contrib, live, hops, thresh = aggregate_on_card(
        chip_smoke.aggregate_case(np.random.default_rng(5), 1001, 10,
                                  "mixed"), cuda, False)
    contrib[~live] = float("nan")
    args = (prob[1:], contrib[1:], live[1:], hops[1:], thresh[1:])
    assert args[0].data_ptr() % 16 and args[1].data_ptr() % 16
    want = ref.grove_aggregate_ref(*args)
    got = ga.grove_aggregate_on_route(*args, route=route)
    for g, w in zip(got, want):
        assert torch.equal(bits(g), bits(w))


def test_grove_aggregate_over_the_tile_takes_the_lane_route(cuda):
    """C above the tile's limit: the wrapper takes the lane route (equal to
    plain); the tile route named there raises before any launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import grove_aggregate as ga
    C = ga.tile_max_classes(_build.smem_optin(cuda)) + 1
    args = aggregate_on_card(chip_smoke.aggregate_case(
        np.random.default_rng(6), 70, C, "mixed"), cuda, False)
    before = dict(_build.routes)
    got = ops.grove_aggregate(*args)
    assert _build.routes["grove_aggregate"] == before["grove_aggregate"] + 1
    assert _build.routes["grove_aggregate_tile"] == \
        before["grove_aggregate_tile"]
    for g, w in zip(got, ref.grove_aggregate_ref(*args)):
        assert torch.equal(bits(g), bits(w))
    n = ops.launches["grove_aggregate"]
    with pytest.raises(ValueError, match="tile route takes C <="):
        ga.grove_aggregate_on_route(*args, route="tile")
    assert ops.launches["grove_aggregate"] == n


def test_grove_aggregate_tile_route_per_eval(cuda, trained_port):
    """8 launches per per-hop eval and 8 per RingMesh(8) eval at B = 1000,
    every one on the tile route."""
    from repro_torch.kernels import _build
    ds, gc = trained_port
    x = ds.x_test[:1000]
    start = tcore.sample_starts(torch.Generator().manual_seed(2), 1000, 8,
                                n_shards=8)
    pol = tcore.FogPolicy(threshold=0.3, max_hops=8)
    for eng in (tcore.FogEngine(gc, backend="pallas", device=cuda),
                tcore.FogEngine(gc, backend="ring", mesh=tcore.RingMesh(8),
                                use_kernels=True, device=cuda)):
        before = dict(_build.routes)
        eng.eval(x, start=start, policy=pol)
        torch.cuda.synchronize()
        assert _build.routes["grove_aggregate_tile"] == \
            before["grove_aggregate_tile"] + 8
        assert _build.routes["grove_aggregate"] == before["grove_aggregate"]


# --------------------------------------------------------------------------
# the serving plane on the card
# --------------------------------------------------------------------------

def serve_plane(dev, gc, x, *, replicas, pipeline, n_slots=256,
                backend="fused", checked=False, n=1500):
    """One packed plane on the card (fp32 and int8 requests, two tiers),
    every request two tokens, all queued up front, every global lane's
    start from ``chip_smoke.lane_draws``; ``checked`` witnesses each
    dispatch (``chip_smoke.witness``).  Returns the batcher."""
    from repro_torch.serve.dispatch import (DeviceDispatcher,
                                            ForestReplicaServer)
    from repro_torch.serve.scheduler import ContinuousBatcher, Request
    server = ForestReplicaServer(gc, x.shape[1], backend=backend,
                                 precisions=("fp32", "int8"),
                                 draw_starts=chip_smoke.lane_draws(n_slots))
    disp = DeviceDispatcher(server.packed_factory, [dev] * replicas)
    b = ContinuousBatcher(n_slots, None, server.prefill, eos_id=-1,
                          default_policy=tcore.FogPolicy(threshold=0.6),
                          dispatcher=disp, pipeline=pipeline)
    if checked:
        chip_smoke.witness(b, server.default_precision)
    for rid in range(n):
        pol = (tcore.FogPolicy(threshold=0.4, hop_budget=3, precision="int8")
               if rid % 5 == 0 else None)
        b.submit(Request(rid=rid, prompt=x[rid % len(x)], max_new_tokens=2,
                         policy=pol))
    return b


def served(b):
    return {r.rid: (tuple(r.generated), tuple(r.hops)) for r in b.completed}


@pytest.mark.parametrize("replicas", [1, 4])
def test_serving_sync_equals_pipelined_on_card(cuda, trained_port, replicas):
    ds, gc = trained_port
    runs = []
    for pipe in (False, True):
        b = serve_plane(cuda, gc, ds.x_test, replicas=replicas,
                        pipeline=pipe)
        b.run()
        assert len(b.completed) == 1500
        runs.append((served(b), b.stats.total_pj, b.stats.tier_summary()))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("pipeline", [False, True])
def test_stream_replicas_equal_one_replica(cuda, trained_port, pipeline):
    """Four replicas on one card, one CUDA stream each, serve what one
    replica serves when every global lane draws the same start."""
    ds, gc = trained_port
    out = []
    for replicas in (1, 4):
        b = serve_plane(cuda, gc, ds.x_test, replicas=replicas,
                        pipeline=pipeline)
        b.run()
        assert [s is not None for s in b.dispatcher.streams] == \
            [True] * replicas
        out.append((served(b), b.stats.total_pj))
    assert out[0] == out[1]


@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_served_lanes_equal_the_reference_backend(cuda, trained_port,
                                                  backend):
    """Every packed dispatch's labels and hops (one fused_fog launch, or 8
    grove_aggregate) equal ``_eval_core(..., "reference")`` on its
    requests' own rows and owed knobs and the starts it drew, and its
    energy equals the model's price of its hops, bit for bit."""
    from repro_torch.kernels import ops
    ds, gc = trained_port
    b = serve_plane(cuda, gc, ds.x_test, replicas=2, pipeline=True,
                    backend=backend, checked=True, n=600)
    n0 = dict(ops.launches)
    harvested = chip_smoke.checker(b, ds.x_test.shape[1])
    checked = 0
    while b.active or b.queue:
        b.step()
        checked += harvested()
    b.flush()
    checked += harvested()
    assert len(b.completed) == 600 and checked >= 1000
    launched = {k: ops.launches[k] - n0[k] for k in ops.launches
                if ops.launches[k] != n0[k]}
    want = ("fused_fog" if backend == "fused" else "grove_aggregate")
    assert set(launched) == {want}
    assert launched[want] == b.dispatcher.n_dispatches * (
        1 if backend == "fused" else 8)


# -- the paper's evaluation path on the card ---------------------------------

def port_baseline_init(name, F, C):
    """The port's own init, drawn on the CPU (seed 0), for both runs."""
    from repro_torch.baselines import BASELINE_INIT
    return BASELINE_INIT[name](torch.Generator().manual_seed(0), F, C)


@pytest.mark.parametrize("name", ["svm_lr", "svm_rbf", "mlp", "cnn"])
def test_card_baselines_equal_the_cpu_port(cuda, name):
    """From the same init and minibatches, TF32 and cuDNN off as in
    training: the logits, and the loss and gradients at each of the first 5 steps (the
    card's taken at the CPU's params), within rtol 1e-5 of the CPU (atol
    1e-5 of each leaf's scale); the params after 5 steps of each run on
    its own within rtol 1e-4 (atol 1e-4 of each leaf's scale: the port's
    setting parts by at most 3.5e-6 here over 6 inits, TF32 on by at least
    7.5e-4 for all but SVM_LR, PERF.md); trained accuracy on segmentation
    within 0.01."""
    import dataclasses

    from repro_torch.baselines import train
    from repro_torch.data import make_dataset
    from repro_torch.optim import adamw, tree_leaves, tree_map
    from repro_torch.optim import tree_unflatten
    ds = make_dataset("segmentation")
    F, C = ds.n_features, ds.n_classes

    def moved(tree, dev):
        return tree_map(lambda a: a.to(dev), tree)

    def close(got, want, rtol):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert g.device.type == "cuda"
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=rtol,
                                       atol=rtol * float(w.abs().max()))

    def grads(tree, logits, loss, x, y):
        leaves = [a.detach().requires_grad_() for a in tree_leaves(tree)]
        value = loss(logits(tree_unflatten(tree, leaves), x), y)
        return value.item(), torch.autograd.grad(value, leaves)

    p_cpu = port_baseline_init(name, F, C)
    x = torch.as_tensor(ds.x_train)
    y = torch.as_tensor(ds.y_train, dtype=torch.long)
    perm = torch.as_tensor(np.random.default_rng(0).permutation(len(x)))
    setup = train.fit_setup(name, p_cpu, F, "cpu")
    tree, logits, loss = setup.tree, setup.logits, setup.loss
    logits_card = train.fit_setup(name, p_cpu, F, cuda).logits
    init, update = adamw(lr=setup.lr, weight_decay=1e-4)
    with train.fp32_products(cudnn=False):
        close(logits_card(moved(tree, cuda), x[:256].to(cuda)),
              logits(tree, x[:256]), 1e-5)
        state = init(tree)
        for k in range(5):
            idx = perm[k * 128:(k + 1) * 128]
            v, g = grads(tree, logits, loss, x[idx], y[idx])
            vc, gc = grads(moved(tree, cuda), logits_card, loss,
                           x[idx].to(cuda), y[idx].to(cuda))
            np.testing.assert_allclose(vc, v, rtol=1e-5)
            close(gc, g, 1e-5)
            with torch.no_grad():
                tree, state = update(tree_unflatten(tree, g), state, tree)
    small = dataclasses.replace(ds, x_train=ds.x_train[:640],
                                y_train=ds.y_train[:640])
    fits = [chip_smoke.five_steps(name, p_cpu, small, torch.device(d))
            for d in ("cpu", cuda)]
    close(fits[1], fits[0], 1e-4)
    on_cpu = train.ALL_BASELINES[name](
        ds, params=port_baseline_init(name, F, C), device="cpu")
    on_card = train.ALL_BASELINES[name](
        ds, params=port_baseline_init(name, F, C), device=cuda)
    assert abs(on_card.accuracy - on_cpu.accuracy) <= 0.01
    if name != "svm_rbf":
        assert on_card.energy_nj == on_cpu.energy_nj


def test_card_evaluate_all_fused_equals_cpu_reference(cuda):
    """Table 1's columns on segmentation: ``fused`` on the card against
    ``reference`` on the CPU from the same starts and baseline init; the
    forest columns equal (energy within rtol 1e-6), the baselines within
    0.01."""
    from repro_torch.paper import common
    name = "segmentation"
    ds = common.dataset(name)
    B = len(ds.y_test)

    def start_for(G):
        return tcore.sample_starts(torch.Generator().manual_seed(0), B, G)

    def init():
        return {k: port_baseline_init(k, ds.n_features, ds.n_classes)
                for k in ("svm_lr", "svm_rbf", "mlp", "cnn")}

    from repro_torch.kernels import ops
    n0 = ops.launches["fused_fog"]
    card = common.evaluate_all(name, device=cuda, backend="fused",
                               start_for=start_for, baseline_params=init())
    # FoG_max and the 9-point FoG_opt sweep: one launch each
    assert ops.launches["fused_fog"] - n0 == 10
    cpu = common.evaluate_all(name, device="cpu", backend="reference",
                              start_for=start_for, baseline_params=init())
    for col in ("rf", "fog_max", "fog_opt"):
        assert card[col].accuracy == cpu[col].accuracy, col
        np.testing.assert_allclose(card[col].energy_nj, cpu[col].energy_nj,
                                   rtol=1e-6)
    for col in ("svm_lr", "svm_rbf", "mlp", "cnn"):
        assert abs(card[col].accuracy - cpu[col].accuracy) <= 0.01, col


@pytest.mark.parametrize("grove_size", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("name", ["isolet", "penbased", "mnist", "letter",
                                  "segmentation"])
def test_card_paper_topologies_fused_equal_cpu_reference(cuda, name,
                                                         grove_size):
    """Each topology of Figures 4 and 5 (16 x 1 to 1 x 16) on each Table 1
    field: ``fused`` on the card, one launch an eval, against ``reference``
    on the CPU from the same starts at Figure 5's thresholds and 1.1 (every
    grove votes): hops and labels equal, proba within rtol 1e-6 / atol
    1e-7."""
    from repro_torch.paper import common, fig5_threshold
    ds = common.dataset(name)
    gc = tcore.split(common.forest_for(name), grove_size)
    start = tcore.sample_starts(torch.Generator().manual_seed(0),
                                len(ds.y_test), gc.n_groves)
    card = tcore.FogEngine(gc, backend="fused", device=cuda)
    cpu = tcore.FogEngine(gc, backend="reference", device="cpu")
    for thr in (*fig5_threshold.THRESHOLDS.tolist(), 1.1):
        pol = tcore.FogPolicy(threshold=thr)
        n0 = ops.launches["fused_fog"]
        got = card.eval(ds.x_test, policy=pol, start=start)
        assert ops.launches["fused_fog"] - n0 == 1
        want = cpu.eval(ds.x_test, policy=pol, start=start)
        assert torch.equal(got.hops.cpu(), want.hops), thr
        assert torch.equal(got.label.cpu(), want.label), thr
        torch.testing.assert_close(got.proba.cpu(), want.proba, rtol=1e-6,
                                   atol=1e-7)


# ------------------------------------------------ the fused autotuner

def _bench_field_pack(precision):
    from repro_torch.data import make_dataset
    from repro_torch.forest import TrainConfig, train_random_forest
    ds = make_dataset("penbased")
    rf = train_random_forest(ds.x_train, ds.y_train, ds.n_classes,
                             TrainConfig(n_trees=16, max_depth=8, seed=1))
    return ds, ForestPack.from_groves(tcore.split(rf, 2), precision)


@pytest.mark.parametrize("B", [1000, 65_536])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_tuned_pick_equals_plain_on_the_bench_field(cuda, precision, B,
                                                     tmp_path, monkeypatch):
    """``autotune.tune`` on the card: every candidate was held to the
    seed's output; the winner, persisted and read back, equals
    ``fused_fog_ref`` bit for bit, and the engine takes it."""
    from repro_torch.kernels import autotune
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tune.json"))
    autotune.clear_cache()
    try:
        ds, pack = _bench_field_pack(precision)
        pack = pack.to(cuda)
        x = torch.as_tensor(ds.x_test, device=cuda)
        x = x.repeat(-(-B // x.shape[0]), 1)[:B].contiguous()
        start = tcore.sample_starts(torch.Generator(device=cuda).manual_seed(
            0), B, pack.n_groves)
        thresh = torch.full((B,), 0.3, device=cuda)
        budget = torch.full((B,), 8, dtype=torch.int32, device=cuda)
        report = []
        won = autotune.tune(pack, x, start, thresh, budget, max_hops=8,
                            repeats=1, report=report)
        assert won.source == "measured" and len(report) > 10
        autotune.clear_cache()
        got = autotune.best_config(pack, 16, B, 8, cuda)
        assert got.source == "cache-file"
        assert (got.route, got.hops_per_walk, got.block_b, got.chunk_b) == (
            won.route, won.hops_per_walk, won.block_b, won.chunk_b)
        res = tcore.FogEngine(pack, backend="fused", device=cuda).eval(
            x, start=start, policy=tcore.FogPolicy(threshold=0.3))
        lay = pack.layout("fused")
        pr, hr = fused_fog_ref(*lay[:3], x, start, thresh, budget, *lay[3:],
                               max_hops=8)
        assert torch.equal(res.hops, hr)
        assert torch.equal(res.proba, pr[:, 0])
    finally:
        autotune.clear_cache()


@pytest.mark.parametrize("precision", PRECISIONS)
def test_tuned_pick_equals_plain_on_a_table1_field(cuda, precision):
    """Segmentation (depth 8, 7 classes, 19 features, 500 rows)."""
    from repro_torch.kernels import autotune
    from repro_torch.paper import common
    autotune.clear_cache()
    try:
        ds = common.dataset("segmentation")
        pack = ForestPack.from_groves(tcore.split(
            common.forest_for("segmentation"), 2), precision).to(cuda)
        x = torch.as_tensor(ds.x_test, device=cuda)
        B = x.shape[0]
        start = tcore.sample_starts(torch.Generator(device=cuda).manual_seed(
            0), B, pack.n_groves)
        thresh = torch.full((B,), 0.3, device=cuda)
        budget = torch.full((B,), 8, dtype=torch.int32, device=cuda)
        won = autotune.tune(pack, x, start, thresh, budget, max_hops=8,
                            repeats=1, persist=False)
        res = chip_smoke.fused_run(pack, x, start, thresh, budget, won)
        lay = pack.layout("fused")
        pr, hr = fused_fog_ref(*lay[:3], x, start, thresh, budget, *lay[3:],
                               max_hops=8)
        assert torch.equal(res.hops, hr) and torch.equal(res.proba, pr[:, 0])
    finally:
        autotune.clear_cache()


# ------------------------------------------------ MLA and MoE on the card

@pytest.mark.parametrize("S", [2048, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(40, 96, 64), (128, 192, 128)],
                         ids=["minicpm3", "deepseek-v3"])
def test_flash_attention_at_the_mla_shapes(cuda, shape, dtype, S):
    """D = dn + dr and Dv = dv of minicpm3-4b and deepseek-v3, causal,
    scale 1/sqrt(D), at S = 2048 and ragged S = 200 (the SIMT route)."""
    H, D, Dv = shape
    dt = getattr(torch, dtype)
    q, k, v = chip_smoke.flash_inputs(np.random.default_rng(S + D),
                                      (1, S, S, H, H, D, Dv), dt, cuda)
    before = dict(chip_smoke._build.routes)
    got = ops.flash_attention(q, k, v, causal=True, scale=1.0 / np.sqrt(D))
    ran = {n: chip_smoke._build.routes[n] - before[n] for n in before
           if chip_smoke._build.routes[n] != before[n]}
    assert ran == {"flash_attention": 1}
    want = ref.flash_attention_ref(q, k, v, causal=True,
                                   scale=1.0 / np.sqrt(D))
    chip_smoke.flash_close(f"MLA {shape} {dtype} S={S}", got, want)


@pytest.mark.parametrize("capacity_factor", [None, 1.0])
@pytest.mark.parametrize("name", ["grok-1-314b", "deepseek-v3-671b",
                                  "jamba-1.5-large-398b"])
def test_moe_layer_on_card_equals_the_cpu_port(cuda, name, capacity_factor):
    """One MoE FFN at the smoke width from the same fp32 weights, drop-free
    and with experts overflowing: the card's output within 1e-5 of the
    CPU's scale, the load-balance loss within rtol 1e-5 (the routing is
    the same: the router's fp32 product decides it on both)."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.models import moe
    cfg = smoke_config(name)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((2, 96, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    want, waux = moe.moe_ffn(p, cfg, x)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got, aux = moe.moe_ffn(p.to(cuda), cfg, x.to(cuda))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(aux.cpu(), waux, rtol=1e-5, atol=0)
