"""repro_torch's trainer histogram against the JAX package's two paths.

The same random (node, y, w, bins) inputs, made with numpy, go through
``repro.kernels.histogram.histogram_level_pallas`` (interpret mode, as
tests/test_grow.py runs it) and ``histogram_level_scatter``, and through
the port's plain version, its scatter twin and its dispatcher.  Counts are
sums of integer-valued fp32 weights, exact in any order, so every
comparison is bit-equal (``torch.equal``), never a tolerance.  The CUDA
kernel itself is held against the plain version in tests/test_torch_cuda.py;
here its tile plan is checked (every (tree, node, feature) cell owned by
exactly one tile, each tile within shared memory) and its per-block
partial sums, merged as a cluster merges them, are replayed in numpy.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.kernels import histogram as jh  # noqa: E402
from repro_torch.kernels import autotune, ops  # noqa: E402
from repro_torch.kernels import histogram as th  # noqa: E402

# (T, N, F, n_bins, C, nodes): the gate-free small shape of
# tests/test_grow.py, the same with an N no block divides, and a third
SHAPES = [(2, 96, 3, 5, 3, 4), (2, 97, 3, 5, 3, 4), (3, 61, 4, 7, 2, 8)]


def make_inputs(seed, T, N, F, n_bins, C, nodes):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, nodes, size=(T, N)).astype(np.int32),
            rng.integers(0, C, size=N).astype(np.int32),
            rng.integers(0, 3, size=(T, N)).astype(np.float32),
            rng.integers(0, n_bins, size=(N, F)).astype(np.uint8))


def torch_inputs(node, y, w, bins):
    return tuple(torch.tensor(a) for a in (node, y, w, bins))


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def case(request):
    T, N, F, n_bins, C, nodes = request.param
    node, y, w, bins = make_inputs(sum(request.param), *request.param)
    kw = dict(n_nodes=nodes, n_bins=n_bins, n_classes=C)
    pallas = np.asarray(jh.histogram_level_pallas(
        node, y, w, bins.astype(np.int32), block_n=32, block_r=8, block_f=2,
        interpret=True, **kw))
    scatter = np.asarray(jh.histogram_level_scatter(
        node, y, w, bins.astype(np.int32), **kw))
    return (node, y, w, bins), kw, pallas, scatter


def test_jax_paths_agree(case):
    _, kw, pallas, scatter = case
    np.testing.assert_array_equal(pallas, scatter)


def test_plain_version_equals_both_jax_paths(case):
    args, kw, pallas, scatter = case
    got = th.histogram_level_ref(*torch_inputs(*args), **kw)
    T, nodes, C = args[0].shape[0], kw["n_nodes"], kw["n_classes"]
    assert tuple(got.shape) == (T, nodes, args[3].shape[1], kw["n_bins"], C)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.tensor(pallas))
    assert torch.equal(got, torch.tensor(scatter))


def test_scatter_twin_equals_both_jax_paths(case):
    args, kw, pallas, scatter = case
    t = torch_inputs(*args)
    wu = th.onehot_rows(t[3], t[2], kw["n_bins"])
    for got in (th.histogram_level_scatter(*t, **kw),
                th.histogram_level_scatter(*t, wu=wu, **kw)):
        assert torch.equal(got, torch.tensor(pallas))
        assert torch.equal(got, torch.tensor(scatter))


def test_dispatcher_at_every_crossover(case):
    """Below, at and above the level's row count, the dispatcher's pick
    gives the same counts (on the CPU the kernel slot is the plain
    version)."""
    args, kw, pallas, _ = case
    R = kw["n_nodes"] * kw["n_classes"]
    before = dict(ops.launches)
    for max_r in (0, R - 1, R, 10**6):
        got = ops.histogram_level(*torch_inputs(*args), matmul_max_r=max_r,
                                  **kw)
        assert torch.equal(got, torch.tensor(pallas)), max_r
    assert ops.launches == before          # CPU tensors launch no kernel


def test_onehot_rows_equals_jax():
    node, y, w, bins = make_inputs(3, *SHAPES[1])
    want = np.asarray(jh.onehot_rows(bins.astype(np.int32), w, 5))
    got = th.onehot_rows(torch.tensor(bins), torch.tensor(w), 5)
    assert torch.equal(got, torch.tensor(want))


def test_zero_weight_lane_adds_nothing():
    """A w=0 sample (out of the bootstrap, or padding) contributes nothing,
    whatever its node, label and bins."""
    T, N, F, n_bins, C, nodes = SHAPES[0]
    node, y, w, bins = make_inputs(11, *SHAPES[0])
    w[:, 7] = 0.0
    kw = dict(n_nodes=nodes, n_bins=n_bins, n_classes=C)
    base = [th.histogram_level_ref(*torch_inputs(node, y, w, bins), **kw),
            th.histogram_level_scatter(*torch_inputs(node, y, w, bins), **kw)]
    node[:, 7] = (node[:, 7] + 1) % nodes
    y[7] = (y[7] + 1) % C
    bins[7] = (bins[7] + 1) % n_bins
    moved = [th.histogram_level_ref(*torch_inputs(node, y, w, bins), **kw),
             th.histogram_level_scatter(*torch_inputs(node, y, w, bins),
                                        **kw)]
    for a, b in zip(base, moved):
        assert torch.equal(a, b)
    # and every weighted sample lands in exactly one (node, bin, class) cell
    # per feature
    np.testing.assert_array_equal(
        base[0][:, :, 0].sum(dim=(1, 2, 3)).numpy(), w.sum(axis=1))


def test_cuda_wrapper_refuses_cpu_tensors():
    """No fallback: the kernel's wrapper raises on a tensor that is not on
    the card instead of running the plain version."""
    t = torch_inputs(*make_inputs(0, *SHAPES[0]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        th.histogram_level_cuda(*t, n_nodes=4, n_bins=5, n_classes=3)


# ------------------------------------------------------------- autotune

def test_analytic_seed_per_device():
    """On the card the seed sends every level of the bench signature to
    the kernel (R = 128 * 10 at depth 8); on the CPU it is twin-everywhere,
    like the JAX package's interpreted seed."""
    card = autotune.analytic_hist_config(32, 8, 16, 17, 10, device="cuda")
    assert card.matmul_max_r == 1280 and card.source == "analytic"
    assert card.block % 32 == 0
    cpu = autotune.analytic_hist_config(32, 8, 16, 17, 10, device="cpu")
    assert cpu.matmul_max_r == 0


def test_cache_file_round_trip_and_jax_cache_ignored(tmp_path, monkeypatch):
    key = autotune.hist_key(32, 8, 16, 17, 10)
    # the JAX package's cache holds TPU/CPU measurements: never read
    jax_file = tmp_path / "jax.json"
    jax_file.write_text(json.dumps({"/".join(map(str, key)): {
        "block_n": 1024, "block_r": 512, "block_f": 16, "matmul_max_r": 7,
        "measured_s": 1.0, "source": "measured"}}))
    monkeypatch.setenv("FOG_AUTOTUNE_CACHE", str(jax_file))
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    autotune.clear_cache()
    try:
        got = autotune.best_hist_config(32, 8, 16, 17, 10, device="cuda")
        assert got.source == "analytic" and got.matmul_max_r == 1280

        path = tmp_path / "port.json"
        monkeypatch.setenv(autotune.CACHE_ENV, str(path))
        autotune._CACHE[key] = autotune.HistConfig(
            block=128, matmul_max_r=320, measured_s=0.5, source="measured")
        autotune._save_cache_file()
        autotune.clear_cache()
        got = autotune.best_hist_config(32, 8, 16, 17, 10, device="cuda")
        assert (got.block, got.matmul_max_r, got.source) == (
            128, 320, "cache-file")
        # a measurement of the card never steers the CPU path
        cpu = autotune.best_hist_config(32, 8, 16, 17, 10, device="cpu")
        assert cpu.matmul_max_r == 0
    finally:
        autotune.clear_cache()


def test_tune_histogram_needs_the_card():
    with pytest.raises(ValueError, match="CUDA device"):
        autotune.tune_histogram(2, 3, 4, 5, 3, n_samples=64, device="cpu")


# ------------------------------------------------------ the kernel's plan

# the gate config's shape (32 trees, 4000 rows, 16 features, 17 bins, 10
# classes) at levels 0..7, and ragged ones: nodes and features that no
# group divides, one node's row over the default tile, a tiny fit
PLAN_SHAPES = ([(32, 4000, 16, 17, 10, 1 << lv) for lv in range(8)]
               + [(3, 1001, 16, 17, 10, 8), (2, 97, 3, 5, 3, 4),
                  (5, 333, 7, 200, 37, 13), (2, 300, 64, 256, 100, 8),
                  (1, 0, 4, 5, 3, 2)])


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_tile_plan_owns_every_cell_once(shape):
    T, N, F, n_bins, C, nodes = shape
    plan = th.tile_plan(T, N, F, n_bins, C, nodes)
    npb, fpb, cs = plan.nodes_per_block, plan.features_per_block, plan.cluster
    assert 1 <= cs <= th.MAX_CLUSTER
    assert plan.smem_bytes == (-(-npb * fpb * C * n_bins // 4) * 16
                               + th.DEFAULT_BLOCK * th.SCAN_PER_THREAD * 12
                               + 16)
    assert plan.smem_bytes <= 232_448
    assert npb * fpb * C * n_bins * 4 <= max(th.TILE_BYTES, C * n_bins * 4)
    n_fg = -(-F // fpb)
    assert plan.grid == (cs, -(-nodes // npb) * n_fg, T)
    owned = np.zeros((T, nodes, F), np.int64)
    for t in range(plan.grid[2]):
        for gy in range(plan.grid[1]):
            nd0, f0 = (gy // n_fg) * npb, (gy % n_fg) * fpb
            assert nd0 < nodes and f0 < F
            owned[t, nd0:nd0 + npb, f0:f0 + fpb] += 1
    assert (owned == 1).all()
    # the cluster's blocks split the samples into contiguous ranges that
    # cover each sample once
    per = -(-N // cs)
    assert sum(max(0, min(N, (r + 1) * per) - r * per)
               for r in range(cs)) == N


def test_tile_plan_refuses_a_row_over_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        th.tile_plan(1, 10, 4, 256, 300, 2)


def replay_plan(node, y, w, bins, n_nodes, n_bins, C, plan):
    """The kernel's arithmetic in numpy: block r of a cluster adds the
    weights of its contiguous range of samples into its own copy of the
    tile (fp32), then each cell is the copies' sum in rank order.  Every
    tile takes the same ranges, so the copies of all tiles together are one
    partial histogram per rank."""
    T, N = node.shape
    F = bins.shape[1]
    per = -(-N // plan.cluster)
    partials = []
    for r in range(plan.cluster):
        part = np.zeros((T, n_nodes * C, F * n_bins), np.float32)
        n = np.arange(r * per, min(N, (r + 1) * per))
        for t in range(T):
            nd = node[t, n]
            keep = ((w[t, n] != 0) & (nd >= 0) & (nd < n_nodes)
                    & (y[n] >= 0) & (y[n] < C))
            nn = n[keep]
            rows = node[t, nn] * C + y[nn]
            for f in range(F):
                b = bins[nn, f].astype(np.int64)
                ok = b < n_bins
                np.add.at(part[t], (rows[ok], f * n_bins + b[ok]),
                          w[t, nn[ok]])
        partials.append(part)
    merged = np.zeros_like(partials[0])
    for part in partials:
        merged = merged + part
    return merged


@pytest.mark.parametrize("shape", [(4, 4000, 16, 17, 10, 1),
                                   (4, 4000, 16, 17, 10, 8),
                                   (4, 4000, 16, 17, 10, 128),
                                   (3, 1001, 16, 17, 10, 8),
                                   (2, 97, 3, 5, 3, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_replayed_cluster_merge_equals_plain(shape):
    T, N, F, n_bins, C, nodes = shape
    node, y, w, bins = make_inputs(sum(shape), *shape)
    node[0, :5] = nodes                   # one past the last node
    bins[5:9, 0] = n_bins                 # one past the last bin
    plan = th.tile_plan(T, N, F, n_bins, C, nodes)
    got = replay_plan(node, y, w, bins, nodes, n_bins, C, plan)
    want = th.histogram_level_ref(*torch_inputs(node, y, w, bins),
                                  n_nodes=nodes, n_bins=n_bins, n_classes=C)
    assert torch.equal(
        th._as_level(torch.from_numpy(got), nodes, C, F, n_bins), want)
