"""repro_torch's device trainer against the JAX package, on the CPU.

Untied (``bootstrap=False, max_features="all"``) there is no randomness:
the port's device trainer, the port's host CART and the JAX package's host
CART must emit equal feature/threshold tables, and leaves within atol
1e-6 (the bar of tests/test_grow.py).  Tied, the port is fed the JAX
trainer's own draws, rebuilt here exactly as ``repro.forest.grow._grow``
makes them, and must equal ``repro.forest.grow.grow_forest`` at the same
bar.  On the CPU the histogram runs the kernel's plain version or the
scatter twin; tests/test_torch_cuda.py repeats the tied case on the card.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro_torch.forest as tforest  # noqa: E402
from repro.forest.grow import grow_forest as jgrow  # noqa: E402
from repro.forest.rf import rf_predict as j_rf_predict  # noqa: E402
from repro.forest.train import TrainConfig as JConfig  # noqa: E402
from repro.forest.train import train_random_forest as jtrain  # noqa: E402
from repro_torch.forest import grow as tgrow  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402

UNTIED = dict(n_trees=3, max_depth=4, bootstrap=False, max_features="all",
              seed=0)
FIELDS = ("feature", "threshold", "leaf")


@pytest.fixture(scope="module")
def small(ds_penbased):
    """The 2000-row subset tests/test_grow.py uses (no near-tied gains)."""
    ds = ds_penbased
    return (ds.x_train[:2000], ds.y_train[:2000], ds.x_test, ds.y_test,
            ds.n_classes)


def jax_draws(seed, T, N, F, k_feat, depth, bootstrap):
    """The bootstrap weights [T, N] and per-level feature masks that
    ``repro.forest.grow._grow`` draws from ``jax.random.key(seed)``."""
    kb, kf = jax.random.split(jax.random.key(seed))
    if bootstrap:
        def draw(k):
            idx = jax.random.randint(k, (N,), 0, N)
            return jnp.zeros((N,), jnp.float32).at[idx].add(1.0)
        w = jax.vmap(draw)(jax.random.split(kb, T))
    else:
        w = jnp.ones((T, N), jnp.float32)
    masks = None
    if k_feat < F:
        masks = []
        for level in range(depth):
            u = jax.random.uniform(jax.random.fold_in(kf, level),
                                   (T, 1 << level, F))
            _, idx = jax.lax.top_k(u, k_feat)
            masks.append(np.asarray((idx[..., None] == jnp.arange(F))
                                    .any(axis=-2)))
    return np.asarray(w), masks


def assert_tables(got, want):
    """feature/threshold equal, leaf within atol 1e-6."""
    np.testing.assert_array_equal(got.feature.cpu().numpy(),
                                  np.asarray(want.feature))
    np.testing.assert_array_equal(got.threshold.cpu().numpy(),
                                  np.asarray(want.threshold))
    np.testing.assert_allclose(got.leaf.cpu().numpy(), np.asarray(want.leaf),
                               atol=1e-6)


@pytest.mark.parametrize("with_cost", [False, True])
def test_untied_matches_both_host_carts(small, with_cost):
    x, y, _, _, C = small
    kw = dict(UNTIED)
    if with_cost:
        kw.update(feature_cost=np.linspace(1.0, 3.0, x.shape[1]).astype(
            np.float32), cost_weight=0.05)
    dev = tforest.grow_forest(x, y, C, tforest.TrainConfig(**kw),
                              device="cpu")
    assert dev.feature.dtype == torch.int32
    assert dev.threshold.dtype == dev.leaf.dtype == torch.float32
    assert_tables(dev, jtrain(x, y, C, JConfig(trainer="host", **kw)))
    assert_tables(dev, tforest.train_random_forest(
        x, y, C, tforest.TrainConfig(trainer="host", **kw)))


@pytest.mark.parametrize("seed", [0, 7])
def test_tied_matches_jax_grow_with_its_draws(small, seed):
    x, y, _, _, C = small
    cfg = dict(n_trees=4, max_depth=4, seed=seed)      # bootstrap + sqrt
    w, masks = jax_draws(seed, 4, len(y), x.shape[1], 4, 4, True)
    got = tforest.grow_forest(x, y, C, tforest.TrainConfig(**cfg),
                              device="cpu", weights=w, feature_masks=masks)
    assert_tables(got, jgrow(x, y, C, JConfig(trainer="device", **cfg)))


def test_histogram_path_does_not_change_the_forest(small, monkeypatch):
    """The crossover only picks a path: the kernel slot (its plain version
    here) at every level gives the forest the twin gives."""
    x, y, _, _, C = small
    cfg = tforest.TrainConfig(n_trees=2, max_depth=3, seed=1)
    twin = tforest.grow_forest(x, y, C, cfg, device="cpu")
    monkeypatch.setattr(autotune, "best_hist_config",
                        lambda *a, **k: autotune.HistConfig(
                            block=256, matmul_max_r=10**6))
    kernel_slot = tforest.grow_forest(x, y, C, cfg, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(twin, f), getattr(kernel_slot, f)), f


def test_same_seed_bit_equal_other_seed_differs(small):
    x, y, _, _, C = small
    cfg = tforest.TrainConfig(n_trees=4, max_depth=4, seed=7,
                              trainer="device")
    a = tforest.train_random_forest(x, y, C, cfg, device="cpu")
    b = tforest.train_random_forest(x, y, C, cfg, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    c = tforest.grow_forest(x, y, C, dataclasses.replace(cfg, seed=8),
                            device="cpu")
    assert not (torch.equal(a.feature, c.feature)
                and torch.equal(a.threshold, c.threshold))


def test_own_draws_are_bootstrap_and_k_of_f():
    gen = torch.Generator().manual_seed(3)
    w = tgrow.bootstrap_weights(gen, 5, 200)
    assert w.dtype == torch.float32 and tuple(w.shape) == (5, 200)
    assert torch.equal(w.sum(dim=1), torch.full((5,), 200.0))
    assert torch.equal(w, w.round()) and bool((w >= 0).all())
    m = tgrow.feature_mask(gen, 5, 4, 16, 4)
    assert m.dtype == torch.bool and torch.equal(
        m.sum(-1), torch.full((5, 4), 4))


def test_config_validation(small):
    x, y, _, _, C = small
    with pytest.raises(ValueError, match="min_samples_leaf"):
        tforest.grow_forest(x, y, C, tforest.TrainConfig(min_samples_leaf=0),
                            device="cpu")
    with pytest.raises(ValueError, match="max_depth"):
        tforest.grow_forest(x, y, C, tforest.TrainConfig(max_depth=0),
                            device="cpu")
    with pytest.raises(ValueError, match="unknown trainer"):
        tforest.train_random_forest(x, y, C,
                                    tforest.TrainConfig(trainer="gpu"))
    cfg = tforest.TrainConfig(n_trees=2, max_depth=2)
    with pytest.raises(ValueError, match="weights"):
        tforest.grow_forest(x, y, C, cfg, device="cpu",
                            weights=np.ones((3, len(y)), np.float32))
    with pytest.raises(ValueError, match="feature_masks"):
        tforest.grow_forest(x, y, C, cfg, device="cpu",
                            feature_masks=[np.ones((2, 1, 16), bool)])


def test_tie_breaks_to_lowest_feature_then_threshold():
    """Three identical columns and a split whose mirror image has the same
    gain: every tied candidate must lose to the lowest feature and the
    lowest threshold, as in both host CARTs and JAX's trainer."""
    col = np.repeat(np.array([0.0, 1.0, 2.0], np.float32), [10, 10, 10])
    x = np.stack([col, col, col], axis=1)
    y = np.concatenate([np.zeros(15, np.int32), np.ones(15, np.int32)])
    kw = dict(n_trees=1, max_depth=1, bootstrap=False, max_features="all",
              n_thresholds=8, min_samples_leaf=1)
    edges = tforest.quantile_bin_edges(x, 8)
    got = tforest.grow_forest(x, y, 2, tforest.TrainConfig(**kw),
                              device="cpu")
    assert int(got.feature[0, 0]) == 0
    assert float(got.threshold[0, 0]) == float(edges[0, 0])
    assert_tables(got, jgrow(x, y, 2, JConfig(trainer="device", **kw)))
    assert_tables(got, jtrain(x, y, 2, JConfig(trainer="host", **kw)))


def test_rf_predict_equals_jax(trained):
    ds, rf = trained
    forest = tforest.TensorForest.from_numpy(rf.feature, rf.threshold,
                                             rf.leaf)
    got = tforest.rf_predict(forest, ds.x_test)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_rf_predict(rf, ds.x_test)))
    proba = tforest.rf_predict_proba(forest, torch.tensor(ds.x_test))
    np.testing.assert_allclose(proba.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_device_trainer_accuracy_gap_to_host(ds_penbased):
    """The gate of benchmarks/train_bench.py at a small size: the device
    trainer's RF accuracy is within 0.5 % of the host CART's."""
    ds = ds_penbased
    kw = dict(n_trees=8, max_depth=6, seed=0, max_features="all")
    acc = {}
    for trainer in ("host", "device"):
        f = tforest.train_random_forest(
            ds.x_train, ds.y_train, ds.n_classes,
            tforest.TrainConfig(trainer=trainer, **kw), device="cpu")
        acc[trainer] = float((tforest.rf_predict(f, ds.x_test).numpy()
                              == ds.y_test).mean())
    assert acc["device"] > 0.85
    assert acc["host"] - acc["device"] <= 0.005, acc
