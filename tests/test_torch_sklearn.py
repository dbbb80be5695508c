"""repro_torch's FogClassifier, frontier and budget sweeps against the JAX
package, on the CPU.

The port is fed the JAX package's own start draws
(``repro.core.engine.sample_starts``) wherever results are compared, so a
frontier point (accuracy, nJ, mean hops) or a label must be equal, not
close.  Facade artifacts are the ``.npz`` v1 pack plus the same facade
state, and must load in both directions with identical labels.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core.engine import sample_starts  # noqa: E402
from repro.sklearn import FogClassifier as JClassifier  # noqa: E402
from repro_torch.forest import TrainConfig  # noqa: E402
from repro_torch.sklearn import FogClassifier  # noqa: E402

KW = dict(n_trees=8, grove_size=2, max_depth=5, seed=1)
NCAL = 512
_TPU_ONLY = ("compact", "interpret")


def port_dict(policy_dict):
    return {k: v for k, v in policy_dict.items() if k not in _TPU_ONLY}


def jstarts(seed, batch, groves):
    return np.asarray(sample_starts(jax.random.key(seed), batch, groves))


@pytest.fixture(scope="module")
def ds(ds_penbased):
    return ds_penbased


@pytest.fixture(scope="module")
def device_clf(ds):
    return FogClassifier(**KW, trainer="device", device="cpu").fit(
        ds.x_train, ds.y_train)


@pytest.fixture(scope="module")
def host_pair(ds):
    """The same host-CART model in both packages (the CARTs are equal bit
    for bit): (port classifier, JAX classifier)."""
    port = FogClassifier(**KW, device="cpu").fit(ds.x_train, ds.y_train)
    jax_clf = JClassifier(**KW).fit(ds.x_train, ds.y_train)
    np.testing.assert_array_equal(port.forest_.feature.numpy(),
                                  np.asarray(jax_clf.forest_.feature))
    return port, jax_clf


def test_device_fit_predict_score_profile(device_clf, ds):
    clf = device_clf
    assert repr(clf).startswith("FogClassifier(n_trees=8")
    assert clf.engine_.backend == "fused"
    assert clf.forest_.feature.device.type == "cpu"
    clf.reset_profile()
    labels = clf.predict(ds.x_test)
    assert labels.shape == (len(ds.y_test),)
    assert float((labels == ds.y_test).mean()) > 0.85
    prof = clf.profile()
    assert prof["n_classified"] == len(ds.y_test)
    assert prof["mean_hops"] >= 1.0
    assert prof["energy_nj_per_classification"] > 0.0
    assert sum(prof["hops_histogram"].values()) == prof["n_classified"]
    assert clf.score(ds.x_test, ds.y_test) > 0.85
    proba = clf.predict_proba(ds.x_test[:64])
    np.testing.assert_allclose(proba.sum(-1), 1.0, rtol=1e-5)
    # fixed seed-derived starts: deterministic; a given start wins
    np.testing.assert_array_equal(clf.predict(ds.x_test[:128]),
                                  clf.predict(ds.x_test[:128]))
    start = jstarts(0, 128, 4)
    np.testing.assert_array_equal(
        clf.predict(ds.x_test[:128], start=start),
        clf.predict(ds.x_test[:128], start=torch.tensor(start)))
    clf.reset_profile()
    assert clf.profile()["n_classified"] == 0


def test_device_facade_equals_device_trainer(device_clf, ds):
    """fit(trainer="device") trains exactly what train_random_forest does
    with the same config."""
    from repro_torch.forest import train_random_forest
    cfg = dataclasses.replace(TrainConfig(), n_trees=8, max_depth=5, seed=1,
                              trainer="device")
    f = train_random_forest(ds.x_train, ds.y_train, ds.n_classes, cfg,
                            device="cpu")
    for name in ("feature", "threshold", "leaf"):
        assert torch.equal(getattr(device_clf.forest_, name),
                           getattr(f, name))


def test_frontier_points_equal_jax(device_clf, ds):
    """The same forest and the same starts: every priced point of the
    default grid, and the pruned frontier, equal the JAX package's."""
    f = device_clf.forest_
    jforest = jcore.split(_jax_forest(f), 2)
    jeng = jcore.FogEngine(jforest)
    teng = tcore.FogEngine(tcore.split(f, 2), device="cpu")
    x, y = ds.x_test[:NCAL], ds.y_test[:NCAL]
    grid_j = jcore.default_grid()
    grid_t = tcore.default_grid()
    assert [port_dict(p.to_dict()) for p in grid_j] == [
        p.to_dict() for p in grid_t]
    want = jcore.sweep_policies(jeng, x, y, grid_j, jax.random.key(5))
    got = tcore.sweep_policies(teng, x, y, grid_t,
                               start=jstarts(5, NCAL, jforest.n_groves))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.policy.to_dict() == port_dict(w.policy.to_dict())
        assert (g.accuracy, g.energy_nj, g.mean_hops) == (
            w.accuracy, w.energy_nj, w.mean_hops)
    front = tcore.Frontier(got)
    front.check_monotone()
    assert [p.to_dict() for p in front] == [
        {**p.to_dict(), "policy": port_dict(p.policy.to_dict())}
        for p in jcore.Frontier(want)]


def _jax_forest(f):
    from repro.forest.tree import TensorForest as JForest
    return JForest(*(np.asarray(getattr(f, n).cpu()) for n in (
        "feature", "threshold", "leaf")))


def test_set_energy_budget_pins_policy_within_budget(ds):
    clf = FogClassifier(**KW, trainer="device", device="cpu").fit(
        ds.x_train, ds.y_train)
    x, y = ds.x_test[:NCAL], ds.y_test[:NCAL]
    clf.set_energy_budget(2.0, x, y)
    assert clf.frontier_.under_budget(2.0).policy == clf.policy
    assert clf.engine_.policy == clf.policy
    clf.frontier_.check_monotone()
    assert clf.profile()["within_budget"] is None      # no traffic yet
    clf.predict(x)
    prof = clf.profile()
    assert prof["energy_budget_nj"] == 2.0
    assert prof["within_budget"] is True
    with pytest.raises(ValueError, match="below the cheapest"):
        clf.set_energy_budget(1e-6, x, y)
    assert clf.energy_budget_nj_ == 2.0                 # state kept


def test_quantize_int8(host_pair, ds):
    port = FogClassifier(**KW, device="cpu").fit(ds.x_train, ds.y_train)
    acc32 = port.score(ds.x_test, ds.y_test)
    port.reset_profile()
    port.predict(ds.x_test)
    nj32 = port.profile()["energy_nj_per_classification"]
    assert port.quantize("int8") is port
    assert port.engine_.precision == "int8"
    assert port.score(ds.x_test, ds.y_test) >= acc32 - 0.01
    port.reset_profile()
    port.predict(ds.x_test)
    assert port.profile()["energy_nj_per_classification"] < nj32
    with pytest.raises(ValueError):
        port.quantize("fp64")


@pytest.mark.parametrize("budgeted", [False, True])
def test_artifacts_load_in_both_packages(host_pair, ds, tmp_path, budgeted):
    port, jclf = host_pair
    x = ds.x_test[:256]
    port = FogClassifier.load(port.save(tmp_path / "seed.npz"), device="cpu")
    jclf = JClassifier.load(jclf.save(tmp_path / "jseed.npz"))
    if budgeted:
        start = jstarts(jclf.seed, NCAL, port.engine_.n_groves)
        cal = (ds.x_test[:NCAL], ds.y_test[:NCAL])
        jclf.set_energy_budget(2.0, *cal)
        port.set_energy_budget(2.0, *cal, start=start)
        assert port.policy.to_dict() == port_dict(jclf.policy.to_dict())
    else:
        port.quantize("int8")
        jclf.quantize("int8")
    start = jstarts(3, len(x), port.engine_.n_groves)
    key = jax.random.key(3)
    want = jclf.predict(x, key=key)
    np.testing.assert_array_equal(port.predict(x, start=start), want)

    from_jax = FogClassifier.load(jclf.save(tmp_path / "j.npz"),
                                  device="cpu")
    from_port = JClassifier.load(port.save(tmp_path / "t.npz"))
    np.testing.assert_array_equal(from_jax.predict(x, start=start), want)
    np.testing.assert_array_equal(from_port.predict(x, key=key), want)
    assert from_jax.precision == from_port.precision
    assert from_jax.policy.to_dict() == port_dict(
        from_port.policy.to_dict())
    if budgeted:
        assert from_jax.energy_budget_nj_ == from_port.energy_budget_nj_
        assert from_jax.frontier_.to_dict() == {"points": [
            {**p.to_dict(), "policy": port_dict(p.policy.to_dict())}
            for p in from_port.frontier_]}


def test_explicit_precision_save_cannot_strand_frontier_rungs(ds, tmp_path):
    """With fp32 rungs aboard, save(precision="int8") must refuse, and the
    automatic rule saves fp32; an all-int8 frontier saves int8."""
    clf = FogClassifier(**KW, device="cpu").fit(ds.x_train, ds.y_train)
    cal = (ds.x_test[:NCAL], ds.y_test[:NCAL])
    clf.set_energy_budget(5.0, *cal,
                          policies=tcore.default_grid(precisions=("fp32",)))
    with pytest.raises(ValueError, match="cannot reconstruct"):
        clf.save(tmp_path / "m.npz", precision="int8")
    assert FogClassifier.load(clf.save(tmp_path / "m.npz"),
                              device="cpu").precision == "fp32"
    clf.set_energy_budget(5.0, *cal,
                          policies=tcore.default_grid(precisions=("int8",)))
    assert FogClassifier.load(clf.save(tmp_path / "m8.npz"),
                              device="cpu").precision == "int8"


def test_load_rejects_bare_packs_and_per_lane_saves(host_pair, tmp_path):
    port, _ = host_pair
    bare = port.engine_.tables.pack("fp32").save(tmp_path / "bare.npz")
    with pytest.raises(ValueError, match="FogClassifier"):
        FogClassifier.load(bare, device="cpu")
    clf = FogClassifier.load(port.save(tmp_path / "m.npz"), device="cpu")
    clf.policy = tcore.FogPolicy(threshold=torch.tensor([0.1, 0.9]))
    with pytest.raises(ValueError, match="per-lane"):
        clf.save(tmp_path / "bad.npz")


def test_governor_raises_and_params(ds):
    clf = FogClassifier(n_trees=8, grove_size=4, device="cpu")
    params = clf.get_params()
    assert params["n_trees"] == 8 and params["device"] == "cpu"
    assert params["backend"] == "fused"
    clf.set_params(n_trees=16)
    assert clf.n_trees == 16
    with pytest.raises(ValueError):
        clf.set_params(bogus=1)
    with pytest.raises(RuntimeError):
        clf.predict(ds.x_test)                      # not fitted
    with pytest.raises(ValueError):
        FogClassifier(n_trees=5, grove_size=2, device="cpu").fit(
            ds.x_train, ds.y_train)
    with pytest.raises(NotImplementedError, match="A8"):
        clf.governor(1.0)


# ------------------------------------------------------------ budget.py

def test_evaluate_topology_and_threshold_sweep_equal_jax(device_clf, ds):
    f = device_clf.forest_
    jf = _jax_forest(f)
    x, y = ds.x_test[:NCAL], ds.y_test[:NCAL]
    start = jstarts(0, NCAL, 4)
    got = tcore.evaluate_topology(f, 2, x, y, 0.3, device="cpu",
                                  start=start)
    want = jcore.evaluate_topology(jf, 2, x, y, 0.3, seed=0)
    assert (got.n_groves, got.grove_size, got.threshold, got.accuracy,
            got.energy_nj, got.delay, got.edp) == (
        want.n_groves, want.grove_size, want.threshold, want.accuracy,
        want.energy_nj, want.delay, want.edp)
    got_s = tcore.threshold_sweep(f, 2, x, y, device="cpu", start=start)
    want_s = jcore.threshold_sweep(jf, 2, x, y)
    assert [(p.accuracy, p.energy_nj, p.delay) for p in got_s] == [
        (p.accuracy, p.energy_nj, p.delay) for p in want_s]
    assert (tcore.find_opt_threshold(got_s).threshold
            == jcore.find_opt_threshold(want_s).threshold)
    assert (tcore.select_min_edp(got_s).threshold
            == jcore.select_min_edp(want_s).threshold)


def test_topology_sweep_covers_every_factorization(device_clf, ds):
    pts = tcore.topology_sweep(device_clf.forest_, ds.x_test[:256],
                               ds.y_test[:256], device="cpu")
    assert [p.grove_size for p in pts] == [1, 2, 4, 8]
    assert [p.n_groves for p in pts] == [8, 4, 2, 1]
    best = tcore.select_min_edp(pts)
    assert best.accuracy >= max(p.accuracy for p in pts) - 0.02
