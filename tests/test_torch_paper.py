"""The port's paper path (repro_torch.paper) against the JAX package on the
CPU, on segmentation.

Both packages train the same forest (the host CART is the same bit for
bit) and the port is fed the JAX package's start draws
(``repro.core.engine.sample_starts(jax.random.key(0), B, n_groves)``, what
JAX's ``FogEngine.eval(x, jax.random.key(0))`` draws) and JAX's baseline
init.  The JAX side is built from ``repro``'s functions as the JAX
package's benchmark harness builds it.  Bars: accuracies and hop means
equal, energies within rtol 1e-6, the CSV rows equal; the baselines'
accuracy within 0.01 of JAX's.  JAX's baselines are trained once
(``jax_baselines``), for Table 1's columns and for the trained-model
checks of ``tests/test_torch_baselines.py``'s bars (each baseline trained
by both packages from JAX's init: accuracy within 0.01 and above 0.8,
its predictions giving its accuracy, SVM_RBF's energy equal).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.baselines.cnn as jcnn  # noqa: E402
import repro.baselines.mlp as jmlp  # noqa: E402
import repro.baselines.svm as jsvm  # noqa: E402
import repro.baselines.train as jtrain  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.forest as jforest  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core.engine import sample_starts  # noqa: E402
from repro.data import make_dataset as jdataset  # noqa: E402
from repro_torch.baselines import (ALL_BASELINES,  # noqa: E402
                                   params_from_jax)
from repro_torch.forest import TensorForest  # noqa: E402
from repro_torch.paper import (ablation_adaptive, common,  # noqa: E402
                               fig4_topology, fig5_threshold, run,
                               table1_accuracy, table1_energy)

NAME = "segmentation"
RTOL = 1e-6
BASELINES = ["svm_lr", "svm_rbf", "mlp", "cnn"]
ACC_BAR = 0.01


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's small training steps: the suite
    runs test files in parallel workers, where each op's threads only
    contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def jax_starts(B: int, n_groves: int) -> np.ndarray:
    return np.asarray(sample_starts(jax.random.key(0), B, n_groves))


def starts(name, n_groves):
    return jax_starts(len(common.dataset(name).y_test), n_groves)


@pytest.fixture(scope="module")
def jds():
    return jdataset(NAME)


@pytest.fixture(scope="module")
def jrf(jds):
    return jforest.train_random_forest(
        jds.x_train, jds.y_train, jds.n_classes,
        jforest.TrainConfig(n_trees=common.N_TREES,
                            max_depth=common.depth_for(NAME), seed=0))


def jax_init(name, F, C):
    key = jax.random.key(0)
    return {"svm_lr": lambda: jsvm.init_linear_svm(key, F, C),
            "svm_rbf": lambda: jsvm.init_rbf_svm(key, F, C),
            "mlp": lambda: jmlp.init_mlp(key, F, C),
            "cnn": lambda: jcnn.init_cnn(key, F, C)}[name]()


@pytest.fixture(scope="module")
def jax_baselines(jds):
    """JAX's four baselines trained on segmentation (seed 0): the one
    training of them in the suite."""
    return {name: getattr(jtrain, f"train_{name}")(jds) for name in BASELINES}


@pytest.fixture(scope="module")
def trained_segmentation(jds, jax_baselines):
    """Each baseline trained by both packages on segmentation from JAX's
    init (seed 0): {name: (JAX's TrainedModel, the port's)}."""
    tds = common.dataset(NAME)
    return {name: (jax_baselines[name], ALL_BASELINES[name](
        tds, params=params_from_jax(name, jax.tree.map(
            np.asarray, jax_init(name, jds.n_features, jds.n_classes)),
            device="cpu"), device="cpu")) for name in BASELINES}


@pytest.mark.parametrize("name", BASELINES)
def test_trained_accuracy_matches_jax_on_segmentation(trained_segmentation,
                                                      name):
    jm, tm = trained_segmentation[name]
    assert tm.name == jm.name == name
    assert abs(tm.accuracy - jm.accuracy) <= ACC_BAR, (tm.accuracy,
                                                       jm.accuracy)
    assert tm.accuracy > 0.8
    x = torch.as_tensor(common.dataset(NAME).x_test)
    assert np.mean(tm.predict(tm.params, x).numpy()
                   == common.dataset(NAME).y_test) == tm.accuracy


def test_trained_svm_rbf_energy_matches_jax(trained_segmentation):
    jm, tm = trained_segmentation["svm_rbf"]
    assert tm.energy_nj == jm.energy_nj


@pytest.fixture(scope="module")
def jax_columns(jds, jrf, jax_baselines):
    """The seven columns as the JAX package's harness computes them."""
    out = {k: (m.accuracy, m.energy_nj) for k, m in jax_baselines.items()}
    x = jnp.asarray(jds.x_test)
    out["rf"] = (float(np.mean(np.asarray(jforest.rf_predict(jrf, x))
                               == jds.y_test)),
                 jcore.rf_report(len(jds.y_test), jrf.n_trees,
                                 common.depth_for(NAME),
                                 jds.n_classes).per_example_nj)
    res = jcore.FogEngine(jcore.split(jrf, 2)).eval(
        x, jax.random.key(0), policy=jcore.FogPolicy(threshold=1.1))
    out["fog_max"] = (float(np.mean(np.asarray(res.label) == jds.y_test)),
                      res.energy_report().per_example_nj)
    opt = jcore.find_opt_threshold(jcore.threshold_sweep(
        jrf, 2, jds.x_test, jds.y_test))
    out["fog_opt"] = (opt.accuracy, opt.energy_nj)
    return out


@pytest.fixture(scope="module")
def port_columns(jds):
    F, C = jds.n_features, jds.n_classes
    params = {k: params_from_jax(k, jax.tree.map(np.asarray,
                                                 jax_init(k, F, C)),
                                 device="cpu") for k in BASELINES}
    return common.evaluate_all(NAME, device="cpu", backend="fused",
                               start_for=functools.partial(starts, NAME),
                               baseline_params=params)


def test_forest_is_jax_forest(jrf):
    rf = common.forest_for(NAME)
    for f in ("feature", "threshold", "leaf"):
        np.testing.assert_array_equal(getattr(rf, f).numpy(),
                                      np.asarray(getattr(jrf, f)))


@pytest.mark.parametrize("col", ["rf", "fog_max", "fog_opt"])
def test_forest_columns_equal_jax(port_columns, jax_columns, col):
    acc, nj = jax_columns[col]
    assert port_columns[col].accuracy == acc
    np.testing.assert_allclose(port_columns[col].energy_nj, nj, rtol=RTOL)


@pytest.mark.parametrize("col", BASELINES)
def test_baseline_columns_match_jax(port_columns, jax_columns, col):
    acc, nj = jax_columns[col]
    assert abs(port_columns[col].accuracy - acc) <= 0.01
    if col != "svm_rbf":          # SVM_RBF's energy follows its support set
        assert port_columns[col].energy_nj == nj


@pytest.mark.parametrize("col", common.COLUMNS)
def test_columns_predict_their_accuracy(port_columns, col):
    ds = common.dataset(NAME)
    labels = port_columns[col].predict(torch.as_tensor(ds.x_test))
    assert np.mean(labels.numpy() == ds.y_test) == port_columns[col].accuracy


def test_table1_rows_are_jax_rows(port_columns, jax_columns):
    cols = common.COLUMNS
    want_acc = ["dataset," + ",".join(cols),
                NAME + "," + ",".join(f"{jax_columns[c][0] * 100:.1f}"
                                      for c in cols)]
    assert table1_accuracy.run({NAME: port_columns}) == want_acc
    rows = table1_energy.run({NAME: port_columns})
    assert rows[0] == want_acc[0]
    assert rows[1].split(",")[:4] == [NAME] + [
        f"{jax_columns[c][1]:.2f}" for c in cols[:3]]
    assert rows[2].startswith("geomean_ratio_vs_fog_opt,")
    assert rows[2].endswith(",1.00")
    ratios = table1_energy.geomean_ratios({NAME: port_columns})
    np.testing.assert_allclose(
        ratios["rf"], jax_columns["rf"][1] / jax_columns["fog_opt"][1],
        rtol=1e-5)


def same_points(got, want):
    assert [(p.n_groves, p.grove_size) for p in got] == [
        (p.n_groves, p.grove_size) for p in want]
    for g, w in zip(got, want):
        assert g.accuracy == w.accuracy
        assert g.delay == w.delay
        assert g.threshold == pytest.approx(w.threshold, rel=1e-12)
        np.testing.assert_allclose(g.energy_nj, w.energy_nj, rtol=RTOL)
        np.testing.assert_allclose(g.edp, w.edp, rtol=RTOL)


@pytest.fixture(scope="module")
def jax_fig4(jds, jrf):
    return jcore.topology_sweep(jrf, jds.x_test, jds.y_test,
                                policy=jcore.FogPolicy(threshold=0.3))


@pytest.mark.parametrize("form", ["callable", "dict"])
def test_topology_sweep_takes_start(jds, jax_fig4, form):
    rf = common.forest_for(NAME)
    B = len(jds.y_test)
    start = (functools.partial(jax_starts, B) if form == "callable"
             else {g: jax_starts(B, g) for g in (1, 2, 4, 8, 16)})
    pts = tcore.topology_sweep(rf, jds.x_test, jds.y_test,
                               policy=tcore.FogPolicy(threshold=0.3),
                               device="cpu", start=start)
    same_points(pts, jax_fig4)


def test_topology_sweep_default_draws_are_unchanged(jds):
    """Without ``start`` each topology draws from a generator seeded 0."""
    rf = common.forest_for(NAME)
    pts = tcore.topology_sweep(rf, jds.x_test, jds.y_test, device="cpu")
    want = [tcore.evaluate_topology(rf, k, jds.x_test, jds.y_test, 0.3,
                                    device="cpu") for k in (1, 2, 4, 8, 16)]
    same_points(pts, want)


def test_fig4_rows_are_jax_rows(jax_fig4):
    rows = fig4_topology.run((NAME,), device="cpu", starts=starts)
    want = ["dataset,topology,threshold,accuracy,energy_nj,mean_hops,edp"]
    for p in jax_fig4:
        want.append(f"{NAME},{p.n_groves}x{p.grove_size},{p.threshold},"
                    f"{p.accuracy:.4f},{p.energy_nj:.3f},{p.delay:.2f},"
                    f"{p.edp:.4f}")
    pick = jcore.select_min_edp(jax_fig4)
    want.append(f"{NAME},SELECTED:{pick.n_groves}x{pick.grove_size},"
                f"{pick.threshold},{pick.accuracy:.4f},{pick.energy_nj:.3f},"
                f"{pick.delay:.2f},{pick.edp:.4f}")
    assert rows == want


@pytest.mark.parametrize("grove_size", [2, 4])
def test_fig5_points_equal_jax(jds, jrf, grove_size):
    rf = common.forest_for(NAME)
    want = jcore.threshold_sweep(jrf, grove_size, jds.x_test, jds.y_test,
                                 fig5_threshold.THRESHOLDS)
    got = tcore.threshold_sweep(
        rf, grove_size, jds.x_test, jds.y_test, fig5_threshold.THRESHOLDS,
        device="cpu", start=starts(NAME, rf.n_trees // grove_size))
    same_points(got, want)


def test_fig5_rows_are_jax_rows(jds, jrf):
    rows = fig5_threshold.run([NAME], device="cpu", starts=starts)
    want = ["dataset,topology,threshold,accuracy,energy_nj,edp"]
    for grove_size, label in [(2, "8x2"), (4, "4x4")]:
        for p in jcore.threshold_sweep(jrf, grove_size, jds.x_test,
                                       jds.y_test, fig5_threshold.THRESHOLDS):
            want.append(f"{NAME},{label},{p.threshold:.2f},"
                        f"{p.accuracy:.4f},{p.energy_nj:.4f},{p.edp:.5f}")
    assert rows == want


def test_ablation_rows_are_jax_rows(jds, jrf):
    """The JAX package's ablation loop, built from ``repro``."""
    gc = jcore.split(jrf, 2)
    engine = jcore.FogEngine(gc)
    x = jnp.asarray(jds.x_test)
    want = ["dataset,thresh,fog_acc,fog_mean_trees,static_trees,static_acc,"
            "adaptive_gain"]
    for thresh in ablation_adaptive.THRESHOLDS:
        res = engine.eval(x, jax.random.key(0),
                          policy=jcore.FogPolicy(threshold=thresh))
        fog_acc = float(np.mean(np.asarray(res.label) == jds.y_test))
        mean_trees = float(np.asarray(res.hops).mean()) * gc.grove_size
        k = max(2, round(mean_trees / gc.grove_size) * gc.grove_size)
        votes = jforest.forest_votes(jrf.slice_trees(0, min(k, jrf.n_trees)),
                                     x)
        st_acc = float(np.mean(np.asarray(jnp.argmax(votes, -1))
                               == jds.y_test))
        want.append(f"{NAME},{thresh},{fog_acc:.4f},{mean_trees:.1f},"
                    f"{min(k, jrf.n_trees)},{st_acc:.4f},"
                    f"{fog_acc - st_acc:+.4f}")
    assert ablation_adaptive.run((NAME,), device="cpu",
                                 starts=starts) == want


@pytest.mark.parametrize("start,count", [(0, 2), (0, 16), (3, 5), (14, 4)])
def test_slice_trees_equals_jax(jrf, start, count):
    got = TensorForest.from_numpy(jrf.feature, jrf.threshold,
                                  jrf.leaf).slice_trees(start, count)
    want = jrf.slice_trees(start, count)
    for f in ("feature", "threshold", "leaf"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert got.n_trees == want.n_trees


def test_runner_sections_and_refusals(capsys):
    assert list(run.sections(device="cpu")) == [
        "table1_accuracy", "table1_energy", "fig4_topology",
        "fig5_threshold", "ablation_adaptive"]
    with pytest.raises(SystemExit):
        run.main(["--only", "engine", "--device", "cpu"])
    assert "unknown sections" in capsys.readouterr().err


def test_runner_prints_a_section(capsys):
    assert run.main(["--quick", "--only", "fig5_threshold",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "===== fig5_threshold =====" in out
    assert "segmentation,4x4,1.00," in out
    assert out.rstrip().endswith("all paper sections passed")
