"""repro_torch's EnergyGovernor, TenantLedger, default_ladder and
FogClassifier.governor() against the JAX package's.

The governor is host numpy in both packages, so fed the same hop / energy
stream the two must hold the same rung, transitions (with the rolling nJ
at each), per-device estimates and ``policy_for_budget`` answers, exactly.
The calibrated ladders come from one frontier (the JAX package's, read by
the port through ``Frontier.from_dict``) or from the facades fitted on the
same data with the same calibration starts.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core.engine import sample_starts  # noqa: E402
from repro.serve import governor as jgov  # noqa: E402
from repro.sklearn import FogClassifier as JClassifier  # noqa: E402
from repro_torch.serve import governor as tgov  # noqa: E402
from repro_torch.sklearn import FogClassifier  # noqa: E402

_TPU_ONLY = ("compact", "interpret")
KW = dict(n_trees=8, grove_size=2, max_depth=5, seed=1)
NCAL = 512


def pdict(policy):
    return {k: v for k, v in policy.to_dict().items() if k not in _TPU_ONLY}


def models(precision="fp32"):
    return (tcore.EnergyModel(2, 6, 10, 16, precision),
            jcore.EnergyModel(2, 6, 10, 16, precision))


def state(gov):
    return (gov.rung, gov.rolling_nj, list(gov.transitions),
            gov.device_summary(), gov._seen, gov._ok_streak,
            dict(gov._measured_nj))


def feed(govs, seed, n=60, use_energy=False):
    """The same random stream into every governor: observe then step,
    with device labels; the states must agree after every step."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        size = int(rng.integers(1, 40))
        hops = rng.integers(1, 9, size)
        devices = rng.integers(0, 4, size)
        for g in govs:
            if use_energy:
                g.observe(energy_pj=np.asarray(g.price(hops)),
                          devices=devices)
            else:
                g.observe(hops=hops, devices=devices)
            g.step()
        states = [state(g) for g in govs]
        assert all(s == states[0] for s in states), i
    return govs


@pytest.mark.parametrize("budget", [None, 0.2, 0.6, 1.0])
def test_default_ladder_equals_jax(budget):
    tm, jm = models()
    base_t = tcore.FogPolicy(threshold=0.6, max_hops=8)
    base_j = jcore.FogPolicy(threshold=0.6, max_hops=8)
    got = tgov.default_ladder(base_t, tm if budget else None, budget)
    want = jgov.default_ladder(base_j, jm if budget else None, budget)
    assert [pdict(p) for p in got] == [pdict(p) for p in want]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("budget", [0.3, 0.5, 0.8])
@pytest.mark.parametrize("use_energy", [False, True])
def test_list_ladder_governor_equals_jax(seed, budget, use_energy):
    tm, jm = models()
    kw = dict(window=32, patience=2, cooldown=200, warmup=4)
    gt = tgov.EnergyGovernor(
        tgov.default_ladder(tcore.FogPolicy(threshold=0.6), tm, budget),
        budget, model=tm, **kw)
    gj = jgov.EnergyGovernor(
        jgov.default_ladder(jcore.FogPolicy(threshold=0.6), jm, budget),
        budget, model=jm, **kw)
    feed([gt, gj], seed, use_energy=use_energy)
    assert gt.summary() == gj.summary()


@pytest.fixture(scope="module")
def frontiers(trained):
    """A JAX frontier over the 8 x 2 field and the port's reading of it."""
    ds, rf = trained
    engine = jcore.FogEngine(jcore.split(rf, 2))
    f = jcore.build_frontier(engine, ds.x_test[:256], ds.y_test[:256],
                             jcore.default_grid(), jax.random.key(0))
    return tcore.Frontier.from_dict(f.to_dict()), f


@pytest.mark.parametrize("budget", [None, 0.25, 0.4, 0.7])
def test_frontier_governor_equals_jax(frontiers, budget):
    tf, jf = frontiers
    tm, jm = models()
    gt = tgov.EnergyGovernor(tf, budget, model=tm, window=32, patience=2)
    gj = jgov.EnergyGovernor(jf, budget, model=jm, window=32, patience=2)
    assert gt.n_rungs == gj.n_rungs and gt.rung == gj.rung
    assert pdict(gt.current) == pdict(gj.current)
    feed([gt, gj], seed=7)
    for nj in (1e-6, 0.05, 0.17, 0.2, 0.35, 0.6, 2.0):
        assert for_budget(gt, nj) == for_budget(gj, nj), nj
    assert for_budget(gt, 1e-6) == "refused"


def for_budget(gov, nj):
    """``policy_for_budget(nj)`` as a dict, or "refused" when the budget
    is below one hop's cost."""
    try:
        return pdict(gov.policy_for_budget(nj))
    except ValueError as e:
        assert "cannot be honored" in str(e)
        return "refused"


def test_ingest_and_ledger_equal_jax():
    tm, jm = models()
    tm8, jm8 = models("int8")
    kw = dict(window=16, patience=2, cooldown=10_000, warmup=4)
    ledgers = []
    for pkg, core, m, m8 in ((tgov, tcore, tm, tm8), (jgov, jcore, jm, jm8)):
        ledger = pkg.TenantLedger(default=pkg.EnergyGovernor(
            [core.FogPolicy(threshold=0.5)], None, model=m))
        ledger.add("a", pkg.EnergyGovernor(
            pkg.default_ladder(core.FogPolicy(threshold=0.6), m, 0.3), 0.3,
            model=m, **kw))
        ledger.add("b", pkg.EnergyGovernor(
            pkg.default_ladder(core.FogPolicy(threshold=0.6), m8, 2.0), 2.0,
            model=m8, **kw))
        ledgers.append(ledger)
    rng = np.random.default_rng(3)
    for _ in range(30):
        tenant = ["a", "b", "c"][int(rng.integers(3))]
        hops = rng.integers(1, 9, int(rng.integers(1, 20)))
        for ledger in ledgers:
            g = ledger.governor_for(tenant)
            g.ingest([(np.asarray(g.price(hops)), None)])
    (lt, lj) = ledgers
    assert lt.tenants() == lj.tenants() == ["a", "b"]
    assert lt.summary() == lj.summary()
    for t in ("a", "b", "c"):
        assert state(lt.governor_for(t)) == state(lj.governor_for(t))
    assert lt.governor_for("a").transitions, "tenant a never stepped down"
    with pytest.raises(ValueError, match="energy model"):
        tgov.TenantLedger().add("x", tgov.EnergyGovernor(
            [tcore.FogPolicy()], 1.0))


def test_governor_refusals_match_jax():
    for pkg, core in ((tgov, tcore), (jgov, jcore)):
        with pytest.raises(ValueError, match="at least one"):
            pkg.EnergyGovernor([], 1.0)
        with pytest.raises(ValueError, match="per-lane"):
            pkg.EnergyGovernor([core.FogPolicy(threshold=np.asarray(
                [0.1, 0.2], np.float32))], 1.0)
        gov = pkg.EnergyGovernor([core.FogPolicy()], budget_nj=1.0)
        with pytest.raises(ValueError, match="hops or energy_pj"):
            gov.observe()
        with pytest.raises(ValueError, match="energy model"):
            gov.observe(hops=np.ones(4))
        with pytest.raises(ValueError, match="devices labels"):
            gov.observe(energy_pj=np.ones(4), devices=np.zeros(3))


@pytest.fixture(scope="module")
def budgeted_pair(ds_penbased):
    """The same host-CART facade in both packages, each calibrated on the
    same rows from the same starts and pinned at 2 nJ."""
    ds = ds_penbased
    port = FogClassifier(**KW, device="cpu").fit(ds.x_train, ds.y_train)
    jclf = JClassifier(**KW).fit(ds.x_train, ds.y_train)
    cal = (ds.x_test[:NCAL], ds.y_test[:NCAL])
    start = np.asarray(sample_starts(jax.random.key(jclf.seed), NCAL,
                                     port.engine_.n_groves))
    jclf.set_energy_budget(2.0, *cal)
    port.set_energy_budget(2.0, *cal, start=start)
    return port, jclf


@pytest.mark.parametrize("budget", [None, 0.3, 1.0])
def test_facade_governor_equals_jax(budgeted_pair, budget):
    port, jclf = budgeted_pair
    gt = port.governor(budget, window=32, patience=2)
    gj = jclf.governor(budget, window=32, patience=2)
    assert gt.budget_nj == gj.budget_nj
    assert gt.n_rungs == gj.n_rungs and gt.rung == gj.rung
    assert [pdict(p) for p in gt._rungs] == [pdict(p) for p in gj._rungs]
    assert gt._predicted_nj == gj._predicted_nj
    assert (gt.model.per_hop_pj, gt.model.transfer_pj) == (
        gj.model.per_hop_pj, gj.model.transfer_pj)
    feed([gt, gj], seed=11)


def test_facade_governor_needs_a_frontier(ds_penbased):
    clf = FogClassifier(**KW, device="cpu")
    with pytest.raises(RuntimeError):
        clf.governor(1.0)                       # not fitted
    clf.fit(ds_penbased.x_train[:600], ds_penbased.y_train[:600])
    with pytest.raises(RuntimeError, match="frontier"):
        clf.governor(1.0)
