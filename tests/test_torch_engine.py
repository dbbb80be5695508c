"""repro_torch's FogEngine against the JAX reference backend.

Every case feeds both packages the JAX package's own start draws
(``repro.core.engine.sample_starts``) and compares against
``repro.core.engine._eval_core(..., backend="reference")`` at the SAME
precision, at the bar of tests/test_engine_conformance.py: hops and labels
equal, proba within rtol 1e-6 / atol 1e-7, and ``energy_pj`` equal to
``lane_pj(hops)``.  On the CPU the kernel backends run the kernels' plain
versions.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core.engine import _eval_core, sample_starts  # noqa: E402
from repro.forest import ForestPack as JPack  # noqa: E402
from repro_torch.core.policy import NO_BUDGET  # noqa: E402
from repro_torch.forest import TensorForest  # noqa: E402

PRECISIONS = ["fp32", "bf16", "int8"]
BACKENDS = ["reference", "pallas", "fused"]
THRESHES = [0.1, 0.3, 1.1]
B = 257          # prime: never a multiple of a block or chunk size


def t_split(rf, k=2):
    return tcore.split(
        TensorForest.from_numpy(rf.feature, rf.threshold, rf.leaf), k)


def assert_conforms(res, want, model):
    np.testing.assert_array_equal(res.hops.numpy(), np.asarray(want.hops))
    np.testing.assert_array_equal(res.label.numpy(), np.asarray(want.label))
    np.testing.assert_allclose(res.proba.numpy(), np.asarray(want.proba),
                               rtol=1e-6, atol=1e-7)
    assert res.hops.dtype == torch.int32 and res.proba.dtype == torch.float32
    assert torch.equal(res.energy_pj, res.model.lane_pj(res.hops))
    # the port prices exactly as the JAX package does
    np.testing.assert_array_equal(
        res.energy_pj.numpy(), np.asarray(model.lane_pj(want.hops)))


@pytest.fixture(scope="module")
def field(trained):
    """(x, start, JAX groves, port groves) for the 8 x 2 field."""
    ds, rf = trained
    start = sample_starts(jax.random.key(7), B, 8)
    return ds.x_test[:B], start, jcore.split(rf, 2), t_split(rf)


@pytest.fixture(scope="module")
def jax_ref(field):
    """Memoized JAX reference results keyed by (precision, thresh, budget,
    max_hops, lazy)."""
    x, start, jgc, _ = field
    packs = {p: JPack.from_groves(jgc, p) for p in PRECISIONS}
    cache = {}

    def run(precision, thresh, budget=None, max_hops=8, lazy=False):
        key = (precision, str(thresh), str(budget), max_hops, lazy)
        if key not in cache:
            th = jnp.broadcast_to(jnp.asarray(thresh, jnp.float32), (B,))
            bu = jnp.broadcast_to(jnp.asarray(
                NO_BUDGET if budget is None else budget, jnp.int32), (B,))
            cache[key] = _eval_core(packs[precision], jnp.asarray(x), start,
                                    th, bu, max_hops, "reference", 256, lazy)
        return cache[key]
    return run


def model_of(precision, jgc):
    return jcore.EnergyModel(jgc.grove_size, jgc.depth, jgc.n_classes, 16,
                             precision)


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("thresh", THRESHES)
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_matches_jax_reference(field, jax_ref, backend, precision,
                                       thresh, lazy):
    x, start, jgc, tgc = field
    eng = tcore.FogEngine(tgc, backend=backend, device="cpu",
                          precision=precision, lazy=lazy)
    res = eng.eval(x, policy=tcore.FogPolicy(threshold=thresh),
                   start=np.asarray(start))
    assert_conforms(res, jax_ref(precision, thresh, lazy=lazy),
                    model_of(precision, jgc))
    assert res.precision == precision


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_per_lane_threshold_and_budget(field, jax_ref, backend, precision):
    x, start, jgc, tgc = field
    rng = np.random.default_rng(0)
    thresh = rng.random(B).astype(np.float32)
    budget = rng.integers(1, 9, B).astype(np.int32)
    want = jax_ref(precision, thresh, budget)
    res = tcore.FogEngine(tgc, backend=backend, device="cpu").eval(
        x, policy=tcore.FogPolicy(threshold=torch.as_tensor(thresh),
                                  hop_budget=torch.as_tensor(budget),
                                  precision=precision),
        start=torch.tensor(np.asarray(start)))
    assert_conforms(res, want, model_of(precision, jgc))
    assert (res.hops.numpy() <= budget).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_hop_budget_one_and_max_hops(field, jax_ref, backend):
    x, start, jgc, tgc = field
    eng = tcore.FogEngine(tgc, backend=backend, device="cpu")
    one = eng.eval(x, policy=tcore.FogPolicy(threshold=1.1, hop_budget=1),
                   start=np.asarray(start))
    assert_conforms(one, jax_ref("fp32", 1.1, 1), model_of("fp32", jgc))
    assert (one.hops.numpy() == 1).all()
    three = eng.eval(x, policy=tcore.FogPolicy(threshold=1.1, max_hops=3),
                     start=np.asarray(start))
    assert_conforms(three, jax_ref("fp32", 1.1, max_hops=3),
                    model_of("fp32", jgc))


@pytest.mark.parametrize("chunk_b", [64, 100])
@pytest.mark.parametrize("backend", BACKENDS)
def test_explicit_chunks_with_ragged_tail(field, jax_ref, backend, chunk_b):
    x, start, jgc, tgc = field
    res = tcore.FogEngine(tgc, backend=backend, chunk_b=chunk_b,
                          device="cpu").eval(
        x, policy=tcore.FogPolicy(threshold=0.3, precision="int8"),
        start=np.asarray(start))
    assert res.proba.shape == (B, 10)
    assert_conforms(res, jax_ref("int8", 0.3), model_of("int8", jgc))
    auto = tcore.FogEngine(tgc, backend=backend, chunk_b="auto",
                           device="cpu").eval(
        x, policy=tcore.FogPolicy(threshold=0.3, precision="int8"),
        start=np.asarray(start))
    assert torch.equal(auto.hops, res.hops)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_two_heads_min_over_heads(trained, rf8_penbased, rf8_noisy_penbased,
                                  backend, precision):
    ds, _ = trained
    heads = (rf8_penbased, rf8_noisy_penbased)
    jgcs = tuple(jcore.split(r, 2) for r in heads)
    n = 130
    start = sample_starts(jax.random.key(11), n, 4)
    x = ds.x_test[:n]
    want = _eval_core(JPack.from_groves(jgcs, precision), jnp.asarray(x),
                      start, jnp.full((n,), 0.3, jnp.float32),
                      jnp.full((n,), NO_BUDGET, jnp.int32), 4, "reference",
                      256, False)
    res = tcore.FogEngine(tuple(t_split(r) for r in heads), backend=backend,
                          precision=precision, device="cpu").eval(
        x, policy=tcore.FogPolicy(threshold=0.3, max_hops=4),
        start=np.asarray(start))
    assert res.proba.shape == (n, 2, ds.n_classes)
    assert res.label.shape == (n, 2)
    assert_conforms(res, want, model_of(precision, jgcs[0]))


def test_engine_from_loaded_artifact(field, jax_ref, tmp_path):
    """A JAX-saved int8 artifact serves through the port unchanged."""
    x, start, jgc, _ = field
    JPack.from_groves(jgc, "int8").save(tmp_path / "m.npz")
    pack = tcore.ForestPack.load(tmp_path / "m.npz")
    eng = tcore.FogEngine(pack, backend="fused", device="cpu")
    assert eng.precision == "int8" and eng.n_groves == 8
    res = eng.eval(x, policy=tcore.FogPolicy(threshold=0.3),
                   start=np.asarray(start))
    assert_conforms(res, jax_ref("int8", 0.3), model_of("int8", jgc))
    assert eng.gcs[0].leaf.dtype == torch.float32   # dequantized views


def test_own_start_draws_are_uniform(field):
    """The port's own RNG is checked by its distribution only."""
    *_, tgc = field
    g = torch.Generator().manual_seed(0)
    start = tcore.sample_starts(g, 80_000, 8)
    assert start.dtype == torch.int32
    counts = np.bincount(start.numpy(), minlength=8)
    assert counts.min() >= 0 and start.max() < 8
    # chi-square with 7 dof: 24.3 is the 0.999 quantile
    chi2 = ((counts - 10_000) ** 2 / 10_000).sum()
    assert chi2 < 24.3
    eng = tcore.FogEngine(tgc, device="cpu")
    x = np.zeros((5, 16), np.float32)
    a = eng.eval(x, torch.Generator().manual_seed(3))
    b = eng.eval(x, torch.Generator().manual_seed(3))
    assert torch.equal(a.proba, b.proba)
    with pytest.raises(ValueError, match="Generator"):
        eng.eval(x)
    with pytest.raises(ValueError, match="features"):
        eng.eval(np.zeros((5, 3), np.float32), start=[0] * 5)


def test_confidence_margin_and_hop_update_dispatch():
    rng = np.random.default_rng(1)
    p = torch.as_tensor(rng.random((9, 4)).astype(np.float32))
    want = tcore.maxdiff(p)
    for backend in ("reference", "pallas"):
        assert torch.equal(tcore.confidence_margin(p, backend=backend), want)
    with pytest.raises(ValueError, match="step backend"):
        tcore.confidence_margin(p, backend="fused")
    live = torch.ones(9, dtype=torch.bool)
    hops = torch.zeros(9, dtype=torch.int32)
    a = tcore.hop_update(p, p, live, hops, 0.2, backend="reference")
    b = tcore.hop_update(p, p, live, hops, 0.2, backend="pallas")
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_device_rules(field):
    *_, tgc = field
    pack = tcore.ForestPack.from_groves(tgc)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tcore.FogEngine(tgc)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        pack.to()
    assert pack.to("cpu").feature.device.type == "cpu"
    assert tcore.FogEngine(tgc, device="cpu").device.type == "cpu"


def test_policy_contract(field):
    *_, tgc = field
    P = tcore.FogPolicy
    # the ring is ported: the policy is accepted, and a ring engine needs
    # a mesh (tests/test_torch_ring.py drives it)
    assert P(backend="ring").backend == "ring"
    with pytest.raises(ValueError, match="mesh"):
        tcore.FogEngine(tgc, backend="ring", device="cpu")
    for bad in (dict(backend="asic"), dict(precision="fp64"),
                dict(max_hops=0), dict(chunk_b="sometimes"),
                dict(chunk_b=0), dict(hop_budget=0),
                dict(hop_budget=torch.tensor([1, 0]))):
        with pytest.raises(ValueError):
            P(**bad)
    with pytest.raises(ValueError, match="threads per block"):
        tcore.FogEngine(tgc, device="cpu", block_b=100).eval(
            np.zeros((2, 16), np.float32), start=[0, 1])
    p = P(threshold=0.25, max_hops=4, hop_budget=3, backend="pallas")
    d = p.to_dict()
    assert P.from_dict(d) == p
    # a JAX-written policy dict (FogClassifier artifacts) reads back
    jd = jcore.FogPolicy(threshold=0.25, max_hops=4, hop_budget=3,
                         backend="pallas").to_dict()
    assert P.from_dict(jd) == p
    assert jcore.FogPolicy.from_dict(d).to_dict() == jd
    assert P(threshold=torch.rand(3)).per_lane
    with pytest.raises(ValueError, match="per-lane"):
        P(threshold=torch.rand(3)).to_dict()
    np.testing.assert_array_equal(
        P(threshold=0.3).lane_thresholds(4).numpy(),
        np.asarray(jcore.FogPolicy(threshold=0.3).lane_thresholds(4)))
    np.testing.assert_array_equal(P().lane_budgets(3).numpy(),
                                  [NO_BUDGET] * 3)
    with pytest.raises(ValueError, match="batch"):
        P(threshold=torch.rand(3)).lane_thresholds(4)
    assert tcore.BACKENDS == ("reference", "pallas", "fused", "ring")
    assert tcore.BACKENDS == jcore.BACKENDS
    # a JAX-written ring policy reads back
    jring = jcore.FogPolicy(threshold=0.3, backend="ring").to_dict()
    assert P.from_dict(jring) == P(threshold=0.3, backend="ring")
