"""repro_torch's ModelRegistry and PackCache against the JAX package's.

A registry is a directory of ``.npz`` v1 artifacts and JSON manifests, so
one written by either package must load in the other: manifests, packs
(field for field), ``route(tenant, rid)`` over 1000 request ids, and the
rollback / promote / abort lifecycle read back from disk.  The cache must
hit, miss and evict in JAX's order on one seeded access trace.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.forest import ForestPack as JPack  # noqa: E402
from repro.registry import ModelRegistry as JRegistry  # noqa: E402
from repro.registry import PackCache as JCache  # noqa: E402
from repro.serve.scheduler import ServeStats as JStats  # noqa: E402
from repro_torch.forest import ForestPack  # noqa: E402
from repro_torch.registry import (CacheStats, ModelRegistry,  # noqa: E402
                                  PackCache, TenantState)
from repro_torch.serve.scheduler import ServeStats  # noqa: E402

FIELDS = ("feature", "threshold", "leaf", "thr_scale", "leaf_scale")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def packs(trained, tmp_path_factory):
    """The 8 x 2 field as a JAX pack and the port's pack of the same
    tables (read from the JAX artifact)."""
    _, rf = trained
    jpack = JPack.from_groves(jcore.split(rf, 2))
    path = jpack.save(tmp_path_factory.mktemp("pack") / "p.npz")
    return jpack, ForestPack.load(path)


def manifests(root):
    return {mf.parent.name: json.loads(mf.read_text())
            for mf in sorted(root.glob("*/MANIFEST.json"))}


def assert_pack_equal(tpack, jpack):
    assert tpack.precision == jpack.precision
    for f in FIELDS:
        got = getattr(tpack, f)
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16).numpy().view(np.uint16)
            want = np.asarray(getattr(jpack, f)).view(np.uint16)
        else:
            got, want = got.numpy(), np.asarray(getattr(jpack, f))
        np.testing.assert_array_equal(got, want, err_msg=f)


def lifecycle(reg, pack):
    """The same publish / canary / rollback history in either package."""
    reg.publish("alpha", pack, extra={"n_features_in": 16})
    reg.publish("alpha", pack.astype("int8"))
    reg.publish("alpha", pack, canary=0.3)
    reg.publish("beta", pack.astype("bf16"))
    reg.publish("beta", pack)
    reg.rollback("beta")
    reg.publish("gamma", pack)
    reg.publish("gamma", pack, canary=0.1)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_registry_loads_in_the_other_package(packs, tmp_path, writer):
    jpack, tpack = packs
    root = tmp_path / "reg"
    if writer == "jax":
        lifecycle(JRegistry(root), jpack)
    else:
        lifecycle(ModelRegistry(root), tpack)
    port, ref = ModelRegistry(root), JRegistry(root)
    assert port.tenants() == ref.tenants() == ["alpha", "beta", "gamma"]
    for t in ref.tenants():
        assert port.versions(t) == ref.versions(t)
        assert port.live_version(t) == ref.live_version(t)
        assert port.canary(t) == ref.canary(t)
        assert ([port.route(t, rid) for rid in range(1000)]
                == [ref.route(t, rid) for rid in range(1000)])
        for v in ref.versions(t):
            (tp, textra), (jp, jextra) = port.load(t, v), ref.load(t, v)
            assert textra == jextra
            assert_pack_equal(tp, jp)
    assert ModelRegistry(root).load("alpha", 1)[1] == {"n_features_in": 16}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_lifecycle_steps_read_back_in_the_other_package(packs, tmp_path,
                                                         writer):
    """promote, abort_canary and rollback written by one package are
    what the other reads from disk, step by step."""
    jpack, tpack = packs
    root = tmp_path / "reg"
    w_reg, r_cls, pack = ((JRegistry(root), ModelRegistry, jpack)
                          if writer == "jax"
                          else (ModelRegistry(root), JRegistry, tpack))
    lifecycle(w_reg, pack)
    steps = [lambda r: r.promote("alpha"), lambda r: r.abort_canary("gamma"),
             lambda r: r.rollback("alpha"), lambda r: r.rollback("alpha", 3),
             lambda r: r.publish("beta", pack, canary=0.5),
             lambda r: r.promote("beta")]
    for step in steps:
        step(w_reg)
        other = r_cls(root)
        for t in w_reg.tenants():
            assert other.live_version(t) == w_reg.live_version(t)
            assert other.canary(t) == w_reg.canary(t)
            assert other.versions(t) == w_reg.versions(t)
            assert ([other.route(t, rid) for rid in range(1000)]
                    == [w_reg.route(t, rid) for rid in range(1000)])
    assert manifests(root) == {t: TenantState.from_json(d).to_json()
                               for t, d in manifests(root).items()}


def test_registry_validation_matches_jax(packs, tmp_path):
    _, tpack = packs
    reg = ModelRegistry(tmp_path / "reg")
    for bad in ("", "a/b", ".hidden", "-x"):
        with pytest.raises(ValueError, match="invalid tenant"):
            reg.publish(bad, tpack)
    with pytest.raises(ValueError, match="full publish"):
        reg.publish("t", tpack, canary=0.1)
    reg.publish("t", tpack)
    for frac in (0.0, 1.0, -0.2, 2.0):
        with pytest.raises(ValueError, match="fraction"):
            reg.publish("t", tpack, canary=frac)
    with pytest.raises(ValueError, match="unknown tenant"):
        reg.route("ghost", 0)
    with pytest.raises(ValueError, match="nothing older"):
        reg.rollback("t")
    with pytest.raises(ValueError, match="no active canary"):
        reg.promote("t")
    reg.artifact_path("t", 1).unlink()
    with pytest.raises(ValueError, match="missing"):
        reg.load("t")


def test_judge_canary_equals_jax(packs, tmp_path):
    jpack, tpack = packs
    out = []
    for reg_cls, pack, stats in ((JRegistry, jpack, JStats),
                                 (ModelRegistry, tpack, ServeStats)):
        reg = reg_cls(tmp_path / reg_cls.__module__)
        reg.publish("t", pack)
        reg.publish("t", pack, canary=0.5)
        rng = np.random.default_rng(0)
        for v in (1, 2):
            reg.stats_for("t", v).update(rng.integers(1, 9, 32),
                                         energy_pj=rng.random(32) * 1e3,
                                         tiers=["a", "b"] * 16)
        assert isinstance(reg.stats_for("t", 1), stats)
        out.append(reg.judge_canary("t"))
    assert out[0] == out[1]


# --------------------------------------------------------------------------
# PackCache
# --------------------------------------------------------------------------

def access_trace(seed, n=300):
    """(op, tenant, version, precision) steps over three tenants with
    publishes interleaved (which demote versions to stale)."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(n):
        if i % 60 == 59:
            steps.append(("publish", ["a", "b", "c"][rng.integers(3)], None,
                          None))
            continue
        t = ["a", "b", "c"][int(rng.choice(3, p=[0.6, 0.3, 0.1]))]
        prec = ["fp32", "int8", "bf16"][int(rng.choice(3, p=[0.6, 0.3, 0.1]))]
        steps.append(("get", t, None if rng.random() < 0.8 else 1, prec))
    return steps


def replay(reg, cache, pack, trace):
    """Every observable after each step: resident keys in order, weights,
    stats and peak bytes."""
    out = []
    for op, t, v, prec in trace:
        if op == "publish":
            reg.publish(t, pack)
        else:
            cache.get(t, v if v is not None else reg.live_version(t), prec)
        out.append((cache.keys(),
                    [round(cache.weight_of(*k), 9) for k in cache.keys()],
                    cache.stats.hits, cache.stats.misses,
                    cache.stats.evictions, cache.bytes_used,
                    cache.peak_bytes))
    return out


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("decay", [0.97, 1.0])
def test_cache_eviction_order_equals_jax(packs, tmp_path, seed, decay):
    jpack, tpack = packs
    budget = 2 * jpack.table_bytes + jpack.astype("int8").table_bytes
    runs = []
    for reg_cls, cache_cls, pack in ((JRegistry, JCache, jpack),
                                     (ModelRegistry, PackCache, tpack)):
        reg = reg_cls(tmp_path / f"{reg_cls.__module__}-{seed}-{decay}")
        for t in ("a", "b", "c"):
            reg.publish(t, pack)
        cache = cache_cls(reg, budget_bytes=budget, decay=decay)
        runs.append(replay(reg, cache, pack, access_trace(seed)))
    assert runs[1] == runs[0]
    assert runs[1][-1][4] > 0, "the trace never evicted"


def test_cache_budget_and_validation(packs, tmp_path):
    _, tpack = packs
    reg = ModelRegistry(tmp_path / "reg")
    reg.publish("t", tpack)
    reg.publish("t", tpack)
    cache = PackCache(reg, budget_bytes=tpack.table_bytes)
    p1 = cache.get("t", 1)
    assert cache.get("t", 1) is p1 and cache.stats.hits == 1
    cache.get("t", 2)
    assert cache.keys() == [("t", 2, "fp32")] and cache.stats.evictions == 1
    assert cache.peak_bytes <= cache.budget_bytes
    assert isinstance(cache.stats, CacheStats)
    assert cache.stats.hit_rate == pytest.approx(1 / 3)
    with pytest.raises(ValueError, match="cache budget"):
        PackCache(reg, budget_bytes=tpack.table_bytes - 1).get("t", 1)
    with pytest.raises(ValueError, match="budget_bytes"):
        PackCache(reg, budget_bytes=0)
    for decay in (0.0, 1.5):
        with pytest.raises(ValueError, match="decay"):
            PackCache(reg, budget_bytes=1024, decay=decay)


def test_device_pack_one_copy_per_device(packs, tmp_path):
    """Copies are keyed by device, not by replica: replicas sharing a
    device share one copy, which eviction drops."""
    _, tpack = packs
    reg = ModelRegistry(tmp_path / "reg")
    reg.publish("t", tpack)
    cache = PackCache(reg, budget_bytes=2 * tpack.table_bytes)
    c1 = cache.device_pack("t", 1, "int8", CPU)
    assert cache.device_pack("t", 1, "int8", "cpu") is c1
    assert c1.precision == "int8" and c1.feature.device == CPU
    assert cache.bytes_used == c1.table_bytes      # one copy counted
    assert cache.evict("t", 1, "int8")
    assert not cache.evict("t", 1, "int8")
    assert cache.device_pack("t", 1, "int8", CPU) is not c1
