"""repro_torch's serving plane against the JAX package's, on the CPU.

The policy helpers (``lane_knobs``, ``LanePolicies``, ``assemble``) and the
splices (``splice_lanes``, ``splice_slot_state``) must equal JAX's bit for
bit.  End to end, ``ContinuousBatcher`` + ``DeviceDispatcher`` +
``ForestReplicaServer`` (the packed protocol, the default "fused" backend)
serve one submission schedule in both packages — two registry tenants,
fp32 and int8 requests, three QoS tiers, energy-budget contracts, a bounded
queue, a per-tenant governor ledger under a budget that makes one tenant
step down, and a hot-swap mid-run — at 1 and 2 replicas, synchronous and
pipelined.  The port is fed JAX's own start draws through ``draw_starts``
(``jax.random.randint(fold_in(key(seed + replica), step), ...)``).  Labels,
hops, shed sets, governor rungs and transitions, pinned versions and event
counts must be equal; energy within rtol 1e-6 (XLA may contract the
affine price into an FMA).  The port's own modes must be bit-equal, energy
included.

The LM case runs the batcher over ``decode_step_fog`` on
``tinyllama-1.1b``'s smoke config with JAX's fp32 weights carried over,
per-request thresholds and a hop budget: tokens and per-step hops equal.
"""
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.core.policy as jpolicy  # noqa: E402
import repro.registry as jregistry  # noqa: E402
import repro.serve.dispatch as jdispatch  # noqa: E402
import repro.serve.governor as jgovernor  # noqa: E402
import repro.serve.scheduler as jscheduler  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.policy as tpolicy  # noqa: E402
import repro_torch.registry as tregistry  # noqa: E402
import repro_torch.serve.dispatch as tdispatch  # noqa: E402
import repro_torch.serve.governor as tgovernor  # noqa: E402
import repro_torch.serve.scheduler as tscheduler  # noqa: E402
from repro.core.engine import splice_lanes as j_splice_lanes  # noqa: E402
from repro.core.engine import (  # noqa: E402
    splice_slot_state as j_splice_slot_state)
from repro.forest import ForestPack as JPack  # noqa: E402
from repro.launch.serve import _splice_row as j_splice_row  # noqa: E402
from repro.models import fog_exit as jfog  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.engine import (splice_lanes,  # noqa: E402
                                     splice_slot_state)
from repro_torch.forest import ForestPack  # noqa: E402
from repro_torch.launch.serve import _splice_tree  # noqa: E402
from repro_torch.models import fog_exit as tfog  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.carry import params_from_jax  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

CPU = torch.device("cpu")
N_SLOTS = 8
SEED = 0

JAX = types.SimpleNamespace(
    name="jax", Policy=jcore.FogPolicy, Registry=jregistry.ModelRegistry,
    Cache=jregistry.PackCache, Server=jdispatch.ForestReplicaServer,
    Dispatcher=jdispatch.DeviceDispatcher, Governor=jgovernor.EnergyGovernor,
    Ledger=jgovernor.TenantLedger, ladder=jgovernor.default_ladder,
    Batcher=jscheduler.ContinuousBatcher, Request=jscheduler.Request)
PORT = types.SimpleNamespace(
    name="torch", Policy=tcore.FogPolicy, Registry=tregistry.ModelRegistry,
    Cache=tregistry.PackCache, Server=tdispatch.ForestReplicaServer,
    Dispatcher=tdispatch.DeviceDispatcher, Governor=tgovernor.EnergyGovernor,
    Ledger=tgovernor.TenantLedger, ladder=tgovernor.default_ladder,
    Batcher=tscheduler.ContinuousBatcher, Request=tscheduler.Request)


def jax_draws(index, step, span, n_groves):
    """JAX's packed dispatch draw for replica ``index``'s ``step``-th
    dispatch (``repro/serve/dispatch.py::_serve_eval_packed``)."""
    key = jax.random.fold_in(jax.random.key(SEED + index), step)
    return np.asarray(jax.random.randint(key, (span,), 0, n_groves))


# --------------------------------------------------------------------------
# policy helpers
# --------------------------------------------------------------------------

def random_policies(rng, pkg, n):
    """``n`` scalar policies or None, with and without hop budgets."""
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.25:
            out.append(None)
            continue
        bud = None if r < 0.6 else int(rng.integers(1, 9))
        out.append(pkg.Policy(threshold=float(rng.random()), hop_budget=bud))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_lane_knobs_equal_jax(seed):
    rng = np.random.default_rng(seed)
    pols = random_policies(rng, JAX, 16)
    rng = np.random.default_rng(seed)
    tpols = random_policies(rng, PORT, 16)
    for jp, tp in zip(pols, tpols):
        got, want = tpolicy.lane_knobs(tp), jpolicy.lane_knobs(jp)
        np.testing.assert_array_equal(np.float32(got[0]), np.float32(want[0]))
        assert got[1] == want[1]


@pytest.mark.parametrize("seed", range(4))
def test_lane_policies_equal_jax(seed):
    """A random sequence of stamps, admits and retires: every take_dirty
    and every resolve under a random default equal JAX's."""
    rng = np.random.default_rng(seed)
    n = 12
    port, ref = tpolicy.LanePolicies(n), jpolicy.LanePolicies(n)
    for _ in range(40):
        op = rng.integers(0, 6)
        if op == 0:
            lane, thr, bud = int(rng.integers(n)), float(rng.random()), 3
            port.stamp(lane, thr, bud)
            ref.stamp(lane, thr, bud)
        elif op == 1:
            lanes = rng.choice(n, size=int(rng.integers(1, n)), replace=False)
            thr = rng.random(lanes.size).astype(np.float32)
            bud = rng.integers(-1, 9, lanes.size).astype(np.int32)
            port.stamp_many(lanes, thr, bud)
            ref.stamp_many(lanes, thr, bud)
        elif op == 2:
            lane = int(rng.integers(n))
            bud = None if rng.random() < 0.5 else 4
            port.admit(lane, tpolicy.FogPolicy(threshold=0.4, hop_budget=bud))
            ref.admit(lane, jpolicy.FogPolicy(threshold=0.4, hop_budget=bud))
        elif op == 3:
            lane = int(rng.integers(n))
            port.admit(lane)
            ref.admit(lane)
        elif op == 4:
            lanes = rng.choice(n, size=3, replace=False)
            port.retire_many(lanes)
            ref.retire_many(lanes)
        else:
            assert port.dirty == ref.dirty
            for got, want in zip(port.take_dirty(), ref.take_dirty()):
                np.testing.assert_array_equal(got, want)
                assert got.dtype == want.dtype
        bud = None if rng.random() < 0.5 else int(rng.integers(1, 9))
        thr = float(rng.random())
        for got, want in zip(
                port.resolve(tpolicy.FogPolicy(threshold=thr, hop_budget=bud)),
                ref.resolve(jpolicy.FogPolicy(threshold=thr, hop_budget=bud))):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


@pytest.mark.parametrize("seed", range(4))
def test_assemble_equal_jax(seed):
    rng = np.random.default_rng(seed)
    jp = random_policies(rng, JAX, 10)
    jdef = JAX.Policy(threshold=0.55, hop_budget=None if seed % 2 else 6)
    rng = np.random.default_rng(seed)
    tp = random_policies(rng, PORT, 10)
    tdef = PORT.Policy(threshold=0.55, hop_budget=None if seed % 2 else 6)
    got, want = tpolicy.assemble(tp, tdef), jpolicy.assemble(jp, jdef)
    np.testing.assert_array_equal(got.threshold, np.asarray(want.threshold))
    assert got.threshold.dtype == np.float32
    if want.hop_budget is None:
        assert got.hop_budget is None
    else:
        np.testing.assert_array_equal(got.hop_budget,
                                      np.asarray(want.hop_budget))
        assert got.hop_budget.dtype == np.int32
    assert got.per_lane


def test_static_overrides_name_the_static_knobs():
    p = tpolicy.FogPolicy(threshold=0.2, precision="int8", max_hops=3)
    assert p.static_overrides == ("max_hops", "precision")
    assert tpolicy.FogPolicy().static_overrides == ()


# --------------------------------------------------------------------------
# splices
# --------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 3, 8, 16])
def test_splice_lanes_equal_jax_and_donation(width):
    rng = np.random.default_rng(width)
    base = rng.normal(size=(16, 5)).astype(np.float32)
    idx = np.sort(rng.choice(16, size=width, replace=False))
    vals = rng.normal(size=(width, 5)).astype(np.float32)
    want = np.asarray(j_splice_lanes(jnp.asarray(base), idx, vals,
                                     donate=False))
    src = torch.from_numpy(base.copy())
    copied = splice_lanes(src, idx, vals, donate=False)
    np.testing.assert_array_equal(copied.numpy(), want)
    np.testing.assert_array_equal(src.numpy(), base)   # source untouched
    assert copied.data_ptr() != src.data_ptr()
    donated = splice_lanes(src, torch.as_tensor(idx), torch.as_tensor(vals))
    assert donated is src                               # in place
    np.testing.assert_array_equal(src.numpy(), want)
    assert splice_lanes(src, [], vals[:0]) is src
    with pytest.raises(ValueError, match="splice of"):
        splice_lanes(torch.zeros(2, 5), np.arange(3), vals[:3])


@pytest.mark.parametrize("width", [1, 3, 8, 16])
@pytest.mark.parametrize("donate", [True, False])
def test_splice_slot_state_equal_jax(width, donate):
    rng = np.random.default_rng(100 + width)
    n, f = 16, 5
    x = rng.normal(size=(n, f)).astype(np.float32)
    thr = rng.random(n).astype(np.float32)
    bud = rng.integers(0, 9, n).astype(np.int32)
    idx = np.sort(rng.choice(n, size=width, replace=False)).astype(np.int32)
    rows = rng.normal(size=(width, f)).astype(np.float32)
    t = rng.random(width).astype(np.float32)
    b = rng.integers(0, 9, width).astype(np.int32)
    want = j_splice_slot_state(jnp.asarray(x), jnp.asarray(thr),
                               jnp.asarray(bud), idx, rows, t, b,
                               donate=False)
    srcs = tuple(torch.from_numpy(a.copy()) for a in (x, thr, bud))
    got = splice_slot_state(*srcs, idx, rows, t, b, donate=donate)
    for g, w, s, a in zip(got, want, srcs, (x, thr, bud)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.dtype == s.dtype
        if donate:
            assert g is s
        else:
            np.testing.assert_array_equal(s.numpy(), a)


# --------------------------------------------------------------------------
# the serving plane end to end
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plane_field(trained, tmp_path_factory):
    """The 8 x 2 field as a JAX pack and as the port's pack read from the
    JAX artifact, the feature rows, and the run's budgets."""
    ds, rf = trained
    jpack = JPack.from_groves(jcore.split(rf, 2))
    path = jpack.save(tmp_path_factory.mktemp("field") / "field.npz")
    tpack = ForestPack.load(path)
    model = jcore.EnergyModel.from_pack(jpack, ds.x_test.shape[1])
    two_hops = float(np.asarray(model.lane_pj(np.asarray([2]))[0])) * 1e-3
    return {"jpack": jpack, "tpack": tpack, "x": ds.x_test[:200],
            "F": ds.x_test.shape[1], "two_hops_nj": two_hops}


def run_plane(pkg, field, root, *, replicas, pipeline, telemetry_every=1):
    """One full registry-mode run at a fixed schedule: 6 waves of 16
    requests with 2 steps between them (the queue holds 12, so waves
    shed), a hot-swap of alpha before wave 3, then drain.  Returns every observable the modes must agree on."""
    pack = field["jpack"] if pkg is JAX else field["tpack"]
    F, x = field["F"], field["x"]
    reg = pkg.Registry(root)
    for t in ("alpha", "beta"):
        reg.publish(t, pack, extra={"n_features_in": F})
    int8_bytes = pack.astype("int8").table_bytes
    # room for both tenants' fp32 and int8 buckets, not for the swap's
    # extra version: the swap must evict
    cache = pkg.Cache(reg, budget_bytes=2 * pack.table_bytes + 2 * int8_bytes)
    if pkg is JAX:
        server = pkg.Server(None, F, backend="fused", registry=reg,
                            cache=cache, seed=SEED)
        devices = [jax.devices()[0]] * replicas
    else:
        server = pkg.Server(None, F, backend="fused", registry=reg,
                            cache=cache, seed=SEED, draw_starts=jax_draws)
        devices = [CPU] * replicas
    disp = pkg.Dispatcher(server.packed_factory, devices)
    base = pkg.Policy(threshold=0.7)
    ledger = pkg.Ledger()
    for t, budget in (("alpha", 50 * field["two_hops_nj"]),
                      ("beta", 0.8 * field["two_hops_nj"])):
        m = server.energy_model(tenant=t)
        ledger.add(t, pkg.Governor(pkg.ladder(base, m, budget), budget,
                                   model=m, window=16, patience=2,
                                   cooldown=10_000, warmup=4))
    b = pkg.Batcher(N_SLOTS, None, server.prefill, eos_id=-1,
                    default_policy=base, governor=ledger, dispatcher=disp,
                    registry=reg, max_queue=12, pipeline=pipeline,
                    telemetry_every=telemetry_every)
    rid = 0
    for wave in range(6):
        if wave == 3:
            reg.publish("alpha", pack, extra={"n_features_in": F})
        for _ in range(16):
            tenant = "beta" if rid % 3 == 0 else "alpha"
            kw = {"tier": "std"}
            if rid % 4 == 0:
                kw = {"tier": "bulk", "policy": pkg.Policy(
                    threshold=0.5, precision="int8")}
            elif rid % 4 == 1:
                kw = {"tier": "gold", "policy": pkg.Policy(threshold=0.9)}
            elif rid % 7 == 3:
                kw = {"tier": "contract",
                      "energy_budget_nj": 1.5 * field["two_hops_nj"]}
            b.submit(pkg.Request(rid=rid, prompt=x[rid % len(x)],
                                 max_new_tokens=1 + rid % 2, model=tenant,
                                 **kw))
            rid += 1
        for _ in range(2):
            b.step()
    while b.active or b.queue:
        b.step()
    b.flush()
    govs = {t: ledger.governor_for(t) for t in ("alpha", "beta")}
    return {
        "served": {r.rid: (r.version, tuple(r.generated), tuple(r.hops))
                   for r in b.completed},
        "shed": sorted(r.rid for r in b.shed_requests),
        "rungs": {t: g.rung for t, g in govs.items()},
        "transitions": {t: [tr[:2] for tr in g.transitions]
                        for t, g in govs.items()},
        "rolling_nj": {t: g.rolling_nj for t, g in govs.items()},
        "transition_nj": {t: [tr[2] for tr in g.transitions]
                          for t, g in govs.items()},
        "events": (b.stats.total_hops, b.stats.n_events, b.stats.n_offered,
                   b.stats.n_shed, b.stats.n_priced),
        "total_pj": b.stats.total_pj,
        "tiers": b.stats.tier_summary(),
        "versions": {(t, v): (reg.stats_for(t, v).n_events,
                              reg.stats_for(t, v).total_hops,
                              reg.stats_for(t, v).total_pj)
                     for t in ("alpha", "beta") for v in reg.versions(t)},
        "cache": (sorted(cache.keys()), cache.stats.hits,
                  cache.stats.misses, cache.stats.evictions,
                  cache.peak_bytes),
    }


def assert_planes_agree(got, want, rtol):
    for k in ("served", "shed", "rungs", "transitions", "events", "cache"):
        assert got[k] == want[k], k
    for t in want["rolling_nj"]:
        np.testing.assert_allclose(got["rolling_nj"][t],
                                   want["rolling_nj"][t], rtol=rtol)
        np.testing.assert_allclose(got["transition_nj"][t],
                                   want["transition_nj"][t], rtol=rtol)
    np.testing.assert_allclose(got["total_pj"], want["total_pj"], rtol=rtol)
    for tier, row in want["tiers"].items():
        g = got["tiers"][tier]
        assert (g["n_done"], g["n_shed"], g["n_events"]) == (
            row["n_done"], row["n_shed"], row["n_events"]), tier
        np.testing.assert_allclose(g["mean_energy_nj"],
                                   row["mean_energy_nj"], rtol=rtol)
    assert got["versions"].keys() == want["versions"].keys()
    for k, (n, h, pj) in want["versions"].items():
        assert got["versions"][k][:2] == (n, h), k
        np.testing.assert_allclose(got["versions"][k][2], pj, rtol=rtol)


@pytest.fixture(scope="module")
def planes(plane_field, tmp_path_factory):
    """Memoized runs keyed by (package, replicas, pipeline, telemetry
    every k harvests)."""
    cache = {}

    def run(pkg, replicas, pipeline, every=1):
        key = (pkg.name, replicas, pipeline, every)
        if key not in cache:
            root = tmp_path_factory.mktemp("-".join(map(str, key)))
            cache[key] = run_plane(pkg, plane_field, root, replicas=replicas,
                                   pipeline=pipeline, telemetry_every=every)
        return cache[key]
    return run


MODES = {"sync": (False, 1), "pipelined": (True, 1),
         "pipelined-deferred": (True, 4)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("replicas", [1, 2])
def test_serving_plane_equals_jax(planes, replicas, mode):
    want = planes(JAX, replicas, *MODES[mode])
    got = planes(PORT, replicas, *MODES[mode])
    assert_planes_agree(got, want, rtol=1e-6)
    # the schedule exercised what it is meant to
    assert got["shed"], "the bounded queue never shed"
    assert got["transitions"]["beta"], "beta's governor never moved"
    assert got["transitions"]["alpha"] == []
    assert {v for v, _, _ in got["served"].values()} == {1, 2}
    assert got["cache"][3] >= 1, "the swap never evicted"
    assert len(got["served"]) + len(got["shed"]) == 96


@pytest.mark.parametrize("replicas", [1, 2])
def test_port_pipelined_is_bit_equal_to_sync(planes, replicas):
    """The port's pipelined mode serves exactly what its synchronous mode
    serves — labels, hops, shed set, governor transitions, pinned
    versions — with energy bit for bit (the port's counterpart of
    tests/test_serve_equivalence.py)."""
    sync = planes(PORT, replicas, False)
    pipe = planes(PORT, replicas, True)
    assert_planes_agree(pipe, sync, rtol=0)


def test_one_replica_equals_two_on_the_port(planes):
    """Replica count changes the draws (one generator per replica), not
    the plumbing: both runs complete every admitted request on its pinned
    version."""
    one, two = planes(PORT, 1, False), planes(PORT, 2, False)
    assert one["shed"] == two["shed"]
    assert {r: v for r, (v, _, _) in one["served"].items()} == {
        r: v for r, (v, _, _) in two["served"].items()}


def checked_plane(plane_field, fault=None):
    """A two-replica pipelined plane on the CPU, every dispatch witnessed
    (``chip_smoke.witness``) and held by ``chip_smoke.check_dispatches``;
    ``fault`` rolls each admitted burst's ``"rows"`` or ``"knobs"`` by one
    lane, so lanes hold another request's row or knobs.  Returns the lanes
    checked."""
    server = PORT.Server(plane_field["tpack"], plane_field["F"],
                         precisions=("fp32", "int8"))

    def factory(index, device, span):
        fn = server.packed_factory(index, device, span)
        admit_many = fn.admit_many

        def rolled(locals_, rows, thr, bud):
            if fault == "rows":
                rows = np.roll(rows, 1, axis=0)
            elif fault == "knobs":
                thr, bud = np.roll(thr, 1), np.roll(bud, 1)
            admit_many(locals_, rows, thr, bud)

        fn.admit_many = rolled
        return fn

    disp = PORT.Dispatcher(factory, [CPU, CPU])
    b = PORT.Batcher(N_SLOTS, None, server.prefill, eos_id=-1,
                     default_policy=PORT.Policy(threshold=0.6),
                     dispatcher=disp, pipeline=True)
    chip_smoke.witness(b, server.default_precision)
    harvested = chip_smoke.checker(b, plane_field["F"])
    x = plane_field["x"]
    for rid in range(40):
        pol = (PORT.Policy(threshold=0.3, hop_budget=2, precision="int8")
               if rid % 3 == 0 else None)
        b.submit(PORT.Request(rid=rid, prompt=x[rid], max_new_tokens=1,
                              policy=pol))
    n = 0
    while b.active or b.queue:
        b.step()
        n += harvested()
    b.flush()
    n += harvested()
    assert len(b.completed) == 40
    return n


def test_packed_dispatch_equals_reference_on_its_inputs(plane_field):
    """Each packed dispatch's labels and hops equal
    ``_eval_core(..., "reference")`` on its requests' own rows and owed
    knobs and the starts it drew, its resolved knobs are the requests', and
    its energy equals the model's price of its hops
    (``chip_smoke.check_dispatches``, the card's check)."""
    assert checked_plane(plane_field) == 40


@pytest.mark.parametrize("fault", ["rows", "knobs"])
def test_dispatch_check_catches_a_lane_served_the_wrong_input(plane_field,
                                                              fault):
    """The check reads what each lane is owed from its request, not from
    the replica's resident state, so a splice that gives a lane another
    request's row or knobs fails it."""
    with pytest.raises(AssertionError, match="differ|owed"):
        checked_plane(plane_field, fault)


def test_legacy_factory_equals_packed(plane_field):
    """The non-packed replica protocol (rows uploaded per dispatch, host
    argmax) serves the same labels and hops as the packed one from the
    same draws."""
    out = []
    for factory in ("factory", "packed_factory"):
        server = PORT.Server(plane_field["tpack"], plane_field["F"],
                             draw_starts=jax_draws)
        disp = PORT.Dispatcher(getattr(server, factory), [CPU, CPU])
        b = PORT.Batcher(N_SLOTS, None, server.prefill, eos_id=-1,
                         default_policy=PORT.Policy(threshold=0.6),
                         dispatcher=disp)
        for rid in range(N_SLOTS):
            b.submit(PORT.Request(rid=rid, prompt=plane_field["x"][rid],
                                  max_new_tokens=1))
        b.run()
        out.append({r.rid: (r.generated[0], r.hops[0]) for r in b.completed})
    assert out[0] == out[1]


def test_dispatcher_contract_on_cpu():
    """Spans, rebinding, per-replica streams (none off the card), the
    one-copy replicate, and the no-card refusal."""
    def factory(index, device, span):
        def decode(tokens, lengths, policy):
            logits = torch.zeros((span, 4))
            logits[:, index] = 1.0
            return logits, torch.full((span,), index + 1)
        return decode

    disp = PORT.Dispatcher(factory, [CPU] * 4)
    with pytest.raises(ValueError, match="divide evenly"):
        disp.bind(10)
    disp.bind(8)
    assert disp.span == 2 and disp.streams == [None] * 4
    with pytest.raises(ValueError, match="cannot rebind"):
        disp.bind(16)
    pend = disp.dispatch(np.zeros(8, np.int32), np.ones(8, np.int32),
                         PORT.Policy(threshold=0.5), [0, 1, 5])
    assert sorted(p.device for p in pend) == [0, 2]
    logits, hops, drained = disp.harvest(8)
    assert np.argmax(logits, -1)[[0, 1, 5]].tolist() == [0, 0, 2]
    assert hops[[0, 1, 5]].tolist() == [1, 1, 3]
    with pytest.raises(ValueError, match="nothing dispatched"):
        disp.harvest(8)
    copies = tdispatch.replicate({"w": torch.arange(3)}, [CPU, CPU])
    assert len(copies) == 2 and torch.equal(copies[1]["w"], torch.arange(3))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, ValueError)):
            PORT.Dispatcher(factory)
        with pytest.raises(RuntimeError, match="CUDA"):
            PORT.Dispatcher(factory, [torch.device("cuda")])


# --------------------------------------------------------------------------
# the LM batcher
# --------------------------------------------------------------------------

LM_ARCH, LM_SLOTS, LM_SEQ = "tinyllama-1.1b", 4, 40
LM_POLICIES = [(0.0, None), (2.0, None), (2.0, 2), (0.0, None), (2.0, None),
               (2.0, 3)]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def run_lm(pkg, cfg, params, prompts):
    """The serve CLI's single-device LM path in either package, with
    per-request thresholds and budgets."""
    if pkg is JAX:
        state = {"caches": JT.cache_init(cfg, LM_SLOTS, LM_SEQ, jnp.float32)}

        def prefill_fn(slot, prompt):
            _, c = JT.prefill(params, cfg, tokens=jnp.asarray(prompt)[None],
                              max_seq=LM_SEQ)
            state["caches"] = jax.tree.map(
                lambda b, r: j_splice_row(b, r, slot, LM_SLOTS),
                state["caches"], c)
            return len(prompt)

        def decode_fn(tokens, lengths, policy):
            length = jnp.int32(int(np.asarray(lengths).max()))
            logits, state["caches"], hops = jfog.decode_step_fog(
                params, cfg, tokens, state["caches"], length, policy)
            return logits, hops
    else:
        state = {"caches": T.cache_init(cfg, LM_SLOTS, LM_SEQ, torch.float32,
                                        device=CPU)}

        def prefill_fn(slot, prompt):
            _, c = T.prefill(params, cfg, tokens=torch.as_tensor(prompt)[None],
                             max_seq=LM_SEQ)
            state["caches"] = _splice_tree(state["caches"], c, slot,
                                           LM_SLOTS)
            return len(prompt)

        def decode_fn(tokens, lengths, policy):
            logits, state["caches"], hops = tfog.decode_step_fog(
                params, cfg, tokens, state["caches"],
                int(np.asarray(lengths).max()), policy)
            return logits, hops

    b = pkg.Batcher(LM_SLOTS, decode_fn, prefill_fn, eos_id=-1,
                    default_policy=pkg.Policy(threshold=0.3))
    for rid, (thr, bud) in enumerate(LM_POLICIES):
        b.submit(pkg.Request(rid=rid, prompt=prompts[rid],
                             max_new_tokens=3 + rid % 3,
                             policy=pkg.Policy(threshold=thr,
                                               hop_budget=bud)))
    done = b.run()
    return {r.rid: ([int(t) for t in r.generated], [int(h) for h in r.hops])
            for r in done}


def test_lm_batcher_equals_jax():
    jcfg = jconfigs.smoke_config(LM_ARCH).scaled(fog_groups=4)
    tcfg = tconfigs.smoke_config(LM_ARCH).scaled(fog_groups=4)
    jparams = JT.init_params(jcfg, jax.random.key(0), jnp.float32)
    tparams = params_from_jax(np_tree(jparams), tcfg, device=CPU)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, 16).astype(np.int32)
               for _ in LM_POLICIES]
    want = run_lm(JAX, jcfg, jparams, prompts)
    got = run_lm(PORT, tcfg, tparams, prompts)
    assert got == want
    hops = [h for _, hs in got.values() for h in hs]
    assert {1, 2, 3, 4} <= set(hops)        # every gate outcome served


@pytest.mark.parametrize("shape", [(4, 6, 3), (2, 9, 2, 5), (3, 1, 7)],
                         ids=str)
def test_splice_row_equals_jax(shape):
    rng = np.random.default_rng(len(shape))
    n_slots = shape[0]
    batch = rng.normal(size=shape).astype(np.float32)
    row_shape = (1,) + tuple(max(1, s - 1) if i == 1 else s
                             for i, s in enumerate(shape[1:], start=1))
    row = rng.normal(size=row_shape).astype(np.float32)
    for slot in range(n_slots):
        want = np.asarray(j_splice_row(jnp.asarray(batch), jnp.asarray(row),
                                       slot, n_slots))
        got = _splice_tree([torch.from_numpy(batch.copy())],
                           [torch.from_numpy(row)], slot, n_slots)[0]
        np.testing.assert_array_equal(got.numpy(), want)
