"""The fused half of repro_torch's autotuner (``kernels/autotune.py``),
after the JAX package's ``tests/test_autotune.py``: the analytic seed is
the launch rule itself, an untuned lookup returns it, the cache file holds
fused and histogram entries together, and the engine, the serving plane
and chunked evaluation consult it.  ``tune`` runs on the card only
(``tests/test_torch_cuda.py`` holds its picks to the plain version).

The card's numbers here are an H100's (132 SMs, 232,448 B of shared memory
a block), patched into ``_build`` where a lookup asks the device.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.forest.pack import ForestPack as JPack  # noqa: E402
from repro_torch.core import FogEngine, FogPolicy  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.forest.pack import ForestPack as TPack  # noqa: E402
from repro_torch.kernels import _build, autotune  # noqa: E402
from repro_torch.kernels import fused_fog as ff  # noqa: E402
from repro_torch.serve import dispatch  # noqa: E402

H100_SMS, H100_SMEM_OPTIN = 132, 232_448
FIELDS = ("feature", "threshold", "leaf", "thr_scale", "leaf_scale")
# the bench field (8 x 2, depth 8, 10 classes, 16 features) and the
# widest Table 1 field (isolet: depth 12, 26 classes, 617 features)
SHAPES = {"bench": (8, 2, 8, 10, 16), "isolet": (8, 2, 12, 26, 617)}
BATCHES = (1, 97, 128, 1000, 2000, 16_384, 65_536)


def make_pack(precision="fp32", O=1, G=8, t=2, d=8, C=10, F=16, seed=0):
    rng = np.random.default_rng(seed)
    N = 2**d - 1
    feat = rng.integers(0, F, (O, G, t, N)).astype(np.int32)
    thr = rng.normal(size=(O, G, t, N)).astype(np.float32)
    leaf = rng.dirichlet(np.ones(C) * 0.5, size=(O, G, t, 2**d)).astype(
        np.float32)
    jp = JPack._pack(jnp.asarray(feat), jnp.asarray(thr), jnp.asarray(leaf),
                     precision)
    return TPack.from_numpy(*(np.asarray(getattr(jp, f)) for f in FIELDS),
                            precision)


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch):
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    autotune.clear_cache()
    yield
    autotune.clear_cache()


@pytest.fixture
def h100(monkeypatch):
    """``_build``'s device queries answer as an H100 does."""
    monkeypatch.setattr(_build, "sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(_build, "smem_optin", lambda dev: H100_SMEM_OPTIN)


def rule_args(pack, F, B, max_hops):
    return (B, pack.n_heads, pack.n_groves, pack.grove_size, pack.depth,
            pack.n_classes, F, pack.threshold.element_size(), max_hops)


# ------------------------------------------------------------ the seed

@pytest.mark.parametrize("max_hops", [1, 3, 8])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_seed_is_the_launch_rule(precision, shape, heads, B, max_hops):
    """route(...), walk_hops(...), FUSED_BLOCK_B and no chunk; and the
    launch the seed names is the one the rule plans (the same kernel on
    the same grid as a launch that names nothing)."""
    G, t, d, C, F = SHAPES[shape]
    pack = make_pack(precision, heads, G, t, d, C, F)
    seed = autotune.seed_config(pack, F, B, max_hops, n_sm=H100_SMS,
                                smem_optin=H100_SMEM_OPTIN)
    a = rule_args(pack, F, B, max_hops)
    want_route = ff.route(*a, ff.FUSED_BLOCK_B, H100_SMS, H100_SMEM_OPTIN)
    assert seed.route == want_route
    assert seed.block_b == ff.FUSED_BLOCK_B == tengine.FUSED_BLOCK_B == 128
    assert seed.chunk_b is None and seed.measured_s is None
    assert seed.source == "analytic"
    if want_route == "lane":
        assert seed.hops_per_walk is None
    else:
        assert seed.hops_per_walk == ff.walk_hops(
            B, max_hops, heads, t, C, H100_SMS)
    named = ff._launch_plan(seed.route, *a, seed.block_b, H100_SMS,
                            H100_SMEM_OPTIN, seed.hops_per_walk)
    rule = ff._launch_plan(None, *a, ff.FUSED_BLOCK_B, H100_SMS,
                           H100_SMEM_OPTIN, None)
    assert named == rule


def test_seed_without_a_card_leaves_the_route_to_the_launch():
    pack = make_pack()
    seed = autotune.seed_config(pack, 16, 1000, 8, n_sm=None,
                                smem_optin=None)
    assert (seed.route, seed.hops_per_walk, seed.block_b, seed.chunk_b) == (
        None, None, ff.FUSED_BLOCK_B, None)


def test_untuned_launch_is_the_rules_launch(h100, monkeypatch):
    """``fused_fog_on_route`` with the seed's route and K makes the same
    call into the library as with neither (the call the engine made
    before the tuner): same entry, K, group, grid, threads, shared
    memory."""
    calls = []
    monkeypatch.setattr(_build, "check_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "launch",
                        lambda name, dev, *a, entry=None: calls.append(
                            (name, entry, a[12:])))
    for precision in ("fp32", "int8"):
        pack = make_pack(precision)
        lay = pack.layout("fused")
        for B in (128, 1000, 65_536):
            x = torch.zeros((B, 16))
            args = (*lay[:3], x, torch.zeros(B, dtype=torch.int32),
                    torch.zeros(B), torch.ones(B, dtype=torch.int32),
                    *lay[3:])
            seed = autotune.best_config(pack, 16, B, 8, "cuda")
            calls.clear()
            ff.fused_fog_on_route(*args, max_hops=8, block_b=128)
            ff.fused_fog_on_route(*args, max_hops=8, block_b=seed.block_b,
                                  route=seed.route,
                                  hops_per_walk=seed.hops_per_walk)
            assert len(calls) == 2 and calls[0] == calls[1], (precision, B)


# ------------------------------------------------------------ lookups

def test_key_has_the_batch_bucket():
    pack = make_pack("bf16")
    assert [autotune.batch_bucket(b) for b in (1, 2, 3, 1000, 1024, 1025,
                                               65_536)] == [
        1, 2, 4, 1024, 1024, 2048, 65_536]
    assert autotune.pack_key(pack, 16, 1000) == (
        "bf16", 1, 8, 2, 8, 10, 16, 1024)


def test_best_config_untuned_returns_the_seed(h100):
    pack = make_pack()
    for B in BATCHES:
        got = autotune.best_config(pack, 16, B, 8, "cuda")
        assert got == autotune.seed_config(pack, 16, B, 8, n_sm=H100_SMS,
                                           smem_optin=H100_SMEM_OPTIN)
        assert got.source == "analytic"
    cpu = autotune.best_config(pack, 16, 1000, 8, "cpu")
    assert cpu.route is None and cpu.source == "analytic"


def test_measured_entry_wins_on_the_card_only(h100):
    pack = make_pack()
    key = autotune.pack_key(pack, 16, 1000)
    autotune._CACHE[key] = autotune.TuneResult(
        route="l1", hops_per_walk=4, block_b=256, measured_s=1e-5,
        source="measured")
    for B in (513, 1000, 1024):          # one bucket
        assert autotune.best_config(pack, 16, B, 8, "cuda") == \
            autotune._CACHE[key]
    assert autotune.best_config(pack, 16, 1025, 8, "cuda").source == \
        "analytic"
    assert autotune.best_config(pack, 16, 1000, 8, "cpu").route is None
    # K never above the call's max_hops
    assert autotune.best_config(pack, 16, 1000, 2, "cuda").hops_per_walk == 2


def test_measured_smem_entry_falls_back_where_its_block_does_not_fit(h100):
    """A bucket spans batches whose blocks differ: "smem" is kept only
    where the block still fits shared memory, else "l1" (same K, same
    threads)."""
    pack = make_pack("fp32", G=8, t=2, d=9, C=10, F=16)   # ~400 KB: never
    key = autotune.pack_key(pack, 16, 1000)
    autotune._CACHE[key] = autotune.TuneResult(
        route="smem", hops_per_walk=8, block_b=128, source="measured")
    got = autotune.best_config(pack, 16, 1000, 8, "cuda")
    assert (got.route, got.hops_per_walk, got.block_b) == ("l1", 8, 128)
    small = make_pack("int8")
    autotune._CACHE[autotune.pack_key(small, 16, 1000)] = \
        autotune.TuneResult(route="smem", hops_per_walk=8, block_b=128,
                            source="measured")
    assert autotune.best_config(small, 16, 1000, 8, "cuda").route == "smem"


# ------------------------------------------------------------ the sweep

@pytest.mark.parametrize("B", [1000, 65_536])
@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_candidates_cover_routes_k_and_threads(precision, B):
    pack = make_pack(precision)
    cands = autotune.candidates(pack, 16, B, 8, n_sm=H100_SMS,
                                smem_optin=H100_SMEM_OPTIN)
    seed = autotune.seed_config(pack, 16, B, 8, n_sm=H100_SMS,
                                smem_optin=H100_SMEM_OPTIN)
    assert cands[0] == seed
    whole = [c for c in cands if c.chunk_b is None]
    assert {c.route for c in whole} == set(ff.ROUTES)
    assert {c.hops_per_walk for c in whole if c.route == "l1"} == {
        8, 4, 2, 1}
    assert {c.block_b for c in whole if c.route == "lane"} == set(
        autotune.BLOCKS)
    # one candidate per distinct launch
    plans = [(c.route, tuple(sorted(ff.plan(
        c.route, B, *rule_args(pack, 16, B, 8)[1:], c.block_b, H100_SMS,
        c.hops_per_walk).items()))) for c in whole]
    assert len(plans) == len(set(plans))
    lanes = autotune.chunk_lanes(pack, 16, 8, H100_SMS)
    chunked = [c for c in cands if c.chunk_b is not None]
    if lanes < B:
        assert [c.chunk_b for c in chunked] == [lanes]
        assert chunked[0].hops_per_walk == 8
        assert ff.walk_hops(lanes, 8, 1, 2, 10, H100_SMS) == 8
        assert ff.walk_hops(lanes + 1, 8, 1, 2, 10, H100_SMS) < 8
    else:
        assert not chunked
    assert autotune.hop_ladder(8) == [8, 4, 2, 1]
    assert autotune.hop_ladder(7) == [7, 4, 2, 1]


def test_tune_needs_the_card():
    pack = make_pack()
    x = torch.zeros((8, 16))
    with pytest.raises(ValueError, match="CUDA device, got cpu"):
        autotune.tune(pack, x, torch.zeros(8, dtype=torch.int32),
                      torch.zeros(8), torch.ones(8, dtype=torch.int32),
                      max_hops=8)


# ------------------------------------------------------------ the file

def test_cache_file_mixed_fused_and_hist_entries(h100, tmp_path,
                                                 monkeypatch):
    """One file holds both entry kinds; each reloads as its own config
    type under its own signature; the JAX package's variable is never
    read."""
    pack = make_pack("int8")
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    monkeypatch.setenv("FOG_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    fused = autotune.TuneResult(route="smem", hops_per_walk=4, block_b=256,
                                chunk_b=None, measured_s=1.5e-5,
                                source="measured")
    chunked = autotune.TuneResult(route="l1", hops_per_walk=8, block_b=128,
                                  chunk_b=8448, measured_s=4e-5,
                                  source="measured")
    hist = autotune.HistConfig(block=256, matmul_max_r=640, measured_s=0.1,
                               source="measured")
    autotune._CACHE[autotune.pack_key(pack, 16, 1000)] = fused
    autotune._CACHE[autotune.pack_key(pack, 16, 65_536)] = chunked
    autotune._CACHE[autotune.hist_key(32, 8, 16, 17, 10)] = hist
    autotune._save_cache_file()
    raw = json.loads(path.read_text())
    assert sorted(raw) == ["hist/32/8/16/17/10", "int8/1/8/2/8/10/16/1024",
                           "int8/1/8/2/8/10/16/65536"]
    autotune.clear_cache()                    # "a fresh process"
    f = autotune.best_config(pack, 16, 1000, 8, "cuda")
    c = autotune.best_config(pack, 16, 65_536, 8, "cuda")
    h = autotune.best_hist_config(32, 8, 16, 17, 10, "cuda")
    assert f == dataclasses_replace(fused, source="cache-file")
    assert c == dataclasses_replace(chunked, source="cache-file")
    assert (h.block, h.matmul_max_r, h.source) == (256, 640, "cache-file")
    assert not (tmp_path / "jax.json").exists()


def dataclasses_replace(obj, **kw):
    import dataclasses
    return dataclasses.replace(obj, **kw)


# ------------------------------------------------------------ consumers

def bench_inputs(B, seed=1):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.normal(size=(B, 16)).astype(np.float32)),
            torch.as_tensor(rng.integers(0, 8, B).astype(np.int32)))


def test_engine_consults_best_config_when_block_b_is_unset(monkeypatch):
    pack = make_pack()
    calls, real = [], autotune.best_config

    def spy(p, f, b, h, dev):
        calls.append((p.precision, f, b, h, torch.device(dev).type))
        return real(p, f, b, h, dev)

    monkeypatch.setattr(autotune, "best_config", spy)
    eng = FogEngine(pack, backend="fused", device="cpu")
    assert eng.block_b is None
    assert eng.resolve().block_b is None
    x, start = bench_inputs(300)
    eng.eval(x, start=start, policy=FogPolicy(threshold=0.3))
    assert calls == [("fp32", 16, 300, 8, "cpu")]
    # an explicit block_b with an int chunk: no lookup
    eng.eval(x, start=start, policy=FogPolicy(threshold=0.3, block_b=64,
                                              chunk_b=100))
    assert len(calls) == 1
    # the per-hop backends keep their default threads, no lookup
    assert eng.resolve(FogPolicy(backend="pallas")).block_b == \
        tengine.DEFAULT_BLOCK_B
    eng.eval(x, start=start, policy=FogPolicy(backend="pallas"))
    assert len(calls) == 1


def test_engine_takes_the_entrys_route_k_and_threads(monkeypatch):
    pack = make_pack("bf16")
    entry = autotune.TuneResult(route="l1", hops_per_walk=2, block_b=256,
                                source="measured")
    monkeypatch.setattr(autotune, "best_config", lambda *a: entry)
    seen, real = [], tengine.ops.fused_fog

    def spy(*a, **kw):
        seen.append({k: kw[k] for k in ("block_b", "route",
                                        "hops_per_walk")})
        return real(*a, **kw)

    monkeypatch.setattr(tengine.ops, "fused_fog", spy)
    x, start = bench_inputs(64)
    FogEngine(pack, backend="fused", device="cpu").eval(
        x, start=start, policy=FogPolicy(threshold=0.3))
    assert seen == [{"block_b": 256, "route": "l1", "hops_per_walk": 2}]
    seen.clear()
    FogEngine(pack, backend="fused", device="cpu", block_b=64).eval(
        x, start=start, policy=FogPolicy(threshold=0.3))
    assert seen == [{"block_b": 64, "route": None, "hops_per_walk": None}]


@pytest.mark.parametrize("chunk_b", [None, "auto"])
@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_cached_chunk_equals_whole_batch(precision, chunk_b, monkeypatch):
    """A measured entry with a chunk splits the batch (the tail chunk
    dead-padded); the outputs equal whole-batch evaluation bit for bit."""
    pack = make_pack(precision)
    x, start = bench_inputs(1000, seed=2)
    thresh = torch.rand(1000, generator=torch.Generator().manual_seed(3))
    policy = FogPolicy(threshold=thresh, chunk_b=chunk_b)
    whole = FogEngine(pack, backend="fused", device="cpu").eval(
        x, start=start, policy=policy)
    entry = autotune.TuneResult(route="l1", hops_per_walk=8, block_b=128,
                                chunk_b=384, source="measured")
    monkeypatch.setattr(autotune, "best_config", lambda *a: entry)
    sizes, core = [], tengine._eval_core

    def spy(pack, x, *a, **kw):
        sizes.append(x.shape[0])
        return core(pack, x, *a, **kw)

    monkeypatch.setattr(tengine, "_eval_core", spy)
    got = FogEngine(pack, backend="fused", device="cpu").eval(
        x, start=start, policy=policy)
    assert sizes == [384, 384, 384]
    for f in ("proba", "label", "hops"):
        assert torch.equal(getattr(got, f), getattr(whole, f)), f
    # an explicit int chunk is honoured as it is
    sizes.clear()
    FogEngine(pack, backend="fused", device="cpu").eval(
        x, start=start, policy=FogPolicy(threshold=0.3, chunk_b=500))
    assert sizes == [500, 500]


def test_serving_plane_consults_the_same_lookup(monkeypatch):
    pack = make_pack()
    calls, real = [], autotune.best_config

    def spy(p, f, b, h, dev):
        calls.append((f, b, h))
        return real(p, f, b, h, dev)

    monkeypatch.setattr(autotune, "best_config", spy)
    x, start = bench_inputs(64)
    thr = torch.full((64,), 0.3)
    bud = torch.full((64,), 8, dtype=torch.int32)
    proba, hops = dispatch._serve_eval(pack, x, None, thr, bud, max_hops=8,
                                       backend="fused", start=start)
    assert calls == [(16, 64, 8)]
    want = tengine._eval_core(pack, x, start, thr, bud, 8, "reference", 256,
                              False)
    assert torch.equal(hops, want.hops)
    assert dispatch._launch(pack, x, 8, "pallas") == (
        tengine.DEFAULT_BLOCK_B, {})
    assert len(calls) == 1
