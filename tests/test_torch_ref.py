"""repro_torch's plain kernel versions against their JAX twins, on random
tables and inputs made with numpy, plus the CPU dispatch of kernels.ops."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.confidence as jconf  # noqa: E402
import repro.kernels.ref as jref  # noqa: E402
import repro_torch.core.confidence as tconf  # noqa: E402
import repro_torch.kernels.ref as tref  # noqa: E402
from repro.core.engine import _eval_core  # noqa: E402
from repro.forest.pack import ForestPack as JPack  # noqa: E402
from repro_torch.forest.pack import ForestPack as TPack  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.fused_fog import fused_fog_ref  # noqa: E402

PRECISIONS = ["fp32", "bf16", "int8"]
# float32 sums of more than two trees may be taken in another order by
# XLA: the engine bar's tolerance (tests/test_engine_conformance.py)
TOL = {"rtol": 1e-6, "atol": 1e-7}


def random_tables(rng, O=1, G=3, t=3, depth=4, C=5, F=6):
    """Packed-ready fp32 tables with +inf padding nodes and -inf nodes."""
    N, L = 2**depth - 1, 2**depth
    feature = rng.integers(0, F, (O, G, t, N)).astype(np.int32)
    thr = rng.normal(size=(O, G, t, N)).astype(np.float32)
    thr[rng.random(thr.shape) < 0.15] = np.inf
    thr[rng.random(thr.shape) < 0.05] = -np.inf
    leaf = rng.random((O, G, t, L, C)).astype(np.float32)
    leaf /= leaf.sum(-1, keepdims=True)
    return feature, thr, leaf


def packs(rng, precision, **kw):
    """(JAX pack, port pack) over the same packed arrays."""
    feature, thr, leaf = random_tables(rng, **kw)
    jp = JPack._pack(jnp.asarray(feature), jnp.asarray(thr),
                     jnp.asarray(leaf), precision)
    tp = TPack.from_numpy(*(np.asarray(getattr(jp, f)) for f in (
        "feature", "threshold", "leaf", "thr_scale", "leaf_scale")),
        precision)
    return jp, tp


@pytest.mark.parametrize("precision", PRECISIONS)
def test_dequantize_tables(precision):
    rng = np.random.default_rng(1)
    jp, tp = packs(rng, precision)
    if precision == "int8":   # the ±inf sentinels are in play
        assert (np.asarray(jp.threshold) == 127).any()
        assert (np.asarray(jp.threshold) == -127).any()
    want = jref.dequantize_tables(jp.threshold, jp.leaf, jp.thr_scale,
                                  jp.leaf_scale)
    got = tref.dequantize_tables(tp.threshold, tp.leaf, tp.thr_scale,
                                 tp.leaf_scale)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if precision == "int8":
        with pytest.raises(ValueError, match="scale"):
            tref.dequantize_tables(tp.threshold, tp.leaf)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_tree_traverse_ref(precision):
    rng = np.random.default_rng(2)
    jp, tp = packs(rng, precision, t=4, depth=5, C=7, F=9)
    x = rng.normal(size=(61, 9)).astype(np.float32)
    for g in range(jp.n_groves):
        want = jref.tree_traverse_ref(
            jp.feature[0, g], jp.threshold[0, g], jp.leaf[0, g],
            jnp.asarray(x), jp.thr_scale[0, g], jp.leaf_scale[0, g])
        got = tref.tree_traverse_ref(
            tp.feature[0, g], tp.threshold[0, g], tp.leaf[0, g],
            torch.as_tensor(x), tp.thr_scale[0, g], tp.leaf_scale[0, g])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def tie_rows(rng, B=40, C=6):
    """Rows with exact ties at the max, ties below it, and one-hot rows."""
    p = rng.random((B, C)).astype(np.float32)
    p[:10, 2] = p[:10, 4] = p[:10].max(1) + 0.5           # tie at the max
    p[10:15] = 0.25                                       # all equal
    p[15:20] = np.eye(C, dtype=np.float32)[rng.integers(0, C, 5)]
    p[20:25, 0] = p[20:25, 5] = 0.1                       # tie below the max
    return p


def test_top2_confidence_ref_ties():
    p = tie_rows(np.random.default_rng(3))
    got = tref.top2_confidence_ref(torch.as_tensor(p)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.top2_confidence_ref(
        jnp.asarray(p))))
    assert (got[:15] == 0).all()
    assert (got[15:20] == 1).all()
    np.testing.assert_array_equal(
        ops.top2_confidence(torch.as_tensor(p)).numpy(), got)


def test_confidence_module_matches():
    rng = np.random.default_rng(4)
    p = rng.random((7, 3, 5)).astype(np.float32)
    p[0, :, 1] = p[0, :, 3] = 2.0
    for name in ("maxdiff", "maxdiff_multioutput"):
        np.testing.assert_array_equal(
            getattr(tconf, name)(torch.as_tensor(p)).numpy(),
            np.asarray(getattr(jconf, name)(jnp.asarray(p))))
    m1, m2 = tconf.top2(torch.as_tensor(p), dim=1)
    j1, j2 = jconf.top2(jnp.asarray(p), axis=1)
    np.testing.assert_array_equal(m1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(m2.numpy(), np.asarray(j2))


@pytest.mark.parametrize("scalar_thresh", [True, False])
def test_grove_aggregate_ref(scalar_thresh):
    rng = np.random.default_rng(5)
    B, C = 53, 10
    prob = (rng.random((B, C)) * 3).astype(np.float32)
    prob[:25] = tie_rows(rng, 25, C)
    contrib = rng.random((B, C)).astype(np.float32)
    live = rng.random(B) < 0.7
    hops = rng.integers(0, 5, B).astype(np.int32)
    thresh = (np.float32(0.2) if scalar_thresh
              else rng.random(B).astype(np.float32))
    want = jref.grove_aggregate_ref(*map(jnp.asarray, (prob, contrib, live,
                                                      hops, thresh)))
    args = [torch.as_tensor(a) for a in (prob, contrib, live, hops)]
    t = thresh if scalar_thresh else torch.as_tensor(thresh)
    for got in (tref.grove_aggregate_ref(*args, t),
                ops.grove_aggregate(*args, t)):
        assert [g.dtype for g in got] == [torch.float32, torch.int32,
                                         torch.bool, torch.float32]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_grove_aggregate_rejects_integer_contrib():
    z = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="dequantize"):
        ops.grove_aggregate(z, z.to(torch.int8), torch.ones(4, dtype=bool),
                            torch.zeros(4, dtype=torch.int32), 0.3)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("heads", [1, 2])
def test_fused_fog_ref_matches_reference_backend(precision, heads):
    """The plain fused loop against the JAX reference backend over the
    same packed tables, with per-lane thresholds and hop budgets."""
    rng = np.random.default_rng(6 + heads)
    G = 5
    jp, tp = packs(rng, precision, O=heads, G=G, t=2, depth=4, C=4, F=6)
    B = 67
    x = rng.normal(size=(B, 6)).astype(np.float32)
    start = rng.integers(0, G, B).astype(np.int32)
    thresh = rng.random(B).astype(np.float32) * 0.6
    budget = rng.integers(1, G + 1, B).astype(np.int32)
    want = _eval_core(jp, jnp.asarray(x), jnp.asarray(start),
                      jnp.asarray(thresh), jnp.asarray(budget), G,
                      "reference", 64, False)
    proba, hops = fused_fog_ref(
        tp.feature, tp.threshold, tp.leaf, torch.as_tensor(x),
        torch.as_tensor(start), torch.as_tensor(thresh),
        torch.as_tensor(budget), tp.thr_scale, tp.leaf_scale, max_hops=G)
    assert proba.shape == (B, heads, 4) and hops.dtype == torch.int32
    np.testing.assert_array_equal(hops.numpy(), np.asarray(want.hops))
    got = proba[:, 0] if heads == 1 else proba
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want.label))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.proba), **TOL)
    assert (hops.numpy() <= budget).all()
    # the ops wrapper takes the plain version for CPU tensors
    p2, h2 = ops.fused_fog(tp.feature, tp.threshold, tp.leaf,
                           torch.as_tensor(x), torch.as_tensor(start),
                           torch.as_tensor(thresh), torch.as_tensor(budget),
                           tp.thr_scale, tp.leaf_scale, max_hops=G)
    assert torch.equal(p2, proba) and torch.equal(h2, hops)


def test_ops_cpu_path_launches_no_kernel():
    before = dict(ops.launches)
    ops.top2_confidence(torch.rand(5, 3))
    ops.tree_traverse(torch.zeros((2, 3), dtype=torch.int32),
                      torch.zeros((2, 3)), torch.rand(2, 4, 5),
                      torch.rand(7, 2))
    ops.ssd_chunk(torch.rand(1, 2, 8, 3, 4), -torch.rand(1, 2, 3, 8),
                  torch.rand(1, 2, 8, 5), torch.rand(1, 2, 8, 5))
    ops.flash_attention(torch.rand(1, 6, 4, 8), torch.rand(1, 6, 2, 8),
                        torch.rand(1, 6, 2, 8))
    assert ops.launches == before
    assert set(ops.launches) == {"fused_fog", "grove_aggregate",
                                 "top2_confidence", "histogram",
                                 "tree_traverse", "ssd_chunk",
                                 "flash_attention"}
