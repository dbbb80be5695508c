"""repro_torch's tree_traverse (on the CPU: its plain version) against the
JAX package's reference and its Pallas kernel in interpret mode, on packs
made with numpy from a seed, plus the shared-memory sizing of the CUDA
kernel.

Tolerances: the port sums the trees in order and divides by t, as the
eager JAX reference does, so the two are equal.  The jitted Pallas path
may sum more than two trees in another order, and XLA:CPU contracts the
int8 leaf dequantize into an FMA there (ROADMAP §C): it is equal for two
fp32/bf16 trees, and otherwise within rtol 1e-6 / atol 1e-7 (the engine
bar of tests/test_engine_conformance.py).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.kernels.ops as jops  # noqa: E402
import repro.kernels.ref as jref  # noqa: E402
from repro.forest.pack import ForestPack as JPack  # noqa: E402
from repro_torch.forest.pack import ForestPack as TPack  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.tree_traverse import (check_smem,  # noqa: E402
                                               smem_bytes)

PRECISIONS = ["fp32", "bf16", "int8"]
# (t, d, C, F, B): the bench grove at the test set's size, and two
# unaligned batches with more trees
SHAPES = [(2, 8, 10, 16, 1000), (4, 5, 7, 16, 83), (8, 6, 3, 12, 37)]
TOL = {"rtol": 1e-6, "atol": 1e-7}
FIELDS = ("feature", "threshold", "leaf", "thr_scale", "leaf_scale")
# cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100
H100_SMEM_OPTIN = 232_448


def grove_packs(rng, precision, t, d, C, F, G=1):
    """(JAX pack, port pack) of G groves of t trees, from the same packed
    arrays, with +inf and -inf padding nodes in play."""
    N = 2**d - 1
    feat = rng.integers(0, F, (1, G, t, N)).astype(np.int32)
    thr = rng.normal(size=(1, G, t, N)).astype(np.float32)
    thr[rng.random(thr.shape) < 0.15] = np.inf
    thr[rng.random(thr.shape) < 0.05] = -np.inf
    leaf = rng.dirichlet(np.ones(C), size=(1, G, t, 2**d)).astype(np.float32)
    jp = JPack._pack(jnp.asarray(feat), jnp.asarray(thr), jnp.asarray(leaf),
                     precision)
    tp = TPack.from_numpy(*(np.asarray(getattr(jp, f)) for f in FIELDS),
                          precision)
    return jp, tp


def grove(pack, g=0):
    return tuple(getattr(pack, f)[0, g] for f in FIELDS)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("precision", PRECISIONS)
def test_port_matches_jax_reference_and_pallas(precision, shape):
    t, d, C, F, B = shape
    rng = np.random.default_rng(sum(shape))
    jp, tp = grove_packs(rng, precision, t, d, C, F)
    x = rng.normal(size=(B, F)).astype(np.float32)
    feat, thr, leaf, ts, ls = grove(tp)
    got = ops.tree_traverse(feat, thr, leaf, torch.as_tensor(x), ts, ls,
                            block_b=128)
    assert got.dtype == torch.float32 and got.shape == (B, C)
    jfeat, jthr, jleaf, jts, jls = grove(jp)
    eager = jref.tree_traverse_ref(jfeat, jthr, jleaf, jnp.asarray(x), jts,
                                   jls)
    np.testing.assert_array_equal(got.numpy(), np.asarray(eager))
    pallas = jops.tree_traverse(jfeat, jthr, jleaf, jnp.asarray(x), jts, jls,
                                block_b=128)
    if t == 2 and precision != "int8":
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_stacked_shards_walk_their_own_grove(precision):
    """S stacked shards [S, b, F] in one call equal each shard's own call
    and the JAX reference on that shard's grove."""
    S, t, d, C, F, b = 8, 2, 6, 5, 9, 37
    rng = np.random.default_rng(5)
    jp, tp = grove_packs(rng, precision, t, d, C, F, G=S)
    x = rng.normal(size=(S, b, F)).astype(np.float32)
    got = ops.tree_traverse(*(getattr(tp, f)[0] for f in FIELDS[:3]),
                            torch.as_tensor(x),
                            *(getattr(tp, f)[0] for f in FIELDS[3:]))
    assert got.shape == (S, b, C)
    for s in range(S):
        feat, thr, leaf, ts, ls = grove(tp, s)
        one = ops.tree_traverse(feat, thr, leaf, torch.as_tensor(x[s]), ts,
                                ls)
        assert torch.equal(got[s], one)
        want = jref.tree_traverse_ref(*grove(jp, s)[:3], jnp.asarray(x[s]),
                                      *grove(jp, s)[3:])
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))


def test_omitted_scales_are_ones():
    rng = np.random.default_rng(3)
    _, tp = grove_packs(rng, "fp32", 4, 5, 7, 16)
    x = torch.as_tensor(rng.normal(size=(50, 16)).astype(np.float32))
    feat, thr, leaf, ts, ls = grove(tp)
    assert torch.equal(ops.tree_traverse(feat, thr, leaf, x),
                       ops.tree_traverse(feat, thr, leaf, x, ts, ls))


def test_smem_bytes_of_the_bench_grove():
    """One grove of the bench field (2 trees of depth 8 over 10 classes),
    the BENCH_engine.json table_bytes over its 8 groves."""
    assert [smem_bytes(2, 8, 10, s) for s in (4, 2, 1)] == [24_576, 13_316,
                                                            7_686]
    jp, _ = grove_packs(np.random.default_rng(0), "bf16", 2, 8, 10, 16, G=8)
    assert smem_bytes(2, 8, 10, 2) * 8 == jp.table_bytes
    check_smem(smem_bytes(2, 8, 10, 4), H100_SMEM_OPTIN, "bench grove")


def test_smem_rejects_the_oversized_forest():
    """tests/test_kernels.py's over-budget forest (t=32, d=12, C=30): its
    leaves alone are 15.7 MB, far over one block's shared memory."""
    need = smem_bytes(32, 12, 30, 4)
    assert need > 32 * 2**12 * 30 * 4
    with pytest.raises(ValueError, match=r"(?s)shared memory.*232448 B.*"
                                         r"int8.*smaller groves"):
        check_smem(need, H100_SMEM_OPTIN, "t=32, d=12, C=30")
    # int8 does not save this one either: still over
    with pytest.raises(ValueError, match=str(smem_bytes(32, 12, 30, 1))):
        check_smem(smem_bytes(32, 12, 30, 1), H100_SMEM_OPTIN, "int8")
