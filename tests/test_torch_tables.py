"""repro_torch tables against the JAX package: the host CART, Split, the
packed ForestPack at every precision, and the .npz artifact both ways."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.forest as jforest  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.forest as tforest  # noqa: E402
from repro.forest.tree import TensorForest as JForest  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402

PRECISIONS = ["fp32", "bf16", "int8"]
FIELDS = ("feature", "threshold", "leaf", "thr_scale", "leaf_scale")


def np_bits(a):
    """Comparable host array: bf16 as its uint16 bits, else numpy."""
    if isinstance(a, torch.Tensor):
        a = a.cpu()
        return (a.view(torch.int16).numpy().view(np.uint16)
                if a.dtype == torch.bfloat16 else a.numpy())
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def t_forest(rf):
    return tforest.TensorForest.from_numpy(rf.feature, rf.threshold, rf.leaf)


@pytest.fixture(scope="module")
def jgc(trained):
    return jcore.split(trained[1], 2)


@pytest.fixture(scope="module")
def tgc(trained):
    return tcore.split(t_forest(trained[1]), 2)


def test_dataset_copy_is_identical(ds_penbased):
    ds = make_dataset("penbased")
    for f in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(ds, f), getattr(ds_penbased, f))


def test_cart_same_seed_emits_same_trees(trained):
    ds, rf = trained
    mine = tforest.train_random_forest(
        ds.x_train, ds.y_train, ds.n_classes,
        tforest.TrainConfig(n_trees=16, max_depth=6, seed=1))
    assert mine.feature.dtype == torch.int32
    for f in ("feature", "threshold", "leaf"):
        np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                      np.asarray(getattr(rf, f)))


def test_device_trainer_not_ported(trained):
    """The device trainer is ported now (tests/test_torch_grow.py holds it
    against the JAX package); what this check keeps is that it has no
    silent fallback: it runs where it is told, and without a card its
    default device raises."""
    ds, _ = trained
    args = (ds.x_train[:50], ds.y_train[:50], ds.n_classes,
            tforest.TrainConfig(n_trees=1, max_depth=2, trainer="device"))
    forest = tforest.train_random_forest(*args, device="cpu")
    assert forest.feature.device.type == "cpu"
    assert tuple(forest.feature.shape) == (1, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tforest.train_random_forest(*args)


def test_split_matches(jgc, tgc):
    assert (tgc.n_groves, tgc.grove_size, tgc.depth, tgc.n_classes) == (
        jgc.n_groves, jgc.grove_size, jgc.depth, jgc.n_classes)
    for f in ("feature", "threshold", "leaf"):
        np.testing.assert_array_equal(getattr(tgc, f).numpy(),
                                      np.asarray(getattr(jgc, f)))
    np.testing.assert_array_equal(tgc.as_forest().leaf.numpy(),
                                  np.asarray(jgc.as_forest().leaf))


def test_pad_forest_matches():
    rng = np.random.default_rng(0)
    shallow = (rng.integers(0, 5, (1, 3)).astype(np.int32),
               rng.normal(size=(1, 3)).astype(np.float32),
               rng.random((1, 4, 3)).astype(np.float32))
    deep = (rng.integers(0, 5, (1, 15)).astype(np.int32),
            rng.normal(size=(1, 15)).astype(np.float32),
            rng.random((1, 16, 3)).astype(np.float32))
    want = jforest.pad_forest([JForest(*map(jnp.asarray, shallow)),
                               JForest(*map(jnp.asarray, deep))])
    got = tforest.pad_forest([tforest.TensorForest.from_numpy(*shallow),
                              tforest.TensorForest.from_numpy(*deep)])
    for f in ("feature", "threshold", "leaf"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


def test_traversal_matches(trained, jgc, tgc):
    ds, rf = trained
    x = ds.x_test[:97]
    # 16 trees: XLA sums them in another order than tree by tree, so the
    # means agree to float32 rounding (the engine bar's tolerance)
    np.testing.assert_allclose(
        tforest.forest_proba(t_forest(rf), torch.as_tensor(x)).numpy(),
        np.asarray(jforest.forest_proba(rf, jnp.asarray(x))),
        rtol=1e-6, atol=1e-7)
    g = np.arange(97, dtype=np.int32) % jgc.n_groves
    np.testing.assert_array_equal(
        tcore.grove_predict_proba(tgc, torch.as_tensor(g),
                                  torch.as_tensor(x)).numpy(),
        np.asarray(jcore.grove_predict_proba(jgc, jnp.asarray(g),
                                             jnp.asarray(x))))
    from repro.forest.tree import traverse_one as jtraverse_one
    one = tforest.traverse_one(t_forest(rf).feature[3], t_forest(rf).threshold[3],
                               t_forest(rf).leaf[3], torch.as_tensor(x[5]))
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jtraverse_one(rf.feature[3], rf.threshold[3],
                                              rf.leaf[3], jnp.asarray(x[5]))))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_pack_equal_field_for_field(jgc, tgc, precision):
    want = jforest.ForestPack.from_groves(jgc, precision)
    got = tforest.ForestPack.from_groves(tgc, precision)
    for f in FIELDS:
        np.testing.assert_array_equal(np_bits(getattr(got, f)),
                                      np_bits(getattr(want, f)), err_msg=f)
    assert got.table_bytes == want.table_bytes
    assert (got.n_heads, got.n_groves, got.grove_size, got.depth,
            got.n_classes) == (want.n_heads, want.n_groves, want.grove_size,
                               want.depth, want.n_classes)
    # dequantized values and the repack path agree too
    for a, b in zip(got.dequantize()[1:], want.dequantize()[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in FIELDS:
        np.testing.assert_array_equal(
            np_bits(getattr(got.astype("int8"), f)),
            np_bits(getattr(want.astype("int8"), f)), err_msg=f)


def test_multihead_pack_matches(rf8_penbased, rf8_noisy_penbased):
    jg = (jcore.split(rf8_penbased, 2), jcore.split(rf8_noisy_penbased, 2))
    tg = tuple(tcore.split(t_forest(r), 2)
               for r in (rf8_penbased, rf8_noisy_penbased))
    want = jforest.ForestPack.from_groves(jg, "int8")
    got = tforest.ForestPack.from_groves(tg, "int8")
    assert got.n_heads == 2
    for f in FIELDS:
        np.testing.assert_array_equal(np_bits(getattr(got, f)),
                                      np_bits(getattr(want, f)), err_msg=f)
    heads = got.to_groves()
    np.testing.assert_array_equal(heads[1].leaf.numpy(),
                                  np.asarray(want.to_groves()[1].leaf))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_npz_round_trip_both_ways(jgc, tmp_path, precision):
    jpack = jforest.ForestPack.from_groves(jgc, precision)
    meta = {"n_features": 16, "note": precision}
    # JAX writes, the port reads
    jpack.save(tmp_path / "jax.npz", extra=meta)
    tpack, extra = tforest.ForestPack.load_with_meta(tmp_path / "jax.npz")
    assert extra == meta and tpack.precision == precision
    for f in FIELDS:
        np.testing.assert_array_equal(np_bits(getattr(tpack, f)),
                                      np_bits(getattr(jpack, f)), err_msg=f)
    # the port writes, JAX reads
    tpack.save(tmp_path / "torch.npz", extra=meta)
    back, extra2 = jforest.ForestPack.load_with_meta(tmp_path / "torch.npz")
    assert extra2 == meta and back.precision == precision
    for f in FIELDS:
        np.testing.assert_array_equal(np_bits(getattr(back, f)),
                                      np_bits(getattr(jpack, f)), err_msg=f)
    # and the raw artifacts carry the same fields, bit for bit
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "torch.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_from_numpy_adopts_packed_fields(jgc):
    jpack = jforest.ForestPack.from_groves(jgc, "bf16")
    got = tforest.ForestPack.from_numpy(
        *(np.asarray(getattr(jpack, f)) for f in FIELDS), "bf16")
    assert got.threshold.dtype == torch.bfloat16
    for f in FIELDS:
        np.testing.assert_array_equal(np_bits(getattr(got, f)),
                                      np_bits(getattr(jpack, f)))


def test_pack_rejects_bad_inputs(tgc, tmp_path):
    with pytest.raises(ValueError, match="precision"):
        tforest.ForestPack.from_groves(tgc, "fp16")
    pack = tforest.ForestPack.from_groves(tgc)
    # the ring layout is ported: one shard by default, the groves in order
    ring = pack.layout("ring")
    assert len(ring) == 5 and ring is pack.layout("ring", 1)
    for f, a in zip(FIELDS, ring):
        assert torch.equal(a, getattr(pack, f)[0]), f
    assert pack.layout("fused")[0] is pack.feature
    np.savez(tmp_path / "junk.npz", a=np.zeros(3))
    with pytest.raises(ValueError, match="not a ForestPack"):
        tforest.ForestPack.load(tmp_path / "junk.npz")
