"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU (decided in the
``cuda`` fixture, never at import).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX: the card's machine has none.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch.forest import ForestPack  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.fused_fog import fused_fog_ref  # noqa: E402

pytestmark = pytest.mark.cuda

PRECISIONS = ["fp32", "bf16", "int8"]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode "
                    "(their plain versions are tested on the CPU)")
    return torch.device("cuda")


def random_tables(rng, O=1, G=5, t=3, depth=6, C=7, F=9):
    N, L = 2**depth - 1, 2**depth
    feature = rng.integers(0, F, (O, G, t, N)).astype(np.int32)
    thr = rng.normal(size=(O, G, t, N)).astype(np.float32)
    thr[rng.random(thr.shape) < 0.2] = np.inf
    leaf = rng.random((O, G, t, L, C)).astype(np.float32)
    return tuple(map(torch.as_tensor, (feature, thr, leaf)))


def random_pack(rng, precision, **shape):
    return ForestPack._pack(*random_tables(rng, **shape), precision)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_packing_on_card_equals_cpu(cuda, precision):
    tables = random_tables(np.random.default_rng(9), O=2)
    tables[1][0, 0, 0, :3] = -np.inf               # the -127 sentinel too
    on_cpu = ForestPack._pack(*tables, precision)
    on_card = ForestPack._pack(*(a.to(cuda) for a in tables), precision)
    for f in ("feature", "threshold", "leaf", "thr_scale", "leaf_scale"):
        got, want = getattr(on_card, f), getattr(on_cpu, f)
        assert got.device.type == "cuda" and got.dtype == want.dtype
        assert torch.equal(got.cpu(), want), f


def test_top2_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    p = torch.as_tensor(rng.random((1031, 10), dtype=np.float32), device=cuda)
    p[:50, 2] = p[:50, 6] = 5.0                     # ties at the max
    p[50:60] = 0.5                                  # all equal
    before = ops.launches["top2_confidence"]
    got = ops.top2_confidence(p, block_b=128)
    assert ops.launches["top2_confidence"] == before + 1
    assert torch.equal(got, ref.top2_confidence_ref(p))
    assert (got[:60] == 0).all()


@pytest.mark.parametrize("per_lane", [False, True])
def test_grove_aggregate_kernel_matches_plain(cuda, per_lane):
    rng = np.random.default_rng(1)
    B, C = 777, 26
    prob = torch.as_tensor(rng.random((B, C), dtype=np.float32) * 3,
                           device=cuda)
    contrib = torch.as_tensor(rng.random((B, C), dtype=np.float32),
                              device=cuda)
    live = torch.as_tensor(rng.random(B) < 0.6, device=cuda)
    hops = torch.as_tensor(rng.integers(0, 5, B, dtype=np.int32), device=cuda)
    thresh = (torch.as_tensor(rng.random(B, dtype=np.float32), device=cuda)
              if per_lane else 0.2)
    got = ops.grove_aggregate(prob, contrib, live, hops, thresh, block_b=64)
    want = ref.grove_aggregate_ref(prob, contrib, live, hops, thresh)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_fused_kernel_matches_plain(cuda, precision, heads):
    rng = np.random.default_rng(2 + heads)
    pack = random_pack(rng, precision, O=heads).to(cuda)
    B = 1000
    x = torch.as_tensor(rng.normal(size=(B, 9)).astype(np.float32),
                        device=cuda)
    start = torch.as_tensor(rng.integers(0, 5, B, dtype=np.int32),
                            device=cuda)
    thresh = torch.as_tensor(rng.random(B, dtype=np.float32) * 0.5,
                             device=cuda)
    budget = torch.as_tensor(rng.integers(1, 6, B, dtype=np.int32),
                             device=cuda)
    args = (*pack.layout("fused")[:3], x, start, thresh, budget,
            *pack.layout("fused")[3:])
    pk, hk = ops.fused_fog(*args, max_hops=5, block_b=96)
    pr, hr = fused_fog_ref(*args, max_hops=5)
    assert torch.equal(hk, hr)
    torch.testing.assert_close(pk, pr, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_engine_backends_agree_on_card(cuda, trained_port, precision):
    ds, gc = trained_port
    x = torch.as_tensor(ds.x_test[:513], device=cuda)
    before = dict(ops.launches)
    res = {}
    for b in ("fused", "pallas", "reference"):
        eng = tcore.FogEngine(gc, backend=b, precision=precision,
                              device=cuda)
        res[b] = eng.eval(x, torch.Generator(device=cuda).manual_seed(5),
                          policy=tcore.FogPolicy(threshold=0.3))
    assert ops.launches["fused_fog"] == before["fused_fog"] + 1
    assert ops.launches["grove_aggregate"] == before["grove_aggregate"] + 8
    for b in ("fused", "pallas"):
        assert torch.equal(res[b].hops, res["reference"].hops)
        assert torch.equal(res[b].label, res["reference"].label)
        torch.testing.assert_close(res[b].proba, res["reference"].proba,
                                   rtol=1e-6, atol=1e-7)
    cpu = tcore.FogEngine(gc, precision=precision, device="cpu").eval(
        ds.x_test[:513], policy=tcore.FogPolicy(threshold=0.3),
        start=tcore.sample_starts(
            torch.Generator(device=cuda).manual_seed(5), 513, 8).cpu())
    assert torch.equal(res["fused"].hops.cpu(), cpu.hops)


@pytest.fixture(scope="module")
def trained_port():
    from repro_torch.data import make_dataset
    from repro_torch.forest import TrainConfig, train_random_forest
    ds = make_dataset("penbased")
    rf = train_random_forest(ds.x_train, ds.y_train, ds.n_classes,
                             TrainConfig(n_trees=16, max_depth=6, seed=1))
    return ds, tcore.split(rf, 2)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    p = torch.rand((64, 10), device=cuda)
    with pytest.raises(ValueError, match="threads per block"):
        ops.top2_confidence(p, block_b=48)
    with pytest.raises(ValueError, match="contiguous"):
        ops.top2_confidence(p.t())
    with pytest.raises(TypeError):
        ops.top2_confidence(p.double())
    with pytest.raises(ValueError, match="dequantize"):
        ops.grove_aggregate(p, p.to(torch.int8), torch.ones(64, dtype=bool,
                                                            device=cuda),
                            torch.zeros(64, dtype=torch.int32, device=cuda),
                            0.3)
