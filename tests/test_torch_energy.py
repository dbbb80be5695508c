"""repro_torch's energy model against the JAX package's: the fp32 goldens
of tests/test_energy.py, every pJ formula at every precision, and the
per-lane pricing on tensors (float32) and numpy arrays (float64)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.energy as jen  # noqa: E402
import repro_torch.core.energy as ten  # noqa: E402
from test_energy import HOPS, TABLE1_TOPOLOGIES  # noqa: E402

PRECISIONS = ["fp32", "bf16", "int8"]


def fields(report):
    """An EnergyReport of either package as plain numbers."""
    return (report.total_pj, report.per_example_pj)


@pytest.mark.parametrize("name", sorted(TABLE1_TOPOLOGIES))
def test_fp32_goldens_bit_for_bit(name):
    k, d, C, F, golden = TABLE1_TOPOLOGIES[name]
    rep = ten.EnergyModel(k, d, C, F).report(HOPS)
    assert rep.per_example_pj == golden
    assert fields(rep) == fields(jen.EnergyModel(k, d, C, F).report(HOPS))
    assert ten.fog_energy(HOPS, k, d, C, F) == rep
    assert str(rep) == str(jen.fog_energy(HOPS, k, d, C, F))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("name", sorted(TABLE1_TOPOLOGIES))
def test_model_matches_jax(name, precision):
    k, d, C, F, _ = TABLE1_TOPOLOGIES[name]
    mine = ten.EnergyModel(k, d, C, F, precision)
    theirs = jen.EnergyModel(k, d, C, F, precision)
    assert mine.per_hop_pj == theirs.per_hop_pj
    assert mine.transfer_pj == theirs.transfer_pj
    assert fields(mine.report(HOPS)) == fields(theirs.report(HOPS))
    assert mine.hops_within(1e4) == theirs.hops_within(1e4)
    assert mine.mean_pj(1.7) == theirs.mean_pj(1.7)
    # host pricing is float64, device pricing float32 — both as in JAX
    host = mine.lane_pj(HOPS)
    assert host.dtype == np.float64
    np.testing.assert_array_equal(host, theirs.lane_pj(HOPS))
    dev = mine.lane_pj(torch.as_tensor(HOPS, dtype=torch.int32))
    assert dev.dtype == torch.float32
    np.testing.assert_array_equal(
        dev.numpy(), np.asarray(theirs.lane_pj(jnp.asarray(HOPS, jnp.int32))))


def test_baseline_formulas_match():
    assert ten.rf_energy_pj(16, 8, 10) == jen.rf_energy_pj(16, 8, 10)
    assert fields(ten.rf_report(5, 16, 8, 10)) == fields(
        jen.rf_report(5, 16, 8, 10))
    assert ten.svm_lr_energy_pj(16, 10) == jen.svm_lr_energy_pj(16, 10)
    assert (ten.svm_rbf_energy_pj(16, 10, 300)
            == jen.svm_rbf_energy_pj(16, 10, 300))
    assert ten.mlp_energy_pj([16, 64, 10]) == jen.mlp_energy_pj([16, 64, 10])
    assert (ten.cnn_energy_pj(1000, 200, 300)
            == jen.cnn_energy_pj(1000, 200, 300))
    a, b = ten.AffineEnergy(12.5, 3.0), jen.AffineEnergy(12.5, 3.0)
    assert fields(a.report(HOPS)) == fields(b.report(HOPS))


def test_from_pack_and_eval_report(trained):
    import repro_torch.core as tcore
    from repro_torch.forest import TensorForest
    ds, rf = trained
    gc = tcore.split(TensorForest.from_numpy(rf.feature, rf.threshold,
                                             rf.leaf), 2)
    eng = tcore.FogEngine(gc, backend="fused", device="cpu")
    res = eng.eval(ds.x_test[:50], torch.Generator().manual_seed(0),
                   policy=tcore.FogPolicy(threshold=0.3, precision="int8"))
    pack = eng.tables.pack("int8")
    assert res.model == ten.EnergyModel.from_pack(pack, 16)
    assert res.model.precision == "int8"
    assert torch.equal(res.energy_pj, res.model.lane_pj(res.hops))
    assert res.energy_report() == res.model.report(res.hops.numpy())
    assert res.mean_energy_nj == pytest.approx(res.mean_energy_pj * 1e-3)
    assert eng.energy_model("int8") is res.model
