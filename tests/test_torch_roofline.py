"""repro_torch's FoG roofline model (``launch/roofline.py``) on the CPU:
the cases of ``tests/test_roofline_model.py`` on the port, with one H100
SXM in the TPU spec's place, and its bytes and FLOPs equal to the JAX
package's ``RooflineModel`` at the same pack (fp32, bf16, int8), batch,
iterations, hops, chunks and compaction, for every traffic class."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.grove import split as jsplit  # noqa: E402
from repro.forest.pack import ForestPack as JPack  # noqa: E402
from repro.forest.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.forest.train import train_random_forest as jtrain  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch.core import split  # noqa: E402
from repro_torch.forest import (ForestPack, TrainConfig,  # noqa: E402
                                train_random_forest)
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.roofline import (H100_SXM,  # noqa: E402
                                         H100_SXM_BF16, HOST_CPU,
                                         MachineSpec, RooflineModel)


def data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((300, 12)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.int32) + 2 * (X[:, 1] > 0).astype(np.int32)
    return X, y


@pytest.fixture(scope="module")
def small_pack():
    """A tiny packed field: 1 head, 4 groves x 2 trees, depth 3, 4
    classes (the JAX test's)."""
    X, y = data()
    rf = train_random_forest(X, y, 4, TrainConfig(n_trees=8, max_depth=3,
                                                  seed=0))
    return ForestPack.from_groves(split(rf, 2), "fp32")


@pytest.fixture(scope="module")
def jax_pack():
    X, y = data()
    rf = jtrain(X, y, 4, JTrainConfig(n_trees=8, max_depth=3, seed=0))
    return JPack.from_groves(jsplit(rf, 2), "fp32")


def test_roofline_fused_moves_fewer_table_bytes(small_pack):
    """The paper's claim in model form: the fused pin touches the tables
    once, the per-hop loop re-reads a grove slice per lane per
    iteration."""
    m = RooflineModel(small_pack, n_features=12)
    per_hop = m.estimate("reference", batch=1000, iters=4)
    fused = m.estimate("fused", batch=1000, iters=4, hops_total=1300.0)
    assert fused.bytes_moved < per_hop.bytes_moved
    assert per_hop.bytes_moved >= 1000 * 4 * (small_pack.table_bytes
                                              / small_pack.n_groves)


def test_roofline_dtype_aware_bytes(small_pack):
    """int8 tables move a quarter of the fp32 per-hop table traffic."""
    p8 = small_pack.astype("int8")
    f32 = RooflineModel(small_pack, 12).estimate("reference", 100, iters=4)
    i8 = RooflineModel(p8, 12).estimate("reference", 100, iters=4)
    assert i8.bytes_moved < f32.bytes_moved
    assert p8.table_bytes < small_pack.table_bytes / 2


def test_roofline_bound_and_achieved(small_pack):
    m = RooflineModel(small_pack, 12, spec=H100_SXM)
    est = m.estimate("reference", 1000, iters=4)
    assert est.bound in ("memory", "compute")
    assert est.ideal_s == max(est.memory_s, est.compute_s) > 0
    assert est.achieved(2 * est.ideal_s) == pytest.approx(0.5)
    assert est.achieved(0.0) == 0.0
    assert est.achieved(None) == 0.0
    d = est.to_dict(measured_s=est.ideal_s)
    assert d["bound"] == est.bound
    assert d["achieved_pct"] == pytest.approx(100.0, abs=0.01)


def test_roofline_spec_selection(small_pack):
    """Specs by name or value; a slower machine lowers the roofline; the
    traffic is machine-free."""
    by_name = RooflineModel(small_pack, 12, spec="host-cpu")
    assert by_name.spec is HOST_CPU
    assert RooflineModel(small_pack, 12).spec is H100_SXM
    custom = MachineSpec("slow", peak_flops=1e9, peak_bw=1e9)
    slow = RooflineModel(small_pack, 12, spec=custom).estimate(
        "fused", 100, iters=4)
    fast = RooflineModel(small_pack, 12, spec=H100_SXM).estimate(
        "fused", 100, iters=4)
    assert slow.ideal_s > fast.ideal_s
    assert slow.bytes_moved == fast.bytes_moved


def test_roofline_compaction_cuts_compute_not_bytes(small_pack):
    m = RooflineModel(small_pack, 12)
    off = m.estimate("fused", 1000, iters=4, hops_total=1300.0,
                     compact=False)
    on = m.estimate("fused", 1000, iters=4, hops_total=1300.0, compact=True)
    assert on.flops < off.flops
    assert on.bytes_moved == off.bytes_moved


def test_roofline_row_names_map_to_traffic_class(small_pack):
    """The traffic class comes from the name's root; the estimate keeps
    the full name."""
    m = RooflineModel(small_pack, 12)
    ref = m.estimate("reference", 1000, iters=4)
    for name in ("pallas", "pallas-chunked", "reference-lazy"):
        est = m.estimate(name, 1000, iters=4)
        assert est.backend == name
        assert est.bytes_moved == ref.bytes_moved
        assert est.flops == ref.flops
    fused = m.estimate("fused", 1000, iters=4, hops_total=1300.0,
                       compact=True)
    named = m.estimate("fused-compact", 1000, iters=4, hops_total=1300.0,
                       compact=True)
    assert named.backend == "fused-compact"
    assert named.bytes_moved == fused.bytes_moved
    assert named.flops == fused.flops


def test_specs_are_the_h100s():
    """The datasheet's rates; no TPU spec is carried over."""
    assert (H100_SXM.peak_bw, H100_SXM.peak_flops) == (3.35e12, 67e12)
    assert H100_SXM_BF16.peak_flops == 989e12
    assert H100_SXM.ici_bw == 0.0
    assert set(roofline.SPECS) == {"h100-sxm", "h100-sxm-bf16", "host-cpu"}
    assert not any("tpu" in name.lower() for name in dir(roofline))


ESTIMATES = [  # (backend, batch, iters, hops_total, chunks, compact)
    ("reference", 1000, 4, None, 1, False),
    ("reference-lazy", 37, 3, 80.0, 1, False),
    ("pallas", 65_536, 8, 300_000.0, 1, False),
    ("pallas-chunked", 1000, 8, None, 4, True),
    ("fused", 1000, 4, 1300.0, 1, False),
    ("fused", 1000, 4, 1300.0, 1, True),
    ("fused-compact", 65_536, 8, 250_000.0, 3, True),
    ("fused", 1, 1, None, 1, False),
    ("ring", 1000, 8, 5000.0, 1, False),
    ("ring-8", 65_536, 8, None, 2, True),
]


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("case", ESTIMATES, ids=lambda c: "-".join(
    map(str, c)))
def test_bytes_and_flops_equal_jax(small_pack, jax_pack, precision, case):
    """The same pack in both packages, the same arguments: the same bytes
    and FLOPs (and the same per-unit terms)."""
    backend, batch, iters, hops_total, chunks, compact = case
    tp, jp = small_pack.astype(precision), jax_pack.astype(precision)
    assert tp.table_bytes == jp.table_bytes
    tm = RooflineModel(tp, 12)
    jm = jroofline.RooflineModel(jp, 12, spec=jroofline.HOST_CPU)
    for k in ("lane_hop_flops", "lane_hop_bytes", "lane_io_bytes"):
        assert getattr(tm, k) == getattr(jm, k), k
    kw = {"iters": iters, "hops_total": hops_total, "chunks": chunks,
          "compact": compact}
    got = tm.estimate(backend, batch, **kw)
    want = jm.estimate(backend, batch, **kw)
    assert got.backend == want.backend == backend
    assert got.bytes_moved == want.bytes_moved
    assert got.flops == want.flops
    # at the same spec, the same times and bound
    host = RooflineModel(tp, 12, spec=HOST_CPU).estimate(backend, batch,
                                                         **kw)
    assert (host.memory_s, host.compute_s, host.bound) == (
        want.memory_s, want.compute_s, want.bound)
