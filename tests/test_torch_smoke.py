"""The work accounting ``chip_smoke.py`` reads its kernel bounds from,
checked on the CPU: fused_fog's against a walk of one lane, one tree at a
time, flash_attention's against a count of every (query, key) pair."""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.forest import ForestPack  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.fused_fog import fused_fog_ref  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def brute_force_distinct(pack, x, start, hops):
    """Distinct (tree, node), (tree, leaf), tree and (lane, feature)
    entries the walk reads, one lane, hop, head and tree at a time."""
    feat, thr, leaf, ts, ls = pack.layout("fused")
    thr = ref.dequantize_tables(thr, leaf, ts, ls)[0]
    O, G, t, N = feat.shape
    trees, nodes, xs, leaves = set(), set(), set(), set()
    for b in range(x.shape[0]):
        for j in range(int(hops[b])):
            g = (int(start[b]) + j) % G
            for o in range(O):
                for tr in range(t):
                    trees.add((o, g, tr))
                    idx = 0
                    for _ in range(pack.depth):
                        f = int(feat[o, g, tr, idx])
                        nodes.add((o, g, tr, idx))
                        xs.add((b, f))
                        idx = 2 * idx + 1 + int(bool(
                            x[b, f] > thr[o, g, tr, idx]))
                    leaves.add((o, g, tr, idx - N))
    return {"trees": len(trees), "nodes": len(nodes), "x": len(xs),
            "leaves": len(leaves)}


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_fused_work_counts_what_the_walk_reads(precision, heads):
    rng = np.random.default_rng(11 + heads)
    O, G, t, d, C, F, B = heads, 4, 3, 4, 5, 6, 37
    N = 2**d - 1
    thr = rng.normal(size=(O, G, t, N)).astype(np.float32)
    thr[rng.random(thr.shape) < 0.25] = np.inf      # padded subtrees
    pack = ForestPack._pack(
        torch.as_tensor(rng.integers(0, F, (O, G, t, N)).astype(np.int32)),
        torch.as_tensor(thr),
        torch.as_tensor(rng.random((O, G, t, N + 1, C)).astype(np.float32)),
        precision)
    x = torch.as_tensor(rng.normal(size=(B, F)).astype(np.float32))
    start = torch.as_tensor(rng.integers(0, G, B, dtype=np.int32))
    thresh = torch.as_tensor(rng.random(B, dtype=np.float32) * 0.6)
    budget = torch.full((B,), 4, dtype=torch.int32)
    _, hops = fused_fog_ref(*pack.layout("fused")[:3], x, start, thresh,
                            budget, *pack.layout("fused")[3:], max_hops=4)
    work = chip_smoke.fused_work(pack, x, start, hops)
    n = brute_force_distinct(pack, x, start, hops)
    assert work["distinct"] == n
    tb = pack.threshold.element_size()
    assert work["bytes"] == (n["nodes"] * (4 + tb) + n["leaves"] * C * tb
                             + n["trees"] * 8 + n["x"] * 4 + 3 * B * 4
                             + B * O * C * 4 + B * 4)
    # the function's chain is one tree's walk; the serial chain walks the
    # slowest lane's hops, heads and trees in turn
    assert work["chain"] == 2 * d + 1
    assert work["serial_chain"] == int(hops.max()) * O * t * (2 * d + 1)
    # the distinct reads never exceed the tables, however many lane-hops
    assert n["nodes"] * (4 + tb) + n["leaves"] * C * tb <= pack.table_bytes


@pytest.mark.parametrize("Sq,Sk,causal", [(37, 53, True), (53, 37, True),
                                          (29, 29, True), (37, 53, False)])
def test_flash_work_counts_every_pair_and_byte(Sq, Sk, causal):
    """flash_work against a brute-force count at small ragged shapes: the
    (query, key) pairs the mask lets through (key j <= query i, both from
    0) and the bytes of q, k, v and the output."""
    B, H, K, D, Dv = 2, 6, 3, 24, 8
    q, k, v = (torch.zeros(sh, dtype=torch.bfloat16) for sh in
               ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, Dv)))
    out = ref.flash_attention_ref(q, k, v, causal=causal)
    pairs = sum(1 for i in range(Sq) for j in range(Sk)
                if not causal or j <= i)
    work = chip_smoke.flash_work(B, Sq, Sk, H, K, D, Dv, 2, causal)
    assert work["pairs"] == pairs
    assert work["ops"] == B * H * pairs * (2 * D + 2 * Dv)
    assert work["bytes"] == sum(t.numel() * t.element_size()
                                for t in (q, k, v, out))


def test_flash_work_at_the_prefill_shape():
    """tinyllama's prefill: 2,098,176 causal pairs per (batch, head), 68.75
    GFLOP and 75.5 MB."""
    work = chip_smoke.flash_work(4, 2048, 2048, 32, 4, 64, 64, 2)
    assert work["pairs"] == 2048 * 2049 // 2 == 2_098_176
    assert work["ops"] == 68_753_031_168
    assert work["bytes"] == 75_497_472
