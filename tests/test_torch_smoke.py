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


@pytest.mark.parametrize("Sq,Sk,causal", [(37, 53, True), (53, 37, True),
                                          (37, 53, False)])
def test_backward_work_counts_every_tensor_and_product(Sq, Sk, causal):
    """bwd_work against the tensors the backward reads and writes (q, k, v,
    o, do, lse; dq, dk, dv) and the five products over the live pairs
    (s, dp, dv, dq, dk: 2 D, 2 Dv, 2 Dv, 2 D, 2 D FLOP a pair)."""
    from repro_torch.kernels import flash_attention as fa
    B, H, K, D, Dv = 2, 6, 3, 24, 8
    q, k, v = (torch.zeros(sh) for sh in
               ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, Dv)))
    o, lse = fa.flash_attention_ref_lse(q, k, v, causal=causal)
    grads = fa.flash_attention_bwd_ref(q, k, v, o, o, lse, causal=causal)
    pairs = sum(1 for i in range(Sq) for j in range(Sk)
                if not causal or j <= i)
    work = chip_smoke.bwd_work(B, Sq, Sk, H, K, D, Dv, causal)
    assert work["pairs"] == pairs
    assert work["ops"] == B * H * pairs * (6 * D + 4 * Dv)
    assert work["bytes"] == sum(t.numel() * t.element_size() for t in (
        q, k, v, o, o, lse, *grads))


def test_backward_work_at_the_training_shape():
    """tinyllama's training shape: 5.39 GFLOP (0.080 ms at 67 TFLOP/s) and
    75.8 MB (0.023 ms at 3.35 TB/s)."""
    work = chip_smoke.bwd_work(8, 256, 256, 32, 4, 64, 64)
    assert work["ops"] == 8 * 32 * (256 * 257 // 2) * 640 == 5_389_680_640
    assert work["bytes"] == 75_759_616
    ms, by = chip_smoke.bound_ms(work["bytes"], work["ops"])
    assert by == "operations" and abs(ms - 0.080443) < 1e-6


@pytest.mark.parametrize("Q", [1, 7, 32])
def test_ssd_backward_work_counts_every_tensor_and_product(Q):
    """ssd_bwd_work against the tensors the backward reads and writes
    (xbar, a, B, C, dy, dstates; dxbar, da, dB, dC) and its products: per
    chunk S, dC and dB's dS^T C over the causal pairs (2 N FLOP a pair
    each), per (chunk, head) dy x^T and W^T dy over the pairs (2 P each)
    and B dst^T and x dst over the chunk (2 Q P N each)."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd_ref
    B, nc, H, P, N = 2, 3, 5, 7, 9
    xbar, dy = torch.zeros((B, nc, Q, H, P)), torch.zeros((B, nc, Q, H, P))
    a = torch.zeros((B, nc, H, Q))
    Bm, Cm = torch.zeros((B, nc, Q, N)), torch.zeros((B, nc, Q, N))
    dst = torch.zeros((B, nc, H, P, N))
    grads = ssd_chunk_bwd_ref(xbar, a, Bm, Cm, dy, dst)
    pairs = sum(1 for i in range(Q) for j in range(Q) if j <= i)
    work = chip_smoke.ssd_bwd_work(B, nc, Q, H, P, N)
    assert work["pairs"] == pairs
    assert work["ops"] == B * nc * (6 * pairs * N + H * (
        4 * pairs * P + 4 * Q * P * N))
    assert work["bytes"] == sum(t.numel() * t.element_size() for t in (
        xbar, a, Bm, Cm, dy, dst, *grads))


def test_ssd_backward_work_at_the_training_shape():
    """mamba2-2.7b's training shape (xbar [8, 1, 256, 80, 64], N = 128):
    10.96 GFLOP (0.164 ms at 67 TFLOP/s) and 152 MB (0.045 ms at 3.35
    TB/s): operations bound it."""
    work = chip_smoke.ssd_bwd_work(8, 1, 256, 80, 64, 128)
    assert work["ops"] == 8 * (6 * 32896 * 128 + 80 * (
        4 * 32896 * 64 + 4 * 256 * 64 * 128)) == 10_960_502_784
    assert work["bytes"] == 152_305_664
    ms, by = chip_smoke.bound_ms(work["bytes"], work["ops"])
    assert by == "operations" and abs(ms - 0.163590) < 1e-6


@pytest.mark.parametrize("Sq,Sk,causal", [(37, 53, True), (53, 37, True),
                                          (37, 53, False)])
def test_tensor_core_backward_work_counts_every_tensor_and_product(
        Sq, Sk, causal):
    """bwd_work_sm90 against the bf16 tensors the backward reads and writes
    (q, k, v, o, do; dq, dk, dv), the fp32 lse it reads, the five products
    over the live pairs and the seven its two passes run (s and dp twice:
    2 (4 D + 3 Dv) FLOP a pair)."""
    from repro_torch.kernels import flash_attention as fa
    B, H, K, D, Dv = 2, 6, 3, 64, 128
    q, k, v = (torch.zeros(sh, dtype=torch.bfloat16) for sh in
               ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, Dv)))
    o, lse = fa.flash_attention_ref_lse(q, k, v, causal=causal)
    grads = fa.flash_attention_bwd_ref(q, k, v, o, o, lse, causal=causal)
    assert lse.dtype == torch.float32 and grads[0].dtype == torch.bfloat16
    pairs = sum(1 for i in range(Sq) for j in range(Sk)
                if not causal or j <= i)
    work = chip_smoke.bwd_work_sm90(B, Sq, Sk, H, K, D, Dv, causal)
    assert work["pairs"] == pairs
    assert work["ops"] == chip_smoke.bwd_work(B, Sq, Sk, H, K, D, Dv,
                                              causal)["ops"]
    assert work["design_ops"] == B * H * pairs * (8 * D + 6 * Dv)
    assert work["bytes"] == sum(t.numel() * t.element_size() for t in (
        q, k, v, o, o, lse, *grads))


@pytest.mark.parametrize("shape,ops,n_bytes,bound,by", [
    ((2, 4096, 4096, 32, 4, 64, 64), 343_681_269_760, 152_043_520,
     0.347504, "operations"),
    ((8, 256, 256, 32, 4, 64, 64), 5_389_680_640, 38_010_880, 0.011346,
     "bytes")])
def test_tensor_core_backward_work_at_the_training_shapes(shape, ops,
                                                          n_bytes, bound,
                                                          by):
    """tinyllama's bf16 step at S = 4096 (3.44e11 FLOP: 0.347 ms at 989
    TFLOP/s, above 152 MB at 3.35 TB/s) and fp32 training's 8 x 256 shape
    in bf16 (38 MB: bytes bound it)."""
    work = chip_smoke.bwd_work_sm90(*shape)
    assert (work["ops"], work["bytes"]) == (ops, n_bytes)
    ms, got_by = chip_smoke.bound_ms(work["bytes"], work["ops"],
                                     chip_smoke.BF16_OPS_PER_S)
    assert got_by == by and abs(ms - bound) < 1e-6


def test_ssd_backward_work_in_bf16_at_mamba2_s_training_shape():
    """mamba2-2.7b's bf16 step at 2 x 4096 (xbar [2, 16, 256, 80, 64], N =
    128): 43.8 GFLOP and 305 MB, so bytes bound it at the bf16 rate
    (0.091 ms; the operations 0.044 ms)."""
    work = chip_smoke.ssd_bwd_work(2, 16, 256, 80, 64, 128, itemsize=2)
    assert work["ops"] == 43_842_011_136
    assert work["bytes"] == 304_611_328
    ms, by = chip_smoke.bound_ms(work["bytes"], work["ops"],
                                 chip_smoke.BF16_OPS_PER_S)
    assert by == "bytes" and abs(ms - 0.090929) < 1e-6


def test_ssd_work_at_the_fp32_training_shape():
    """ssd_chunk's forward at mamba2-2.7b's fp32 training shape (xbar [8,
    1, 256, 80, 64], N = 128): 5.45 GFLOP over the causal pairs (0.0813
    ms at 67 TFLOP/s) above 107.6 MB (0.032 ms at 3.35 TB/s): operations
    bound it."""
    work = chip_smoke.ssd_work(8, 1, 256, 80, 64, 128, 4)
    assert work["ops"] == 5_446_565_888
    assert work["bytes"] == 107_610_112
    ms, by = chip_smoke.bound_ms(work["bytes"], work["ops"])
    assert by == "operations" and abs(ms - 0.081292) < 1e-6


@pytest.mark.parametrize("shape", [(8, 1, 256, 80, 64, 128),
                                   (2, 2, 200, 5, 72, 130),
                                   (1, 3, 7, 2, 5, 3)], ids=str)
def test_simt_design_operations_count_their_tiles(shape):
    """What the SIMT kernels run over their 64 x 64 tiles, Q, P and N
    rounded up to 64, counted tile by tile: the forward C.B^T once per
    chunk over the tiles on or below the diagonal, per head W.x over them
    and the states over the whole chunk; the backward S, dC and dB per
    chunk over the tiles, per head dW and W^T dy over the tiles, G per
    (row tile, 64 columns of P) and x dst per (row tile, 64 columns of N)
    over the whole chunk.  At the training shape 6.12 and 12.33 GFLOP."""
    B, nc, Q, H, P, N = shape
    T = 64
    nt, npp, nn = -(-Q // T), -(-P // T), -(-N // T)
    tiles = [(ti, tj) for ti in range(nt) for tj in range(ti + 1)]
    prod = 2 * T * T * T                  # one 64 x 64 x 64 tile product
    fwd = bwd = 0
    for _ in range(B * nc):
        fwd += len(tiles) * nn * prod                       # S
        bwd += 3 * len(tiles) * nn * prod                   # S, dC, dB
        for _ in range(H):
            fwd += len(tiles) * npp * prod                  # W x
            fwd += npp * nn * nt * prod                     # states
            bwd += 2 * len(tiles) * npp * prod              # dW, W^T dy
            bwd += nt * npp * nn * prod                     # G
            bwd += nt * nn * npp * prod                     # x dst
    assert chip_smoke.ssd_work(*shape, 4)["ops_simt"] == fwd
    assert chip_smoke.ssd_bwd_work(*shape)["simt_ops"] == bwd
    if shape == (8, 1, 256, 80, 64, 128):
        assert (fwd, bwd) == (6_123_683_840, 12_331_253_760)


@pytest.mark.parametrize("shape,causal", [
    ((8, 256, 256, 32, 64, 64), True), ((2, 200, 200, 8, 32, 32), True),
    ((1, 100, 300, 4, 129, 129), True), ((1, 300, 100, 4, 65, 48), True),
    ((2, 150, 170, 6, 64, 64), False)], ids=str)
def test_simt_forward_design_operations_count_their_tiles(shape, causal):
    """What the SIMT attention forward runs: every (q tile, K/V tile) pair
    it visits whole (64 x 64 tiles up to max(D, Dv) = 128, 32 x 32 above;
    causal: the K/V tiles up to the q tile's last row), 2 (D + Dv) FLOP a
    (row, key) pair, counted row by row.  At tinyllama's fp32 training
    shape 2.68 GFLOP, 1.24x the 2.16 the causal pairs need."""
    B, Sq, Sk, H, D, Dv = shape
    T = 64 if max(D, Dv) <= 128 else 32
    pairs = 0
    for i0 in range(0, Sq, T):
        last = min(i0 + T, Sq) - 1
        seen = min(Sk, last + 1) if causal else Sk
        pairs += T * T * -(-seen // T)
    want = B * H * pairs * 2 * (D + Dv)
    assert chip_smoke.flash_design_ops(B, Sq, Sk, H, D, Dv, causal) == want
    if shape == (8, 256, 256, 32, 64, 64):
        assert want == 2_684_354_560
        need = chip_smoke.flash_work(B, Sq, Sk, H, 4, D, Dv, 4)["ops"]
        assert need == 2_155_872_256


def test_phase_21_mesh_step_check_on_a_one_rank_gloo_group(tmp_path):
    """Phase 21's mesh train step check at smoke width on the CPU, on a
    one-rank gloo group as ``sharding_phase`` starts one there: two mesh
    steps on the host mesh and on the (1, 1, 1) mesh bit-equal to two
    one-device steps from the same state (fp32 and bf16), and the state
    saved from the mesh restored bit-equal."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_host_mesh

    cpu = torch.device("cpu")
    cfg = smoke_config(chip_smoke.SHARD_ARCH)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        meshes = {"host": make_host_mesh(),
                  "1x1x1": init_device_mesh("cpu", (1, 1, 1),
                                            mesh_dim_names=chip_smoke
                                            .SHARD_AXES)}
        runs = {dt: chip_smoke.mesh_train_check(cpu, cfg, meshes, B=2,
                                                S=64, dtype=dt)
                for dt in (torch.float32, torch.bfloat16)}
        saved = chip_smoke.mesh_save_check(cpu, cfg, meshes["1x1x1"],
                                           tmp_path / "ckpt", B=2, S=64)
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(n)
    n_params = len(list(chip_smoke.T.init_params(
        cfg, torch.Generator().manual_seed(0), torch.float32,
        device="cpu").parameters()))
    for out in runs.values():
        for m in meshes:
            assert out[m]["leaves"] == 3 * n_params
            assert out[m]["losses"] == out["one_device"]["losses"]
            assert len(out[m]["ms"]) == chip_smoke.MESH_STEPS
    assert saved["leaves"] == 3 * n_params
    assert not (tmp_path / "ckpt").exists()


def test_phase_21_mesh_serve_check_on_a_one_rank_gloo_group(monkeypatch):
    """Phase 21's mesh serving check at smoke width on the CPU, on a
    one-rank gloo group: the prefill, 4 decode and 4 FoG steps on the host
    mesh and on the (1, 1, 1) mesh bit-equal to the one-device steps, with
    each step's counts (the kernels' wrappers stand in: they count a
    launch and the tensor-core route, as the card's do) and the head-slice
    check."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import smoke_config
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh

    ops = chip_smoke.ops
    flash, top2 = ops.flash_attention, ops.top2_confidence

    def counted_flash(*a, **kw):
        ops.launches["flash_attention"] += 1
        _build.routes["flash_attention_sm90"] += 1
        return flash(*a, **kw)

    def counted_top2(*a, **kw):
        ops.launches["top2_confidence"] += 1
        return top2(*a, **kw)

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(ops, "flash_attention", counted_flash)
    monkeypatch.setattr(ops, "top2_confidence", counted_top2)
    cpu = torch.device("cpu")
    cfg = smoke_config(chip_smoke.SHARD_ARCH).scaled(fog_groups=4)
    params = chip_smoke.bf16_model(cfg, cpu)
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        meshes = {"host": make_host_mesh(),
                  "1x1x1": init_device_mesh("cpu", (1, 1, 1),
                                            mesh_dim_names=chip_smoke
                                            .SHARD_AXES)}
        out = chip_smoke.mesh_serve_check(
            cpu, cfg, params,
            {k: (m, chip_smoke.shard_tree(params, m, chip_smoke
                                          .param_shardings(cfg, m, params)))
             for k, m in meshes.items()}, tokens)
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(n)
    steps = 1 + 2 * chip_smoke.MESH_DECODE
    for name in ("host", "1x1x1", "one_card"):
        assert out[name]["counts"] == {
            "prefill": {"launches": {"flash_attention": cfg.n_layers},
                        "routes": {"flash_attention_sm90": cfg.n_layers}},
            "decode": {"launches": {}, "routes": {}},
            "fog": {"launches": {"top2_confidence": 3}, "routes": {}}}
        assert sum(len(v) for v in out[name]["ms"].values()) == steps
    for name in ("host", "1x1x1"):
        # logits and every cache leaf each step, hops each FoG step
        assert out[name]["outputs"] == (
            steps * (1 + 2 * cfg.n_layers) + chip_smoke.MESH_DECODE)
    assert out["head_slice"] == {"q_heads": [2, 3], "kv_heads": [1, 1],
                                 "shape": [4, 32, 4, 32]}
    hops = torch.tensor(out["hops"])
    assert (hops[:, 0] == 1).all() and (hops[:, 1] == 4).all()
    assert (hops[:, 3] == chip_smoke.LM_BUDGET).all()


def test_phase_21_tensor_parallel_part_on_two_gloo_ranks():
    """Phase 21's tensor-parallel part at smoke width on the CPU: the
    top-2 partials and merge at its block cases, then two spawned gloo
    ranks on a (1, 2) ("data", "model") mesh (the ranks count launches
    with stand-ins for the card's wrappers): the prefill, 4 decode and 4
    FoG steps with each step's counts, the step parameters the sum of the
    rank's blocks, every output within the bf16 bar of the one-device
    steps, hops equal, the replicated values identical on both ranks."""
    from repro_torch.configs import smoke_config

    cpu = torch.device("cpu")
    blocks = chip_smoke.top2_block_checks(cpu)
    assert list(blocks["cases"]) == [
        f"[{b}, {c}] in {r}" for b, c, r in chip_smoke.TOP2_BLOCK_CASES]
    cfg = smoke_config(chip_smoke.SHARD_ARCH).scaled(fog_groups=4)
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0))
    out = chip_smoke.tp_serve_check(cpu, cfg, tokens, [0.0, 2.0, 2.0, 2.0],
                                    [9, 9, 9, chip_smoke.LM_BUDGET])
    n = cfg.n_layers
    for r in out["ranks"]:
        assert r["counts"][0] == {
            "launches": {"flash_attention": n},
            "routes": {"flash_attention_sm90": n}}
        assert r["counts"][1] == {"launches": {}, "routes": {}}
        assert r["counts"][-1] == {
            "launches": {"top2_confidence": 6},
            "routes": {"top2_partials": 3, "top2_merge": 3}}
        assert 0.45 * r["whole_bytes"] < r["param_bytes"] < 0.55 * r[
            "whole_bytes"]
        assert len(r["ms"]) == 1 + 2 * chip_smoke.MESH_DECODE
    # logits and 2 K/V leaves a layer, each step
    assert out["outputs"] == (1 + 2 * chip_smoke.MESH_DECODE) * (1 + 2 * n)
    assert out["bar"] <= 1.0 and out["hop_rows"] == []
    assert out["hops"] == out["one_hops"]
    assert [h[3] for h in out["hops"]] == [chip_smoke.LM_BUDGET] * 4
    assert out["identical"] > 0
