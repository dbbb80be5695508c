"""repro_torch's dry-run tools on the CPU: ``launch/cost.py``'s
``analytic_model_flops`` and ``train/loop.py``'s ``input_specs`` and
``shape_supported`` against the JAX package's for every config and shape;
``launch/dryrun.py``'s counts on the meta device against the same step
run on the CPU at smoke configs, the attention kernels' stand-ins on both
(FLOPs equal; parameter and moment bytes equal to the CPU model's and
``init_opt``'s); the stand-ins' outputs and work against the plain
attention's and ``launch.roofline``'s; the CLI's records."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch.hlo_cost import (  # noqa: E402
    analytic_model_flops as janalytic)
from repro.train import loop as jloop  # noqa: E402
from repro_torch.configs import ARCHS, get_arch, smoke_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cost import (RooflineTerms,  # noqa: E402
                                     analytic_model_flops)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.roofline import (H100_SXM_BF16, bwd_work,  # noqa: E402
                                         flash_work)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import MetaDraws  # noqa: E402
from repro_torch.train.loop import (SHAPES, ShapeSpec,  # noqa: E402
                                    input_specs, make_train_step,
                                    shape_supported)

CELLS = [(a, s) for a in sorted(JARCHS) for s in jloop.SHAPES]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small tensors: the suite runs test
    files in parallel workers, where each op's threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_same_configs_and_shapes():
    assert sorted(ARCHS) == sorted(JARCHS) and len(ARCHS) == 10
    assert {k: tuple(v.__dict__.values()) for k, v in SHAPES.items()} == {
        k: tuple(v.__dict__.values()) for k, v in jloop.SHAPES.items()}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_tools_equal_jax(arch, shape):
    """``analytic_model_flops``, ``input_specs`` (shapes and dtypes, the
    default bf16 and fp32 embeddings) and ``shape_supported``."""
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    assert analytic_model_flops(cfg, shape) == janalytic(jcfg, shape)
    import jax.numpy as jnp
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        got = input_specs(cfg, shape, tdt)
        want = jloop.input_specs(jcfg, shape, jdt)
        assert list(got) == list(want)
        for k, (sh, dt) in got.items():
            assert sh == tuple(want[k].shape), k
            assert str(dt).removeprefix("torch.") == str(want[k].dtype), k
    assert shape_supported(cfg, shape) == jloop.shape_supported(jcfg, shape)


def test_roofline_terms():
    t = RooflineTerms("a", "s", counted_flops=2 * 989e12,
                      counted_bytes=3.35e12, model_flops=989e12)
    assert t.spec is H100_SXM_BF16
    assert (t.compute_s, t.memory_s) == (2.0, 1.0)
    assert t.dominant == "compute" and t.step_time_s == 2.0
    assert t.useful_flops_ratio == 0.5 and t.roofline_fraction == 0.5


# smoke configs of each mixer and FFN kind (attention, Mamba-2, MLA + MoE
# + MTP, MoE, the hybrid period, embeddings in)
SMOKE = ["tinyllama-1.1b", "mamba2-2.7b", "deepseek-v3-671b", "grok-1-314b",
         "jamba-1.5-large-398b", "musicgen-large"]
SMALL = {"train": ShapeSpec("t", "train", 16, 2),
         "prefill": ShapeSpec("p", "prefill", 16, 2),
         "decode": ShapeSpec("d", "decode", 16, 2)}


@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("name", SMOKE)
def test_meta_counts_equal_cpu(monkeypatch, name, kind):
    """The step's FLOPs on meta equal those of the same step run on the
    CPU with the attention kernels' stand-ins there too, and the
    parameter, gradient, moment and cache bytes are the CPU model's (and
    ``init_opt``'s)."""
    cfg, sp = smoke_config(name), SMALL[kind]
    meta = T.init_params(cfg, MetaDraws(), torch.bfloat16, device="meta")
    cpu = T.init_params(cfg, torch.Generator().manual_seed(0),
                        torch.bfloat16, device="cpu")
    got = dryrun.count_step(cfg, sp, meta)
    monkeypatch.setattr(ops, "_stands_in", lambda t: True)
    want = dryrun.count_step(cfg, sp, cpu)
    assert got["counted_flops"] == want["counted_flops"] > 0
    assert got["attention_flops"] == want["attention_flops"]
    # the bytes within 1e-6: a few 0-d operands (Python scalars) are
    # wrapped on one device and not the other (deepseek's train step parts
    # by 16 of 2.3e8 bytes)
    assert got["counted_bytes"] == pytest.approx(want["counted_bytes"],
                                                 rel=1e-6)
    nbytes = sum(p.numel() * p.element_size() for p in cpu.parameters())
    assert got["param_bytes"] == want["param_bytes"] == nbytes
    assert got["cache_bytes"] == want["cache_bytes"]
    assert (got["cache_bytes"] > 0) == (kind != "train")
    if kind == "train":
        state = make_train_step(cfg, device="cpu")[1](cpu)
        moments = sum(t.numel() * t.element_size()
                      for m in (state.mu, state.nu) for t in m.values())
        assert got["moment_bytes"] == moments == 2 * 4 * sum(
            p.numel() for p in cpu.parameters())
        assert got["grad_bytes"] == nbytes
    assert got["peak_bytes"] >= got["held_bytes"] >= got["param_bytes"]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_stand_ins_have_the_kernels_outputs_and_work(causal,
                                                               dtype):
    """On meta, ``flash_attention``'s forward and backward allocate what
    the plain versions return on the CPU (shapes and dtypes; lse fp32
    ``[B, H, Sq]``) and nothing else, and ``stand_in_work`` prices them
    as ``flash_work`` and ``bwd_work``: the products over the live pairs,
    each input read once."""
    B, Sq, Sk, H, K, D, Dv = 2, 5, 7, 4, 2, 8, 6
    gen = torch.Generator().manual_seed(0)
    cpu = [torch.randn(sh, generator=gen).to(dtype).requires_grad_()
           for sh in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, Dv))]
    meta = [t.detach().to("meta").requires_grad_() for t in cpu]
    outs = {}
    ops.stand_in_calls = calls = []
    try:
        for where, (q, k, v) in (("cpu", cpu), ("meta", meta)):
            o = ops.flash_attention(q, k, v, causal=causal)
            grads = torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
            outs[where] = [(t.shape, t.dtype, t.device.type)
                           for t in (o, *grads)]
    finally:
        ops.stand_in_calls = None
    assert [(sh, dt) for sh, dt, _ in outs["meta"]] == [
        (sh, dt) for sh, dt, _ in outs["cpu"]]
    assert {d for *_, d in outs["meta"]} == {"meta"}
    lse = ops._flash_forward(*meta, causal, None, True)[1]
    assert (lse.shape, lse.dtype) == ((B, H, Sq), torch.float32)
    assert [c[0] for c in calls] == ["flash_attention", "flash_attention_bwd"]
    item = cpu[0].element_size()
    fwd = flash_work(B, Sq, Sk, H, K, D, Dv, item, causal)
    bwd = bwd_work(B, Sq, Sk, H, K, D, Dv, causal)
    qkv = item * B * (Sq * H * D + Sk * K * (D + Dv))
    o_do_lse = item * B * Sq * H * Dv * 2 + 4 * B * H * Sq
    assert dryrun.stand_in_work(calls) == {
        "flops": fwd["ops"] + bwd["ops"], "bytes": qkv + qkv + o_do_lse}


def test_accumulation_counts_one_microbatch_times_k():
    """k microbatches: k times one microbatch's FLOPs and bytes, beside a
    float32 accumulator tree."""
    cfg = smoke_config("tinyllama-1.1b")
    meta = T.init_params(cfg, MetaDraws(), torch.bfloat16, device="meta")
    whole = dryrun.count_step(cfg, SMALL["train"], meta, accum_steps=2)
    half = dryrun.count_step(cfg, ShapeSpec("h", "train", 16, 1), meta)
    assert whole["counted_flops"] == 2 * half["counted_flops"]
    assert whole["counted_bytes"] == 2 * half["counted_bytes"]
    assert whole["accumulator_bytes"] == 4 * sum(
        p.numel() for p in meta.parameters())
    assert half["accumulator_bytes"] == 0
    with pytest.raises(ValueError, match="does not divide"):
        dryrun.count_step(cfg, SMALL["train"], meta, accum_steps=3)


def test_cli_records(tmp_path, capsys):
    """``--arch --shape --out``: a full-width cell on meta gets its
    record; a cell ``shape_supported`` refuses is skipped with JAX's
    reason."""
    out = tmp_path / "cells.jsonl"
    for arch, shape in (("mamba2-2.7b", "long_500k"),
                        ("tinyllama-1.1b", "long_500k")):
        assert dryrun.main(["--arch", arch, "--shape", shape,
                            "--out", str(out)]) == 0
    ran, skipped = map(json.loads, out.read_text().splitlines())
    assert not ran["skipped"] and ran["device"] == "meta"
    assert ran["model_flops"] == janalytic(jget_arch("mamba2-2.7b"),
                                           "long_500k")
    assert ran["fits_80gb"] and ran["peak_bytes"] > ran["param_bytes"] > 0
    assert skipped == {"arch": "tinyllama-1.1b", "shape": "long_500k",
                       "skipped": True,
                       "why": jloop.shape_supported(
                           jget_arch("tinyllama-1.1b"), "long_500k")[1]}
    assert "skipped" in capsys.readouterr().out
