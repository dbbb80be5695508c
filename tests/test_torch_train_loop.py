"""repro_torch's LM training loop on the CPU: JAX's own convergence bars
(``tests/test_train_integration.py``, whose JAX run fails under a mesh in
jax 0.9, ROADMAP §C) on the port, bit-exact resume after a crash, the
train CLI (``--smoke --device cpu`` in-process, Mamba configs included)
and ``examples.train_lm``, Mamba resume, the update that frees as it
goes, and the refusal of fp16 training (the backward kernels take fp32
and bf16) on every device.  The comparison with
JAX's loss, gradients and steps is ``tests/test_torch_train.py``'s.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.data.lm_data import DataConfig as JDataConfig  # noqa: E402
from repro.data.lm_data import batch_at_step as jbatch_at_step  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data.lm_data import DataConfig, batch_at_step  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.carry import params_from_jax  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.loop import (check_trainable,  # noqa: E402
                                    make_train_step)

LR = 5e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small tensors: the suite runs test
    files in parallel workers, where each op's threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def tiny(configs):
    """The tiny config of ``tests/test_train_integration.py``."""
    return configs.get_arch("tinyllama-1.1b").scaled(
        name="tiny-test", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256)


def run_tiny(steps, *, compress=False, params=None, opt_state=None, start=0,
             lr=LR):
    """``tests/test_train_integration.py::_run`` in the port: the tiny
    config from the port's seed-0 init, batches of 4 x 64."""
    cfg = tiny(tconfigs)
    step_fn, init_opt = make_train_step(cfg, lr=lr, total_steps=steps,
                                        compress_pod_grads=compress,
                                        device="cpu")
    if params is None:
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32, device="cpu")
        opt_state = init_opt(params)
    dcfg = DataConfig(cfg.vocab_size, 64, 4, seed=0)
    losses = []
    for s in range(start, steps):
        b = batch_at_step(dcfg, s)
        params, opt_state, m = step_fn(params, opt_state, {
            k: torch.as_tensor(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return params, opt_state, losses


@pytest.mark.parametrize("compress,drop", [(False, 0.5), (True, 0.4)])
def test_loss_decreases(compress, drop):
    """JAX's own bars (``tests/test_train_integration.py``): 30 steps drop
    the loss by 0.5, or 0.4 with compressed gradients."""
    _, _, losses = run_tiny(30, compress=compress)
    assert losses[-1] < losses[0] - drop, (losses[0], losses[-1])


def same_state(a, b):
    (pa, oa), (pb, ob) = a, b
    na, nb = dict(pa.named_parameters()), dict(pb.named_parameters())
    assert na.keys() == nb.keys()
    assert all(torch.equal(na[k], nb[k]) for k in na)
    assert torch.equal(oa.step, ob.step)
    for m in ("mu", "nu"):
        ma, mb = getattr(oa, m), getattr(ob, m)
        assert ma.keys() == mb.keys()
        assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_resume_after_a_crash_is_bit_exact(tmp_path):
    """Crash at step 10, resume from the checkpoint: steps 10..20 equal the
    uninterrupted run bit for bit (deterministic data, the optimizer state
    saved)."""
    p1, o1, l_full = run_tiny(20)
    p2, o2, _ = run_tiny(10)
    ckpt.save(10, (p2, o2), tmp_path)
    (p3, o3), step = ckpt.restore((p2, o2), tmp_path)
    assert step == 10
    same_state((p3, o3), (p2, o2))
    p4, o4, l_resumed = run_tiny(20, params=p3, opt_state=o3, start=10)
    assert l_resumed == l_full[10:]
    same_state((p4, o4), (p1, o1))


def test_data_is_jax_data():
    """The batches the CLI trains on are JAX's ``batch_at_step``'s."""
    for step in (0, 7):
        got = batch_at_step(DataConfig(256, 64, 4, seed=3), step)
        want = jbatch_at_step(JDataConfig(256, 64, 4, seed=3), step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])


def test_step_turns_gradients_on_and_replaces_tensors():
    """The trainer's parameters require grad after a step (carried serving
    weights stay frozen until then); tensors taken before the step keep
    their values."""
    cfg = tiny(tconfigs)
    jp = JT.init_params(tiny(jconfigs), jax.random.key(0), jnp.float32)
    params = params_from_jax(np_tree(jp), cfg, device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    before = {k: p.detach() for k, p in params.named_parameters()}
    copies = {k: p.clone() for k, p in before.items()}
    step_fn, init_opt = make_train_step(cfg, lr=LR, device="cpu")
    b = batch_at_step(DataConfig(cfg.vocab_size, 16, 2), 0)
    params, _, m = step_fn(params, init_opt(params), {
        k: torch.as_tensor(v) for k, v in b.items()})
    assert all(p.requires_grad for p in params.parameters())
    assert all(torch.equal(before[k], copies[k]) for k in before)
    assert int(m["step"]) == 1 and float(m["grad_norm"]) > 0


@pytest.mark.parametrize("name", ["mamba2-2.7b", "jamba-1.5-large-398b",
                                  "tinyllama-1.1b"])
def test_bf16_training_is_refused(name):
    """The backward kernels (ssd_chunk's, flash_attention's) take fp32 and
    bf16: an fp16 model is refused before any step, on every device,
    naming the dtypes they take; fp32, float64 and bf16 pass (bf16 was
    refused too before its backwards were written), and a bf16 step keeps
    each parameter's dtype (bf16; an MoE router fp32, as JAX's) and the
    moments fp32."""
    cfg = tconfigs.smoke_config(name)
    with pytest.raises(NotImplementedError, match="take fp32 or bf16, not "
                       "torch.float16"):
        check_trainable(cfg, torch.float16)
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        check_trainable(cfg, dtype)
    step_fn, init_opt = make_train_step(cfg, device="cpu")
    b = {k: torch.as_tensor(v) for k, v in batch_at_step(
        DataConfig(cfg.vocab_size, 16, 2), 0).items()}
    half = T.init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float16, device="cpu")
    with pytest.raises(NotImplementedError, match="float16"):
        step_fn(half, init_opt(half), b)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.bfloat16, device="cpu")
    dtypes = {k: p.dtype for k, p in params.named_parameters()}
    assert torch.bfloat16 in dtypes.values()
    params, opt, m = step_fn(params, init_opt(params), b)
    assert np.isfinite(float(m["loss"])) and int(m["step"]) == 1
    assert {k: p.dtype for k, p in params.named_parameters()} == dtypes
    assert all(t.dtype == torch.float32 for t in opt.mu.values())


def mamba_steps(steps, *, params=None, opt_state=None, start=0):
    """The mamba2-2.7b smoke config from the port's seed-0 init, batches
    of 2 x 64 (two chunks)."""
    cfg = tconfigs.smoke_config("mamba2-2.7b")
    step_fn, init_opt = make_train_step(cfg, lr=LR, total_steps=steps,
                                        device="cpu")
    if params is None:
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32, device="cpu")
        opt_state = init_opt(params)
    dcfg = DataConfig(cfg.vocab_size, 64, 2, seed=0)
    losses = []
    for s in range(start, steps):
        params, opt_state, m = step_fn(params, opt_state, {
            k: torch.as_tensor(v) for k, v in batch_at_step(dcfg, s).items()})
        losses.append(float(m["loss"]))
    return params, opt_state, losses


def test_mamba_resume_is_bit_exact(tmp_path):
    """mamba2-2.7b smoke: 6 steps straight equal 3 steps, save, restore, 3
    steps bit for bit (params and optimizer state), and the loss falls."""
    p1, o1, l_full = mamba_steps(6)
    p2, o2, _ = mamba_steps(3)
    ckpt.save(3, (p2, o2), tmp_path)
    (p3, o3), step = ckpt.restore((p2, o2), tmp_path)
    assert step == 3
    same_state((p3, o3), (p2, o2))
    p4, o4, l_resumed = mamba_steps(6, params=p3, opt_state=o3, start=3)
    assert l_resumed == l_full[3:]
    same_state((p4, o4), (p1, o1))
    assert l_full[-1] < l_full[0]


@pytest.mark.parametrize("name", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_cli_trains_a_mamba_config(name, capsys):
    """``--arch <mamba config> --smoke --device cpu`` trains: the
    ``[train]`` lines and finite losses, the same on a second run."""
    args = ["--arch", name, "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "64", "--device", "cpu", "--log-every", "1"]
    a = train_cli.main(args)
    out = capsys.readouterr().out
    assert f"[train] arch={name}-smoke device=cpu B=2 S=64" in out
    assert out.count("[train] step") == 2 and "[train] done" in out
    assert all(np.isfinite(a["losses"])) and len(a["losses"]) == 2
    assert train_cli.main(args)["losses"] == a["losses"]


def test_update_frees_as_it_goes(monkeypatch):
    """The step holds no second tree: AdamW's per-leaf arithmetic runs
    once a leaf, and by then every earlier leaf's gradient has left the
    gradients (the
    remaining gradients' elements fall leaf by leaf to none at the last);
    the optimizer state passed in is the one returned, its moments
    replaced in place."""
    from repro_torch.train import loop
    cfg = tconfigs.smoke_config("mamba2-2.7b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, device="cpu")
    alive, left = {}, []
    real_adamw, real_lg = loop.adamw, loop.loss_and_grads

    def spying_adamw(**kw):
        init, update = real_adamw(**kw)
        leaf = update.leaf

        def spy(*args):
            left.append(sum(g.numel() for g in alive["grads"].values()))
            return leaf(*args)
        update.leaf = spy
        return init, update

    def spying_lg(*a):
        loss, grads = real_lg(*a)
        alive["grads"] = grads
        return loss, grads

    monkeypatch.setattr(loop, "adamw", spying_adamw)
    monkeypatch.setattr(loop, "loss_and_grads", spying_lg)
    step_fn, init_opt = make_train_step(cfg, device="cpu")
    opt_state = init_opt(params)
    mu0 = dict(opt_state.mu)
    b = batch_at_step(DataConfig(cfg.vocab_size, 64, 2), 0)
    params, out_state, _ = step_fn(params, opt_state, {
        k: torch.as_tensor(v) for k, v in b.items()})
    sizes = [p.numel() for p in params.parameters()]
    assert len(left) == len(sizes)
    assert left[0] < sum(sizes)
    assert left[-1] == 0 and all(a > b for a, b in zip(left, left[1:]))
    assert out_state is opt_state and int(opt_state.step) == 1
    assert all(opt_state.mu[k] is not mu0[k] for k in mu0)


def cli(tmp_path, *extra):
    return train_cli.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps",
                           "4", "--batch", "2", "--seq", "32", "--device",
                           "cpu", "--log-every", "1", *extra])


def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    """``--smoke --device cpu`` in-process: JAX's ``[train]`` lines, a
    heartbeat and committed checkpoints every 2 steps; after a crash that
    left step 4 uncommitted, ``--resume`` restarts from step 2 and steps
    2..3 equal the first run's bit for bit."""
    first = cli(tmp_path, "--ckpt-dir", str(tmp_path), "--ckpt-every", "2")
    out = capsys.readouterr().out
    assert "[train] arch=tinyllama-1.1b-smoke device=cpu B=2 S=32" in out
    assert out.count("[train] step") == 4 and "[train] done" in out
    assert first["steps"] == [0, 1, 2, 3]
    assert ckpt.latest_step(tmp_path) == 4
    assert (tmp_path / "hb_host0.json").exists()
    (tmp_path / "step_00000004" / "COMMIT").unlink()
    again = cli(tmp_path, "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                "--resume")
    assert "[train] resumed from step 2" in capsys.readouterr().out
    assert again["steps"] == [2, 3]
    assert again["losses"] == first["losses"][2:]
    same_state((again["params"], again["opt_state"]),
               (first["params"], first["opt_state"]))


def test_cli_trains_a_front_end_config_from_embeddings(capsys):
    """musicgen trains from embeddings drawn by a seeded generator: two
    runs give the same losses."""
    args = ["--arch", "musicgen-large", "--smoke", "--steps", "2",
            "--batch", "2", "--seq", "16", "--device", "cpu"]
    a, b = train_cli.main(args), train_cli.main(args)
    assert a["losses"] == b["losses"] and len(a["losses"]) == 2
    assert all(np.isfinite(a["losses"]))


def test_cli_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps",
                        "1"])


def test_train_lm_example_resumes(tmp_path):
    """``examples.train_lm`` at its ~100M config, cut to 2 + 1 steps of
    1 x 16 tokens: the second run resumes from the first's checkpoint."""
    from repro_torch.examples import train_lm
    cfg = train_lm.config()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (8, 768, 12, 4, 2048, 8192)
    args = ["--batch", "1", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    first = train_lm.main(["--steps", "2", *args])
    assert first["start"] == 0 and len(first["losses"]) == 2
    second = train_lm.main(["--steps", "3", *args])
    assert second["start"] == 2 and len(second["losses"]) == 1
    assert ckpt.latest_step(tmp_path) == 3
