"""bf16 training checkpoints in the JAX package's on-disk layout, on the
CPU.

JAX's ``save`` writes a bf16 leaf as numpy writes ``ml_dtypes``' bfloat16:
2-byte void elements (``'<V2'`` in the ``.npy`` header) and ``"bfloat16"``
in ``meta.json``'s ``dtypes``.  The port writes the same file, leaf by
leaf byte for byte, without ``ml_dtypes``, and restores it by the dtype in
``meta.json``: its own files, JAX's (which JAX's own ``restore`` cannot
read back: ``astype`` has no cast from the void elements), and both in a
process that never loads ``ml_dtypes`` or JAX.  A bf16 resume is bit-exact.
"""
import json
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.optim as jopt  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data.lm_data import DataConfig, batch_at_step  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.carry import (opt_state_from_jax,  # noqa: E402
                                      opt_state_to_jax, params_from_jax,
                                      params_to_jax)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.loop import make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# attention; Mamba; Mamba + attention + MoE (its router stays fp32)
CONFIGS = ["tinyllama-1.1b", "mamba2-2.7b", "jamba-1.5-large-398b"]


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


def jax_state(name):
    """JAX's bf16 params and AdamW state after one step of its update on
    the gradient of a batch (so the moments are not zeros)."""
    jcfg = jconfigs.smoke_config(name)
    params = JT.init_params(jcfg, jax.random.key(3), jnp.bfloat16)
    init, update = jopt.adamw(lr=1e-3, weight_decay=0.1)
    b = batch_at_step(DataConfig(jcfg.vocab_size, 64, 2, seed=0), 0)

    def step(p, s, b):
        g = jax.grad(lambda p: JT.lm_loss(p, jcfg, tokens=b["tokens"],
                                          labels=b["labels"]))(p)
        return update(g, s, p)

    return jax.jit(step)(params, init(params),
                         {k: jnp.asarray(v) for k, v in b.items()})


def same_tree(got, want):
    """Equal structure, dtypes and bits, leaf for leaf."""
    g_flat, g_def = jax.tree_util.tree_flatten(got)
    w_flat, w_def = jax.tree_util.tree_flatten(np_tree(want))
    assert g_def == w_def
    for g, w in zip(g_flat, w_flat):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("name", CONFIGS)
def test_bf16_file_equals_jax_s_leaf_by_leaf(name, tmp_path):
    """The same bf16 tree saved by both packages: the same members in the
    ``.npz``, each the same bytes (header included), and the same
    ``meta.json`` but for its time."""
    params, state = jax_state(name)
    jckpt.save(4, (params, state), tmp_path / "jax")
    ckpt.save(4, (params_from_jax(np_tree(params), tconfigs.smoke_config(
        name), device="cpu"), opt_state_from_jax(np_tree(state),
                                                 device="cpu")),
              tmp_path / "port")
    dirs = [tmp_path / w / "step_00000004" for w in ("jax", "port")]
    metas = [json.loads((d / "meta.json").read_text()) for d in dirs]
    for m in metas:
        m.pop("time")
    assert metas[0] == metas[1]
    assert "bfloat16" in metas[0]["dtypes"].values()
    assert metas[0]["dtypes"]["1/mu/embed"] == "float32"
    with zipfile.ZipFile(dirs[0] / "shard_0.npz") as a, \
            zipfile.ZipFile(dirs[1] / "shard_0.npz") as b:
        assert sorted(a.namelist()) == sorted(b.namelist())
        for member in a.namelist():
            assert a.read(member) == b.read(member), member


@pytest.mark.parametrize("name", CONFIGS)
def test_the_port_restores_jax_s_bf16_file(name, tmp_path):
    params, state = jax_state(name)
    jckpt.save(2, (params, state), tmp_path)
    cfg = tconfigs.smoke_config(name)
    tp = T.init_params(cfg, torch.Generator().manual_seed(9),
                       torch.bfloat16, device="cpu")
    to = make_train_step(cfg, device="cpu")[1](tp)
    (rp, ro), step = ckpt.restore((tp, to), tmp_path)
    assert step == 2
    same_tree(params_to_jax(rp), params)
    back = opt_state_to_jax(ro)
    same_tree(back["mu"], state.mu)
    same_tree(back["nu"], state.nu)
    assert int(ro.step) == 1


SUBPROCESS = """
import sys
import torch
from repro_torch import configs
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import make_train_step

cfg = configs.smoke_config("jamba-1.5-large-398b")
p = T.init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16,
                  device="cpu")
o = make_train_step(cfg, device="cpu")[1](p)
ckpt.save(1, (p, o), sys.argv[1])
like = T.init_params(cfg, torch.Generator().manual_seed(1), torch.bfloat16,
                     device="cpu")
(rp, ro), step = ckpt.restore((like, o), sys.argv[1])
(jp, _), _ = ckpt.restore((like, o), sys.argv[2])
for a, b, c in zip(p.parameters(), rp.parameters(), jp.parameters()):
    assert a.dtype == b.dtype and torch.equal(a, b), "own file"
    assert c.dtype == a.dtype, "JAX's file"
assert any(a.dtype == torch.bfloat16 for a in rp.parameters())
assert "ml_dtypes" not in sys.modules and "jax" not in sys.modules
print("restored", step)
"""


def test_save_and_restore_need_no_ml_dtypes(tmp_path):
    """In a process that imports neither ``ml_dtypes`` nor JAX (as on the
    card's machine): the port saves and restores a bf16 model and its
    optimizer state, and restores a bf16 file JAX wrote."""
    params, state = jax_state("jamba-1.5-large-398b")
    jckpt.save(1, (params, state), tmp_path / "jax")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", SUBPROCESS, str(tmp_path / "port"),
         str(tmp_path / "jax")], env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "restored 1" in out.stdout


def same_state(a, b):
    (pa, oa), (pb, ob) = a, b
    for (ka, ta), (kb, tb) in zip(pa.named_parameters(),
                                  pb.named_parameters()):
        assert ka == kb and ta.dtype == tb.dtype and torch.equal(ta, tb), ka
    assert torch.equal(oa.step, ob.step)
    for m in ("mu", "nu"):
        for k, t in getattr(oa, m).items():
            assert torch.equal(t, getattr(ob, m)[k]), (m, k)


def bf16_steps(cfg, n, params=None, opt_state=None, start=0):
    step_fn, init_opt = make_train_step(cfg, lr=5e-3, warmup=1,
                                        total_steps=4, device="cpu")
    if params is None:
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.bfloat16, device="cpu")
        opt_state = init_opt(params)
    dcfg = DataConfig(cfg.vocab_size, 64, 2, seed=0)
    losses = []
    for s in range(start, n):
        params, opt_state, m = step_fn(params, opt_state, {
            k: torch.as_tensor(v) for k, v in batch_at_step(dcfg, s).items()})
        losses.append(float(m["loss"]))
    return params, opt_state, losses


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "mamba2-2.7b"])
def test_bf16_resume_is_bit_exact(name, tmp_path):
    """Four bf16 steps straight equal two steps, save, restore, two steps,
    bit for bit: losses, bf16 params, fp32 moments."""
    cfg = tconfigs.smoke_config(name)
    p1, o1, l_full = bf16_steps(cfg, 4)
    p2, o2, _ = bf16_steps(cfg, 2)
    ckpt.save(2, (p2, o2), tmp_path)
    like = T.init_params(cfg, torch.Generator().manual_seed(5),
                         torch.bfloat16, device="cpu")
    (p3, o3), step = ckpt.restore((like, make_train_step(
        cfg, device="cpu")[1](like)), tmp_path)
    assert step == 2
    same_state((p3, o3), (p2, o2))
    p4, o4, l_resumed = bf16_steps(cfg, 4, p3, o3, start=2)
    assert l_resumed == l_full[2:]
    same_state((p4, o4), (p1, o1))
    assert all(p.dtype == torch.bfloat16 for p in p4.parameters())
