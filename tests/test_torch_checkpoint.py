"""repro_torch's training checkpoints and fault tools against the JAX
package's, on the CPU: the carry of parameters and optimizer state back
to JAX's layout (``params_to_jax`` ∘ ``params_from_jax`` is the
identity), checkpoints that cross between the packages in both
directions bit for bit, JAX's directory layout and commit protocol, and
the heartbeat / restart planning of ``train/fault.py``."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.optim as jopt  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import fault as jfault  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.models.carry import (opt_state_from_jax,  # noqa: E402
                                      opt_state_to_jax, params_from_jax,
                                      params_to_jax)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import fault  # noqa: E402
from repro_torch.train.loop import make_train_step  # noqa: E402

# attention; MLA + MoE + shared expert + dense prefix + MTP; Mamba + MoE
# in the hybrid period; embeddings in
CARRY = ["tinyllama-1.1b", "deepseek-v3-671b", "jamba-1.5-large-398b",
         "musicgen-large"]
# the configs whose checkpoints cross after a port train step: attention,
# MLA + MoE + MTP, Mamba, and Mamba + attention + MoE
CROSS = CARRY[:2] + ["mamba2-2.7b", "jamba-1.5-large-398b"]


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


def init(jcfg, seed, dtype=jnp.float32):
    """JAX's ``init_params`` jitted (one compile, not one per op)."""
    return jax.jit(lambda k: JT.init_params(jcfg, k, dtype))(
        jax.random.key(seed))


def same_tree(got, want):
    """Equal structure and bits, leaf for leaf."""
    g_flat, g_def = jax.tree_util.tree_flatten(got)
    w_flat, w_def = jax.tree_util.tree_flatten(np_tree(want))
    assert g_def == w_def
    for g, w in zip(g_flat, w_flat):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CARRY)
def test_params_to_jax_inverts_params_from_jax(name, dtype):
    jcfg, tcfg = jconfigs.smoke_config(name), tconfigs.smoke_config(name)
    tree = np_tree(init(jcfg, 4, getattr(jnp, dtype)))
    same_tree(params_to_jax(params_from_jax(tree, tcfg, device="cpu"),
                            tcfg), tree)


def test_carry_refuses_another_configs_tree():
    tree = np_tree(init(jconfigs.smoke_config("tinyllama-1.1b"), 0))
    other = tconfigs.smoke_config("tinyllama-1.1b").scaled(n_layers=3)
    with pytest.raises(ValueError, match="stack"):
        params_from_jax(tree, other, device="cpu")


def jax_state(name, seed=0):
    """JAX params and an AdamW state after one update from random grads."""
    jcfg = jconfigs.smoke_config(name)
    params = init(jcfg, seed)
    init_opt, update = jopt.adamw(lr=1e-3, weight_decay=0.1)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    grads = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(rng.normal(size=p.shape).astype(np.float32))
        for p in leaves])
    return jax.jit(lambda g, p: update(g, init_opt(p), p))(grads, params)


@pytest.mark.parametrize("name", CARRY[:2])
def test_opt_state_carries_both_ways(name):
    _, state = jax_state(name)
    port = opt_state_from_jax(np_tree(state), device="cpu")
    assert port.step.dtype == torch.int32 and int(port.step) == 1
    back = opt_state_to_jax(port)
    same_tree(back["mu"], state.mu)
    same_tree(back["nu"], state.nu)
    assert back["step"] == np.asarray(state.step)


def port_template(name):
    """A port model and optimizer state of ``name``'s smoke config, from
    the port's own init (other values than JAX's)."""
    cfg = tconfigs.smoke_config(name)
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, torch.Generator().manual_seed(9),
                           torch.float32, device="cpu")
    _, init_opt = make_train_step(cfg, device="cpu")
    return cfg, params, init_opt(params)


@pytest.mark.parametrize("name", CROSS)
def test_a_jax_checkpoint_restores_in_the_port(name, tmp_path):
    params, state = jax_state(name, seed=1)
    jckpt.save(7, (params, state), tmp_path)
    cfg, tp, to = port_template(name)
    (rp, ro), step = ckpt.restore((tp, to), tmp_path)
    assert step == 7
    same_tree(params_to_jax(rp), params)
    back = opt_state_to_jax(ro)
    same_tree(back["mu"], state.mu)
    same_tree(back["nu"], state.nu)
    assert int(ro.step) == 1 and ro.step.dtype == torch.int32


@pytest.mark.parametrize("name", CROSS)
def test_a_port_checkpoint_restores_in_jax(name, tmp_path):
    """The port's model and state after a train step, saved by the port,
    restored by JAX's ``restore`` into its own tree."""
    cfg, tp, to = port_template(name)
    step_fn, _ = make_train_step(cfg, lr=1e-3, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)))
             for k in ("tokens", "labels")}
    tp, to, _ = step_fn(tp, to, batch)
    ckpt.save(3, (tp, to), tmp_path)
    jparams, jstate = jax_state(name)
    (rp, ro), step = jckpt.restore((jparams, jstate), tmp_path)
    assert step == 3
    same_tree(np_tree(rp), params_to_jax(tp))
    back = opt_state_to_jax(to)
    same_tree(np_tree(ro.mu), back["mu"])
    same_tree(np_tree(ro.nu), back["nu"])
    assert int(ro.step) == 1


def test_layout_and_meta_are_jax_s(tmp_path):
    """The same tree saved by both packages: the same files, the same keys
    (``0/stack/pos0/attn/wq``, ``1/mu/embed``, ``1/step`` ...), shapes and
    dtypes in ``meta.json``, the same bytes in every array."""
    name = "deepseek-v3-671b"
    params, state = jax_state(name)
    jckpt.save(5, (params, state), tmp_path / "jax")
    tcfg = tconfigs.smoke_config(name)
    ckpt.save(5, (params_from_jax(np_tree(params), tcfg, device="cpu"),
                  opt_state_from_jax(np_tree(state), device="cpu")),
              tmp_path / "port")
    dirs = [tmp_path / w / "step_00000005" for w in ("jax", "port")]
    assert [sorted(p.name for p in d.iterdir()) for d in dirs] == [
        ["COMMIT", "meta.json", "shard_0.npz"]] * 2
    metas = [json.loads((d / "meta.json").read_text()) for d in dirs]
    for m in metas:
        m.pop("time")
    assert metas[0] == metas[1]
    assert "0/stack/pos0/attn/w_dq" in metas[0]["keys"]
    assert {"1/step", "1/mu/embed", "0/mtp/proj"} <= set(metas[0]["keys"])
    with np.load(dirs[0] / "shard_0.npz") as a, \
            np.load(dirs[1] / "shard_0.npz") as b:
        assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)


def small_tree():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "n": [torch.tensor(3, dtype=torch.int32)]}


def test_commit_protocol_and_gc(tmp_path):
    """``keep`` committed steps stay; an uncommitted step is removed on
    restore; the newest committed step restores; an async write returns
    its thread."""
    tree = small_tree()
    assert ckpt.latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tree, tmp_path)
    for s in (1, 2, 3, 4):
        ckpt.save(s, {"w": tree["w"] + s, "n": tree["n"]}, tmp_path, keep=2)
    assert sorted(d.name for d in tmp_path.glob("step_*")) == [
        "step_00000003", "step_00000004"]
    t = ckpt.save(5, tree, tmp_path, async_write=True, keep=5)
    t.join()
    (tmp_path / "step_00000005" / "COMMIT").unlink()   # a torn write
    got, step = ckpt.restore(tree, tmp_path)
    assert step == 4 and not (tmp_path / "step_00000005").exists()
    assert torch.equal(got["w"], tree["w"] + 4)
    assert isinstance(got["n"], list) and int(got["n"][0]) == 3
    got, step = ckpt.restore(tree, tmp_path, step=3)
    assert torch.equal(got["w"], tree["w"] + 3)


def test_restore_refuses_another_shape(tmp_path):
    ckpt.save(1, small_tree(), tmp_path)
    with pytest.raises(ValueError, match="w:"):
        ckpt.restore({"w": torch.zeros(3, 2), "n": [torch.tensor(0)]},
                     tmp_path)


def test_async_save_snapshots_at_the_call(tmp_path):
    """The host copy is taken when ``save`` is called: a later in-place
    change of the tensor is not written."""
    tree = small_tree()
    t = ckpt.save(1, tree, tmp_path, async_write=True)
    tree["w"].add_(100.0)
    t.join()
    got, _ = ckpt.restore(small_tree(), tmp_path)
    assert torch.equal(got["w"], small_tree()["w"])


def test_fault_tools_plan_as_jax_does(tmp_path):
    """Heartbeats written by the port are read by JAX's monitor and the
    other way round; both plan the same restart (dead hosts, stragglers,
    the data extent, the newest committed checkpoint)."""
    fault.Heartbeat(str(tmp_path), "host0").beat(100)
    jfault.Heartbeat(str(tmp_path), "host1").beat(40)
    fault.Heartbeat(str(tmp_path), "host2").beat(99)
    (tmp_path / "hb_host3.json").write_text("{torn")
    ckpt.save(50, small_tree(), tmp_path)
    hb = json.loads((tmp_path / "hb_host2.json").read_text())
    now = hb["time"] + 30
    old = json.loads((tmp_path / "hb_host0.json").read_text())
    old["time"] -= 100
    (tmp_path / "hb_host0.json").write_text(json.dumps(old))
    got = fault.FleetMonitor(str(tmp_path), timeout=60).plan(now=now)
    want = jfault.FleetMonitor(str(tmp_path), timeout=60).plan(now=now)
    assert got.__dict__ == want.__dict__
    assert got.dead_hosts == ["host0"] and got.stragglers == ["host1"]
    assert got.restore_step == 50


def test_one_data_key_definition():
    """``train.fault.deterministic_data_key`` is ``data.lm_data``'s, and
    equals JAX's."""
    assert fault.deterministic_data_key is lm_data.deterministic_data_key
    for seed, step in ((0, 0), (3, 17), (12345, 10**6)):
        assert (fault.deterministic_data_key(seed, step)
                == jfault.deterministic_data_key(seed, step))
