"""repro_torch's gradient accumulation (``make_train_step(...,
accum_steps=k)``) on the CPU against the JAX package's.

The oracle is JAX's accumulation (``src/repro/train/loop.py:156-175``)
composed outside a mesh: per microbatch ``jax.value_and_grad`` of
``lm_loss(remat=True)`` (jitted), the losses summed from a float32 zero
and the gradients added into a float32 zero tree in microbatch order,
both times ``1 / k``, then ``clip_by_global_norm`` and AdamW.  JAX's own
scan calls ``constrain_batch``, which asserts under explicit mesh axes
in jax 0.9 (ROADMAP §C), so its body is composed here as
``tests/test_torch_train.py`` composes the step's.

Bars, those of one step in ``tests/test_torch_train.py`` (fp32: the loss
and the global norm within rtol 1e-5, every accumulated gradient leaf
within 1e-5 of its scale, the params and moments after the step within
1e-3 of a leaf's scale plus 1e-7) and ``tests/test_torch_train_bf16.py``
(bf16: the loss within rtol 1e-2 of JAX's, and the loss and every
accumulated gradient leaf no farther from the fp32 oracle than twice
JAX's bf16 run, plus half a bf16 ulp).  The accumulation's arithmetic is
held bit for bit: JAX's bf16 microbatch gradients carried into the
port's step give JAX's params and moments exactly.  ``accum_steps=1`` is
the step without accumulation, bit for bit.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.optim as jopt  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data.lm_data import DataConfig, batch_at_step  # noqa: E402
from repro_torch.models.carry import (named_to_tree,  # noqa: E402
                                      opt_state_to_jax, params_from_jax,
                                      params_to_jax, tree_to_named)
from repro_torch.train import loop  # noqa: E402
from repro_torch.train.loop import (accumulated_grads,  # noqa: E402
                                    apply_update, loss_and_grads,
                                    make_train_step)

B, S = 4, 32
LR, WARMUP, TOTAL = 5e-3, 1, 30
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5
STEP_TOL, STEP_ATOL = 1e-3, 1e-7
BF16_LOSS_RTOL, FLOOR = 1e-2, 2.0 ** -9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small tensors: the suite runs test
    files in parallel workers, where each op's threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs():
    """The tiny tinyllama of ``tests/test_train_integration.py``."""
    return tuple(c.get_arch("tinyllama-1.1b").scaled(
        name="tiny-test", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256) for c in (jconfigs, tconfigs))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def batch(cfg) -> dict:
    return batch_at_step(DataConfig(cfg.vocab_size, S, B, seed=0), 0)


def leaves(got, want):
    """(path, port leaf, JAX leaf) for every leaf of JAX's tree."""
    for path, w in jax.tree_util.tree_flatten_with_path(np_tree(want))[0]:
        g = got
        for p in path:
            g = g[getattr(p, "key", getattr(p, "idx", None))]
        yield jax.tree_util.keystr(path), np.asarray(g), np.asarray(w)


def leaf_close(got, want, tol, atol=0.0, what=""):
    for where, g, w in leaves(got, want):
        assert g.shape == w.shape, where
        scale = float(np.abs(w.astype(np.float32)).max())
        np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32),
                                   rtol=0, atol=tol * scale + atol,
                                   err_msg=f"{what} {where}")


def jax_loss(jcfg):
    def loss(params, b):
        return JT.lm_loss(params, jcfg, tokens=b["tokens"],
                          labels=b["labels"], remat=True)
    return loss


_GRAD_FNS: dict = {}


def jax_accumulate(jcfg, params, b, k):
    """JAX's ``grads_of`` with ``accum_steps = k``: the microbatches in
    order, the float32 sums, then ``* (1 / k)``; also each microbatch's
    own (loss, gradients).  One jitted ``value_and_grad`` serves every
    test (its compiles are most of this file's time)."""
    if jcfg not in _GRAD_FNS:
        _GRAD_FNS[jcfg] = jax.jit(jax.value_and_grad(jax_loss(jcfg)))
    grad_fn = _GRAD_FNS[jcfg]
    micro = {n: jnp.asarray(v).reshape(k, v.shape[0] // k, *v.shape[1:])
             for n, v in b.items()}
    loss = jnp.zeros(())
    acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    each = []
    for i in range(k):
        l, g = grad_fn(params, {n: v[i] for n, v in micro.items()})
        each.append((l, g))
        loss = loss + l
        acc = jax.tree.map(lambda a, x: a + x, acc, g)
    inv = 1.0 / k
    return loss * inv, jax.tree.map(lambda x: x * inv, acc), each


def jax_update(clip):
    init, update = jopt.adamw(lr=jopt.linear_warmup_cosine(LR, WARMUP, TOTAL),
                              b1=0.9, b2=0.95, weight_decay=0.1)

    def step(params, state, grads):
        grads, gnorm = jopt.clip_by_global_norm(grads, clip)
        params, state = update(grads, state, params)
        return params, state, gnorm
    return init, step


@pytest.mark.parametrize("k", [2, 4])
def test_fp32_accumulated_step_matches_jax(k):
    """The accumulated loss and gradients, then the step's global norm,
    params and moments, against JAX's composed accumulation."""
    jcfg, tcfg = configs()
    b = batch(tcfg)
    jp = JT.init_params(jcfg, jax.random.key(0), jnp.float32)
    jloss, jgrads, _ = jax_accumulate(jcfg, jp, b, k)
    init, update = jax_update(1.0)
    jp2, js2, jnorm = jax.jit(update)(jp, init(jp), jgrads)

    tp = params_from_jax(np_tree(jp), tcfg, device="cpu")
    tb = {n: torch.as_tensor(v) for n, v in b.items()}
    tloss, tgrads = accumulated_grads(tp, tcfg, tb, k)
    assert all(g.dtype == torch.float32 for g in tgrads.values())
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    leaf_close(named_to_tree(tgrads), jgrads, GRAD_TOL, what=f"k={k} grads")

    step, tinit = make_train_step(tcfg, lr=LR, warmup=WARMUP,
                                  total_steps=TOTAL, device="cpu",
                                  accum_steps=k)
    tp, ts, m = step(tp, tinit(tp), tb)
    assert float(m["loss"]) == float(tloss)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jnorm),
                               rtol=LOSS_RTOL)
    leaf_close(params_to_jax(tp), jp2, STEP_TOL, STEP_ATOL, f"k={k} params")
    to = opt_state_to_jax(ts)
    assert int(to["step"]) == int(js2.step) == 1
    leaf_close(to["mu"], js2.mu, STEP_TOL, STEP_ATOL, f"k={k} mu")
    leaf_close(to["nu"], js2.nu, STEP_TOL, STEP_ATOL, f"k={k} nu")


def distance(a, oracle) -> float:
    a, oracle = (np.asarray(np.asarray(t, np.float32), np.float64)
                 for t in (a, oracle))
    return float(np.linalg.norm(a - oracle) / (np.linalg.norm(oracle)
                                                or 1.0))


@pytest.mark.parametrize("k", [2, 4])
def test_bf16_accumulated_grads_within_twice_jax_distance(k):
    """bf16 params: the port's accumulated loss and float32 gradients no
    farther from the fp32 oracle (JAX's accumulation from the same
    params upcast) than twice JAX's bf16 accumulation, plus ``FLOOR``."""
    jcfg, tcfg = configs()
    b = batch(tcfg)
    jp = JT.init_params(jcfg, jax.random.key(0), jnp.bfloat16)
    jloss, jgrads, _ = jax_accumulate(jcfg, jp, b, k)
    oloss, ograds, _ = jax_accumulate(
        jcfg, jax.tree.map(lambda x: x.astype(jnp.float32), jp), b, k)
    tp = params_from_jax(np_tree(jp), tcfg, device="cpu")
    tloss, tgrads = accumulated_grads(
        tp, tcfg, {n: torch.as_tensor(v) for n, v in b.items()}, k)
    tloss, jloss, oloss = map(float, (tloss, jloss, oloss))
    np.testing.assert_allclose(tloss, jloss, rtol=BF16_LOSS_RTOL)
    assert abs(tloss - oloss) <= 2 * abs(jloss - oloss) + FLOOR * abs(oloss)
    got = named_to_tree(tgrads)
    for (where, g, o), (_, _, j) in zip(leaves(got, ograds),
                                        leaves(got, jgrads)):
        assert g.dtype == j.dtype == np.float32, where
        assert distance(g, o) <= 2 * distance(j, o) + FLOOR, where


@pytest.mark.parametrize("k", [2, 4])
def test_bf16_accumulation_is_jax_bit_for_bit(monkeypatch, k):
    """JAX's bf16 microbatch gradients carried into the port's step (its
    ``loss_and_grads`` replaced by them, in order): the accumulation (bf16
    promoted by the float32 add, the sums in microbatch order, ``* 1/k``)
    and the update give JAX's bf16 params, fp32 moments and step exactly,
    the gradients reaching the clip already in float32 (clip inactive:
    the global norms' sums run in other orders)."""
    jcfg, tcfg = configs()
    b = batch(tcfg)
    jp = JT.init_params(jcfg, jax.random.key(1), jnp.bfloat16)
    jloss, jgrads, each = jax_accumulate(jcfg, jp, b, k)
    init, update = jax_update(1e9)
    with jax.disable_jit():
        jp2, js2, _ = update(jp, init(jp), jgrads)

    carried = iter([(torch.tensor(float(l)), tree_to_named(np_tree(g), "cpu"))
                    for l, g in each])
    seen = []

    def from_jax(params, cfg, mb):
        seen.append({n: v.shape for n, v in mb.items()})
        return next(carried)

    monkeypatch.setattr(loop, "loss_and_grads", from_jax)
    tp = params_from_jax(np_tree(jp), tcfg, device="cpu")
    step, tinit = make_train_step(tcfg, lr=LR, warmup=WARMUP,
                                  total_steps=TOTAL, clip_norm=1e9,
                                  device="cpu", accum_steps=k)
    tp, ts, m = step(tp, tinit(tp),
                     {n: torch.as_tensor(v) for n, v in b.items()})
    assert seen == [{"tokens": (B // k, S), "labels": (B // k, S)}] * k
    assert float(m["loss"]) == float(jloss)
    want = {"params": np_tree(jp2), "mu": np_tree(js2.mu),
            "nu": np_tree(js2.nu)}
    got = {"params": params_to_jax(tp), **opt_state_to_jax(ts)}
    assert int(got["step"]) == int(js2.step) == 1
    for part in ("params", "mu", "nu"):
        for where, g, w in leaves(got[part], want[part]):
            assert g.dtype == w.dtype, (part, where)
            assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), (
                part, where)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_accum_steps_one_is_the_step_bit_for_bit(dtype):
    """``accum_steps=1`` (and the default) is ``loss_and_grads`` of the
    whole batch then ``apply_update``: the same bits over two steps."""
    _, tcfg = configs()
    data = [batch_at_step(DataConfig(tcfg.vocab_size, S, B, seed=0), s)
            for s in range(2)]
    runs = []
    for how in ("default", "one", "composed"):
        torch.manual_seed(0)
        params = params_from_jax(np_tree(JT.init_params(
            configs()[0], jax.random.key(2),
            jnp.float32 if dtype == torch.float32 else jnp.bfloat16)),
            tcfg, device="cpu")
        kw = {} if how == "default" else {"accum_steps": 1}
        step, init = make_train_step(tcfg, lr=LR, warmup=WARMUP,
                                     total_steps=TOTAL, device="cpu", **kw)
        _, update = loop.adamw(lr=loop.linear_warmup_cosine(LR, WARMUP,
                                                            TOTAL),
                               b1=0.9, b2=0.95, weight_decay=0.1)
        state, losses = init(params), []
        for d in data:
            tb = {n: torch.as_tensor(v) for n, v in d.items()}
            if how == "composed":
                loss, grads = loss_and_grads(params, tcfg, tb)
                apply_update(dict(params.named_parameters()), grads, state,
                             update)
            else:
                params, state, m = step(params, state, tb)
                loss = m["loss"]
            losses.append(loss)
        runs.append((params, state, losses))
    (p0, s0, l0), *rest = runs
    for p, s, losses in rest:
        assert all(torch.equal(a, b) for a, b in zip(l0, losses))
        for (n, a), b in zip(p0.named_parameters(), p.parameters()):
            assert a.dtype == b.dtype == dtype and torch.equal(a, b), n
        for m0, m in ((s0.mu, s.mu), (s0.nu, s.nu)):
            assert all(torch.equal(m0[n], m[n]) for n in m0)


def test_accum_steps_must_divide_the_batch():
    _, tcfg = configs()
    params = params_from_jax(np_tree(JT.init_params(
        configs()[0], jax.random.key(3), jnp.float32)), tcfg, device="cpu")
    tb = {n: torch.as_tensor(v) for n, v in batch(tcfg).items()}
    step, init = make_train_step(tcfg, device="cpu", accum_steps=3)
    with pytest.raises(ValueError, match="does not divide the batch of 4"):
        step(params, init(params), tb)
    with pytest.raises(ValueError, match="at least 1"):
        make_train_step(tcfg, device="cpu", accum_steps=0)
