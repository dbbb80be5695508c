"""repro_torch's training of the configs with Mamba layers (mamba2-2.7b and
jamba-1.5-large-398b, at their smoke sizes) on the CPU against the JAX
package: the loss and every gradient leaf against JAX's
``jax.value_and_grad`` of ``lm_loss(remat=True)``, and three steps against
JAX's step body composed outside a mesh, as ``tests/test_torch_train.py``
composes it (``src/repro/train/loop.py:100-111``).  S = 64 at the smoke
configs' chunk of 32, so two chunks and the inter-chunk recurrence's
gradient are exercised.  The SSD block's gradient runs through
``ops.SsdChunk`` and ``ssd_chunk_bwd_ref``.

Bars.  The loss within rtol 1e-5, and every leaf outside the Mamba
mixers within 1e-5 of its scale (its largest magnitude), the bars of
``tests/test_torch_train.py``.  The Mamba mixers' gradients are
ill-conditioned in fp32: the decay cumsum's rounding reaches the
gradients of ``A_log``, ``dt_bias``, ``in_dt`` and of B and C's weights,
so JAX's own fp32 gradient is up to ~1.5e-5 of ``A_log``'s scale from a
float64 oracle (the port's plain path in float64 under autograd: the
SSD block by autograd of its einsum form, not the formulas the backward
is written from).  At mamba2-2.7b each Mamba leaf of the port is held to
``max(1e-5, 2 x JAX's distance from the oracle)`` of its scale.  At
jamba no float64 oracle can be had: its MoE router casts its input to
fp32 and the attention's plain version computes in fp32, so a float64
run there is not float64 throughout.  Its Mamba leaves are held to a
fixed 1e-4 of their scale: before this backward existed the port's fp32
autograd was 2.6e-5 (mamba2) and 6.3e-5 (jamba) of ``A_log``'s scale
from JAX, and through ``ssd_chunk_bwd_ref`` the largest is 2.5e-5
(jamba's ``A_log``); the bar is 1.6 times the larger measure.
Three steps: losses within rtol 1e-5, params and moments within 1e-3 of
each leaf's scale plus 1e-7, ``tests/test_torch_train.py``'s reason.  At
jamba an element whose step sits near zero (a bias or norm weight that
starts at 0 in a MoE or Mamba layer) carries the Mamba gradients' larger
differences into its step: there at most 0.1 % of a leaf's elements (at
least one) may part by more, each by at most 1e-2 of the scale
(measured: one element of 32 of a Mamba layer's ``conv_b_C`` at 6.6e-3,
one of a ``ln2`` at 1.3e-3).
"""
import copy

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
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd_chunk import ssd_intra_chunk  # noqa: E402
from repro_torch.models.carry import (named_to_tree,  # noqa: E402
                                      opt_state_to_jax, params_from_jax,
                                      params_to_jax)
from repro_torch.train.loop import (loss_and_grads,  # noqa: E402
                                    make_train_step)

CONFIGS = ["mamba2-2.7b", "jamba-1.5-large-398b"]
B, S = 2, 64
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5
JAMBA_MAMBA_TOL = 1e-4
JAMBA_STEP_FLIPS, JAMBA_STEP_BAR = 1e-3, 1e-2
STEP_TOL, STEP_ATOL = 1e-3, 1e-7
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


def flat(tree) -> dict:
    """JAX-layout leaves by key path string."""
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64) for p, v in
            jax.tree_util.tree_flatten_with_path(np_tree(tree))[0]}


def is_mamba(path: str) -> bool:
    return "['mamba']" in path


def inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def jax_loss_fn(jcfg):
    def loss(params, batch):
        return JT.lm_loss(params, jcfg, tokens=batch["tokens"],
                          labels=batch["labels"], remat=True)
    return loss


def float64_grads(tparams, cfg, batch) -> dict:
    """The port's plain path in float64 under autograd: the SSD block by
    autograd of its einsum form (``ssd_intra_chunk``)."""
    p64 = copy.deepcopy(tparams).double()
    real = ops.ssd_chunk
    ops.ssd_chunk = ssd_intra_chunk
    try:
        _, grads = loss_and_grads(p64, cfg, batch)
    finally:
        ops.ssd_chunk = real
    return flat(named_to_tree(grads))


@pytest.fixture(scope="module", params=CONFIGS)
def loss_case(request):
    """One config's loss and gradients in both packages from JAX's init,
    and at mamba2-2.7b the float64 oracle's gradients."""
    name = request.param
    jcfg, tcfg = jconfigs.smoke_config(name), tconfigs.smoke_config(name)
    assert S // tcfg.ssm_chunk >= 2
    jparams = JT.init_params(jcfg, jax.random.key(0), jnp.float32)
    batch = inputs(tcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss_fn(jcfg)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = params_from_jax(np_tree(jparams), tcfg, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tloss, tgrads = loss_and_grads(tparams, tcfg, tb)
    exact = (float64_grads(tparams, tcfg, tb) if name == "mamba2-2.7b"
             else None)
    return {"name": name, "jloss": float(jloss), "tloss": float(tloss),
            "jgrads": flat(jgrads), "tgrads": flat(named_to_tree(tgrads)),
            "exact": exact}


def test_lm_loss_matches_jax(loss_case):
    np.testing.assert_allclose(loss_case["tloss"], loss_case["jloss"],
                               rtol=LOSS_RTOL)


def grad_bar(case, path: str) -> float:
    """A leaf's bar as a share of its scale (the module docstring)."""
    if not is_mamba(path):
        return GRAD_TOL
    if case["exact"] is None:
        return JAMBA_MAMBA_TOL
    e, j = case["exact"][path], case["jgrads"][path]
    return max(GRAD_TOL, 2 * np.abs(j - e).max() / np.abs(e).max())


def test_gradients_match_jax(loss_case):
    """Every leaf, carried into JAX's layout, against JAX's gradient;
    at mamba2-2.7b the Mamba leaves also within twice JAX's distance from
    the float64 oracle."""
    got, want = loss_case["tgrads"], loss_case["jgrads"]
    assert got.keys() == want.keys()
    assert any(is_mamba(k) for k in want)
    for path, w in want.items():
        scale = np.abs(w).max()
        bar = grad_bar(loss_case, path)
        np.testing.assert_allclose(got[path], w, rtol=0, atol=bar * scale,
                                   err_msg=f"{loss_case['name']} {path}")
        if loss_case["exact"] is not None and is_mamba(path):
            e = loss_case["exact"][path]
            jax_err = np.abs(w - e).max()
            assert np.abs(got[path] - e).max() <= max(
                2 * jax_err, GRAD_TOL * np.abs(e).max()), path


def jax_step(jcfg, *, lr, warmup, total):
    """JAX's train step body outside a mesh, jitted without shardings."""
    init_opt, update_opt = jopt.adamw(
        lr=jopt.linear_warmup_cosine(lr, warmup, total), b1=0.9, b2=0.95,
        weight_decay=0.1)
    loss_fn = jax_loss_fn(jcfg)

    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        grads, gnorm = jopt.clip_by_global_norm(grads, 1.0)
        params, opt_state = update_opt(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return jax.jit(step), init_opt


@pytest.fixture(scope="module", params=CONFIGS)
def three_steps(request):
    """Three steps of each package from JAX's init on ``batch_at_step``'s
    batches of 2 x 64, warmup 100, clip 1.0, lr 5e-3."""
    name = request.param
    jcfg, tcfg = jconfigs.smoke_config(name), tconfigs.smoke_config(name)
    jstep, jinit = jax_step(jcfg, lr=LR, warmup=100, total=30)
    tstep, tinit = make_train_step(tcfg, lr=LR, total_steps=30,
                                   device="cpu")
    jp = JT.init_params(jcfg, jax.random.key(0), jnp.float32)
    jo = jinit(jp)
    tp = params_from_jax(np_tree(jp), tcfg, device="cpu")
    to = tinit(tp)
    dcfg = DataConfig(tcfg.vocab_size, S, B, seed=0)
    jl, tl = [], []
    for s in range(3):
        b = batch_at_step(dcfg, s)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = tstep(tp, to, {k: torch.as_tensor(v)
                                    for k, v in b.items()})
        jl.append((float(jm["loss"]), float(jm["grad_norm"])))
        tl.append((float(tm["loss"]), float(tm["grad_norm"])))
    return {"name": name, "jp": jp, "jo": jo, "tp": tp, "to": to, "jl": jl,
            "tl": tl}


def test_three_steps_losses_match_jax(three_steps):
    np.testing.assert_allclose(np.array(three_steps["tl"]),
                               np.array(three_steps["jl"]), rtol=LOSS_RTOL)


def test_three_steps_params_and_moments_match_jax(three_steps):
    to = opt_state_to_jax(three_steps["to"])
    assert int(to["step"]) == int(three_steps["jo"].step) == 3
    for what, got, want in (
            ("params", params_to_jax(three_steps["tp"]), three_steps["jp"]),
            ("mu", to["mu"], three_steps["jo"].mu),
            ("nu", to["nu"], three_steps["jo"].nu)):
        got, want = flat(got), flat(want)
        assert got.keys() == want.keys()
        for path, w in want.items():
            where = f"{three_steps['name']} {what} {path}"
            scale = np.abs(w).max()
            err = np.abs(got[path] - w)
            if three_steps["name"] == "mamba2-2.7b":
                assert (err <= STEP_TOL * scale + STEP_ATOL).all(), (
                    where, err.max() / scale)
                continue
            off = (err > STEP_TOL * scale + STEP_ATOL).sum()
            assert off <= max(1, JAMBA_STEP_FLIPS * w.size), (where, off)
            assert (err <= JAMBA_STEP_BAR * scale + STEP_ATOL).all(), (
                where, err.max() / scale)
