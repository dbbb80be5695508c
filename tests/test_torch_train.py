"""repro_torch's LM training on the CPU against the JAX package.

The oracle is JAX's ``lm_loss`` under ``jax.value_and_grad``, and a step
composed here from ``lm_loss``, ``clip_by_global_norm``, ``adamw``,
``linear_warmup_cosine`` and ``ef_compress_grads`` exactly as
``src/repro/train/loop.py:100-111`` composes them, jitted without
shardings: JAX's own ``make_train_step`` fails under a mesh in jax 0.9
(``tests/test_train_integration.py``, ROADMAP §C), and outside a mesh
``constrain_batch`` does nothing.  Weights are JAX's, carried by
``params_from_jax``; JAX's gradients are carried into the port's layout.

Bars: the loss within rtol 1e-5; every gradient leaf within 1e-5 of that
leaf's scale (its largest magnitude); the losses of three steps within
rtol 1e-5.  After three steps the params and moments are held within 1e-3
of each leaf's scale (plus 1e-7): AdamW divides each gradient by its own
root mean square, so an element whose gradient is near zero (a rare
token's embedding row, a norm weight that starts at 0) carries the
gradients' last-digit differences into its step (measured: at most 3e-4
of a leaf's scale).  With compression an element whose int8 code sits on
a rounding boundary may take the next code: there at most 0.1 % of a
leaf's elements (at least one) may part by more, each by at most two
codes (2/127 of the scale), and the global norms of steps 2-3, computed
after such a flip, are held within rtol 1e-3.  The trainer's own loop,
resume, CLI and refusals are ``tests/test_torch_train_loop.py``'s.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.optim as jopt  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.compression import ef_compress_grads as jef  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data.lm_data import DataConfig, batch_at_step  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.carry import (named_to_tree,  # noqa: E402
                                      opt_state_to_jax, params_from_jax)
from repro_torch.train.loop import (loss_and_grads,  # noqa: E402
                                    make_train_step)

# attention, MQA + tied embeddings, the non-gated MLP, embeddings in,
# MLA, MoE, and MLA + MoE + the dense prefix + MTP
CONFIGS = ["tinyllama-1.1b", "gemma-2b", "granite-34b", "musicgen-large",
           "minicpm3-4b", "grok-1-314b", "deepseek-v3-671b"]
B, S = 2, 32
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5
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


def tiny(configs):
    """The tiny config of ``tests/test_train_integration.py``."""
    return configs.get_arch("tinyllama-1.1b").scaled(
        name="tiny-test", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256)


def leaf_close(got: dict, want, tol: float, atol: float = 0.0,
               what: str = "", flips: float = 0.0):
    """Every leaf of JAX's tree ``want`` against the same path of the
    JAX-layout tree ``got``, within ``tol`` of the leaf's scale; with
    ``flips``, that share of a leaf's elements may be up to two int8
    codes (2/127 of the scale) off."""
    flat = jax.tree_util.tree_flatten_with_path(np_tree(want))[0]
    assert flat
    for path, w in flat:
        g = got
        for p in path:
            g = g[getattr(p, "key", getattr(p, "idx", None))]
        w = np.asarray(w, np.float32)
        g = np.asarray(g, np.float32)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        scale = float(np.abs(w).max())
        where = f"{what} {jax.tree_util.keystr(path)}"
        off = np.abs(g - w) > tol * scale + atol
        if flips:
            assert off.sum() <= max(1, flips * w.size), (where, off.sum())
            bar = 2 / 127 * scale + atol
            assert (np.abs(g - w) <= bar).all(), (where, np.abs(g - w).max())
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale + atol,
                                       err_msg=where)


def inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.frontend:
        batch["embeds"] = (rng.normal(size=(B, S, cfg.d_model))
                           * 0.02).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    return batch


def jax_loss_fn(jcfg):
    def loss(params, batch):
        return JT.lm_loss(params, jcfg, tokens=batch.get("tokens"),
                          labels=batch["labels"], embeds=batch.get("embeds"),
                          remat=True)
    return loss


@pytest.fixture(scope="module", params=CONFIGS)
def loss_case(request):
    """One config's loss and gradients in both packages, from JAX's init
    (one JAX compile per config)."""
    name = request.param
    jcfg, tcfg = jconfigs.smoke_config(name), tconfigs.smoke_config(name)
    jparams = JT.init_params(jcfg, jax.random.key(0), jnp.float32)
    batch = inputs(tcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss_fn(jcfg)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = params_from_jax(np_tree(jparams), tcfg, device="cpu")
    tloss, tgrads = loss_and_grads(tparams, tcfg, {
        k: torch.as_tensor(v) for k, v in batch.items()})
    return {"name": name, "tcfg": tcfg, "tparams": tparams, "batch": batch,
            "jloss": float(jloss), "jgrads": jgrads, "tloss": float(tloss),
            "tgrads": tgrads}


def test_lm_loss_matches_jax(loss_case):
    np.testing.assert_allclose(loss_case["tloss"], loss_case["jloss"],
                               rtol=LOSS_RTOL)


def test_gradients_match_jax(loss_case):
    """Every parameter's gradient, carried into JAX's layout, within 1e-5
    of its scale; the MTP head's and the MoE router's included."""
    got = named_to_tree(loss_case["tgrads"])
    leaf_close(got, loss_case["jgrads"], GRAD_TOL, what=loss_case["name"])
    tcfg = loss_case["tcfg"]
    assert ("mtp" in got) == bool(tcfg.mtp)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "deepseek-v3-671b"])
def test_remat_changes_no_number(name):
    """``remat`` recomputes the blocks in the backward: the loss and every
    gradient are the same bits with and without it."""
    cfg = tconfigs.smoke_config(name)
    jp = JT.init_params(jconfigs.smoke_config(name), jax.random.key(1),
                        jnp.float32)
    batch = {k: torch.as_tensor(v) for k, v in inputs(cfg, 1).items()}
    out = []
    for remat in (True, False):
        params = params_from_jax(np_tree(jp), cfg, device="cpu")
        named = dict(params.named_parameters())
        for p in named.values():
            p.requires_grad_(True)
        loss = T.lm_loss(params, cfg, tokens=batch["tokens"],
                         labels=batch["labels"], remat=remat)
        out.append((loss, torch.autograd.grad(loss, list(named.values()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("chunk,masked", [(8, False), (12, False),
                                          (512, False), (8, True)])
def test_chunked_ce_matches_jax(chunk, masked):
    """JAX's chunking (``min(chunk, S)``, the whole sequence when that does
    not divide S) and mask, from the same hidden states."""
    name = "tinyllama-1.1b"
    jcfg, tcfg = jconfigs.smoke_config(name), tconfigs.smoke_config(name)
    jp = JT.init_params(jcfg, jax.random.key(2), jnp.float32)
    rng = np.random.default_rng(3)
    h = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32) if masked else None
    want = JT.chunked_ce(jp, jcfg, jnp.asarray(h), jnp.asarray(labels),
                         chunk=chunk,
                         mask=None if mask is None else jnp.asarray(mask))
    got = T.chunked_ce(params_from_jax(np_tree(jp), tcfg, device="cpu"),
                       tcfg, torch.as_tensor(h), torch.as_tensor(labels),
                       chunk=chunk,
                       mask=None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def jax_step(jcfg, *, lr, warmup, total, compress):
    """JAX's train step body (``src/repro/train/loop.py:100-111``) outside
    a mesh, jitted without shardings; returns (step, init_opt)."""
    init_opt, update_opt = jopt.adamw(
        lr=jopt.linear_warmup_cosine(lr, warmup, total), b1=0.9, b2=0.95,
        weight_decay=0.1)
    loss_fn = jax_loss_fn(jcfg)

    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        grads, gnorm = jopt.clip_by_global_norm(grads, 1.0)
        if compress:
            grads, _ = jef(grads, None)
        params, opt_state = update_opt(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return jax.jit(step), init_opt


STEP_CASES = [("tiny", False), ("tiny", True), ("deepseek-v3-671b", False),
              ("deepseek-v3-671b", True), ("grok-1-314b", True),
              ("minicpm3-4b", False), ("musicgen-large", False)]


@pytest.fixture(scope="module", params=STEP_CASES, ids=str)
def three_steps(request):
    """Three steps of each package from JAX's init on ``batch_at_step``'s
    batches (embeddings from numpy for musicgen), at JAX's defaults
    (warmup 100, clip 1.0) and lr 5e-3."""
    name, compress = request.param
    if name == "tiny":
        jcfg, tcfg = tiny(jconfigs), tiny(tconfigs)
    else:
        jcfg, tcfg = jconfigs.smoke_config(name), tconfigs.smoke_config(name)
    jstep, jinit = jax_step(jcfg, lr=LR, warmup=100, total=30,
                            compress=compress)
    tstep, tinit = make_train_step(tcfg, lr=LR, total_steps=30,
                                   compress_pod_grads=compress, device="cpu")
    jp = JT.init_params(jcfg, jax.random.key(0), jnp.float32)
    jo = jinit(jp)
    tp = params_from_jax(np_tree(jp), tcfg, device="cpu")
    to = tinit(tp)
    dcfg = DataConfig(tcfg.vocab_size, 64, 4, seed=0)
    rng = np.random.default_rng(5)
    jl, tl = [], []
    for s in range(3):
        b = batch_at_step(dcfg, s)
        if tcfg.frontend:
            b = {"labels": b["labels"],
                 "embeds": (rng.normal(size=(4, 64, tcfg.d_model))
                            * 0.02).astype(np.float32)}
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = tstep(tp, to, {k: torch.as_tensor(v)
                                    for k, v in b.items()})
        jl.append((float(jm["loss"]), float(jm["grad_norm"])))
        tl.append((float(tm["loss"]), float(tm["grad_norm"])))
    return {"jp": jp, "jo": jo, "tp": tp, "to": to, "jl": jl, "tl": tl,
            "what": f"{name} compress={compress}",
            "flips": 1e-3 if compress else 0.0}


def test_three_steps_losses_match_jax(three_steps):
    (tl, tn), (jl, jn) = (np.array(three_steps[k]).T for k in ("tl", "jl"))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tn[0], jn[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tn, jn, rtol=STEP_TOL if three_steps[
        "flips"] else LOSS_RTOL)


def test_three_steps_params_and_moments_match_jax(three_steps):
    from repro_torch.models.carry import params_to_jax
    what, flips = three_steps["what"], three_steps["flips"]
    leaf_close(params_to_jax(three_steps["tp"]), three_steps["jp"],
               STEP_TOL, STEP_ATOL, what + " params", flips)
    jo, to = three_steps["jo"], opt_state_to_jax(three_steps["to"])
    assert int(to["step"]) == int(jo.step) == 3
    leaf_close(to["mu"], jo.mu, STEP_TOL, STEP_ATOL, what + " mu", flips)
    leaf_close(to["nu"], jo.nu, STEP_TOL, STEP_ATOL, what + " nu", flips)
