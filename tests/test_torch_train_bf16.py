"""repro_torch's bf16 LM training on the CPU against the JAX package's bf16
step.

JAX trains bf16 by default (``make_train_step(..., param_dtype=bfloat16)``):
bf16 parameters and gradients, fp32 moments, clipped gradients in fp32.
The port trains bf16 by the same ``make_train_step`` given a bf16 model.
Both start from JAX's bf16 init (carried by ``params_from_jax``) and see
the same batches.

Oracle and bars.  bf16 gradients are far from fp32 ones (JAX's own bf16
gradients part from its fp32 gradients of the same bf16-rounded params
by 1.8-3.4e-2 of a leaf's scale at the tiny tinyllama), and the port
rounds at other places than JAX (its kernels' plain versions compute
attention and the SSD chunk in fp32), so an elementwise bar against JAX
cannot hold.  The oracle is JAX's fp32 run from the same bf16-rounded
params, and a distance is relative: ``|a - oracle| / |oracle|`` for a
loss, the same with Frobenius norms for a leaf (a max-abs distance would
be set by single elements: an MoE token that takes another expert, a
near-zero moment).  The port is held to the oracle as the bf16 forward's
bars are set, no farther than twice JAX's bf16 run plus ``FLOOR``
(2^-9, half a bf16 ulp: the rounding of a value stored in bf16 alone):

* the loss, and also within rtol ``LOSS_RTOL`` of JAX's bf16 loss (1e-2:
  at jamba's smoke config JAX's own bf16 loss parts from fp32 by 5.0e-3,
  the port's by 5.5e-4);
* every gradient leaf, in JAX's dtype (bf16; the MoE router's fp32);
* three steps: JAX's bf16 step (warmup 1, lr 5e-3, so every step moves
  the bf16 params) run three times, and at each of the three params it
  starts from (carried into the port), the loss and every gradient leaf
  held as above, the oracle's at the same params upcast.  Each package's
  own trajectory is not held to the other's: AdamW divides each gradient
  by its own root mean square, so its first steps move every element by
  about the rate with the sign of its gradient, an element whose
  gradient is near zero takes either sign in any bf16 run, and at the
  MoE and hybrid configs a token then takes another expert (measured:
  after two steps at jamba's smoke config the port's loss parts from the
  fp32 trajectory's by 4.1e-2, JAX's by 7.4e-3; both gradients there are
  0.5-0.7 of a leaf's norm from fp32 already at the first step).  The
  port's own three steps are checked for their dtypes and that the first
  loss is the one held above, and the update's arithmetic bit for bit,
  below.

The optimizer's bf16 arithmetic is held bit for bit: JAX's bf16
gradients carried into the port's ``apply_update`` give JAX's params and
moments exactly.  JAX's update runs op by op there (``jax.disable_jit``),
the arithmetic ``repro/optim/optim.py`` writes: jitted on the CPU, XLA
contracts ``b1 * m + (1 - b1) * g`` into one fused multiply-add, which
moves about a third of the moments by an ulp (the bf16 params, rounded
once, agree either way).  With the clip inactive the clip factor is 1.0
in both; with it active the global norms part in the last bits (the
reductions sum in other orders), so the clipped gradients are carried
instead.
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
from repro_torch import optim as topt  # noqa: E402
from repro_torch.data.lm_data import DataConfig, batch_at_step  # noqa: E402
from repro_torch.models.carry import (named_to_tree,  # noqa: E402
                                      opt_state_to_jax, params_from_jax,
                                      params_to_jax, tree_to_named)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train.loop import (apply_update, loss_and_grads,  # noqa
                                    make_train_step)

# attention (GQA), MLA, MoE, D = 256 (the SIMT backward's largest
# tiles), Mamba-2, and the hybrid (Mamba, attention, MoE)
CONFIGS = {"tinyllama-1.1b": {}, "minicpm3-4b": {}, "grok-1-314b": {},
           "gemma-2b-hd256": {"head_dim": 256}, "mamba2-2.7b": {},
           "jamba-1.5-large-398b": {}}
B, S = 2, 64
LR, WARMUP, TOTAL = 5e-3, 1, 30
LOSS_RTOL = 1e-2
FLOOR = 2.0 ** -9


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


def arch(name: str) -> str:
    return name.removesuffix("-hd256")


def configs(name: str):
    return (jconfigs.smoke_config(arch(name)).scaled(**CONFIGS[name]),
            tconfigs.smoke_config(arch(name)).scaled(**CONFIGS[name]))


def batches(cfg, n: int = 3) -> list:
    dcfg = DataConfig(cfg.vocab_size, S, B, seed=0)
    return [batch_at_step(dcfg, s) for s in range(n)]


def jax_loss_fn(jcfg):
    def loss(params, batch):
        return JT.lm_loss(params, jcfg, tokens=batch["tokens"],
                          labels=batch["labels"], remat=True)
    return loss


def jax_step(jcfg):
    """JAX's train step body (``src/repro/train/loop.py:100-111``) outside
    a mesh, jitted without shardings."""
    init_opt, update_opt = jopt.adamw(
        lr=jopt.linear_warmup_cosine(LR, WARMUP, TOTAL), b1=0.9, b2=0.95,
        weight_decay=0.1)
    loss_fn = jax_loss_fn(jcfg)

    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        grads, gnorm = jopt.clip_by_global_norm(grads, 1.0)
        params, opt_state = update_opt(grads, opt_state, params)
        return params, opt_state, loss

    return jax.jit(step), init_opt


def f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32), tree)


def run_case(name: str) -> dict:
    """One config: JAX's bf16 step three times from JAX's bf16 init, and at
    each params it starts from the loss and gradients of JAX in bf16, of
    JAX in fp32 from the same params upcast (the oracle) and of the port
    (the params carried); then the port's own three bf16 steps."""
    jcfg, tcfg = configs(name)
    data = batches(tcfg)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in data]
    grad_fn = jax.jit(jax.value_and_grad(jax_loss_fn(jcfg)))
    step, init = jax_step(jcfg)
    jp = JT.init_params(jcfg, jax.random.key(0), jnp.bfloat16)
    p0, state, at = jp, init(jp), []
    for b, tb in zip(jb, data):
        loss, grads = grad_fn(jp, b)
        oloss, ograds = grad_fn(f32(jp), b)
        tp = params_from_jax(np_tree(jp), tcfg, device="cpu")
        tloss, tgrads = loss_and_grads(tp, tcfg, {
            k: torch.as_tensor(v) for k, v in tb.items()})
        at.append({"jax": (float(loss), grads),
                   "oracle": (float(oloss), ograds),
                   "port": (float(tloss), named_to_tree(tgrads))})
        jp, state, _ = step(jp, state, b)
    tstep, tinit = make_train_step(tcfg, lr=LR, warmup=WARMUP,
                                   total_steps=TOTAL, device="cpu")
    tp = params_from_jax(np_tree(p0), tcfg, device="cpu")
    ts, losses = tinit(tp), []
    for b in data:
        tp, ts, m = tstep(tp, ts, {k: torch.as_tensor(v)
                                   for k, v in b.items()})
        losses.append(float(m["loss"]))
    return {"name": name, "at": at, "own": (tp, ts, losses)}


@pytest.fixture(scope="module", params=list(CONFIGS))
def bf16_case(request):
    return run_case(request.param)


def distance(a, oracle) -> float:
    a, oracle = (np.asarray(np.asarray(t, np.float32), np.float64)
                 for t in (a, oracle))
    return float(np.linalg.norm(a - oracle) / (np.linalg.norm(oracle)
                                                or 1.0))


def hold(what, got, jax_got, oracle):
    """Every leaf of the JAX-layout trees ``got``, in the dtype of JAX's, no
    farther from the oracle's than twice JAX's bf16 leaf is, plus
    ``FLOOR``; given lists of trees (one per state), the distances summed
    over the states (``FLOOR`` once a state)."""
    if not isinstance(got, list):
        got, jax_got, oracle = [got], [jax_got], [oracle]
    err: dict = {}
    for tree, jtree, otree in zip(got, jax_got, oracle):
        flat = jax.tree_util.tree_flatten_with_path(np_tree(otree))[0]
        jflat = jax.tree_util.tree_leaves(np_tree(jtree))
        assert len(flat) == len(jflat) > 0
        for (path, want), j in zip(flat, jflat):
            g = tree
            for p in path:
                g = g[getattr(p, "key", getattr(p, "idx", None))]
            g = np.asarray(g)
            where = f"{what} {jax.tree_util.keystr(path)}"
            assert g.shape == want.shape and g.dtype == j.dtype, where
            assert np.isfinite(np.asarray(g, np.float32)).all(), where
            e = err.setdefault(where, [0.0, 0.0])
            e[0] += distance(g, want)
            e[1] += distance(j, want)
    n = len(got)
    for where, (e, jax_e) in err.items():
        assert e <= 2 * jax_e + n * FLOOR, (where, e, jax_e)


def hold_loss(what, got, jax_got, oracle):
    err, jax_err = (abs(x - oracle) / abs(oracle) for x in (got, jax_got))
    assert err <= 2 * jax_err + FLOOR, (what, got, jax_got, oracle)


def test_bf16_loss_matches_jax(bf16_case):
    at = bf16_case["at"][0]
    loss, want = at["port"][0], at["jax"][0]
    np.testing.assert_allclose(loss, want, rtol=LOSS_RTOL)
    hold_loss(bf16_case["name"], loss, want, at["oracle"][0])


def test_bf16_gradients_within_twice_jax_distance_from_fp32(bf16_case):
    """Every gradient leaf (bf16 as JAX's, the MoE router's fp32) no
    farther from the fp32 oracle than twice JAX's bf16 gradient, plus
    ``FLOOR``."""
    at = bf16_case["at"][0]
    hold(bf16_case["name"] + " gradients", at["port"][1], at["jax"][1],
         at["oracle"][1])


def test_bf16_three_steps_match_jax(bf16_case):
    """At the params each of JAX's three bf16 steps starts from: the loss
    held to the oracle's, and every gradient leaf, its distances summed
    over the three states (at the MoE configs a token takes another
    expert at one state and not the next: measured at grok, ``embed``
    0.165, 0.134, 0.064 from the oracle against JAX's 0.193, 0.059,
    0.040).  The port's own three steps keep JAX's dtypes (bf16, the
    router fp32) and fp32 moments, and start from that loss."""
    what, ats = bf16_case["name"], bf16_case["at"]
    for i, at in enumerate(ats):
        hold_loss(f"{what} step {i}", at["port"][0], at["jax"][0],
                  at["oracle"][0])
    hold(f"{what} three steps' gradients",
         *([at[k][1] for at in ats] for k in ("port", "jax", "oracle")))
    params, state, losses = bf16_case["own"]
    assert losses[0] == bf16_case["at"][0]["port"][0]
    assert np.isfinite(losses).all() and int(state.step) == 3
    start = jax.tree_util.tree_leaves(ats[0]["jax"][1])
    assert [a.dtype.name for a in jax.tree_util.tree_leaves(
        params_to_jax(params))] == [np.asarray(a).dtype.name for a in start]
    assert all(t.dtype == torch.float32
               for m in (state.mu, state.nu) for t in m.values())


@pytest.mark.parametrize("clip", ["inactive", "active"])
def test_update_is_jax_bf16_adamw_bit_for_bit(clip):
    """JAX's bf16 gradients of the tiny tinyllama, three steps: the port's
    ``apply_update`` gives JAX's bf16 params, fp32 moments and step
    exactly.  ``inactive``: clip_norm 1e9 (the factor is 1.0 in both), the
    raw bf16 gradients carried; ``active``: clip_norm 1.0 in JAX, its
    clipped fp32 gradients carried into the port with the clip inactive
    (the global norms part in the last bits)."""
    jcfg, tcfg = configs("tinyllama-1.1b")
    jp = JT.init_params(jcfg, jax.random.key(1), jnp.bfloat16)
    init, update = jopt.adamw(lr=jopt.linear_warmup_cosine(LR, WARMUP,
                                                           TOTAL),
                              b1=0.9, b2=0.95, weight_decay=0.1)
    _, tupdate = topt.adamw(lr=topt.linear_warmup_cosine(LR, WARMUP, TOTAL),
                            b1=0.9, b2=0.95, weight_decay=0.1)
    grad_fn = jax.jit(jax.grad(jax_loss_fn(jcfg)))
    tp = params_from_jax(np_tree(jp), tcfg, device="cpu")
    named = dict(tp.named_parameters())
    js = init(jp)
    ts = make_train_step(tcfg, device="cpu")[1](tp)
    for b in batches(tcfg):
        g = grad_fn(jp, {k: jnp.asarray(v) for k, v in b.items()})
        with jax.disable_jit():
            if clip == "active":
                g, _ = jopt.clip_by_global_norm(g, 1.0)
            else:
                g = jopt.clip_by_global_norm(g, 1e9)[0]
            jp, js = update(g, js, jp)
        grads = tree_to_named(np_tree(g), "cpu")
        apply_update(named, grads, ts, tupdate, clip_norm=1e9)
    want = {"params": np_tree(jp), "mu": np_tree(js.mu),
            "nu": np_tree(js.nu)}
    got = {"params": params_to_jax(tp), **opt_state_to_jax(ts)}
    assert int(got["step"]) == int(js.step) == 3
    for part in ("params", "mu", "nu"):
        for path, w in jax.tree_util.tree_flatten_with_path(want[part])[0]:
            gt = got[part]
            for p in path:
                gt = gt[getattr(p, "key", getattr(p, "idx", None))]
            w, gt = np.asarray(w), np.asarray(gt)
            assert gt.dtype == w.dtype, (part, path)
            assert np.array_equal(gt.view(np.uint8), w.view(np.uint8)), (
                part, jax.tree_util.keystr(path))


def _bf16(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_bf16_forward_keeps_jax_dtypes():
    """Where JAX's bf16 forward computes in another dtype than bf16, the
    port's does too: RMSNorm's fp32 upcast (bf16 out), the MoE router's
    fp32 logits (its aux loss fp32, the output bf16), the fp32 CE of
    ``chunked_ce``, and the SSD scan (y and the final state bf16, as
    JAX's, with the chunk block through ``ops.SsdChunk``)."""
    from repro.models import layers as JL
    from repro.models import mamba2 as JM
    from repro.models import moe as JMoE
    from repro_torch.models import layers as TL
    from repro_torch.models import mamba2 as TM
    from repro_torch.models import moe as TMoE
    rng = np.random.default_rng(0)

    def both(a):
        return (jnp.asarray(a).astype(jnp.bfloat16),
                torch.tensor(a).bfloat16())

    x, xt = both(_bf16(rng, 2, 8, 16))
    w, wt = both(_bf16(rng, 16))
    assert str(JL.rmsnorm(x, w).dtype) == "bfloat16"
    assert TL.rmsnorm(xt, wt).dtype == torch.bfloat16

    jcfg, tcfg = configs("grok-1-314b")
    jp = JT.init_params(jcfg, jax.random.key(0), jnp.bfloat16)
    tp = params_from_jax(np_tree(jp), tcfg, device="cpu")
    h, ht = both(_bf16(rng, 2, 8, jcfg.d_model))
    jmoe = jax.tree.map(lambda a: a[0], jp["stack"]["pos0"]["ffn"])
    jout, jaux = JMoE.moe_ffn(jmoe, jcfg, h)
    tout, taux = TMoE.moe_ffn(tp.stack[0]["pos0"].ffn, tcfg, ht)
    assert str(jout.dtype) == "bfloat16" and tout.dtype == torch.bfloat16
    assert str(jaux.dtype) == "float32" and taux.dtype == torch.float32
    assert tp.stack[0]["pos0"].ffn.router.dtype == torch.float32
    labels = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    jce = JT.chunked_ce(jp, jcfg, h, jnp.asarray(labels))
    tce = T.chunked_ce(tp, tcfg, ht, torch.as_tensor(labels))
    assert str(jce.dtype) == "float32" and tce.dtype == torch.float32
    np.testing.assert_allclose(float(tce), float(jce), rtol=LOSS_RTOL)

    args = [_bf16(rng, 2, 32, 3, 4), np.abs(_bf16(rng, 2, 32, 3)) * 0.1,
            -np.abs(_bf16(rng, 3)), _bf16(rng, 2, 32, 5),
            _bf16(rng, 2, 32, 5)]
    jargs, targs = zip(*(both(a) for a in args))
    jy, jfin = JM.ssd_chunked(*jargs, 16)
    targs = [t.requires_grad_() for t in targs]
    ty, tfin = TM.ssd_chunked(*targs, 16, use_kernels=True)
    assert str(jy.dtype) == str(jfin.dtype) == "bfloat16"
    assert ty.dtype == tfin.dtype == torch.bfloat16
    grads = torch.autograd.grad((ty.float().sum() + tfin.float().sum()),
                                targs)
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
               for g in grads)
