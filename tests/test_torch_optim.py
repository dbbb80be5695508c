"""repro_torch.optim against the JAX package's optim on the CPU.

The same params and gradients (a tree of three float32 leaves and one
bf16 leaf, made with numpy from a seed) go through both packages' updates
for 5 steps.  JAX runs eagerly, one op at a time, so neither side fuses.
Bars: params and moments within rtol 1e-6; the schedules and the clip
within rtol 1e-6; int8 codes bit-equal, their scale within rtol 1e-7; the
error-feedback residual within atol 1e-7.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.optim as jopt  # noqa: E402
import repro_torch.optim as topt  # noqa: E402
from repro_torch.models.carry import to_tensor  # noqa: E402

RTOL = 1e-6
STEPS = 5
SHAPES = {"w": (6, 4), "b": (4,), "layers": [(3, 5), (5, 2)]}


def make_tree(rng, scale=1.0):
    """{"w": f32, "b": f32, "layers": [f32, bf16]} as numpy arrays."""
    import ml_dtypes
    w = (rng.normal(size=SHAPES["w"]) * scale).astype(np.float32)
    b = (rng.normal(size=SHAPES["b"]) * scale).astype(np.float32)
    l0 = (rng.normal(size=SHAPES["layers"][0]) * scale).astype(np.float32)
    l1 = (rng.normal(size=SHAPES["layers"][1]) * scale).astype(
        ml_dtypes.bfloat16)
    return {"w": w, "b": b, "layers": [l0, l1]}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return topt.tree_map(lambda a: to_tensor(np.asarray(a), "cpu"), tree)


def close(got, want, rtol=RTOL, atol=0.0):
    """Every leaf of the port's tree against the JAX tree's, in float32."""
    g_leaves = topt.tree_leaves(got)
    w_leaves = jax.tree_util.tree_leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        w = np.asarray(w)
        assert str(g.dtype).split(".")[-1] == w.dtype.name, (g.dtype, w.dtype)
        np.testing.assert_allclose(g.to(torch.float32).numpy(),
                                   w.astype(np.float32), rtol=rtol,
                                   atol=atol)


SCHEDULES = {
    "constant": (1e-2, 1e-2),
    "warmup_cosine": (jopt.linear_warmup_cosine(1e-2, 2, STEPS),
                      topt.linear_warmup_cosine(1e-2, 2, STEPS)),
}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_updates_match_jax_over_five_steps(opt, schedule):
    rng = np.random.default_rng(0)
    jlr, tlr = SCHEDULES[schedule]
    if opt == "adamw":
        jinit, jupd = jopt.adamw(lr=jlr, weight_decay=1e-2)
        tinit, tupd = topt.adamw(lr=tlr, weight_decay=1e-2)
    else:
        jinit, jupd = jopt.sgd(lr=jlr, weight_decay=1e-2)
        tinit, tupd = topt.sgd(lr=tlr, weight_decay=1e-2)
    params = make_tree(rng)
    jp, tp = to_jax(params), to_torch(params)
    js, ts = jinit(jp), tinit(tp)
    for _ in range(STEPS):
        grads = make_tree(rng, scale=0.1)
        jp, js = jupd(to_jax(grads), js, jp)
        tp, ts = tupd(to_torch(grads), ts, tp)
        close(tp, jp)
        close(ts.mu, js.mu)
        if opt == "adamw":
            close(ts.nu, js.nu)
        assert int(ts.step) == int(js.step)
    # the update returns new tensors: the inputs stay as they were
    assert ts.step.dtype == torch.int32


@pytest.mark.parametrize("name", ["cosine", "warmup_cosine"])
def test_schedules_match_jax(name):
    if name == "cosine":
        jf, tf = (jopt.cosine_schedule(3e-3, 7, 0.2),
                  topt.cosine_schedule(3e-3, 7, 0.2))
    else:
        jf, tf = (jopt.linear_warmup_cosine(3e-3, 3, 11),
                  topt.linear_warmup_cosine(3e-3, 3, 11))
    steps = np.arange(0, 14, dtype=np.float32)
    got = np.asarray([float(tf(torch.tensor(s))) for s in steps])
    want = np.asarray([float(jf(jnp.float32(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = make_tree(np.random.default_rng(1))
    jc, jn = jopt.clip_by_global_norm(to_jax(grads), max_norm)
    tc, tn = topt.clip_by_global_norm(to_torch(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    close(tc, jc)
    np.testing.assert_allclose(float(topt.global_norm(to_torch(grads))),
                               float(jopt.global_norm(to_jax(grads))),
                               rtol=RTOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_int8_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(257,)) * 10.0 ** rng.integers(-3, 3)).astype(
        np.float32)
    x[:4] = [0.5, -0.5, 2.5, -2.5]      # exact halves after the scaling
    x[4] = np.abs(x).max() * 1.5        # the max maps to 127
    jq, js = jopt.compress_int8(jnp.asarray(x))
    tq, ts = topt.compress_int8(torch.as_tensor(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)
    np.testing.assert_array_equal(
        topt.decompress_int8(tq, ts).numpy(),
        np.asarray(jopt.decompress_int8(jq, js)))


def test_compression_round_halves_to_even():
    """q = round(x / scale) at exact halves goes to the even code."""
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5])
    q, scale = topt.compress_int8(x)
    assert float(scale) == pytest.approx(1.0, rel=1e-7)
    assert q.tolist() == [127, 0, 2, 2, 0, -2]


def test_ef_compress_grads_matches_jax():
    rng = np.random.default_rng(3)
    js = ts = None
    for _ in range(3):
        grads = make_tree(rng)
        jo, js = jopt.ef_compress_grads(to_jax(grads), js)
        to, ts = topt.ef_compress_grads(to_torch(grads), ts)
        close(to, jo, rtol=1e-6, atol=1e-7)
        close(ts.error, js.error, rtol=0.0, atol=1e-7)
    fresh = topt.init_compression(to_torch(grads))
    assert all(float(e.abs().sum()) == 0.0
               for e in topt.tree_leaves(fresh.error))


def test_tree_order_is_jax_order():
    tree = {"z": 1, "a": [2, {"y": 3, "b": 4}], "m": (5,)}
    assert topt.tree_leaves(tree) == jax.tree_util.tree_leaves(tree)
    rebuilt = topt.tree_unflatten(tree, topt.tree_leaves(tree))
    assert rebuilt == tree and list(rebuilt) == list(tree)
