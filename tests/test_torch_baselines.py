"""repro_torch.baselines against the JAX package's baselines on the CPU.

Both packages start from JAX's own init (``jax.random.key(seed)``),
carried into the port by ``params_from_jax``, and train on the same
minibatches (the same numpy permutations).  Bars: logits within rtol 1e-5
/ atol 1e-6 (times the logits' largest magnitude where it exceeds 1); loss and gradients within rtol 1e-5 of ``jax.value_and_grad``
(hinge rows with tied margins included; a parameter's atol 1e-5 of
its gradient's largest magnitude); params after 5 training steps
within rtol 1e-4; the energy models exactly equal.  The port's own init
is held to JAX's by distribution (two-sample KS).  The baselines trained
on segmentation (accuracy within 0.01, SVM_RBF's energy for the same
support set) are held in ``tests/test_torch_paper.py``, beside the one
fixture that trains JAX's baselines for Table 1's columns.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from scipy import stats  # noqa: E402

import repro.baselines.cnn as jcnn  # noqa: E402
import repro.baselines.mlp as jmlp  # noqa: E402
import repro.baselines.svm as jsvm  # noqa: E402
import repro.baselines.train as jtrain  # noqa: E402
import repro_torch.baselines.cnn as tcnn  # noqa: E402
import repro_torch.baselines.mlp as tmlp  # noqa: E402
import repro_torch.baselines.svm as tsvm  # noqa: E402
import repro_torch.baselines.train as ttrain  # noqa: E402
from repro.data import make_dataset as jdataset  # noqa: E402
from repro_torch.baselines import params_from_jax  # noqa: E402
from repro_torch.data import make_dataset as tdataset  # noqa: E402
from repro_torch.optim import tree_leaves  # noqa: E402

NAMES = ["svm_lr", "svm_rbf", "mlp", "cnn"]
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-5
FIT_RTOL = 1e-4


def jax_init(name, F, C, seed=0):
    key = jax.random.key(seed)
    return {"svm_lr": lambda: jsvm.init_linear_svm(key, F, C),
            "svm_rbf": lambda: jsvm.init_rbf_svm(key, F, C),
            "mlp": lambda: jmlp.init_mlp(key, F, C),
            "cnn": lambda: jcnn.init_cnn(key, F, C)}[name]()


def carried(name, jparams):
    return params_from_jax(name, jax.tree.map(np.asarray, jparams),
                           device="cpu")


def jax_logits(name, F):
    return {"svm_lr": jsvm.linear_svm_scores,
            "svm_rbf": jsvm.rbf_svm_scores,
            "mlp": jmlp.mlp_logits,
            "cnn": lambda p, x: jcnn.cnn_logits(p, x, F)}[name]


def port_logits(name, F):
    return {"svm_lr": tsvm.linear_svm_scores,
            "svm_rbf": tsvm.rbf_svm_scores,
            "mlp": tmlp.mlp_logits,
            "cnn": lambda p, x: tcnn.cnn_logits(p, x, F)}[name]


def jax_loss(name):
    return (jsvm.multiclass_hinge_loss if name.startswith("svm")
            else jtrain._xent)


def port_loss(name):
    return (tsvm.multiclass_hinge_loss if name.startswith("svm")
            else ttrain._xent)


def batch(F, C, B=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, F)).astype(np.float32)
    y = rng.integers(0, C, B).astype(np.int32)
    return x, y


# (F, C): the five datasets' shapes; the CNN's image sides 5, 4, 28, 4, 25
SHAPES = [(19, 7), (16, 10), (784, 10), (16, 26), (617, 26)]


@pytest.mark.parametrize("F,C", SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_logits_match_jax_from_carried_init(name, F, C):
    jp = jax_init(name, F, C)
    x, _ = batch(F, C)
    want = np.asarray(jax_logits(name, F)(jp, jnp.asarray(x)))
    got = port_logits(name, F)(carried(name, jp), torch.as_tensor(x))
    # atol in units of the logits' scale where it exceeds 1: a 784-term
    # float32 dot product summed in another order differs by a few ulps of
    # the scale, not of each entry
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want,
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL * scale)


@pytest.mark.parametrize("side", [5, 7, 25])
def test_cnn_pool_pads_odd_sides_at_the_end(side):
    """JAX's 2x2 stride-2 SAME pool == max_pool2d with ceil_mode."""
    x = np.random.default_rng(side).normal(size=(2, side, side, 3)).astype(
        np.float32)
    want = np.asarray(jcnn._pool(jnp.asarray(x)))
    got = tcnn._pool(torch.as_tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert got.shape[-1] == -(-side // 2)


def tied_scores(C=6, B=48, seed=1):
    """Scores on a grid of 0.5 with rows whose hinge margins tie: two
    other classes at the row max, a margin of exactly 0, every margin
    below 0 (the max taken at the true class's zero)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(-4, 5, (B, C)).astype(np.float32) * 0.5
    y = rng.integers(0, C, B).astype(np.int32)
    for i in range(0, B, 4):
        j, k = (y[i] + 1) % C, (y[i] + 2) % C
        s[i, j] = s[i, k] = s[i].max() + 1.0          # a tie at the max
        s[i + 1, :] = s[i + 1, y[i + 1]] - 1.0        # margins exactly 0
        s[i + 2, :] = -3.0
        s[i + 2, y[i + 2]] = 2.0                      # every margin < 0
    return s, y


@pytest.mark.parametrize("loss", ["hinge", "xent"])
def test_loss_grad_on_scores_matches_jax_with_ties(loss):
    s, y = tied_scores()
    jf = jsvm.multiclass_hinge_loss if loss == "hinge" else jtrain._xent
    tf = tsvm.multiclass_hinge_loss if loss == "hinge" else ttrain._xent
    jv, jg = jax.value_and_grad(jf)(jnp.asarray(s), jnp.asarray(y))
    ts = torch.as_tensor(s).requires_grad_()
    tv = tf(ts, torch.as_tensor(y, dtype=torch.long))
    (tg,) = torch.autograd.grad(tv, ts)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=GRAD_RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=GRAD_RTOL,
                               atol=1e-9)
    if loss == "hinge":
        # the ties split: some entries carry half or a third of a row's
        # 1/B share, as JAX gives them
        share = np.abs(tg.numpy()) * len(y)
        assert np.any(np.isclose(share, 0.5)) and np.any(
            np.isclose(share, 1.0))


@pytest.mark.parametrize("name", NAMES)
def test_model_loss_and_grads_match_jax(name):
    F, C = 19, 7
    jp = jax_init(name, F, C)
    x, y = batch(F, C, B=128, seed=2)
    jl, jl_logits = jax_loss(name), jax_logits(name, F)
    if name == "svm_rbf":               # only the head trains
        jv, jg = jax.value_and_grad(lambda lin: jl(
            jsvm.linear_svm_scores(lin, jsvm.rff_lift(jp, jnp.asarray(x))),
            jnp.asarray(y)))(jp.linear)
    else:
        jv, jg = jax.value_and_grad(lambda p: jl(jl_logits(p, jnp.asarray(x)),
                                                 jnp.asarray(y)))(jp)
    tp = carried(name, jp)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y, dtype=torch.long)
    if name == "svm_rbf":
        leaves = [tp.linear["b"].requires_grad_(),
                  tp.linear["w"].requires_grad_()]
        tv = port_loss(name)(tsvm.linear_svm_scores(
            {"b": leaves[0], "w": leaves[1]}, tsvm.rff_lift(tp, tx)), ty)
    else:
        leaves = [p.requires_grad_() for p in tree_leaves(tp)]
        tv = port_loss(name)(port_logits(name, F)(tp, tx), ty)
    grads = torch.autograd.grad(tv, leaves)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=GRAD_RTOL)
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)]
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        if g.ndim == 4:                       # OIHW -> HWIO
            g = g.permute(2, 3, 1, 0)
        # atol in units of the leaf's scale: a conv weight's gradient sums
        # 128 x side**2 terms that cancel
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale)


def small(ds, n):
    return dataclasses.replace(ds, x_train=ds.x_train[:n],
                               y_train=ds.y_train[:n])


@pytest.mark.parametrize("name", NAMES)
def test_five_fit_steps_match_jax(name):
    """One epoch of 5 minibatches of 128 (the same numpy permutation)."""
    jds, tds = small(jdataset("segmentation"), 640), small(
        tdataset("segmentation"), 640)
    F, C = jds.n_features, jds.n_classes
    jp = jax_init(name, F, C)
    tp = carried(name, jp)
    kw = {"epochs": 1, "lr": 3e-3 if name.startswith("svm") else 1e-3}
    if name == "svm_rbf":
        jfit = jtrain._fit(jp.linear, lambda lin, x: jsvm.linear_svm_scores(
            lin, jsvm.rff_lift(jp, x)), jsvm.multiclass_hinge_loss, jds, **kw)
    else:
        jfit = jtrain._fit(jp, jax_logits(name, F), jax_loss(name), jds, **kw)
    setup = ttrain.fit_setup(name, tp, F, "cpu")
    assert setup.lr == kw["lr"]
    tfit = setup.fit(tds, epochs=1, device="cpu")
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jfit)]
    got = tree_leaves(tfit)
    assert len(want) == len(got)
    for g, w in zip(got, want):
        if g.ndim == 4:
            g = g.permute(2, 3, 1, 0)
        np.testing.assert_allclose(g.numpy(), w, rtol=FIT_RTOL,
                                   atol=FIT_RTOL * float(np.abs(w).max()))


@pytest.mark.parametrize("F,C", SHAPES)
def test_energy_models_equal_jax(F, C):
    assert tsvm.svm_lr_energy_nj(F, C) == jsvm.svm_lr_energy_nj(F, C)
    assert tmlp.mlp_energy_nj(F, C) == jmlp.mlp_energy_nj(F, C)
    assert tcnn.cnn_energy_nj(F, C) == jcnn.cnn_energy_nj(F, C)
    for n_sv in (0, 1, 137, 4000):
        assert (tsvm.svm_rbf_energy_nj(F, C, n_sv)
                == jsvm.svm_rbf_energy_nj(F, C, n_sv))


def test_count_support_vectors_matches_jax():
    s, y = tied_scores()
    assert (tsvm.count_support_vectors(s, y)
            == jsvm.count_support_vectors(s, y))


def port_init(name, F, C, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"svm_lr": lambda: tsvm.init_linear_svm(gen, F, C),
            "svm_rbf": lambda: tsvm.init_rbf_svm(gen, F, C),
            "mlp": lambda: tmlp.init_mlp(gen, F, C),
            "cnn": lambda: tcnn.init_cnn(gen, F, C)}[name]()


def init_leaves(name, tree, port=False):
    """{path: array} in JAX's layout."""
    if name == "svm_rbf":
        tree = {"omega": tree.omega, "phase": tree.phase,
                "linear": tree.linear}
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda a: np.asarray(a.numpy() if isinstance(
            a, torch.Tensor) else a), tree))[0]
    out = {}
    for path, a in flat:
        key = jax.tree_util.keystr(path)
        if port and a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)          # OIHW -> HWIO
        out[key] = a
    return out


@pytest.mark.parametrize("F,C", [(617, 26), (16, 10)])
@pytest.mark.parametrize("name", NAMES)
def test_port_init_matches_jax_by_distribution(name, F, C):
    want = init_leaves(name, jax_init(name, F, C))
    got = init_leaves(name, port_init(name, F, C), port=True)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if not w.any():                               # biases: zeros
            assert not g.any(), k
            continue
        if w.size >= 50:
            p = stats.ks_2samp(g.ravel(), w.ravel()).pvalue
            assert p > 1e-4, (k, p)
        else:
            np.testing.assert_allclose(g.std(), w.std(), rtol=0.5)


def test_params_from_jax_layouts():
    jp = jax_init("cnn", 19, 7)
    tp = carried("cnn", jp)
    assert tuple(tp["conv2"]["w"].shape) == (16, 8, 3, 3)
    np.testing.assert_array_equal(tp["conv2"]["w"].permute(2, 3, 1, 0),
                                  np.asarray(jp["conv2"]["w"]))
    np.testing.assert_array_equal(tp["fc1"]["w"], np.asarray(jp["fc1"]["w"]))
    with pytest.raises(ValueError, match="unknown baseline"):
        params_from_jax("svm_poly", {}, device="cpu")


def test_train_on_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device"):
        ttrain.train_svm_lr(tdataset("segmentation"))


@pytest.mark.parametrize("cudnn", [True, False])
def test_fp32_products_restores_the_flags(cudnn):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled)
    with ttrain.fp32_products(cudnn=cudnn):
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cudnn.enabled == (saved[2] and cudnn)
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.enabled) == saved
