"""repro_torch's Mamba-2 layer against the JAX package's
(``models/mamba2.py``) on ``smoke_config("mamba2-2.7b")`` at fp32, with
the JAX weights carried over by ``params_from_jax``.

Tolerances: the port takes ``ssd_chunked(use_kernels=True)`` (the plain
``ssd_chunk`` on the CPU) where JAX's layer takes the einsum branch, and
both sum fp32 terms in their own order; outputs, states and conv tails
agree within rtol 1e-4 / atol 1e-5, JAX's own bar between the two
branches (tests/test_kernels.py::test_ssd_chunked_kernel_backend_
equivalence).  Elementwise pieces (convs, norms) within rtol/atol 1e-6.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import rmsnorm as j_rmsnorm  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402
from repro_torch.models.carry import params_from_jax, to_tensor  # noqa: E402
from repro_torch.models.layers import rmsnorm  # noqa: E402

TOL = {"rtol": 1e-4, "atol": 1e-5}
EXACT = {"rtol": 1e-6, "atol": 1e-6}
B, S = 2, 64


@pytest.fixture(scope="module")
def layer():
    """(cfg, JAX layer-0 mamba params, port layer-0 mamba module, x)."""
    cfg = j_smoke("mamba2-2.7b")
    jparams = JT.init_params(cfg, jax.random.key(0), jnp.float32)
    port = params_from_jax(jax.tree.map(np.asarray, jparams),
                           smoke_config("mamba2-2.7b"), device="cpu")
    jp = jax.tree.map(lambda a: a[0], jparams["stack"]["pos0"]["mamba"])
    x = np.random.default_rng(0).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    return cfg, jp, port.stack[0]["pos0"].mamba, x


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def close_tree(got, want, tol=TOL):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close_tree(g, w, tol)
    else:
        close(got, want, tol)


def test_configs_are_copies():
    want = j_smoke("mamba2-2.7b")
    got = smoke_config("mamba2-2.7b")
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == \
        {f: getattr(want, f) for f in want.__dataclass_fields__}


def test_mamba_forward_matches_jax(layer):
    cfg, jp, tp, x = layer
    out_j, (st_j, tail_j) = jm.mamba_forward(jp, cfg, jnp.asarray(x))
    out_t, (st_t, tail_t) = tm.mamba_forward(tp, cfg, torch.as_tensor(x))
    close(out_t, out_j)
    close(st_t, st_j)
    close_tree(tail_t, tail_j, EXACT)


def test_mamba_forward_continues_from_state_and_tail(layer):
    """A forward over the second half from the first half's state and
    (unconvolved) conv tails equals JAX's, and equals the full forward."""
    cfg, jp, tp, x = layer
    half = S // 2
    _, (st_j, tail_j) = jm.mamba_forward(jp, cfg, jnp.asarray(x[:, :half]))
    _, (st_t, tail_t) = tm.mamba_forward(tp, cfg,
                                         torch.as_tensor(x[:, :half]))
    out_j, (fin_j, _) = jm.mamba_forward(jp, cfg, jnp.asarray(x[:, half:]),
                                         initial_state=st_j,
                                         conv_tail=tail_j)
    out_t, (fin_t, _) = tm.mamba_forward(tp, cfg,
                                         torch.as_tensor(x[:, half:]),
                                         initial_state=st_t,
                                         conv_tail=tail_t)
    close(out_t, out_j)
    close(fin_t, fin_j)
    full, (fin_full, _) = tm.mamba_forward(tp, cfg, torch.as_tensor(x))
    close(out_t, full[:, half:].numpy())
    close(fin_t, fin_full.numpy())


def test_mamba_decode_matches_jax(layer):
    cfg, jp, tp, x = layer
    half = S // 2
    _, (st_j, tail_j) = jm.mamba_forward(jp, cfg, jnp.asarray(x[:, :half]))
    _, (st_t, tail_t) = tm.mamba_forward(tp, cfg,
                                         torch.as_tensor(x[:, :half]))
    # the decode's inputs carried from JAX, so only the step is compared
    st_c = to_tensor(np.asarray(st_j), "cpu")
    tail_c = tuple(to_tensor(np.asarray(t), "cpu") for t in tail_j)
    tok = x[:, half:half + 1]
    out_j, (st2_j, tail2_j) = jm.mamba_decode(jp, cfg, jnp.asarray(tok),
                                              st_j, tail_j)
    out_t, (st2_t, tail2_t) = tm.mamba_decode(tp, cfg, torch.as_tensor(tok),
                                              st_c, tail_c)
    close(out_t, out_j)
    close(st2_t, st2_j)
    close_tree(tail2_t, tail2_j, EXACT)
    # decoding on from the port's own prefill == the port's full forward
    full, (fin_full, _) = tm.mamba_forward(tp, cfg, torch.as_tensor(x))
    for t in range(half, S):
        out_d, (st_t, tail_t) = tm.mamba_decode(
            tp, cfg, torch.as_tensor(x[:, t:t + 1]), st_t, tail_t)
        close(out_d, full[:, t:t + 1].numpy())
    close(st_t, fin_full.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_state_init_matches_jax(dtype):
    cfg = j_smoke("mamba2-2.7b")
    st_j, tails_j = jm.mamba_state_init(cfg, 3, getattr(jnp, dtype))
    st_t, tails_t = tm.mamba_state_init(smoke_config("mamba2-2.7b"), 3,
                                        getattr(torch, dtype), "cpu")
    for g, w in zip((st_t, *tails_t), (st_j, *tails_j)):
        assert g.dtype == getattr(torch, dtype)
        assert tuple(g.shape) == w.shape and not g.any()


def test_init_mamba_draws_jax_distributions():
    cfg = smoke_config("mamba2-2.7b").scaled(d_model=512)
    got = tm.init_mamba(torch.Generator().manual_seed(0), cfg,
                        torch.float32)
    want = jm.init_mamba(jax.random.key(0), cfg, jnp.float32)
    for name in tm.PARAM_NAMES:
        assert tuple(getattr(got, name).shape) == want[name].shape, name
        assert not getattr(got, name).requires_grad
    for name in ("conv_b_x", "conv_b_B", "conv_b_C", "dt_bias", "A_log",
                 "D", "norm"):
        close(getattr(got, name), want[name], EXACT)
    d, di = cfg.d_model, cfg.d_inner
    for name, std in (("in_z", d ** -0.5), ("in_x", d ** -0.5),
                      ("out_proj", di ** -0.5), ("conv_x", 0.2)):
        assert abs(getattr(got, name).std().item() / std - 1) < 0.05, name
    bf = tm.init_mamba(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert bf.in_z.dtype == torch.bfloat16
    assert torch.equal(bf.in_z, got.in_z.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    w = rng.normal(size=(64,)).astype(np.float32) * 0.1
    got = rmsnorm(torch.as_tensor(x).to(getattr(torch, dtype)),
                  torch.as_tensor(w).to(getattr(torch, dtype)))
    want = j_rmsnorm(jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    assert got.dtype == getattr(torch, dtype)
    # bf16: the fp32 normalisation may round to a neighbouring bf16 value
    tol = EXACT if dtype == "float32" else {"rtol": 2**-7, "atol": 0}
    close(got.float(), want.astype(jnp.float32), tol)


def test_conv_segsum_and_gated_norm_match_jax(layer):
    cfg, jp, tp, x = layer
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(B, 16, cfg.d_inner)).astype(np.float32)
    close(tm._causal_conv(torch.as_tensor(xs), tp.conv_x, tp.conv_b_x),
          jm._causal_conv(jnp.asarray(xs), jp["conv_x"], jp["conv_b_x"]),
          EXACT)
    win = xs[:, :cfg.ssm_conv]
    close(tm._conv_step(torch.as_tensor(win), tp.conv_x, tp.conv_b_x),
          jm._conv_step(jnp.asarray(win), jp["conv_x"], jp["conv_b_x"]),
          EXACT)
    a = -rng.uniform(0.01, 0.5, size=(2, 3, 8)).astype(np.float32)
    seg_t = tm._segsum(torch.as_tensor(a))
    seg_j = np.asarray(jm._segsum(jnp.asarray(a)))
    assert torch.equal(torch.isinf(seg_t), torch.as_tensor(np.isinf(seg_j)))
    fin = np.isfinite(seg_j)
    np.testing.assert_allclose(seg_t.numpy()[fin], seg_j[fin], **EXACT)
    z = rng.normal(size=xs.shape).astype(np.float32)
    close(tm._rmsnorm_gated(torch.as_tensor(xs), torch.as_tensor(z),
                            tp.norm),
          jm._rmsnorm_gated(jnp.asarray(xs), jnp.asarray(z), jp["norm"]),
          EXACT)
