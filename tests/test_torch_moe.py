"""repro_torch's Mixture-of-Experts FFN (``models/moe.py``) against the JAX
package's ``repro.models.moe`` from the same weights (JAX's ``init_moe``
carried over), at the smoke configs of grok-1-314b (8 experts, top 2),
deepseek-v3-671b (8 experts of 64, top 2, one shared expert) and
jamba-1.5-large-398b (8 experts, top 2), drop-free as the smoke configs
route and with capacities that overflow.

Tolerances: fp32 outputs within 1e-5 of their scale (the expert products
sum fp32 terms in their own order), bf16 within 2 bf16 ulps (2**-7) of
it; the load-balance loss within rtol 1e-6; the routing itself (which
tokens each expert keeps) exactly.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models.carry import to_tensor  # noqa: E402

ARCHS = ["grok-1-314b", "deepseek-v3-671b", "jamba-1.5-large-398b"]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2 * 2**-7)}
B, S = 2, 40


def carried(jp: dict) -> TMoE.MoE:
    t = lambda a: to_tensor(np.asarray(a), "cpu")   # noqa: E731
    shared = None
    if "shared" in jp:
        shared = TMoE.SharedExpert(*(t(jp["shared"][k])
                                     for k in ("w_gate", "w_up", "w_down")))
    return TMoE.MoE(t(jp["router"]), t(jp["w_gate"]), t(jp["w_up"]),
                    t(jp["w_down"]), shared)


def both(name, dtype, capacity_factor=None, seed=0):
    jdt = DTYPES[dtype][0]
    jcfg, tcfg = jconfigs.smoke_config(name), tconfigs.smoke_config(name)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    jp = JMoE.init_moe(jax.random.key(seed), jcfg, jdt)
    x = np.random.default_rng(seed + 1).normal(
        size=(B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, carried(jp), x


def close(got, want, tol, what=""):
    got = np.asarray(got.float(), np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def routed_per_expert(tcfg, tp, x) -> np.ndarray:
    """[B, E]: tokens of each row whose top-k holds the expert."""
    probs = torch.softmax(torch.tensor(x) @ tp.router, dim=-1)
    _, topi = TMoE.top_k(probs, tcfg.experts_per_token)
    return torch.nn.functional.one_hot(topi, tcfg.n_experts).sum(
        (1, 2)).numpy()


@pytest.mark.parametrize("name", ARCHS)
def test_init_has_jaxs_names_shapes_and_scales(name):
    jcfg, tcfg = jconfigs.smoke_config(name), tconfigs.smoke_config(name)
    jp = JMoE.init_moe(jax.random.key(0), jcfg, jnp.float32)
    tp = TMoE.init_moe(torch.Generator().manual_seed(0), tcfg, torch.float32)
    got = {k: tuple(v.shape) for k, v in tp.named_parameters()}
    assert got == _flat(jp)
    assert tp.router.dtype == torch.float32
    assert (tp.shared is not None) == bool(tcfg.n_shared_experts)
    d = tcfg.d_model
    assert abs(float(tp.w_gate.std()) * np.sqrt(d) - 1.0) < 0.1
    assert abs(float(tp.router.std()) / 0.02 - 1.0) < 0.1


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


@pytest.mark.parametrize("n_tokens", [1, 7, 40, 64, 2048])
@pytest.mark.parametrize("name", ARCHS)
def test_capacity_matches_jax(name, n_tokens):
    for jc, tc in ((jconfigs.get_arch(name), tconfigs.get_arch(name)),
                   (jconfigs.smoke_config(name), tconfigs.smoke_config(name))):
        assert TMoE._capacity(n_tokens, tc) == JMoE._capacity(n_tokens, jc)


@pytest.mark.parametrize("shape", [(3, 9), (2, 5, 16), (4, 40)])
def test_top_k_breaks_ties_as_jax(shape):
    """Rows full of ties (zeros, repeated values): the same values and
    indices as ``jax.lax.top_k``, the lower index first."""
    rng = np.random.default_rng(sum(shape))
    x = rng.choice([0.0, 0.0, 0.0, 0.25, 0.5], size=shape).astype(np.float32)
    k = shape[-1] // 2
    wv, wi = jax.lax.top_k(jnp.asarray(x), k)
    gv, gi = TMoE.top_k(torch.tensor(x), k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ARCHS)
def test_moe_ffn_matches_jax_drop_free(name, dtype):
    jcfg, tcfg, jp, tp, x = both(name, dtype)
    jdt, tdt, tol = DTYPES[dtype]
    want, waux = JMoE.moe_ffn(jp, jcfg, jnp.asarray(x, jdt))
    got, aux = TMoE.moe_ffn(tp, tcfg, torch.tensor(x).to(tdt))
    assert got.dtype == tdt and aux.dtype == torch.float32
    close(got, want, tol)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


@pytest.mark.parametrize("capacity_factor", [1.0, 0.5])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ARCHS)
def test_moe_ffn_matches_jax_when_an_expert_overflows(name, dtype,
                                                      capacity_factor):
    """Capacities under the busiest expert's load: the tokens past it are
    dropped as JAX drops them (the same tokens: the outputs agree)."""
    jcfg, tcfg, jp, tp, x = both(name, dtype, capacity_factor, seed=5)
    jdt, tdt, tol = DTYPES[dtype]
    cap = TMoE._capacity(S, tcfg)
    load = routed_per_expert(tcfg, tp, x)
    assert load.max() > cap, (load, cap)        # an expert overflows
    want, waux = JMoE.moe_ffn(jp, jcfg, jnp.asarray(x, jdt))
    got, aux = TMoE.moe_ffn(tp, tcfg, torch.tensor(x).to(tdt))
    close(got, want, tol)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    # and dropping changed the output: the drop-free layer differs
    free = dataclasses.replace(tcfg, capacity_factor=float(tcfg.n_experts))
    full, _ = TMoE.moe_ffn(tp, free, torch.tensor(x).to(tdt))
    assert not torch.allclose(full, got)


def test_dropped_tokens_keep_only_the_shared_expert():
    """At the smallest capacity (8 of 160 tokens an expert: 64 slots) a
    token no expert kept gets nothing from the routed experts: deepseek's
    output there is the shared expert's alone."""
    jcfg, tcfg, jp, tp, _ = both("deepseek-v3-671b", "float32", 0.01,
                                 seed=7)
    n = 160
    x = np.random.default_rng(8).normal(size=(B, n, jcfg.d_model)).astype(
        np.float32)
    got, _ = TMoE.moe_ffn(tp, tcfg, torch.tensor(x))
    want, _ = JMoE.moe_ffn(jp, jcfg, jnp.asarray(x))
    close(got, want, 1e-5)
    sp = tp.shared
    xt = torch.tensor(x)
    shared = (torch.nn.functional.silu(xt @ sp.w_gate) * (xt @ sp.w_up)
              ) @ sp.w_down
    kept = np.zeros((B, n), bool)
    probs = torch.softmax(xt @ tp.router, dim=-1)
    topv, topi = TMoE.top_k(probs, tcfg.experts_per_token)
    topv = topv / topv.sum(-1, keepdim=True)
    sel = torch.zeros((B, n, tcfg.n_experts)).scatter(-1, topi, topv)
    escore, eidx = TMoE.top_k(sel.transpose(1, 2), TMoE._capacity(n, tcfg))
    for b in range(B):
        kept[b, eidx[b][escore[b] > 0].numpy()] = True
    assert (~kept).any()
    np.testing.assert_allclose(got[~kept].numpy(), shared[~kept].numpy(),
                               rtol=0, atol=1e-6)


def test_single_token_decode_matches_jax():
    """S = 1, as a decode step calls it: a capacity of one token."""
    jcfg, tcfg, jp, tp, x = both("grok-1-314b", "float32")
    want, waux = JMoE.moe_ffn(jp, jcfg, jnp.asarray(x[:, :1]))
    got, aux = TMoE.moe_ffn(tp, tcfg, torch.tensor(x[:, :1]))
    close(got, want, 1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


def test_experts_use_silu_whatever_the_config_says():
    jcfg, tcfg, jp, tp, x = both("grok-1-314b", "float32")
    assert tcfg.act == "gelu"
    silu = dataclasses.replace(tcfg, act="silu")
    a, _ = TMoE.moe_ffn(tp, tcfg, torch.tensor(x))
    b, _ = TMoE.moe_ffn(tp, silu, torch.tensor(x))
    assert torch.equal(a, b)
