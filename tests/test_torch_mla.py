"""repro_torch's Multi-head Latent Attention (``models/mla.py``) against
the JAX package's ``repro.models.mla`` from the same weights (JAX's
``init_mla`` carried over), at the smoke configs of minicpm3-4b and
deepseek-v3-671b (d_model 128, 4 heads, q rank 48, kv rank 32, dn 32, dr
16, dv 32).

Tolerances: fp32 within 1e-5 of the output's scale (its largest
magnitude): the full-sequence path runs ``ops.flash_attention``'s plain
version where JAX runs its blocked online softmax, and both sum fp32
terms in their own order; the absorbed decode's products are fp32 in
both.  bf16 within 2 bf16 ulps (2**-7) of the output's scale: roundings
to bf16 of the projections may fall on either side of a tie.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import mla as JM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import mla as TM  # noqa: E402
from repro_torch.models.carry import to_tensor  # noqa: E402

ARCHS = ["minicpm3-4b", "deepseek-v3-671b"]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2 * 2**-7)}
B, S = 2, 24


def both(name, dtype):
    """(JAX cfg, port cfg, JAX weights, port module, x as numpy fp32)."""
    jdt, tdt, _ = DTYPES[dtype]
    jcfg, tcfg = jconfigs.smoke_config(name), tconfigs.smoke_config(name)
    jp = JM.init_mla(jax.random.key(3), jcfg, jdt)
    tp = TM.MLA({k: to_tensor(np.asarray(v), "cpu") for k, v in jp.items()})
    x = np.random.default_rng(4).normal(size=(B, S, jcfg.d_model)).astype(
        np.float32)
    return jcfg, tcfg, jp, tp, x


def close(got, want, tol, what=""):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def test_init_has_jaxs_names_and_shapes():
    for name in ARCHS:
        tcfg = tconfigs.smoke_config(name)
        jp = JM.init_mla(jax.random.key(0), jconfigs.smoke_config(name),
                         jnp.float32)
        tp = TM.init_mla(torch.Generator().manual_seed(0), tcfg,
                         torch.float32)
        got = {k: tuple(v.shape) for k, v in tp.named_parameters()}
        assert got == {k: tuple(v.shape) for k, v in jp.items()}
        assert tuple(TM.PARAM_NAMES) == tuple(jp)
        assert not tp.q_norm.any() and not tp.kv_norm.any()
        # JAX's scale: normal / sqrt(first dim)
        assert abs(float(tp.w_uk.std()) * np.sqrt(tcfg.kv_lora_rank)
                   - 1.0) < 0.1


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ARCHS)
def test_projections_match_jax(name, dtype):
    jcfg, tcfg, jp, tp, x = both(name, dtype)
    jdt, tdt, tol = DTYPES[dtype]
    pos = np.broadcast_to(np.arange(S) + 5, (B, S))
    for jf, tf in ((JM._project_q, TM._project_q),
                   (JM._compress_kv, TM._compress_kv)):
        want = jf(jp, jcfg, jnp.asarray(x, jdt), jnp.asarray(pos))
        got = tf(tp, tcfg, torch.tensor(x).to(tdt), torch.tensor(pos))
        for g, w, part in zip(got, want, ("first", "second")):
            assert g.dtype == tdt
            close(g, w, tol, f"{jf.__name__} {part}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ARCHS)
def test_full_sequence_path_matches_jax(name, dtype, monkeypatch):
    """One ``ops.flash_attention`` call with q/k heads of dn + dr, value
    heads of dv, k_rope broadcast over the heads, scale 1/sqrt(dn + dr)."""
    jcfg, tcfg, jp, tp, x = both(name, dtype)
    jdt, tdt, tol = DTYPES[dtype]
    calls, real = [], ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), kw,
                      k.is_contiguous()))
        # the rope part of k is one vector per position, shared by heads
        assert torch.equal(k[..., tcfg.qk_nope_head_dim:],
                           k[:, :, :1, tcfg.qk_nope_head_dim:].expand(
                               -1, -1, k.shape[2], -1))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    want = JM.mla_attention_train(jp, jcfg, jnp.asarray(x, jdt))
    out, c_kv, k_rope = TM.mla_forward(tp, tcfg, torch.tensor(x).to(tdt))
    D = tcfg.qk_nope_head_dim + tcfg.qk_rope_head_dim
    H = tcfg.n_heads
    assert calls == [((B, S, H, D), (B, S, H, D),
                      (B, S, H, tcfg.v_head_dim),
                      {"causal": True, "scale": 1.0 / np.sqrt(D)}, True)]
    assert out.dtype == tdt
    close(out, want, tol)
    pos = np.broadcast_to(np.arange(S), (B, S))
    jc, jr = JM._compress_kv(jp, jcfg, jnp.asarray(x, jdt), jnp.asarray(pos))
    close(c_kv, jc, tol)
    close(k_rope, jr, tol)


@pytest.mark.parametrize("length", [0, 7, S])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ARCHS)
def test_absorbed_decode_matches_jax(name, dtype, length):
    """One absorbed step against a cache of S + 4 positions (random rows
    below ``length``, zeros above): the output and the new cache, whose
    row at ``length`` is written and whose other rows are unchanged."""
    jcfg, tcfg, jp, tp, x = both(name, dtype)
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(length)
    M = S + 4
    cache = {"c_kv": rng.normal(size=(B, M, jcfg.kv_lora_rank)),
             "k_rope": rng.normal(size=(B, M, jcfg.qk_rope_head_dim))}
    for a in cache.values():
        a[:, length:] = 0.0
    xs = x[:, :1]
    jcache = {k: jnp.asarray(v, jdt) for k, v in cache.items()}
    tcache = {k: torch.tensor(v, dtype=torch.float32).to(tdt)
              for k, v in cache.items()}
    want, wcache = JM.mla_attention_decode(jp, jcfg, jnp.asarray(xs, jdt),
                                           jcache, length)
    got, gcache = TM.mla_attention_decode(tp, tcfg,
                                          torch.tensor(xs).to(tdt), tcache,
                                          length)
    assert got.shape == (B, 1, tcfg.d_model) and got.dtype == tdt
    close(got, want, tol)
    for k in cache:
        close(gcache[k], wcache[k], tol, k)
        assert gcache[k] is not tcache[k]
        keep = np.arange(M) != length
        assert torch.equal(gcache[k][:, keep], tcache[k][:, keep])
    with pytest.raises(ValueError, match="outside the KV cache"):
        TM.mla_attention_decode(tp, tcfg, torch.tensor(xs).to(tdt), tcache,
                                M)


def test_decode_products_run_with_tf32_off():
    """The absorbed products are fp32 products: TF32 is off inside them
    and restored after."""
    jcfg, tcfg, jp, tp, x = both("minicpm3-4b", "float32")
    seen = []
    real = torch.einsum

    def spy(*a):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*a)

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        torch.einsum = spy
        TM.mla_attention_decode(
            tp, tcfg, torch.tensor(x[:, :1]),
            TM.mla_cache_init(tcfg, B, 8, torch.float32, "cpu"), 3)
    finally:
        torch.einsum = real
        after = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert seen == [False] * 5 and after is True


@pytest.mark.parametrize("name", ARCHS)
def test_cache_init_matches_jax(name):
    jcfg, tcfg = jconfigs.smoke_config(name), tconfigs.smoke_config(name)
    want = JM.mla_cache_init(jcfg, 3, 16, jnp.bfloat16)
    got = TM.mla_cache_init(tcfg, 3, 16, torch.bfloat16, "cpu")
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape
        assert v.dtype == torch.bfloat16 and not v.any()
