"""repro_torch's attention serving path (RoPE, decode attention, the gated
FFN, forward, prefill, decode_step, decode_step_fog, the serving steps)
against the JAX package on ``smoke_config("tinyllama-1.1b")`` (4 layers,
d_model 128, 4 query heads and 2 KV heads of 32, SwiGLU d_ff 256, vocab
512) with 4 layer-groves of one layer, at fp32, with the JAX weights and
caches carried over (``models/carry.py``).

Tolerances: logits within 1e-4 of the logit scale (their largest
magnitude) and caches within 1e-4 of theirs.  The port's prefill runs
``ops.flash_attention`` (on the CPU its full-matrix plain version) where
JAX's runs its blocked online softmax, and the two sum fp32 terms in
their own order over 4 layers.  The layers alone: within 1e-5 of their
output's scale.  Hops must be equal: a lane whose hop count differs is
reported with its margin's distance from the threshold, never hidden.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.core import FogPolicy as JPolicy  # noqa: E402
from repro.models import fog_exit as jfog  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import FogPolicy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import fog_exit as tfog  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.carry import (cache_from_jax,  # noqa: E402
                                      params_from_jax)
from repro_torch.serve.decode import (make_prefill_step,  # noqa: E402
                                      make_serve_step)

ARCH = "tinyllama-1.1b"
B, S, EXTRA = 4, 64, 8
MAX_SEQ = S + EXTRA
LOGIT_TOL, LAYER_TOL = 1e-4, 1e-5
# configs whose layers the port built last (MLA, MoE, the hybrid period)
WAITING = ["minicpm3-4b", "deepseek-v3-671b", "grok-1-314b",
           "jamba-1.5-large-398b"]


@pytest.fixture(scope="module")
def lm():
    """The smoke config with 4 groves, JAX's fp32 weights in both
    packages, a batch of prompts and JAX's prefill of it into a cache of
    MAX_SEQ positions."""
    jcfg = jconfigs.smoke_config(ARCH).scaled(fog_groups=4)
    tcfg = tconfigs.smoke_config(ARCH).scaled(fog_groups=4)
    jparams = JT.init_params(jcfg, jax.random.key(0), jnp.float32)
    tparams = params_from_jax(np_tree(jparams), tcfg, device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    logits, cache = JT.prefill(jparams, jcfg, tokens=jnp.asarray(tokens),
                               max_seq=MAX_SEQ)
    return {"jcfg": jcfg, "tcfg": tcfg, "jparams": jparams,
            "tparams": tparams, "tokens": tokens, "jlogits": logits,
            "jcache": cache}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_scaled_close(got, want, tol, what=""):
    """|got - want| <= tol * max|want| elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def assert_cache_close(port: dict, jax_cache: dict):
    """The port's per-block K/V cache against JAX's stacked one."""
    want = np_tree(jax_cache)
    for r, blk in enumerate(port["stack"]):
        for key, layer in blk.items():
            for name in ("k", "v"):
                assert_scaled_close(layer[name].numpy(),
                                    want["stack"][key][name][r], LOGIT_TOL,
                                    f"block {r} {name}")


def carried(lm) -> dict:
    return cache_from_jax(np_tree(lm["jcache"]), lm["tcfg"], device="cpu")


# ------------------------------------------------------------- layers ---
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(dtype):
    """Half-split RoPE at positions from 0 and from 1000, fp32 angles."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
    pos = np.arange(16)[None] + np.array([[0], [1000]])
    want = JL.apply_rope(jnp.asarray(x, dtype), jnp.asarray(pos), 10000.0)
    got = TL.apply_rope(torch.tensor(x).to(getattr(torch, dtype)),
                        torch.tensor(pos), 10000.0)
    assert str(got.dtype) == f"torch.{dtype}"
    assert_scaled_close(got.float().numpy(),
                        np.asarray(want.astype(jnp.float32)), LAYER_TOL)


@pytest.mark.parametrize("length", [1, 17, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(dtype, length):
    """GQA decode over a cache of 40 positions attended below ``length``;
    bf16 caches accumulate in fp32."""
    rng = np.random.default_rng(length)
    q, kc, vc = (rng.normal(size=sh).astype(np.float32)
                 for sh in ((3, 1, 8, 16), (3, 40, 2, 16), (3, 40, 2, 16)))
    want = JL.decode_attention(*(jnp.asarray(a, dtype) for a in (q, kc, vc)),
                               length)
    got = TL.decode_attention(*(torch.tensor(a).to(getattr(torch, dtype))
                                for a in (q, kc, vc)), length)
    assert_scaled_close(got.float().numpy(),
                        np.asarray(want.astype(jnp.float32)), LAYER_TOL)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False)])
def test_gated_ffn_matches_jax(act, gated):
    """SwiGLU, GeGLU (tanh GELU, jax.nn.gelu's default) and the plain MLP."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    wg, wu = (rng.normal(size=(32, 64)).astype(np.float32) / 6
              for _ in range(2))
    wd = rng.normal(size=(64, 32)).astype(np.float32) / 8
    want = JL.gated_ffn(jnp.asarray(x), jnp.asarray(wg),
                        jnp.asarray(wu) if gated else None, jnp.asarray(wd),
                        act)
    got = TL.gated_ffn(torch.tensor(x), torch.tensor(wg),
                       torch.tensor(wu) if gated else None, torch.tensor(wd),
                       act)
    assert_scaled_close(got.numpy(), np.asarray(want), LAYER_TOL)


# -------------------------------------------------------------- model ---
def test_forward_matches_jax(lm):
    tcfg, tp = lm["tcfg"], lm["tparams"]
    h, aux = T.forward(tp, tcfg, torch.as_tensor(lm["tokens"]))
    hj, _ = JT.forward(lm["jparams"], lm["jcfg"],
                       tokens=jnp.asarray(lm["tokens"]), remat=False)
    assert_scaled_close(T.unembed(tp, tcfg, h).numpy(),
                        JT.unembed(lm["jparams"], lm["jcfg"], hj), LOGIT_TOL)
    assert float(aux) == 0.0


def test_prefill_matches_jax_and_pads_the_cache(lm):
    logits, cache = T.prefill(lm["tparams"], lm["tcfg"],
                              torch.as_tensor(lm["tokens"]), max_seq=MAX_SEQ)
    assert logits.dtype == torch.float32 and logits.shape == (
        B, lm["tcfg"].vocab_size)
    assert_scaled_close(logits.numpy(), lm["jlogits"], LOGIT_TOL)
    assert_cache_close(cache, lm["jcache"])
    for blk in cache["stack"]:
        for name in ("k", "v"):
            t = blk["pos0"][name]
            assert t.shape == (B, MAX_SEQ, 2, 32)
            assert not t[:, S:].any() and t[:, :S].abs().sum() > 0


def test_prefill_runs_the_kernel_once_per_layer(lm, monkeypatch):
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    T.prefill(lm["tparams"], lm["tcfg"], torch.as_tensor(lm["tokens"]))
    assert calls == [((B, S, 4, 32), (B, S, 2, 32),
                      {"causal": True, "scale": None})] * lm["tcfg"].n_layers


def test_decode_steps_match_jax(lm):
    """Successive decode steps from JAX's prefill, in both packages."""
    jcfg, tcfg = lm["jcfg"], lm["tcfg"]
    jcache, tcache = lm["jcache"], carried(lm)
    tok = lm["tokens"][:, -1]
    for t in range(S, S + 4):
        want, jcache = JT.decode_step(lm["jparams"], jcfg, jnp.asarray(tok),
                                      jcache, jnp.int32(t))
        got, tcache = T.decode_step(lm["tparams"], tcfg, torch.as_tensor(tok),
                                    tcache, t)
        assert_scaled_close(got.numpy(), want, LOGIT_TOL, f"position {t}")
        assert_cache_close(tcache, jcache)
        tok = np.asarray(want).argmax(-1).astype(np.int32)


def test_decode_after_prefill_matches_forward(lm):
    """The check of tests/test_archs.py::test_decode_matches_forward on the
    port alone: decode after a prefill of half the prompt reproduces the
    forward's logits at every position."""
    tcfg, tp = lm["tcfg"], lm["tparams"]
    tokens = torch.as_tensor(lm["tokens"])
    h, _ = T.forward(tp, tcfg, tokens)
    want = T.unembed(tp, tcfg, h)
    split = S // 2
    logits, cache = T.prefill(tp, tcfg, tokens[:, :split], max_seq=S)
    assert_scaled_close(logits.numpy(), want[:, split - 1].numpy(),
                        LOGIT_TOL)
    for t in range(split, S):
        logits, cache = T.decode_step(tp, tcfg, tokens[:, t], cache, t)
        assert_scaled_close(logits.numpy(), want[:, t].numpy(), LOGIT_TOL,
                            f"position {t}")


def test_decode_beyond_the_cache_raises(lm):
    _, cache = T.prefill(lm["tparams"], lm["tcfg"],
                         torch.as_tensor(lm["tokens"]))
    with pytest.raises(ValueError, match="outside the KV cache"):
        T.decode_step(lm["tparams"], lm["tcfg"],
                      torch.as_tensor(lm["tokens"][:, -1]), cache, S)


# --------------------------------------------------------------- FoG ---
def fog_both(lm, thresh, budget=None):
    """decode_step_fog at position S in both packages from JAX's prefill:
    (JAX's (logits, cache, hops), the port's)."""
    tok = lm["tokens"][:, -1]

    def knob(v, dtype):
        return v if v is None or np.isscalar(v) else np.asarray(v, dtype)

    want = jfog.decode_step_fog(
        lm["jparams"], lm["jcfg"], jnp.asarray(tok), lm["jcache"],
        jnp.int32(S), JPolicy(threshold=knob(thresh, np.float32),
                              hop_budget=knob(budget, np.int32)))
    got = tfog.decode_step_fog(
        lm["tparams"], lm["tcfg"], torch.as_tensor(tok), carried(lm), S,
        FogPolicy(threshold=(thresh if np.isscalar(thresh)
                             else torch.tensor(thresh, dtype=torch.float32)),
                  hop_budget=(budget if budget is None or np.isscalar(budget)
                              else torch.tensor(budget, dtype=torch.int32))))
    return want, got


def gate_margins(lm) -> np.ndarray:
    """[G-1, B]: each lane's margin after every grove but the last, every
    lane running every grove."""
    cfg, params = lm["tcfg"], lm["tparams"]
    cache = carried(lm)
    h = T.embed_tokens(params, cfg, torch.as_tensor(lm["tokens"][:, -1])[:,
                                                                         None])
    out = []
    for r in range(len(params.stack) - 1):
        h, _ = T._apply_layer_decode(params.stack[r]["pos0"], cfg,
                                     T.layer_plan(cfg)[1][0], h,
                                     cache["stack"][r]["pos0"], S)
        probs = torch.softmax(T.unembed(params, cfg, h[:, 0]), dim=-1)
        out.append(tfog.confidence_margin(probs).numpy())
    return np.stack(out)


@pytest.mark.parametrize("thresh,budget", [
    (0.0, None), (0.01, None), (0.5, None), (2.0, None),
    ([0.0, 2.0, 0.01, 0.5], None), (2.0, 2)],
    ids=["thresh-0", "thresh-0.01", "thresh-0.5", "thresh-2", "per-lane",
         "budget-2"])
def test_decode_step_fog_matches_jax(lm, thresh, budget):
    (want_logits, want_cache, want_hops), (logits, cache, hops) = fog_both(
        lm, thresh, budget)
    want_hops = np.asarray(want_hops)
    flipped = np.flatnonzero(hops.numpy() != want_hops)
    if flipped.size:
        thr = np.broadcast_to(np.asarray(thresh, np.float32), (B,))
        dist = {int(b): np.abs(gate_margins(lm)[:, b] - thr[b]).tolist()
                for b in flipped}
        pytest.fail(f"hops {hops.tolist()} != JAX {want_hops.tolist()}; "
                    f"|margin - thresh| per gate of the flipped lanes: "
                    f"{dist}")
    assert hops.dtype == torch.int32
    assert_scaled_close(logits.numpy(), want_logits, LOGIT_TOL)
    assert_cache_close(cache, want_cache)


def test_exited_lane_keeps_its_old_kv_row(lm):
    """Lane 0 exits after the first grove; the deep layers' K/V row at its
    position stays as it was (zeros from the prefill's padding), as in
    JAX: the decode's write must not reach the cache the mask keeps."""
    (_, want_cache, want_hops), (_, cache, hops) = fog_both(
        lm, [0.0, 2.0, 2.0, 2.0])
    assert hops.tolist() == np.asarray(want_hops).tolist() == [1, 4, 4, 4]
    want = np_tree(want_cache)
    for r, blk in enumerate(cache["stack"]):
        for name in ("k", "v"):
            row = blk["pos0"][name][:, S].numpy()
            np.testing.assert_allclose(row, want["stack"]["pos0"][name][r][:,
                                                                          S],
                                       rtol=0, atol=1e-4 * np.abs(row).max())
            assert all(row[b].any() for b in (1, 2, 3))
            if r > 0:
                assert not row[0].any(), f"block {r} {name}"
            else:
                assert row[0].any()


def test_skipped_groves_discard_the_calm_fill(lm):
    """Every lane exits after the first grove: the skip branch's K/V fill of
    the later groves is discarded by the mask, as in JAX; their rows at
    this position stay zero."""
    (_, want_cache, _), (_, cache, hops) = fog_both(lm, 0.0)
    assert hops.tolist() == [1] * B
    assert_cache_close(cache, want_cache)
    for blk in cache["stack"][1:]:
        assert not blk["pos0"]["k"][:, S].any()
        assert not blk["pos0"]["v"][:, S].any()


def test_never_exit_fog_equals_plain_decode(lm):
    cfg, tp = lm["tcfg"], lm["tparams"]
    tok = torch.as_tensor(lm["tokens"][:, -1])
    plain, plain_cache = T.decode_step(tp, cfg, tok, carried(lm), S)
    logits, cache, hops = tfog.decode_step_fog(tp, cfg, tok, carried(lm), S,
                                               FogPolicy(threshold=2.0))
    assert hops.tolist() == [4] * B
    assert torch.equal(logits, plain)
    for got, want in zip(cache["stack"], plain_cache["stack"]):
        assert torch.equal(got["pos0"]["k"], want["pos0"]["k"])


# ---------------------------------------------------- serving, carry ---
def test_serving_steps_on_cpu(lm):
    cfg, tp = lm["tcfg"], lm["tparams"]
    tokens = torch.as_tensor(lm["tokens"])
    prefill_fn, inputs = make_prefill_step(cfg, "cpu", batch=B, seq_len=S,
                                           max_seq=MAX_SEQ)
    assert inputs == {"tokens": ((B, S), torch.int32)}
    logits, cache = prefill_fn(tp, tokens)
    want_logits, want_cache = T.prefill(tp, cfg, tokens, max_seq=MAX_SEQ)
    assert torch.equal(logits, want_logits)
    assert cache["stack"][0]["pos0"]["k"].shape[1] == MAX_SEQ

    step, _ = make_serve_step(cfg, "cpu", batch=B, max_seq=MAX_SEQ)
    tok = logits.argmax(-1).to(torch.int32)
    got, _ = step(tp, cache, tok, S)
    assert torch.equal(got, T.decode_step(tp, cfg, tok, want_cache, S)[0])
    fog_step, _ = make_serve_step(cfg, "cpu", batch=B, max_seq=MAX_SEQ,
                                  fog=True, policy=FogPolicy(backend="pallas"))
    thresh = torch.tensor([0.0, 2.0, 0.01, 2.0])
    budget = torch.tensor([4, 4, 4, 2], dtype=torch.int32)
    got, _, hops = fog_step(tp, cache, tok, S, thresh, budget)
    want, _, want_hops = tfog.decode_step_fog(
        tp, cfg, tok, want_cache, S,
        FogPolicy(threshold=thresh, hop_budget=budget, backend="pallas"))
    assert torch.equal(got, want) and torch.equal(hops, want_hops)
    assert hops[0] == 1 and hops[1] == 4 and hops[3] == 2
    with pytest.raises(ValueError, match="outside the cache"):
        step(tp, cache, tok, MAX_SEQ)


def test_cache_init_matches_jax(lm):
    cache = T.cache_init(lm["tcfg"], 3, 16, torch.bfloat16, device="cpu")
    want = np_tree(JT.cache_init(lm["jcfg"], 3, 16))
    for r, blk in enumerate(cache["stack"]):
        for name in ("k", "v"):
            t = blk["pos0"][name]
            assert t.dtype == torch.bfloat16
            assert t.shape == want["stack"]["pos0"][name][r].shape
            assert not t.any()


def test_cache_from_jax_carries_kv_bit_for_bit():
    """A bf16 JAX prefill's K/V cache arrives in the port bit for bit."""
    jcfg = jconfigs.smoke_config(ARCH)
    jparams = JT.init_params(jcfg, jax.random.key(1), jnp.bfloat16)
    tokens = jnp.asarray(np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32))
    _, jcache = JT.prefill(jparams, jcfg, tokens=tokens, max_seq=24)
    tree = np_tree(jcache)
    cache = cache_from_jax(tree, tconfigs.smoke_config(ARCH), device="cpu")
    assert len(cache["stack"]) == jcfg.n_layers
    for r, blk in enumerate(cache["stack"]):
        for name in ("k", "v"):
            got = blk["pos0"][name]
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(),
                tree["stack"]["pos0"][name][r].view(np.int16))


def test_params_from_jax_carries_bf16_bit_for_bit():
    jcfg = jconfigs.smoke_config(ARCH)
    tree = np_tree(JT.init_params(jcfg, jax.random.key(2), jnp.bfloat16))
    port = params_from_jax(tree, tconfigs.smoke_config(ARCH), device="cpu")
    layer = port.stack[1]["pos0"]
    jl = tree["stack"]["pos0"]
    for got, want in ((layer.attn.wq, jl["attn"]["wq"][1]),
                      (layer.attn.wo, jl["attn"]["wo"][1]),
                      (layer.ffn.w_up, jl["ffn"]["w_up"][1]),
                      (layer.ffn.w_down, jl["ffn"]["w_down"][1]),
                      (port.unembed, tree["unembed"])):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    assert not any(p.requires_grad for p in port.parameters())


@pytest.mark.parametrize("name", WAITING)
def test_mla_moe_and_hybrid_configs_still_raise(name):
    """The five entry points that raised for these configs until the last
    LM slice now build them and equal JAX: ``init_params`` and
    ``cache_init`` have JAX's shapes, ``params_from_jax`` carries bf16 bit
    for bit, and the prefill and serving steps from carried fp32 weights
    equal JAX's ``prefill`` and ``decode_step`` within 1e-4 of the logit
    scale (``tests/test_torch_lm_configs.py`` holds them end to end)."""
    tcfg, jcfg = tconfigs.smoke_config(name), jconfigs.smoke_config(name)
    port = T.init_params(tcfg, torch.Generator().manual_seed(0),
                         torch.float32, device="cpu")
    jtree = np_tree(JT.init_params(jcfg, jax.random.key(0), jnp.bfloat16))
    assert sum(p.numel() for p in port.parameters()) == sum(
        a.size for a in jax.tree.leaves(jtree))
    cache = T.cache_init(tcfg, 1, 8, device="cpu")
    jcache = np_tree(JT.cache_init(jcfg, 1, 8))
    shapes = lambda tree: sorted(tuple(a.shape)  # noqa: E731
                                 for a in jax.tree.leaves(tree))
    assert shapes(cache["prefix"]) == shapes(jcache["prefix"])
    assert len(cache["stack"]) == jax.tree.leaves(jcache["stack"])[0].shape[0]
    assert shapes(cache["stack"][0]) == sorted(
        s[1:] for s in shapes(jcache["stack"]))
    carried_bf16 = params_from_jax(jtree, tcfg, device="cpu")
    np.testing.assert_array_equal(
        carried_bf16.embed.view(torch.int16).numpy(),
        jtree["embed"].view(np.int16))
    assert all(p.dtype == torch.bfloat16 or p.dtype == torch.float32
               for p in carried_bf16.parameters())

    jparams = JT.init_params(jcfg, jax.random.key(1), jnp.float32)
    tparams = params_from_jax(np_tree(jparams), tcfg, device="cpu")
    tokens = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (1, 8)).astype(np.int32)
    prefill_fn, _ = make_prefill_step(tcfg, "cpu", batch=1, seq_len=8,
                                      max_seq=9, param_dtype=torch.float32)
    logits, tcache = prefill_fn(tparams, torch.as_tensor(tokens))
    want, jcache = JT.prefill(jparams, jcfg, tokens=jnp.asarray(tokens),
                              max_seq=9)
    assert_scaled_close(logits.numpy(), want, LOGIT_TOL)
    step, _ = make_serve_step(tcfg, "cpu", batch=1, max_seq=9,
                              param_dtype=torch.float32)
    tok = np.asarray(want).argmax(-1).astype(np.int32)
    got, _ = step(tparams, tcache, torch.as_tensor(tok), 8)
    want, _ = JT.decode_step(jparams, jcfg, jnp.asarray(tok), jcache,
                             jnp.int32(8))
    assert_scaled_close(got.numpy(), want, LOGIT_TOL)
