"""repro_torch's decoder end to end against the JAX package at the smoke
configs of the dense configs the attention slice built (gemma-2b: tied
embeddings, MQA, GeGLU, and at its own head dim of 256; granite-34b: MQA,
the non-gated GELU MLP) and of the MLA, MoE and hybrid configs
(minicpm3-4b: MLA; deepseek-v3-671b: MLA, a dense prefix layer, MoE with
a shared expert, the MTP head carried; grok-1-314b: MoE top 2 with GELU
attention FFNs; jamba-1.5-large-398b: the hybrid period of 8, one
attention layer among Mamba layers that keep their FFN, MoE every other
layer), at fp32, with JAX's weights and caches carried over
(``models/carry.py``).

Tolerances: logits within 1e-4 of the logit scale (their largest
magnitude) and caches within 1e-4 of theirs, the bar of
``tests/test_torch_attn_lm.py``; the MoE load-balance loss within rtol
1e-5.  Hops must be equal.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.core import FogPolicy as JPolicy  # noqa: E402
from repro.models import fog_exit as jfog  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import FogPolicy  # noqa: E402
from repro_torch.models import fog_exit as tfog  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.carry import (cache_from_jax,  # noqa: E402
                                      params_from_jax)
from repro_torch.serve.decode import (make_prefill_step,  # noqa: E402
                                      make_serve_step)

# name -> overrides of the smoke config (both packages)
CONFIGS = {
    "gemma-2b": {},
    "gemma-2b-hd256": {"head_dim": 256},
    "granite-34b": {},
    "minicpm3-4b": {},
    "deepseek-v3-671b": {},
    "grok-1-314b": {},
    "jamba-1.5-large-398b": {},
}
B, S, EXTRA = 3, 32, 4
MAX_SEQ = S + EXTRA
TOL = 1e-4
THRESHOLDS = {"exit-all": 0.0, "never": 2.0, "per-lane": [0.0, 2.0, 2.0]}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def arch(name: str) -> str:
    return name.removesuffix("-hd256")


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def lm(request):
    name = request.param
    jcfg = jconfigs.smoke_config(arch(name)).scaled(**CONFIGS[name])
    tcfg = tconfigs.smoke_config(arch(name)).scaled(**CONFIGS[name])
    jparams = JT.init_params(jcfg, jax.random.key(0), jnp.float32)
    tparams = params_from_jax(np_tree(jparams), tcfg, device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    logits, cache = JT.prefill(jparams, jcfg, tokens=jnp.asarray(tokens),
                               max_seq=MAX_SEQ)
    return {"name": name, "jcfg": jcfg, "tcfg": tcfg, "jparams": jparams,
            "tparams": tparams, "tokens": tokens, "jlogits": logits,
            "jcache": cache}


def close(got, want, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def assert_cache_close(port: dict, jax_cache: dict):
    """The port's per-block cache against JAX's stacked one, leaf by leaf
    (K/V, MLA latent and rope key, Mamba state and conv tails)."""
    want = np_tree(jax_cache)
    for i, layer in enumerate(port["prefix"]):
        w = dict(leaves(want["prefix"][i]))
        assert sorted(w) == sorted(p for p, _ in leaves(layer))
        for path, got in leaves(layer):
            close(got.numpy(), w[path], f"prefix {i}{path}")
    for r, blk in enumerate(port["stack"]):
        w = dict(leaves(want["stack"]))
        assert sorted(w) == sorted(p for p, _ in leaves(blk))
        for path, got in leaves(blk):
            close(got.numpy(), w[path][r], f"block {r}{path}")


def carried(lm) -> dict:
    return cache_from_jax(np_tree(lm["jcache"]), lm["tcfg"], device="cpu")


def test_carried_model_has_jaxs_structure(lm):
    tcfg, tp = lm["tcfg"], lm["tparams"]
    prefix, period, n_rep = T.layer_plan(tcfg)
    assert len(tp.prefix) == len(prefix) and len(tp.stack) == n_rep
    assert (tp.unembed is None) == tcfg.tie_embeddings
    assert (tp.mtp is not None) == tcfg.mtp
    for p, s in T._layers(tp, tcfg):
        assert (p.mamba is not None) == (s.mixer == "mamba")
        assert (p.ffn is None) == (s.mixer == "mamba"
                                   and not tcfg.attn_layer_period)
        if p.ffn is not None:
            assert hasattr(p.ffn, "router") == (s.ffn == "moe")
        if s.mixer != "mamba":
            assert hasattr(p.attn, "w_dkv") == (s.mixer == "mla")
    n = sum(a.size for _, a in leaves(np_tree(lm["jparams"])))
    assert sum(p.numel() for p in tp.parameters()) == n


def test_forward_matches_jax(lm):
    tcfg, tp = lm["tcfg"], lm["tparams"]
    h, aux = T.forward(tp, tcfg, torch.as_tensor(lm["tokens"]))
    hj, auxj = JT.forward(lm["jparams"], lm["jcfg"],
                          tokens=jnp.asarray(lm["tokens"]), remat=False)
    close(T.unembed(tp, tcfg, h).numpy(),
          JT.unembed(lm["jparams"], lm["jcfg"], hj))
    np.testing.assert_allclose(float(aux), float(auxj), rtol=1e-5)
    assert (float(aux) > 0) == tcfg.moe


def test_prefill_matches_jax(lm):
    logits, cache = T.prefill(lm["tparams"], lm["tcfg"],
                              torch.as_tensor(lm["tokens"]), max_seq=MAX_SEQ)
    close(logits.numpy(), lm["jlogits"])
    assert_cache_close(cache, lm["jcache"])


def test_decode_steps_match_jax(lm):
    jcfg, tcfg = lm["jcfg"], lm["tcfg"]
    jcache, tcache = lm["jcache"], carried(lm)
    tok = lm["tokens"][:, -1]
    for t in range(S, S + 3):
        want, jcache = JT.decode_step(lm["jparams"], jcfg, jnp.asarray(tok),
                                      jcache, jnp.int32(t))
        got, tcache = T.decode_step(lm["tparams"], tcfg, torch.as_tensor(tok),
                                    tcache, t)
        close(got.numpy(), want, f"position {t}")
        assert_cache_close(tcache, jcache)
        tok = np.asarray(want).argmax(-1).astype(np.int32)


def test_decode_after_prefill_matches_forward(lm):
    tcfg, tp = lm["tcfg"], lm["tparams"]
    tokens = torch.as_tensor(lm["tokens"])
    h, _ = T.forward(tp, tcfg, tokens)
    want = T.unembed(tp, tcfg, h)
    split = S // 2
    logits, cache = T.prefill(tp, tcfg, tokens[:, :split], max_seq=S)
    close(logits.numpy(), want[:, split - 1].numpy())
    for t in range(split, S):
        logits, cache = T.decode_step(tp, tcfg, tokens[:, t], cache, t)
        close(logits.numpy(), want[:, t].numpy(), f"position {t}")


@pytest.mark.parametrize("thresh", sorted(THRESHOLDS))
def test_decode_step_fog_matches_jax(lm, thresh):
    """At 0 every lane exits after the first grove (the later groves take
    the skip branch: K/V, MLA latent or Mamba state filled, then
    discarded by the mask); at 2 none does."""
    value = THRESHOLDS[thresh]
    tok = lm["tokens"][:, -1]
    want_logits, want_cache, want_hops = jfog.decode_step_fog(
        lm["jparams"], lm["jcfg"], jnp.asarray(tok), lm["jcache"],
        jnp.int32(S), JPolicy(threshold=np.asarray(value, np.float32)))
    logits, cache, hops = tfog.decode_step_fog(
        lm["tparams"], lm["tcfg"], torch.as_tensor(tok), carried(lm), S,
        FogPolicy(threshold=torch.tensor(value, dtype=torch.float32)))
    G = len(tfog.grove_boundaries(lm["tcfg"]))
    assert hops.tolist() == np.asarray(want_hops).tolist()
    want = {"exit-all": [1] * B, "never": [G] * B,
            "per-lane": [1, G, G]}[thresh]
    assert hops.tolist() == want
    close(logits.numpy(), want_logits)
    assert_cache_close(cache, want_cache)


def test_serving_steps_on_cpu(lm):
    cfg, tp = lm["tcfg"], lm["tparams"]
    tokens = torch.as_tensor(lm["tokens"])
    prefill_fn, _ = make_prefill_step(cfg, "cpu", batch=B, seq_len=S,
                                      max_seq=MAX_SEQ)
    logits, cache = prefill_fn(tp, tokens)
    close(logits.numpy(), lm["jlogits"])
    step, _ = make_serve_step(cfg, "cpu", batch=B, max_seq=MAX_SEQ)
    tok = logits.argmax(-1).to(torch.int32)
    got, _ = step(tp, cache, tok, S)
    assert torch.equal(got, T.decode_step(tp, cfg, tok, cache, S)[0])
    fog_step, _ = make_serve_step(cfg, "cpu", batch=B, max_seq=MAX_SEQ,
                                  fog=True, policy=FogPolicy(backend="pallas"))
    thresh = torch.tensor([0.0, 2.0, 2.0])
    budget = torch.tensor([4, 4, 1], dtype=torch.int32)
    got, _, hops = fog_step(tp, cache, tok, S, thresh, budget)
    want, _, want_hops = tfog.decode_step_fog(
        tp, cfg, tok, cache, S,
        FogPolicy(threshold=thresh, hop_budget=budget, backend="pallas"))
    assert torch.equal(got, want) and torch.equal(hops, want_hops)
    assert hops[0] == 1 and hops[2] == 1


def test_cache_init_matches_jax(lm):
    cache = T.cache_init(lm["tcfg"], 2, 16, torch.bfloat16, device="cpu")
    want = np_tree(JT.cache_init(lm["jcfg"], 2, 16))
    got = {p: a for p, a in leaves({"prefix": cache["prefix"]})}
    for path, w in leaves({"prefix": want["prefix"]}):
        assert tuple(got[path].shape) == w.shape, path
    for r, blk in enumerate(cache["stack"]):
        for path, a in leaves(blk):
            w = dict(leaves(want["stack"]))[path]
            assert tuple(a.shape) == w.shape[1:], path
            assert str(a.dtype) == f"torch.{w.dtype.name}", path
