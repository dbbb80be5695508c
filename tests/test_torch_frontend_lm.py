"""repro_torch's ``embeds`` input path against the JAX package: the audio
and VLM configs (``cfg.frontend``: ``musicgen-large``, ``chameleon-34b``)
are served from their front ends' embeddings, as JAX's
``make_prefill_step`` / ``make_serve_step`` serve them.

On each ``smoke_config`` (4 layers, d_model 128, 4 query heads and 2 KV
heads of 32, vocab 512) with 4 layer-groves of one layer, at fp32, with
JAX's weights carried over (``models/carry.py``) and embeddings made with
numpy from a seed: ``forward``, a prefill on ``[B, S, d]``, greedy decode
on ``[B, 1, d]`` and ``decode_step_fog`` at per-lane thresholds, in both
packages.

Tolerances: those of tests/test_torch_attn_lm.py for tinyllama, logits
and caches within 1e-4 of their scale (their largest magnitude): the
port's prefill runs ``ops.flash_attention``'s full-matrix plain version
where JAX's runs its blocked online softmax, and the two sum fp32 terms in
their own order over 4 layers.  Hops must be equal: a lane whose hop count
differs is reported with its margin's distance from the threshold, never
hidden.
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

ARCHS = ["musicgen-large", "chameleon-34b"]
B, S, EXTRA = 4, 48, 8
MAX_SEQ = S + EXTRA
LOGIT_TOL = 1e-4
THRESH = [0.0, 2.0, 0.01, 0.5]


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
    want = np_tree(jax_cache)
    for r, blk in enumerate(port["stack"]):
        for name in ("k", "v"):
            assert_scaled_close(blk["pos0"][name].numpy(),
                                want["stack"]["pos0"][name][r], LOGIT_TOL,
                                f"block {r} {name}")


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """The smoke config with 4 groves, JAX's fp32 weights in both packages,
    prompt embeddings [B, S, d] and JAX's prefill of them into a cache of
    MAX_SEQ positions."""
    name = request.param
    jcfg = jconfigs.smoke_config(name).scaled(fog_groups=4)
    tcfg = tconfigs.smoke_config(name).scaled(fog_groups=4)
    assert tcfg.frontend and tcfg.frontend == jcfg.frontend
    jparams = JT.init_params(jcfg, jax.random.key(0), jnp.float32)
    tparams = params_from_jax(np_tree(jparams), tcfg, device="cpu")
    rng = np.random.default_rng(len(name))
    embeds = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    logits, cache = JT.prefill(jparams, jcfg, embeds=jnp.asarray(embeds),
                               max_seq=MAX_SEQ)
    return {"jcfg": jcfg, "tcfg": tcfg, "jparams": jparams,
            "tparams": tparams, "embeds": embeds, "rng": rng,
            "jlogits": logits, "jcache": cache}


def carried(lm) -> dict:
    return cache_from_jax(np_tree(lm["jcache"]), lm["tcfg"], device="cpu")


def next_embeds(lm, logits: np.ndarray, t: int) -> np.ndarray:
    """A decode step's input [B, 1, d]: the embedding of each lane's greedy
    token plus a frame made with numpy from the step's seed (a front end's
    stand-in)."""
    table = np.asarray(lm["jparams"]["embed"])
    frame = np.random.default_rng(100 + t).normal(
        size=(B, 1, table.shape[1])).astype(np.float32)
    return table[logits.argmax(-1)][:, None] + 0.5 * frame


def test_forward_from_embeds_and_from_tokens_matches_jax(lm):
    """forward from embeds [B, S, d]; the model function still takes
    tokens for these configs, as JAX's does."""
    jcfg, tcfg, tp = lm["jcfg"], lm["tcfg"], lm["tparams"]
    h, aux = T.forward(tp, tcfg, embeds=torch.as_tensor(lm["embeds"]))
    hj, _ = JT.forward(lm["jparams"], jcfg, embeds=jnp.asarray(lm["embeds"]),
                       remat=False)
    assert_scaled_close(T.unembed(tp, tcfg, h).numpy(),
                        JT.unembed(lm["jparams"], jcfg, hj), LOGIT_TOL)
    assert float(aux) == 0.0
    tokens = lm["rng"].integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    h, _ = T.forward(tp, tcfg, torch.as_tensor(tokens))
    hj, _ = JT.forward(lm["jparams"], jcfg, tokens=jnp.asarray(tokens),
                       remat=False)
    assert_scaled_close(T.unembed(tp, tcfg, h).numpy(),
                        JT.unembed(lm["jparams"], jcfg, hj), LOGIT_TOL)
    with pytest.raises(ValueError, match="give tokens or embeds"):
        T.forward(tp, tcfg)


def test_prefill_from_embeds_matches_jax(lm):
    logits, cache = T.prefill(lm["tparams"], lm["tcfg"],
                              embeds=torch.as_tensor(lm["embeds"]),
                              max_seq=MAX_SEQ)
    assert logits.dtype == torch.float32 and logits.shape == (
        B, lm["tcfg"].vocab_size)
    assert_scaled_close(logits.numpy(), lm["jlogits"], LOGIT_TOL)
    assert_cache_close(cache, lm["jcache"])
    assert cache["stack"][0]["pos0"]["k"].shape[1] == MAX_SEQ


def test_greedy_decode_from_embeds_matches_jax(lm):
    """Successive decode steps on [B, 1, d] from JAX's prefill, in both
    packages; the greedy tokens agree at every step."""
    jcfg, tcfg = lm["jcfg"], lm["tcfg"]
    jcache, tcache = lm["jcache"], carried(lm)
    last = np.asarray(lm["jlogits"])
    for t in range(S, S + 4):
        x = next_embeds(lm, last, t)
        want, jcache = JT.decode_step(lm["jparams"], jcfg, None, jcache,
                                      jnp.int32(t), embeds=jnp.asarray(x))
        got, tcache = T.decode_step(lm["tparams"], tcfg, None, tcache, t,
                                    embeds=torch.as_tensor(x))
        assert_scaled_close(got.numpy(), want, LOGIT_TOL, f"position {t}")
        assert_cache_close(tcache, jcache)
        assert np.array_equal(got.numpy().argmax(-1),
                              np.asarray(want).argmax(-1))
        last = np.asarray(want)


@pytest.mark.parametrize("thresh,budget", [
    (THRESH, None), (2.0, None), (0.0, None), (2.0, 2)],
    ids=["per-lane", "never-exit", "exit-at-once", "budget-2"])
def test_decode_step_fog_from_embeds_matches_jax(lm, thresh, budget):
    x = next_embeds(lm, np.asarray(lm["jlogits"]), S)
    jthr = thresh if np.isscalar(thresh) else np.asarray(thresh, np.float32)
    want_logits, want_cache, want_hops = jfog.decode_step_fog(
        lm["jparams"], lm["jcfg"], None, lm["jcache"], jnp.int32(S),
        JPolicy(threshold=jthr, hop_budget=budget), embeds=jnp.asarray(x))
    tthr = thresh if np.isscalar(thresh) else torch.tensor(
        thresh, dtype=torch.float32)
    logits, cache, hops = tfog.decode_step_fog(
        lm["tparams"], lm["tcfg"], None, carried(lm), S,
        FogPolicy(threshold=tthr, hop_budget=budget),
        embeds=torch.as_tensor(x))
    want_hops = np.asarray(want_hops)
    flipped = np.flatnonzero(hops.numpy() != want_hops)
    if flipped.size:
        pytest.fail(f"hops {hops.tolist()} != JAX {want_hops.tolist()} "
                    f"(lanes {flipped.tolist()}, thresholds {thresh})")
    assert hops.dtype == torch.int32 and hops.shape == (B,)
    if thresh == THRESH:
        assert hops[0] == 1 and hops[1] == 4
    assert_scaled_close(logits.numpy(), want_logits, LOGIT_TOL)
    assert_cache_close(cache, want_cache)


def test_serving_steps_take_embeds(lm):
    """make_prefill_step / make_serve_step name ``"embeds"`` in their
    inputs, as JAX's do, and equal the model functions."""
    cfg, tp = lm["tcfg"], lm["tparams"]
    d, f32 = cfg.d_model, torch.float32
    embeds = torch.as_tensor(lm["embeds"])
    prefill_fn, inputs = make_prefill_step(cfg, "cpu", batch=B, seq_len=S,
                                           max_seq=MAX_SEQ, param_dtype=f32)
    assert inputs == {"embeds": ((B, S, d), f32)}
    logits, cache = prefill_fn(tp, embeds)
    want_logits, want_cache = T.prefill(tp, cfg, embeds=embeds,
                                        max_seq=MAX_SEQ)
    assert torch.equal(logits, want_logits)

    x = torch.as_tensor(next_embeds(lm, logits.numpy(), S))
    step, inputs = make_serve_step(cfg, "cpu", batch=B, max_seq=MAX_SEQ,
                                   param_dtype=f32)
    assert inputs == {"embeds": ((B, 1, d), f32)}
    got, _ = step(tp, cache, x, S)
    assert torch.equal(got, T.decode_step(tp, cfg, None, want_cache, S,
                                          embeds=x)[0])
    fog_step, inputs = make_serve_step(cfg, "cpu", batch=B, max_seq=MAX_SEQ,
                                       fog=True, param_dtype=f32,
                                       policy=FogPolicy(backend="pallas"))
    assert set(inputs) == {"embeds", "fog_thresh", "fog_budget"}
    thresh = torch.tensor(THRESH)
    budget = torch.tensor([4, 4, 4, 2], dtype=torch.int32)
    got, _, hops = fog_step(tp, cache, x, S, thresh, budget)
    want, _, want_hops = tfog.decode_step_fog(
        tp, cfg, None, want_cache, S,
        FogPolicy(threshold=thresh, hop_budget=budget, backend="pallas"),
        embeds=x)
    assert torch.equal(got, want) and torch.equal(hops, want_hops)
    assert hops[0] == 1 and hops[3] <= 2


def test_serving_steps_check_the_embeds(lm):
    """Shape, dtype and device are checked before the step runs; token ids
    are refused where the step takes embeddings."""
    cfg, tp = lm["tcfg"], lm["tparams"]
    prefill_fn, _ = make_prefill_step(cfg, "cpu", batch=B, seq_len=S,
                                      param_dtype=torch.float32)
    embeds = torch.as_tensor(lm["embeds"])
    with pytest.raises(ValueError, match=r"embeds must have shape"):
        prefill_fn(tp, embeds[:, :8])
    with pytest.raises(TypeError, match="embeds must be torch.float32"):
        prefill_fn(tp, embeds.to(torch.bfloat16))
    with pytest.raises(ValueError, match="embeds must have shape"):
        prefill_fn(tp, torch.zeros((B, S), dtype=torch.int32))
    step, _ = make_serve_step(cfg, "cpu", batch=B, max_seq=MAX_SEQ)
    x = torch.zeros((B, 1, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="embeds must have shape"):
        step(tp, carried(lm), x[:2], S)
    with pytest.raises(TypeError, match="embeds must be torch.bfloat16"):
        step(tp, carried(lm), x.float(), S)
    with pytest.raises(ValueError, match="embeds is on meta"):
        step(tp, carried(lm), x.to("meta"), S)
    with pytest.raises(ValueError, match="outside the cache"):
        step(tp, carried(lm), x, MAX_SEQ)
