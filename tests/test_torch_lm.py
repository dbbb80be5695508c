"""repro_torch's Mamba-2 serving path (prefill, decode_step,
decode_step_fog, the serving steps) against the JAX package on
``smoke_config("mamba2-2.7b")`` with 4 layer-groves of one layer, at fp32,
with the JAX weights and caches carried over (``models/carry.py``), plus
the copied configs and their energy/FLOP accounting on every arch.

Tolerances: logits and caches within rtol/atol 1e-4.  The port's prefill
takes ``ssd_chunked(use_kernels=True)`` where JAX's takes the einsum
branch, and both sum fp32 terms in their own order over 4 layers (JAX's
own bar between the branches is rtol 1e-4 / atol 1e-5 for one scan;
logits are sums over d=128 of unit-scale products).  Hops must be equal:
a lane whose hop count differs is reported with its margin's distance
from the threshold at each gate, never hidden.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.core.policy as jpolicy  # noqa: E402
from repro.core import FogPolicy as JPolicy  # noqa: E402
from repro.data import lm_data as jdata  # noqa: E402
from repro.models import fog_exit as jfog  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import FogPolicy, margin_backend  # noqa: E402
from repro_torch.core.policy import BACKENDS  # noqa: E402
from repro_torch.data import DataConfig, batch_at_step  # noqa: E402
from repro_torch.models import fog_exit as tfog  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.carry import (cache_from_jax,  # noqa: E402
                                      params_from_jax)
from repro_torch.serve.decode import (make_prefill_step,  # noqa: E402
                                      make_serve_step)

TOL = {"rtol": 1e-4, "atol": 1e-4}
B, S = 4, 64
ARCHS = sorted(jconfigs.ARCHS)


@pytest.fixture(scope="module")
def lm():
    """The smoke config with 4 groves, JAX's fp32 weights in both
    packages, a batch of prompts and JAX's prefill of it."""
    name = "mamba2-2.7b"
    jcfg = jconfigs.smoke_config(name).scaled(fog_groups=4)
    tcfg = tconfigs.smoke_config(name).scaled(fog_groups=4)
    jparams = JT.init_params(jcfg, jax.random.key(0), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    tokens = batch_at_step(DataConfig(tcfg.vocab_size, S, B), 0)["tokens"]
    logits, cache = JT.prefill(jparams, jcfg, tokens=jnp.asarray(tokens))
    return {"jcfg": jcfg, "tcfg": tcfg, "jparams": jparams,
            "tparams": tparams, "tokens": tokens, "jlogits": logits,
            "jcache": cache}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_cache_close(port: dict, jax_cache: dict):
    """The port's per-block cache against JAX's stacked one."""
    want = np_tree(jax_cache)
    assert len(port["prefix"]) == len(want["prefix"])
    for r, blk in enumerate(port["stack"]):
        for key, layer in blk.items():
            w = want["stack"][key]
            np.testing.assert_allclose(layer["state"].numpy(),
                                       w["state"][r], **TOL)
            for got_t, want_t in zip(layer["conv"], w["conv"]):
                np.testing.assert_allclose(got_t.numpy(), want_t[r], **TOL)


def gate_margins(params, cfg, token, cache) -> np.ndarray:
    """[G-1, B]: each lane's MaxDiff margin after every grove but the
    last, with every lane running every grove (a lane's margins up to its
    exit are the same in any FoG run)."""
    h = T.embed_tokens(params, cfg, token[:, None])
    _, period, _ = T.layer_plan(cfg)
    out, start = [], 0
    sizes = tfog.grove_boundaries(cfg)
    for g, size in enumerate(sizes[:-1]):
        for r in range(start, start + size):
            for j, s in enumerate(period):
                h, _ = T._apply_layer_decode(
                    params.stack[r][f"pos{j}"], cfg, s, h,
                    cache["stack"][r][f"pos{j}"], 0)
        probs = torch.softmax(T.unembed(params, cfg, h[:, 0]), dim=-1)
        out.append(tfog.confidence_margin(probs).numpy())
        start += size
    return np.stack(out)


def test_batch_at_step_matches_jax():
    for step, host, n_hosts in ((0, 0, 1), (7, 1, 2)):
        cfg = DataConfig(vocab_size=512, seq_len=96, global_batch=4, seed=3)
        jcfg = jdata.DataConfig(vocab_size=512, seq_len=96, global_batch=4,
                                seed=3)
        got = batch_at_step(cfg, step, host=host, n_hosts=n_hosts)
        want = jdata.batch_at_step(jcfg, step, host=host, n_hosts=n_hosts)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])


def test_prefill_matches_jax(lm):
    logits, cache = T.prefill(lm["tparams"], lm["tcfg"],
                              tokens=torch.as_tensor(lm["tokens"]))
    assert logits.dtype == torch.float32 and logits.shape == (
        B, lm["tcfg"].vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(lm["jlogits"]),
                               **TOL)
    assert_cache_close(cache, lm["jcache"])


def test_forward_matches_jax_and_decode_matches_forward(lm):
    """JAX's forward == the port's; the port's decode after its own
    prefill reproduces its forward's logits at every position (the check
    of tests/test_archs.py::test_decode_matches_forward)."""
    tcfg, tp = lm["tcfg"], lm["tparams"]
    tokens = torch.as_tensor(lm["tokens"])
    h, aux = T.forward(tp, tcfg, tokens)
    want = T.unembed(tp, tcfg, h)
    hj, _ = JT.forward(lm["jparams"], lm["jcfg"],
                       tokens=jnp.asarray(lm["tokens"]), remat=False)
    np.testing.assert_allclose(
        want.numpy(), np.asarray(JT.unembed(lm["jparams"], lm["jcfg"], hj)),
        **TOL)
    assert float(aux) == 0.0
    split = S // 2
    logits, cache = T.prefill(tp, tcfg, tokens=tokens[:, :split],
                              max_seq=S + 4)
    np.testing.assert_allclose(logits.numpy(), want[:, split - 1].numpy(),
                               **TOL)
    for t in range(split, S):
        logits, cache = T.decode_step(tp, tcfg, tokens[:, t], cache, t)
        np.testing.assert_allclose(logits.numpy(), want[:, t].numpy(),
                                   **TOL, err_msg=f"position {t}")


def test_jax_prefill_continued_by_port_decode(lm):
    tok = lm["tokens"][:, -1]
    want_logits, want_cache = JT.decode_step(
        lm["jparams"], lm["jcfg"], jnp.asarray(tok), lm["jcache"],
        jnp.int32(S))
    cache = cache_from_jax(np_tree(lm["jcache"]), lm["tcfg"], device="cpu")
    logits, new_cache = T.decode_step(lm["tparams"], lm["tcfg"],
                                      torch.as_tensor(tok), cache, S)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **TOL)
    assert_cache_close(new_cache, want_cache)


# (name, threshold, hop budget): scalars, a per-lane vector and budgets
FOG_CASES = [
    ("thresh-0", 0.0, None),
    ("thresh-0.01", 0.01, None),
    ("thresh-2", 2.0, None),
    ("per-lane", [0.0, 2.0, 0.01, 0.02], None),
    ("budget-2", 2.0, 2),
    ("per-lane-budget", [2.0, 0.01, 2.0, 2.0], [1, 3, 2, 4]),
]


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("name,thresh,budget", FOG_CASES,
                         ids=[c[0] for c in FOG_CASES])
def test_decode_step_fog_matches_jax(lm, name, thresh, budget, backend):
    tok = lm["tokens"][:, -1]

    def knob(v, dtype):
        return v if v is None or np.isscalar(v) else np.asarray(v, dtype)

    jpol = JPolicy(threshold=knob(thresh, np.float32),
                   hop_budget=knob(budget, np.int32), backend=backend)
    want_logits, want_cache, want_hops = jfog.decode_step_fog(
        lm["jparams"], lm["jcfg"], jnp.asarray(tok), lm["jcache"],
        jnp.int32(S), jpol)
    cache = cache_from_jax(np_tree(lm["jcache"]), lm["tcfg"], device="cpu")
    tpol = FogPolicy(
        threshold=(thresh if np.isscalar(thresh)
                   else torch.tensor(thresh, dtype=torch.float32)),
        hop_budget=(budget if budget is None or np.isscalar(budget)
                    else torch.tensor(budget, dtype=torch.int32)),
        backend=backend)
    logits, new_cache, hops = tfog.decode_step_fog(
        lm["tparams"], lm["tcfg"], torch.as_tensor(tok), cache, S, tpol)
    want_hops = np.asarray(want_hops)
    flipped = np.flatnonzero(hops.numpy() != want_hops)
    if flipped.size:
        margins = gate_margins(lm["tparams"], lm["tcfg"],
                               torch.as_tensor(tok), cache)
        thr = np.broadcast_to(np.asarray(thresh, np.float32), (B,))
        dist = {int(b): np.abs(margins[:, b] - thr[b]).tolist()
                for b in flipped}
        pytest.fail(f"hops {hops.tolist()} != JAX {want_hops.tolist()}; "
                    f"|margin - thresh| per gate of the flipped lanes: "
                    f"{dist}")
    assert hops.dtype == torch.int32
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **TOL)
    assert_cache_close(new_cache, want_cache)


def test_fog_hops_follow_the_gate(lm):
    """Threshold 0 exits after one grove, 2.0 never exits (and equals the
    plain decode), a budget caps the hops."""
    cfg, tp = lm["tcfg"], lm["tparams"]
    tok = torch.as_tensor(lm["tokens"][:, -1])
    cache = cache_from_jax(np_tree(lm["jcache"]), cfg, device="cpu")
    G = len(tfog.grove_boundaries(cfg))
    plain, plain_cache = T.decode_step(tp, cfg, tok, cache, S)
    for thresh, budget, want in ((0.0, None, 1), (2.0, None, G),
                                 (2.0, 2, 2)):
        logits, new_cache, hops = tfog.decode_step_fog(
            tp, cfg, tok, cache, S, FogPolicy(threshold=thresh,
                                              hop_budget=budget))
        assert hops.tolist() == [want] * B
        if want == G:
            assert torch.equal(logits, plain)
            for r, blk in enumerate(new_cache["stack"]):
                assert torch.equal(blk["pos0"]["state"],
                                   plain_cache["stack"][r]["pos0"]["state"])


def test_serving_steps_on_cpu(lm):
    cfg, tp = lm["tcfg"], lm["tparams"]
    tokens = torch.as_tensor(lm["tokens"])
    prefill_fn, inputs = make_prefill_step(cfg, "cpu", batch=B, seq_len=S)
    assert inputs == {"tokens": ((B, S), torch.int32)}
    logits, cache = prefill_fn(tp, tokens)
    want_logits, want_cache = T.prefill(tp, cfg, tokens=tokens)
    assert torch.equal(logits, want_logits)

    step, inputs = make_serve_step(cfg, "cpu", batch=B, max_seq=S + 8)
    assert inputs == {"token": ((B,), torch.int32)}
    tok = logits.argmax(-1).to(torch.int32)
    got, _ = step(tp, cache, tok, S)
    assert torch.equal(got, T.decode_step(tp, cfg, tok, want_cache, S)[0])

    fog_step, inputs = make_serve_step(
        cfg, "cpu", batch=B, max_seq=S + 8, fog=True,
        policy=FogPolicy(backend="pallas"))
    assert set(inputs) == {"token", "fog_thresh", "fog_budget"}
    thresh = torch.tensor([0.0, 2.0, 0.01, 2.0])
    budget = torch.tensor([4, 4, 4, 2], dtype=torch.int32)
    got, _, hops = fog_step(tp, cache, tok, S, thresh, budget)
    want, _, want_hops = tfog.decode_step_fog(
        tp, cfg, tok, want_cache, S,
        FogPolicy(threshold=thresh, hop_budget=budget, backend="pallas"))
    assert torch.equal(got, want) and torch.equal(hops, want_hops)
    assert hops[0] == 1 and hops[1] == 4 and hops[3] == 2

    with pytest.raises(ValueError, match="token must have shape"):
        step(tp, cache, tok[:2], S)
    with pytest.raises(ValueError, match="outside the cache"):
        step(tp, cache, tok, S + 8)
    with pytest.raises(ValueError, match="tokens must have shape"):
        prefill_fn(tp, tokens[:, :8])
    with pytest.raises(ValueError, match="max_seq 63 < prompt length 64"):
        T.prefill(tp, cfg, tokens, max_seq=S - 1)


def test_entry_points_default_to_the_card(lm):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a card")
    cfg = lm["tcfg"]
    for call in (lambda: make_serve_step(cfg, batch=B, max_seq=S),
                 lambda: make_prefill_step(cfg, batch=B, seq_len=S),
                 lambda: T.cache_init(cfg, B, S),
                 lambda: T.init_params(cfg, torch.Generator()),
                 lambda: params_from_jax({}, cfg)):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            call()


def test_params_from_jax_carries_bf16_bit_for_bit():
    jcfg = jconfigs.smoke_config("mamba2-2.7b")
    tree = np_tree(JT.init_params(jcfg, jax.random.key(1), jnp.bfloat16))
    port = params_from_jax(tree, tconfigs.smoke_config("mamba2-2.7b"),
                           device="cpu")
    assert port.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(port.embed.view(torch.int16).numpy(),
                                  tree["embed"].view(np.int16))
    got = port.stack[2]["pos0"].mamba.in_x.view(torch.int16).numpy()
    np.testing.assert_array_equal(
        got, tree["stack"]["pos0"]["mamba"]["in_x"][2].view(np.int16))
    assert len(port.stack) == 4 and not any(
        p.requires_grad for p in port.parameters())


@pytest.mark.parametrize("name", ARCHS)
def test_config_accounting_matches_jax(name):
    """The copied configs: the same fields, param_count, layer plan,
    grove boundaries, hop energy and FoG FLOPs as the JAX package."""
    for jcfg, tcfg in ((jconfigs.get_arch(name), tconfigs.get_arch(name)),
                       (jconfigs.smoke_config(name),
                        tconfigs.smoke_config(name))):
        assert dict(vars(tcfg)) == dict(vars(jcfg))
        assert tconfigs.param_count(tcfg) == jconfigs.param_count(jcfg)
        jplan, tplan = JT.layer_plan(jcfg), T.layer_plan(tcfg)
        assert [[(s.mixer, s.ffn) for s in part] for part in tplan[:2]] == \
            [[(s.mixer, s.ffn) for s in part] for part in jplan[:2]]
        assert tplan[2] == jplan[2]
        assert tfog.grove_boundaries(tcfg) == jfog.grove_boundaries(jcfg)
        assert (tfog.lm_hop_energy(tcfg).per_hop_pj
                == jfog.lm_hop_energy(jcfg).per_hop_pj)
        for mean_hops in (1.0, 2.5):
            assert (tfog.fog_flops_per_token(tcfg, mean_hops)
                    == jfog.fog_flops_per_token(jcfg, mean_hops))


@pytest.mark.parametrize("name", [n for n in ARCHS if n != "mamba2-2.7b"])
def test_other_layers_wait_for_the_attention_slice(name):
    """Every other config builds, serves a step and equals JAX: attention
    layers with dense FFNs since the attention slice (the audio and VLM
    configs from their front ends' embeddings), MLA, MoE and the hybrid
    period since the last LM slice.  One serving step from zero caches at
    position 0, from JAX's fp32 weights, equals JAX's ``decode_step``
    within 1e-4 of the logit scale; the port's own init builds and its
    step is finite."""
    tcfg, jcfg = tconfigs.smoke_config(name), jconfigs.smoke_config(name)
    params = T.init_params(tcfg, torch.Generator().manual_seed(0),
                           torch.float32, device="cpu")
    step, inputs = make_serve_step(tcfg, "cpu", batch=1, max_seq=8,
                                   param_dtype=torch.float32)
    if tcfg.frontend:
        assert inputs == {"embeds": ((1, 1, tcfg.d_model), torch.float32)}
        x = torch.randn((1, 1, tcfg.d_model),
                        generator=torch.Generator().manual_seed(1))
        jin = {"token": None, "embeds": jnp.asarray(x.numpy())}
    else:
        assert inputs == {"token": ((1,), torch.int32)}
        x = torch.full((1,), 3, dtype=torch.int32)
        jin = {"token": jnp.asarray(x.numpy())}
    logits, _ = step(params, T.cache_init(tcfg, 1, 8, torch.float32,
                                          device="cpu"), x, 0)
    assert logits.shape == (1, tcfg.vocab_size)
    assert torch.isfinite(logits).all()
    jparams = JT.init_params(jcfg, jax.random.key(5), jnp.float32)
    want, _ = JT.decode_step(jparams, jcfg, cache=JT.cache_init(
        jcfg, 1, 8, jnp.float32), length=jnp.int32(0), **jin)
    got, _ = step(params_from_jax(np_tree(jparams), tcfg, device="cpu"),
                  T.cache_init(tcfg, 1, 8, torch.float32, device="cpu"), x, 0)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_margin_backend_matches_jax():
    for b in (*BACKENDS, None):
        assert margin_backend(b) == jpolicy.margin_backend(b)
