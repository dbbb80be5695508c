"""repro_torch's flash_attention backward in bf16 on the CPU: the plain
version (``flash_attention_bwd_ref`` on bf16 inputs, the function both
bf16 backward kernels compute) against ``jax.vjp`` of the JAX package's
blocked ``models.layers.flash_attention`` in bf16, and a numpy replay of
the tensor-core kernel's tiling (``csrc/flash_attention_bwd_sm90.cu``)
against the plain version, on inputs made with numpy from a seed and
rounded to bf16.

Bars.  The oracle is the plain version in float64 on the same bf16
values (the forward's output and lse taken in float64 too).  The plain
bf16 backward (fp32 inside, gradients stored in bf16) is held within
twice JAX's bf16 distance from it, plus ``FLOOR`` (2^-9, half a bf16 ulp,
of each gradient's scale: the rounding of a gradient stored in bf16
alone); a distance is the largest absolute error over the scale (the
oracle's largest magnitude).  The replay rounds p and ds to bf16 before
the last products, as the kernel does, and is held to the plain version
within ``chip_smoke.BWD_BF16_BAR``, the bar the card holds the kernel to.
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# (B, Sq, Sk, H, K, D, Dv, causal): the tensor cores' pairs (64 and 128,
# mixed, minicpm3's 96 / 64, deepseek's 192 / 128, gemma's 256 / 256) and a
# small 32 on the SIMT route; G in {1, 2, 4}; Sq != Sk both ways; causal
# and not
SHAPES = [(1, 70, 70, 4, 1, 64, 64, True), (1, 70, 90, 4, 4, 64, 64, False),
          (1, 90, 70, 4, 1, 128, 128, True),
          (1, 64, 64, 4, 4, 128, 128, False),
          (1, 60, 60, 4, 1, 64, 128, True),
          (1, 80, 80, 4, 1, 96, 64, True), (1, 50, 70, 2, 2, 96, 64, False),
          (2, 40, 40, 4, 1, 32, 32, True), (1, 40, 60, 4, 4, 32, 32, False),
          (1, 70, 90, 2, 2, 192, 128, True),
          (1, 66, 50, 4, 2, 256, 256, False)]
SM90 = [s for s in SHAPES if fa.route(torch.bfloat16, s[5], s[6]) == "sm90"]
FLOOR = 2.0 ** -9
NAMES = ("dq", "dk", "dv")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_inputs(shape, seed=0):
    """q, k, v and the output's gradient, bf16 tensors from numpy."""
    B, Sq, Sk, H, K, D, Dv, _ = shape
    rng = np.random.default_rng(seed + sum(shape[:-1]))
    return tuple(torch.tensor(rng.normal(size=sh).astype(np.float32))
                 .bfloat16() for sh in ((B, Sq, H, D), (B, Sk, K, D),
                                        (B, Sk, K, Dv), (B, Sq, H, Dv)))


def plain(q, k, v, do, causal):
    """The plain forward (its output and lse) and backward on ``q``'s
    dtype."""
    o, lse = fa.flash_attention_ref_lse(q, k, v, causal=causal)
    return o, lse, fa.flash_attention_bwd_ref(q, k, v, o, do, lse,
                                              causal=causal)


def jax_bf16(q, k, v, do, causal):
    """``jax.vjp`` of JAX's blocked attention in bf16."""
    j = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
         for t in (q, k, v, do)]
    _, vjp = jax.vjp(lambda q, k, v: JL.flash_attention(q, k, v,
                                                        causal=causal),
                     *j[:3])
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(j[3])]


def distance(a, exact) -> float:
    a = np.asarray(a, np.float64)
    return float(np.abs(a - exact).max() / (np.abs(exact).max() or 1.0))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_bf16_backward_within_twice_jax_distance(shape):
    causal = shape[-1]
    q, k, v, do = bf16_inputs(shape)
    _, _, got = plain(q, k, v, do, causal)
    assert all(g.dtype == torch.bfloat16 for g in got)
    exact = plain(*(t.double() for t in (q, k, v, do)), causal)[2]
    for name, g, j, e in zip(NAMES, got, jax_bf16(q, k, v, do, causal),
                             exact):
        e = e.numpy()
        err, jax_err = distance(g.float().numpy(), e), distance(j, e)
        assert err <= 2 * jax_err + FLOOR, (name, err, jax_err)


@pytest.mark.parametrize("shape", SHAPES[:4], ids=str)
def test_bf16_forward_lse_is_the_fp32_log_sum_exp(shape):
    """The bf16 forward's lse (what the backward recomputes p from) is the
    log-sum-exp of the fp32 scores of the bf16 inputs; its output is the
    plain forward's bits."""
    causal = shape[-1]
    q, k, v, _ = bf16_inputs(shape)
    o, lse = fa.flash_attention_ref_lse(q, k, v, causal=causal)
    assert lse.dtype == torch.float32 and o.dtype == torch.bfloat16
    assert torch.equal(o, fa.flash_attention_ref(q, k, v, causal=causal))
    s = fa._scores(q, k, causal=causal, scale=None)
    want = torch.logsumexp(s.double(), dim=-1).reshape(lse.shape)
    torch.testing.assert_close(lse.double(), want, rtol=1e-6, atol=1e-6)


def bf16r(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def sm90_replay(q, k, v, o, do, lse, causal, scale=None):
    """The tensor-core backward's tiling in plain fp32 arithmetic: delta
    per row; a dK/dV pass per (64-key tile, KV head, batch) over the q
    tiles from the causal start and, within each, the G query heads, with
    S^T = K q^T and dP^T = V do^T, P^T = exp(S^T scale - lse) on the live
    pairs, dS^T = P^T (dP^T - delta), dV += bf16(P^T) do, dK += bf16(dS^T)
    q and dK scaled at the end; a dQ pass per (64-row q tile, head, batch)
    over the key tiles up to the diagonal, dQ += bf16(dS) K, scaled at the
    end.  Returns (dq, dk, dv) in bf16."""
    B, Sq, H, D = q.shape
    Sk, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    G, T = H // K, 64
    sc = fa.softmax_scale(D, scale)
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    delta = (dof * of).sum(-1)                                # [B, Sq, H]
    dq = torch.zeros(B, Sq, H, D)
    dk = torch.zeros(B, Sk, K, D)
    dv = torch.zeros(B, Sk, K, Dv)

    def live(rows, cols, ls):
        ok = torch.isfinite(ls)[:, None] & torch.ones(len(rows), len(cols),
                                                      dtype=torch.bool)
        if causal:
            ok &= rows[:, None] >= cols[None, :]
        return ok

    for b in range(B):
        for kh in range(K):
            for j0 in range(0, Sk, T):
                js = torch.arange(j0, min(j0 + T, Sk))
                kt, vt = kf[b, js, kh], vf[b, js, kh]
                dk_acc, dv_acc = torch.zeros(len(js), D), torch.zeros(
                    len(js), Dv)
                for i0 in range(j0 if causal else 0, Sq, T):
                    rows = torch.arange(i0, min(i0 + T, Sq))
                    for g in range(G):
                        h = kh * G + g
                        qt, dot = qf[b, rows, h], dof[b, rows, h]
                        ls = lse[b, h, rows]
                        ok = live(rows, js, ls).T             # [keys, rows]
                        st, dpt = kt @ qt.T, vt @ dot.T
                        p = torch.where(ok, torch.exp(st * sc - ls), 0.0)
                        ds = p * (dpt - delta[b, rows, h])
                        dv_acc += bf16r(p) @ dot
                        dk_acc += bf16r(ds) @ qt
                dk[b, js, kh], dv[b, js, kh] = dk_acc * sc, dv_acc
        for h in range(H):
            kh = h // G
            for i0 in range(0, Sq, T):
                rows = torch.arange(i0, min(i0 + T, Sq))
                qt, dot, ls = qf[b, rows, h], dof[b, rows, h], lse[b, h, rows]
                end = min(Sk, int(rows[-1]) + 1) if causal else Sk
                acc = torch.zeros(len(rows), D)
                for j0 in range(0, end, T):
                    js = torch.arange(j0, min(j0 + T, Sk))
                    kt, vt = kf[b, js, kh], vf[b, js, kh]
                    p = torch.where(live(rows, js, ls),
                                    torch.exp(qt @ kt.T * sc - ls[:, None]),
                                    0.0)
                    ds = p * (dot @ vt.T - delta[b, rows, h][:, None])
                    acc += bf16r(ds) @ kt
                dq[b, rows, h] = acc * sc
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


@pytest.mark.parametrize("shape", SM90, ids=str)
def test_tensor_core_replay_within_the_card_bar(shape):
    """The kernel's rounding (bf16 p and ds as the A operands of the last
    products) keeps it within ``BWD_BF16_BAR`` of the plain version, and
    no farther from float64 than twice the plain version plus ``FLOOR``."""
    causal = shape[-1]
    q, k, v, do = bf16_inputs(shape, seed=1)
    o, lse, want = plain(q, k, v, do, causal)
    got = sm90_replay(q, k, v, o, do, lse, causal)
    exact = plain(*(t.double() for t in (q, k, v, do)), causal)[2]
    for name, g, w, e in zip(NAMES, got, want, exact):
        assert g.dtype == torch.bfloat16
        w, e = w.float().numpy(), e.numpy()
        assert distance(g.float().numpy(), w) <= chip_smoke.BWD_BF16_BAR, \
            name
        assert (distance(g.float().numpy(), e)
                <= 2 * distance(w, e) + FLOOR), name


def test_replay_rounds_where_the_kernel_does():
    """The replay without its two bf16 roundings is the plain version
    within fp32 sums' reach: the roundings are the whole difference."""
    shape = SM90[0]
    q, k, v, do = bf16_inputs(shape, seed=2)
    o, lse, want = plain(q, k, v, do, True)
    global bf16r
    saved, bf16r = bf16r, (lambda t: t)
    try:
        got = sm90_replay(q, k, v, o, do, lse, True)
    finally:
        bf16r = saved
    for g, w in zip(got, want):
        assert distance(g.float().numpy(), w.float().numpy()) <= 2 ** -7


def test_bf16_gradient_flows_through_the_function():
    """``ops.flash_attention`` on bf16 CPU tensors that need a gradient:
    the Function's backward is the plain one, bit for bit."""
    shape = SHAPES[0]
    q, k, v, do = bf16_inputs(shape, seed=3)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*ins, causal=True), ins,
                              do)
    want = plain(q, k, v, do, True)[2]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
