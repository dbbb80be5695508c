"""repro_torch's ssd_chunk backward on the CPU (``ssd_chunk_bwd_ref`` and
``ops.SsdChunk``) against the JAX package's gradients: ``jax.vjp`` of
``repro.kernels.ref.ssd_chunk_ref`` and of the einsum branch of
``repro.models.mamba2.ssd_chunked`` (the block JAX's trainer
differentiates), on inputs made with numpy from a seed.

Bars.  The oracle is float64 autograd of the port's einsum block
(``ssd_intra_chunk`` in float64, independent of the formulas
``ssd_chunk_bwd_ref`` is written from).  Each gradient of the port is held
within twice JAX's own fp32 distance from that oracle (plus 1e-7 of the
gradient's scale, for the cases JAX gets exactly), the bar
``tests/test_torch_ssd_chunk.py`` sets the forward.  An elementwise
tolerance against JAX alone does not hold: at Q = 256 the fp32 cumsum of
the decays reaches -64, where one ulp is 7.6e-6, so every exp(cum_i -
cum_j) carries a relative error of ~1e-6 and ``da``, a reverse cumsum of
sums of such terms, parts from float64 by ~1e-5 of its scale in JAX and
in the port alike.  In float64 the formulas equal the oracle within
1e-12 of each gradient's scale, and ``torch.autograd.gradcheck`` holds
``ops.SsdChunk`` to finite differences.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.kernels.ref as jref  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402

# (B, nc, Q, H, P, N): Q in {1, 7, 32, 256}, odd P and N, nc >= 2
SHAPES = [(1, 2, 1, 2, 3, 5), (2, 2, 7, 3, 5, 3), (1, 3, 32, 2, 9, 7),
          (1, 2, 256, 2, 17, 9)]
NAMES = ("dxbar", "da", "dBm", "dCm")


def chunk_case(B, nc, Q, H, P, N, seed=0, decay=0.49):
    """xbar, a (negative log-decays; at Q = 256 their cumsum reaches about
    -64), B, C and the cotangents dy, dstates, float32 numpy."""
    rng = np.random.default_rng(seed + Q)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    a = -rng.uniform(0.01, decay, size=(B, nc, H, Q)).astype(np.float32)
    return (f(B, nc, Q, H, P), a, f(B, nc, Q, N), f(B, nc, Q, N),
            f(B, nc, Q, H, P), f(B, nc, H, P, N))


def oracle(case):
    """Float64 autograd of the einsum block."""
    ins = [torch.tensor(t, dtype=torch.float64, requires_grad=True)
           for t in case[:4]]
    y, st = sc.ssd_intra_chunk(*ins)
    dy, dst = (torch.tensor(t, dtype=torch.float64) for t in case[4:])
    return [g.numpy() for g in torch.autograd.grad(
        (y * dy).sum() + (st * dst).sum(), ins)]


def jax_ref_vjp(case):
    _, vjp = jax.vjp(jref.ssd_chunk_ref, *map(jnp.asarray, case[:4]))
    return [np.asarray(g) for g in vjp(tuple(map(jnp.asarray, case[4:])))]


def hold(what, got, jax_got, exact):
    """Each gradient within twice JAX's distance from the float64 oracle
    (plus 1e-7 of its scale)."""
    for name, g, j, e in zip(NAMES, got, jax_got, exact):
        g = np.asarray(g, np.float64)
        scale = np.abs(e).max()
        jax_err = np.abs(np.asarray(j, np.float64) - e).max()
        err = np.abs(g - e).max()
        assert np.isfinite(g).all(), (what, name)
        assert err <= 2 * jax_err + 1e-7 * scale, (what, name, err, jax_err,
                                                   scale)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_matches_jax_vjp_of_the_ref(shape):
    case = chunk_case(*shape)
    got = ref.ssd_chunk_bwd_ref(*map(torch.as_tensor, case))
    for g, t in zip(got, case[:4]):
        assert g.dtype == torch.float32 and g.shape == t.shape
    hold(f"ssd_chunk_bwd_ref {shape}", [g.numpy() for g in got],
         jax_ref_vjp(case), oracle(case))


def test_decays_whose_cumsum_reaches_minus_64():
    """Every decay -0.25 at Q = 256: the cumsum ends at exactly -64."""
    case = list(chunk_case(1, 2, 256, 3, 16, 8, seed=4))
    case[1] = np.full_like(case[1], -0.25)
    assert np.cumsum(case[1], axis=-1)[..., -1].min() == -64.0
    got = ref.ssd_chunk_bwd_ref(*map(torch.as_tensor, case))
    hold("cum -64", [g.numpy() for g in got], jax_ref_vjp(case), oracle(case))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_formulas_equal_autograd_in_float64(shape):
    case = chunk_case(*shape, seed=1)
    got = sc.ssd_chunk_bwd_ref(*(torch.tensor(t, dtype=torch.float64)
                                 for t in case))
    for name, g, e in zip(NAMES, got, oracle(case)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), e, rtol=0,
                                   atol=1e-12 * max(np.abs(e).max(), 1.0),
                                   err_msg=name)


def test_function_passes_gradcheck_in_float64():
    case = chunk_case(1, 2, 5, 2, 3, 4, seed=2)
    ins = tuple(torch.tensor(t, dtype=torch.float64, requires_grad=True)
                for t in case[:4])
    assert torch.autograd.gradcheck(lambda *a: ops.SsdChunk.apply(*a), ins)


def test_ops_goes_through_the_function_only_for_a_gradient():
    """With an input that needs a gradient ``ops.ssd_chunk`` returns the
    Function's outputs, whose gradient is ``ssd_chunk_bwd_ref``'s (the
    same bits); without, the plain forward, the same bits as with; the CPU
    launches nothing."""
    case = chunk_case(2, 2, 16, 3, 5, 7, seed=3)
    x, a, Bm, Cm, dy, dst = map(torch.as_tensor, case)
    before = dict(ops.launches)
    plain = ops.ssd_chunk(x, a, Bm, Cm)
    assert plain[0].grad_fn is None
    ins = [t.clone().requires_grad_() for t in (x, a, Bm, Cm)]
    y, st = ops.ssd_chunk(*ins)
    assert type(y.grad_fn).__name__ == "SsdChunkBackward"
    assert torch.equal(y, plain[0]) and torch.equal(st, plain[1])
    got = torch.autograd.grad((y, st), ins, (dy, dst))
    want = ref.ssd_chunk_bwd_ref(x, a, Bm, Cm, dy, dst)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # one output unused: its gradient arrives as zeros
    ins = [t.clone().requires_grad_() for t in (x, a, Bm, Cm)]
    got = torch.autograd.grad((ops.ssd_chunk(*ins)[0] * dy).sum(), ins)
    want = ref.ssd_chunk_bwd_ref(x, a, Bm, Cm, dy, torch.zeros_like(dst))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.launches == before


@pytest.fixture
def routed_as_cuda(monkeypatch):
    """``ops`` takes its CUDA branch on CPU tensors, the forward and
    backward kernels replaced by their plain versions (recording each
    call)."""
    calls = []

    def fwd(*args):
        calls.append("forward")
        return sc.ssd_chunk_ref(*args)

    def bwd(*args):
        calls.append("backward")
        return sc.ssd_chunk_bwd_ref(*args)

    monkeypatch.setattr(ops, "_runs_plain", lambda t: False)
    monkeypatch.setattr(ops, "ssd_chunk_cuda", fwd)
    monkeypatch.setattr(ops, "ssd_chunk_bwd_cuda", bwd)
    return calls


def test_cuda_path_keeps_the_graph(routed_as_cuda):
    """On the CUDA branch a forward that needs a gradient goes through the
    Function, whose backward launches the backward kernel once; under
    no_grad the forward alone.  bf16 takes the same path (the backward
    kernel takes it); an fp16 input that needs a gradient is refused
    before any launch, naming the dtypes."""
    case = chunk_case(1, 2, 8, 2, 4, 4, seed=5)
    x, a, Bm, Cm, dy, dst = map(torch.as_tensor, case)
    with torch.no_grad():
        ops.ssd_chunk(x, a, Bm, Cm)
    assert routed_as_cuda == ["forward"]
    ins = [t.clone().requires_grad_() for t in (x, a, Bm, Cm)]
    got = torch.autograd.grad(ops.ssd_chunk(*ins), ins, (dy, dst))
    assert routed_as_cuda[1:] == ["forward", "backward"]
    want = sc.ssd_chunk_bwd_ref(x, a, Bm, Cm, dy, dst)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    bf = [t.bfloat16().requires_grad_() for t in (x, a, Bm, Cm)]
    got = torch.autograd.grad(ops.ssd_chunk(*bf), bf,
                              (dy.bfloat16(), dst.bfloat16()))
    assert routed_as_cuda[3:] == ["forward", "backward"]
    assert all(g.dtype == torch.bfloat16 for g in got)
    half = [t.half().requires_grad_() for t in (x, a, Bm, Cm)]
    with pytest.raises(TypeError, match="take fp32 or bf16, got "
                       "torch.float16"):
        ops.ssd_chunk(*half)
    assert len(routed_as_cuda) == 5


def test_backward_wrapper_refuses_before_any_launch():
    """The kernel's wrapper takes contiguous fp32 or bf16 CUDA tensors and
    Q <= 256; it refuses the rest by shape and dtype, never by a failed
    launch."""
    case = [torch.as_tensor(t) for t in chunk_case(1, 2, 8, 2, 4, 4)]
    before = dict(ops.launches)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        sc.ssd_chunk_bwd_cuda(*case)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        sc.ssd_chunk_bwd_cuda(*(t.bfloat16() for t in case))
    with pytest.raises(TypeError, match="takes fp32 or bf16, got "
                       "torch.float16"):
        sc.ssd_chunk_bwd_cuda(*(t.half() for t in case))
    long = [torch.as_tensor(t) for t in chunk_case(1, 1, 257, 1, 2, 2)]
    with pytest.raises(ValueError, match="Q <= 256"):
        sc.ssd_chunk_bwd_cuda(*long)
    with pytest.raises(ValueError, match="dstates must be"):
        sc.ssd_chunk_bwd_cuda(*case[:5], case[5][..., :3])
    assert ops.launches == before and "ssd_chunk_bwd" in ops.launches


def scan_case(seed, B=2, S=64, H=3, P=5, N=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.3, size=(B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(B, S, H, P)).astype(np.float32),
            rng.normal(size=(B, H, P, N)).astype(np.float32))


SCAN_NAMES = ("dx", "ddt", "dA", "dBm", "dCm")


@pytest.mark.parametrize("chunk,initial", [(16, False), (8, True),
                                           (64, False)])
def test_scan_gradient_matches_jax_vjp_of_the_einsum_branch(chunk, initial):
    """``ssd_chunked(use_kernels=True)`` (the intra-chunk block through
    ``ops.SsdChunk``, the recurrence and the off-diagonal term under
    autograd) against ``jax.vjp`` of JAX's ``use_kernels=False`` branch,
    cotangents on y and the final state, with and without an initial state
    (its gradient too), nc = S / chunk chunks; bar: twice JAX's distance
    from float64 autograd of the port's einsum branch."""
    x, dt, A, Bm, Cm, dy, dfin = scan_case(chunk)
    s0 = (np.random.default_rng(9).normal(size=dfin.shape).astype(np.float32)
          if initial else None)
    prim = [x, dt, A, Bm, Cm] + ([s0] if initial else [])

    def jfn(x, dt, A, Bm, Cm, *s):
        return jm.ssd_chunked(x, dt, A, Bm, Cm, chunk,
                              s[0] if s else None, use_kernels=False)

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, prim))
    jgot = [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dfin)))]

    def port(dtype, use_kernels):
        ins = [torch.tensor(t, dtype=dtype, requires_grad=True)
               for t in prim]
        y, fin = tm.ssd_chunked(*ins[:5], chunk,
                                ins[5] if initial else None,
                                use_kernels=use_kernels)
        cot = [torch.tensor(t, dtype=dtype) for t in (dy, dfin)]
        return [g.numpy() for g in torch.autograd.grad((y, fin), ins, cot)]

    got = port(torch.float32, True)
    exact = port(torch.float64, False)
    for name, g, j, e in zip(SCAN_NAMES + ("dstate0",), got, jgot, exact):
        scale = np.abs(e).max()
        jax_err = np.abs(j - e).max()
        assert np.abs(g - e).max() <= 2 * jax_err + 1e-7 * scale, (
            name, np.abs(g - e).max(), jax_err, scale)


def test_mamba_layer_keeps_its_graph_and_tails():
    """A Mamba mixer whose weights need gradients: its output, state and
    conv tails equal the no-grad forward's bit for bit, and every weight's
    gradient through the Function equals autograd of the einsum block (at
    1e-5 of the gradient's scale), the conv weights and the projections
    feeding B and C included (their ``.contiguous()`` copies keep the
    graph)."""
    from repro_torch.configs import smoke_config
    cfg = smoke_config("mamba2-2.7b")
    torch.manual_seed(0)
    p = tm.init_mamba(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((2, 64, cfg.d_model)) * 0.5
    with torch.no_grad():
        want_out, (want_state, want_tail) = tm.mamba_forward(p, cfg, x)
    named = dict(p.named_parameters())
    for t in named.values():
        t.requires_grad_(True)
    out, (state, tail) = tm.mamba_forward(p, cfg, x)
    assert torch.equal(out, want_out) and torch.equal(state, want_state)
    assert all(torch.equal(a, b) for a, b in zip(tail, want_tail))
    w = torch.randn_like(out)
    got = torch.autograd.grad((out * w).sum(), list(named.values()))
    real = ops.ssd_chunk
    ops.ssd_chunk = sc.ssd_intra_chunk
    try:
        out2, _ = tm.mamba_forward(p, cfg, x)
        want = torch.autograd.grad((out2 * w).sum(), list(named.values()))
    finally:
        ops.ssd_chunk = real
    for (k, _), g, e in zip(named.items(), got, want):
        assert g.abs().max() > 0 or k in ("conv_b_x",), k
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=0,
                                   atol=1e-5 * float(e.abs().max()),
                                   err_msg=k)
