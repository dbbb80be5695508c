"""repro_torch's ssd_chunk (on the CPU: its plain version) and ssd_chunked
against the JAX package: the Pallas kernel in interpret mode (as
tests/test_kernels.py runs it), ``ref.ssd_chunk_ref`` and both branches of
``models.mamba2.ssd_chunked``, on inputs made with numpy from a seed.

Tolerances: the intra-chunk block at rtol 1e-5 with an atol of 1e-5 of
the output's largest magnitude, the bar of
tests/test_kernels.py::test_ssd_chunk_matches_ref scaled to the output.
An elementwise atol of 1e-5 does not hold at Q=64 and Q=256: the fp32
cumsum of the decays reaches -16 and -64 there, so every exp(cum_i -
cum_j) carries a relative error of ~1e-6 (ulp(64) = 7.6e-6), and
elements that are small sums of large terms differ by up to 3e-4 at Q=256
(2.3e-6 of the largest |y|, 134).  JAX's interpret kernel and the port
are both that far from a float64 oracle; the test also holds the port to
at most twice JAX's own distance from it.  The whole scan at JAX's own
1e-4 / 1e-5 (tests/test_kernels.py::test_ssd_chunked_kernel_backend_
equivalence).
bf16: the plain version computes in fp32 and casts, as the TPU kernel
does, so it equals JAX's interpret kernel within 2 bf16 ulps (rtol 2**-6)
plus 1e-4 of the output's magnitude for the fp32 sums' order.

The tensor-core route (bf16, P = 64, N in {64, 128}) rounds W and the
decay-scaled x̄ to bf16 as its products' operands.  Its replay
(``ssd_chunk_sm90_replay``) is held to the float64 oracle at full width
(Q = 256, H = 80, P = 64, N = 128): no farther from it than
``ssd_intra_chunk`` in bf16, the einsum branch JAX's own Mamba model runs.
Its distance from the plain version sets the card's bar
(``chip_smoke.ssd_close``): within 2 bf16 ulps of the output's scale,
twice the replay's worst (1 ulp of y's scale, half an ulp of the
states').
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.kernels.ref as jref  # noqa: E402
from repro.kernels.ssd_chunk import ssd_chunk_pallas  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.ssd_chunk import (MAX_Q, check_shapes,  # noqa: E402
                                           route,
                                           sm90_heads_per_block,
                                           smem_bytes_sm90, ssd_chunk_cuda,
                                           ssd_chunk_ref,
                                           ssd_chunk_sm90_replay,
                                           ssd_intra_chunk)
from repro_torch.models import mamba2 as tm  # noqa: E402

# JAX's four cases (tests/test_kernels.py:355) and the serving chunk
# Q=256 with the serving head width P=64 and state N=128
SHAPES = [(1, 1, 8, 1, 4, 4), (2, 2, 16, 3, 8, 8), (1, 4, 32, 5, 16, 16),
          (2, 2, 64, 2, 32, 32), (1, 1, 256, 3, 64, 128)]
RTOL = 1e-5


def chunk_inputs(B, nc, Q, H, P, N, seed=None):
    """xbar, a (negative log-decays, like softplus(dt) * -exp(A_log)), B, C
    as float32 numpy, made as tests/test_kernels.py makes them."""
    rng = np.random.default_rng(B * 100 + Q if seed is None else seed)
    return (rng.normal(size=(B, nc, Q, H, P)).astype(np.float32),
            -rng.uniform(0.01, 0.5, size=(B, nc, H, Q)).astype(np.float32),
            rng.normal(size=(B, nc, Q, N)).astype(np.float32),
            rng.normal(size=(B, nc, Q, N)).astype(np.float32))


def scan_inputs(seed, B=2, S=64, H=4, P=8, N=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.3, size=(B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32))


def assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def float64_oracle(xbar, a, Bm, Cm):
    """The intra-chunk block in numpy float64."""
    x, a, Bm, Cm = (t.astype(np.float64) for t in (xbar, a, Bm, Cm))
    Q = x.shape[2]
    cs = np.cumsum(a, axis=-1)
    diff = np.minimum(cs[..., :, None] - cs[..., None, :], 0.0)
    L = np.where(np.tril(np.ones((Q, Q), bool)), np.exp(diff), 0.0)
    scores = np.einsum("bcin,bcjn->bcij", Cm, Bm)
    y = np.einsum("bcij,bchij,bcjhp->bcihp", scores, L, x)
    decay_end = np.exp(cs[..., -1:] - cs)
    return y, np.einsum("bchj,bcjn,bcjhp->bchpn", decay_end, Bm, x)


@pytest.mark.parametrize("B,nc,Q,H,P,N", SHAPES)
def test_plain_matches_pallas_interpret_and_ref(B, nc, Q, H, P, N):
    args = chunk_inputs(B, nc, Q, H, P, N)
    got = ops.ssd_chunk(*map(torch.as_tensor, args))
    assert got[0].shape == (B, nc, Q, H, P)
    assert got[1].shape == (B, nc, H, P, N)
    pallas = ssd_chunk_pallas(*map(jnp.asarray, args))
    for want in (pallas, jref.ssd_chunk_ref(*map(jnp.asarray, args))):
        for g, w in zip(got, want):
            assert_close(g.numpy(), w)
    for g, w, exact in zip(got, pallas, float64_oracle(*args)):
        jax_err = np.abs(np.asarray(w) - exact).max()
        assert np.abs(g.numpy() - exact).max() <= 2 * jax_err + 1e-6


def test_ref_reexport_and_cpu_launches_nothing():
    assert ref.ssd_chunk_ref is ssd_chunk_ref
    before = dict(ops.launches)
    ops.ssd_chunk(*map(torch.as_tensor, chunk_inputs(1, 1, 8, 1, 4, 4)))
    assert ops.launches == before


def test_above_diagonal_overflow_gives_no_nan():
    """Large decays make exp(cum_i - cum_j) overflow above the diagonal;
    the plain version selects 0 there, as the TPU kernel's where does."""
    x, a, Bm, Cm = chunk_inputs(1, 2, 32, 2, 4, 4, seed=3)
    a = a * 200.0
    y, st = ops.ssd_chunk(*map(torch.as_tensor, (x, a, Bm, Cm)))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    want = ssd_chunk_pallas(*map(jnp.asarray, (x, a, Bm, Cm)))
    assert_close(y.numpy(), want[0])


def test_bf16_plain_matches_interpret_kernel():
    x, a, Bm, Cm = chunk_inputs(2, 2, 64, 3, 16, 32, seed=7)
    got = ops.ssd_chunk(*(torch.as_tensor(t).to(torch.bfloat16)
                          for t in (x, a, Bm, Cm)))
    want = ssd_chunk_pallas(*(jnp.asarray(t, jnp.bfloat16)
                              for t in (x, a, Bm, Cm)))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g32 = g.float().numpy()
        w32 = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g32, w32, rtol=2**-6,
                                   atol=1e-4 * np.abs(w32).max())


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("seed,Q", [(11, 16), (5, 64), (2, 32)])
def test_ssd_chunked_matches_jax(use_kernels, seed, Q):
    args = scan_inputs(seed)
    y_j, s_j = jm.ssd_chunked(*map(jnp.asarray, args), Q,
                              use_kernels=use_kernels)
    y_t, s_t = tm.ssd_chunked(*map(torch.as_tensor, args), Q,
                              use_kernels=use_kernels)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-4,
                               atol=1e-5)


def test_ssd_chunked_branches_agree_with_initial_state():
    args = scan_inputs(4)
    s0 = np.random.default_rng(9).normal(size=(2, 4, 8, 8)).astype(np.float32)
    y0, f0 = tm.ssd_chunked(*map(torch.as_tensor, args), 16,
                            torch.as_tensor(s0), use_kernels=False)
    y1, f1 = tm.ssd_chunked(*map(torch.as_tensor, args), 16,
                            torch.as_tensor(s0), use_kernels=True)
    yj, fj = jm.ssd_chunked(*map(jnp.asarray, args), 16, jnp.asarray(s0))
    for t0, t1, j in ((y0, y1, yj), (f0, f1, fj)):
        np.testing.assert_allclose(t1.numpy(), t0.numpy(), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(t0.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-5)


def test_ssd_chunked_refuses_ragged_sequence():
    x, dt, A, Bm, Cm = scan_inputs(1, S=48)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tm.ssd_chunked(*map(torch.as_tensor, (x, dt, A, Bm, Cm)), 32)


def test_cuda_wrapper_refuses_bad_inputs():
    args = [torch.as_tensor(t) for t in chunk_inputs(1, 1, 8, 1, 4, 4)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_chunk_cuda(*args)
    with pytest.raises(ValueError, match=r"a must be \(1, 1, 1, 8\)"):
        check_shapes(args[0], args[1][..., :4], args[2], args[3])
    big = [torch.as_tensor(t) for t in chunk_inputs(1, 1, MAX_Q + 1, 1, 2, 2)]
    with pytest.raises(ValueError, match=r"1 <= Q <= 256 .* got Q=257"):
        ssd_chunk_cuda(*big)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        ssd_chunk_cuda(*(t.double() for t in args))


# ------------------------------------------------ the tensor-core route

@pytest.mark.parametrize("dtype,Q,P,N,want", [
    (torch.bfloat16, 256, 64, 128, "sm90"),
    (torch.bfloat16, 256, 64, 64, "sm90"),
    (torch.bfloat16, 1, 64, 128, "sm90"),
    (torch.bfloat16, 200, 64, 128, "sm90"),
    (torch.float32, 256, 64, 128, "simt"),
    (torch.bfloat16, 256, 72, 128, "simt"),
    (torch.bfloat16, 256, 32, 128, "simt"),
    (torch.bfloat16, 256, 64, 130, "simt"),
    (torch.bfloat16, 256, 64, 256, "simt"),
    (torch.bfloat16, 257, 64, 128, "simt"),
    (torch.float16, 256, 64, 128, "simt")], ids=str)
def test_route_rule(dtype, Q, P, N, want):
    assert route(dtype, Q, P, N) == want


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_serving_configs_take_the_tensor_cores(arch):
    cfg = get_arch(arch)
    assert route(torch.bfloat16, cfg.ssm_chunk, cfg.ssm_head_dim,
                 cfg.ssm_state) == "sm90"
    assert route(torch.float32, cfg.ssm_chunk, cfg.ssm_head_dim,
                 cfg.ssm_state) == "simt"


def test_sm90_plan_fits_the_card():
    """One block's shared memory fits the H100's 227 KB opt-in at both
    state sizes, and the head groups cover every head once."""
    assert smem_bytes_sm90(128) == 201_768
    assert smem_bytes_sm90(64) < smem_bytes_sm90(128) <= 232_448
    assert sm90_heads_per_block(32, 80, 132) == 20     # 4 x 32 blocks
    for n_chunks, H, n_sm in ((32, 80, 132), (6, 80, 132), (1, 3, 132),
                              (500, 80, 132), (7, 13, 16)):
        hpb = sm90_heads_per_block(n_chunks, H, n_sm)
        groups = -(-H // hpb)
        assert 1 <= hpb <= H and (groups - 1) * hpb < H <= groups * hpb


def test_tma_check_refuses_misaligned_and_strided_inputs():
    """The tensor-core route refuses a base off a 16-byte boundary or a
    non-contiguous view before any launch."""
    before = dict(ops.launches)
    x = torch.zeros((1, 1, 8, 2, 64), dtype=torch.bfloat16)
    _build.check_tma("xbar", x)
    buf = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        _build.check_tma("xbar", buf[1:].view(x.shape))
    with pytest.raises(ValueError, match="contiguous"):
        _build.check_tma("Bm", torch.zeros((1, 1, 128, 8),
                                    dtype=torch.bfloat16).transpose(2, 3))
    assert ops.launches == before


def bf16_inputs(shape, seed):
    return [torch.as_tensor(t).to(torch.bfloat16)
            for t in chunk_inputs(*shape, seed=seed)]


def ulps_of_scale(got, want):
    """max |got - want| in bf16 ulps of want's largest magnitude."""
    scale = float(want.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    return float((got.float() - want.float()).abs().max()) / ulp


@pytest.mark.parametrize("shape", [(1, 2, 256, 80, 64, 128),
                                   (1, 2, 200, 80, 64, 128),
                                   (2, 1, 256, 80, 64, 64)], ids=str)
def test_sm90_rounding_replay_at_full_width(shape):
    """The tensor-core route's rounding, at mamba2-2.7b's width: no farther
    from the float64 oracle than JAX's bf16 einsum branch, and within the
    card's bar (2 bf16 ulps of the output's scale) of the plain version,
    at most 1 ulp here: the bar's margin is 2."""
    args = bf16_inputs(shape, seed=sum(shape))
    replay = ssd_chunk_sm90_replay(*args)
    einsum = ssd_intra_chunk(*args)
    plain = ssd_chunk_ref(*args)
    exact = float64_oracle(*(t.float().numpy() for t in args))
    for rp, ein, pl, ex in zip(replay, einsum, plain, exact):
        assert rp.dtype == torch.bfloat16 and rp.shape == pl.shape
        rp_err = np.abs(rp.float().numpy() - ex).max()
        ein_err = np.abs(ein.float().numpy() - ex).max()
        assert rp_err <= ein_err
        assert ulps_of_scale(rp, pl) <= 1.0


def test_sm90_replay_selects_zero_above_the_diagonal():
    """Decays large enough that exp(cum_i - cum_j) overflows above the
    diagonal: the replay, like the kernel, selects 0 there (no NaN) and
    stays within the bar of the plain version."""
    x, a, Bm, Cm = chunk_inputs(1, 2, 64, 2, 64, 64, seed=3)
    args = [torch.as_tensor(t).to(torch.bfloat16)
            for t in (x, a * 200.0, Bm, Cm)]
    for rp, pl in zip(ssd_chunk_sm90_replay(*args), ssd_chunk_ref(*args)):
        assert torch.isfinite(rp.float()).all()
        assert ulps_of_scale(rp, pl) <= 1.0
