"""repro_torch's ssd_chunk backward on bf16 inputs, on the CPU:
``ssd_chunk_bwd_ref`` (fp32 inside, the gradients in bf16: the function
the backward kernel computes from bf16 inputs) against ``jax.vjp`` of the
JAX package's einsum block in bf16 (``repro.kernels.ref.ssd_chunk_ref``,
the chunk of the einsum branch its trainer differentiates), on inputs
made with numpy from a seed and rounded to bf16.

Bars.  The oracle is float64 autograd of the port's einsum block on the
same bf16 values.  Each gradient of the port is held within twice JAX's
bf16 distance from it, plus ``FLOOR`` (2^-9, half a bf16 ulp, of the
gradient's scale: the rounding of a gradient stored in bf16 alone); a
distance is the largest absolute error over the scale.  The backward is
the exact gradient of the chunk function at the bf16 inputs: it does not
replay the tensor-core forward's rounding of W and of the decayed x.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.kernels.ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402

# (B, nc, Q, H, P, N): Q in {7, 256}, nc >= 2, odd P and N, and the
# tensor-core forward's P = 64, N = 128
SHAPES = [(2, 2, 7, 3, 5, 3), (1, 2, 256, 2, 17, 9), (1, 2, 256, 2, 64, 128)]
NAMES = ("dxbar", "da", "dBm", "dCm")
FLOOR = 2.0 ** -9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_case(B, nc, Q, H, P, N, seed=0, decay=0.49):
    """xbar, a (negative log-decays), B, C and the cotangents dy,
    dstates as bf16 tensors."""
    rng = np.random.default_rng(seed + Q)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    a = -rng.uniform(0.01, decay, size=(B, nc, H, Q)).astype(np.float32)
    return [torch.tensor(t).bfloat16() for t in (
        f(B, nc, Q, H, P), a, f(B, nc, Q, N), f(B, nc, Q, N),
        f(B, nc, Q, H, P), f(B, nc, H, P, N))]


def oracle(case):
    ins = [t.double().requires_grad_() for t in case[:4]]
    y, st = sc.ssd_intra_chunk(*ins)
    dy, dst = (t.double() for t in case[4:])
    return [g.numpy() for g in torch.autograd.grad(
        (y * dy).sum() + (st * dst).sum(), ins)]


def jax_bf16(case):
    j = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in case]
    _, vjp = jax.vjp(jref.ssd_chunk_ref, *j[:4])
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(tuple(j[4:]))]


def hold(what, got, case):
    exact = oracle(case)
    for name, g, j, e in zip(NAMES, got, jax_bf16(case), exact):
        assert g.dtype == torch.bfloat16, (what, name)
        g = g.double().numpy()
        scale = np.abs(e).max()
        err = np.abs(g - e).max() / scale
        jax_err = np.abs(np.asarray(j, np.float64) - e).max() / scale
        assert np.isfinite(g).all(), (what, name)
        assert err <= 2 * jax_err + FLOOR, (what, name, err, jax_err)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_bf16_backward_within_twice_jax_distance(shape):
    case = bf16_case(*shape)
    hold(f"ssd_chunk_bwd_ref bf16 {shape}", sc.ssd_chunk_bwd_ref(*case),
         case)


def test_decays_whose_cumsum_reaches_minus_64():
    """Every decay -0.25 (exact in bf16) at Q = 256: the cumsum ends at
    exactly -64, in bf16 as in fp32."""
    case = bf16_case(1, 2, 256, 3, 16, 8, seed=4)
    case[1] = torch.full_like(case[1], -0.25)
    assert float(torch.cumsum(case[1].float(), -1)[..., -1].min()) == -64.0
    hold("cum -64 bf16", sc.ssd_chunk_bwd_ref(*case), case)


def test_bf16_plain_backward_is_the_fp32_one_rounded():
    """On bf16 inputs the plain backward computes in fp32 and rounds each
    gradient once: the fp32 backward of the same values, rounded."""
    case = bf16_case(1, 3, 32, 2, 9, 7, seed=5)
    got = sc.ssd_chunk_bwd_ref(*case)
    want = sc.ssd_chunk_bwd_ref(*(t.float() for t in case))
    assert all(torch.equal(g, w.bfloat16()) for g, w in zip(got, want))


def test_bf16_gradient_flows_through_the_function():
    """``ops.ssd_chunk`` on bf16 CPU tensors that need a gradient goes
    through ``ops.SsdChunk``, whose backward is the plain one."""
    case = bf16_case(1, 2, 16, 2, 4, 8, seed=6)
    ins = [t.clone().requires_grad_() for t in case[:4]]
    y, st = ops.ssd_chunk(*ins)
    assert type(y.grad_fn).__name__ == "SsdChunkBackward"
    got = torch.autograd.grad((y, st), ins, tuple(case[4:]))
    want = sc.ssd_chunk_bwd_ref(*case)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# the tensor-core backward's shapes: P = 64 with N = 128 (mamba2-2.7b's and
# jamba's SSM layers), a ragged chunk, and N = 64
SM90_SHAPES = [(1, 2, 256, 2, 64, 128), (1, 2, 200, 3, 64, 128),
               (2, 2, 96, 2, 64, 64)]


@pytest.mark.parametrize("shape", SM90_SHAPES, ids=str)
def test_sm90_replay_within_twice_jax_distance(shape):
    """``ssd_chunk_bwd_sm90_replay`` (the tensor-core backward's rounding:
    W_h and dS rounded to bf16 as its products' A operands) held to the
    float64 oracle within twice JAX's bf16 distance plus ``FLOOR``, the
    bar the plain bf16 backward meets; its da (no rounded operand) is the
    plain version's bit for bit, and its other gradients part from the
    plain version's only by those roundings."""
    case = bf16_case(*shape)
    got = sc.ssd_chunk_bwd_sm90_replay(*case)
    hold(f"ssd_chunk_bwd_sm90_replay {shape}", got, case)
    plain = sc.ssd_chunk_bwd_ref(*case)
    assert torch.equal(got[1], plain[1])
    for name, g, p in zip(NAMES, got, plain):
        scale = float(p.float().abs().max())
        assert float((g.float() - p.float()).abs().max()) <= 2 ** -6 * scale, \
            name


def test_sm90_replay_with_decays_whose_cumsum_reaches_minus_64():
    """The replay at P = 64, N = 128 with every decay -0.25: L spans
    exp(-64) to 1 and W's bf16 rounding keeps its relative error."""
    case = bf16_case(1, 2, 256, 2, 64, 128, seed=4)
    case[1] = torch.full_like(case[1], -0.25)
    hold("sm90 replay cum -64", sc.ssd_chunk_bwd_sm90_replay(*case), case)


@pytest.mark.parametrize("dtype,Q,P,N,want", [
    (torch.bfloat16, 1, 64, 128, "sm90"), (torch.bfloat16, 200, 64, 128,
                                          "sm90"),
    (torch.bfloat16, 256, 64, 128, "sm90"), (torch.bfloat16, 1, 64, 64,
                                             "sm90"),
    (torch.bfloat16, 200, 64, 64, "sm90"), (torch.bfloat16, 256, 64, 64,
                                            "sm90"),
    (torch.float32, 256, 64, 128, "simt"), (torch.bfloat16, 256, 17, 9,
                                            "simt"),
    (torch.bfloat16, 256, 64, 32, "simt"), (torch.float16, 256, 64, 128,
                                            "simt")], ids=str)
def test_backward_route_rule(dtype, Q, P, N, want):
    """The backward takes the forward's rule (``ssd_chunk.route``): bf16
    at P = 64, N in {64, 128}, 1 <= Q <= 256 on the tensor cores, the
    rest (fp32, other P or N) on the SIMT kernel; fp16 names no kernel's
    input: the wrapper refuses it before any launch."""
    assert sc.route(dtype, Q, P, N) == want
    if dtype == torch.float16:
        case = [t.half() for t in bf16_case(1, 1, 8, 2, P, N)]
        before = dict(ops.launches)
        with pytest.raises(TypeError, match="takes fp32 or bf16, got "
                           "torch.float16"):
            sc.ssd_chunk_bwd_cuda(*case)
        assert ops.launches == before


def test_sm90_backward_block_fits_the_card():
    """The tensor-core backward's largest block (the dx pass: C and B
    [256, N], two stages of dy_h [256, 64] and dst_h [64, N], 3 mbarriers
    and 1024 B to align the swizzled tiles) under the 227 KB (232,448 B)
    a Hopper block may opt into at both state sizes."""
    assert sc.bwd_smem_bytes_sm90(128) == 230_424 <= 232_448
    assert sc.bwd_smem_bytes_sm90(64) == 148_504
    for N in sc.SM90_N:
        assert sc.bwd_smem_bytes_sm90(N) == (
            2 * 2 * 256 * N + 2 * (2 * 256 * 64 + 2 * 64 * N) + 24 + 1024)
