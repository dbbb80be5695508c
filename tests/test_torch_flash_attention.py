"""repro_torch's flash_attention (on the CPU: its plain version) and the
model's blocked form against the JAX package: ``ref.flash_attention_ref``
and ``models.layers.flash_attention`` (the blocked jnp online softmax), on
inputs made with numpy from a seed.  ``flash_attention_pallas`` is not an
oracle here: it raises under jax 0.9 (ROADMAP §C).

Tolerances: fp32 at rtol/atol 2e-5, the bar of
tests/test_kernels.py::test_flash_attention_pallas_matches_ref.  bf16:
both plain versions compute in fp32 from the same bf16 inputs and round
once, so they agree within 1 bf16 ulp (rtol 2**-7) plus 1e-6 for the fp32
sums' order.  The port's blocked form rounds q·k to bf16 as JAX's does;
the two products' fp32 sums run in their own order, so a rare product
rounds the other way and the output is then 1 ulp off: the same bar.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.kernels.ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    MAX_HEAD, check_shapes, flash_attention_cuda, flash_attention_ref, route,
    sm90_keys, smem_bytes, smem_bytes_sm90)
from repro_torch.models import layers as TL  # noqa: E402

# (B, Sq, Sk, H, K, D, Dv, causal): JAX's five cases
# (tests/test_kernels.py:324), Sq != Sk both ways, a ragged length
JAX_SHAPES = [(1, 8, 8, 2, 1, 4, 4, True), (2, 64, 64, 4, 2, 16, 16, True),
              (2, 128, 128, 8, 8, 32, 32, True),
              (1, 64, 64, 4, 1, 32, 16, True),
              (2, 64, 64, 4, 2, 16, 16, False)]
MORE_SHAPES = [(1, 48, 80, 4, 2, 16, 16, True), (1, 80, 48, 4, 2, 16, 16, True),
               (2, 37, 37, 4, 2, 16, 16, True),
               (1, 37, 53, 6, 3, 24, 8, False)]
FP32 = {"rtol": 2e-5, "atol": 2e-5}
BF16 = {"rtol": 2.0**-7, "atol": 1e-6}


def inputs(shape, seed=0):
    B, Sq, Sk, H, K, D, Dv, _ = shape
    rng = np.random.default_rng(seed + sum(shape[:-1]))
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Sk, K, D)).astype(np.float32),
            rng.normal(size=(B, Sk, K, Dv)).astype(np.float32))


def jax_ref(q, k, v, causal, dtype=jnp.float32):
    out = jref.flash_attention_ref(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                                   causal=causal)
    return np.asarray(out.astype(jnp.float32))


def port(fn, q, k, v, dtype=torch.float32, **kw):
    out = fn(*(torch.tensor(a).to(dtype) for a in (q, k, v)), **kw)
    return out.float().numpy()


@pytest.mark.parametrize("shape", JAX_SHAPES + MORE_SHAPES, ids=str)
def test_plain_version_matches_jax_ref(shape):
    q, k, v = inputs(shape)
    causal = shape[-1]
    got = port(flash_attention_ref, q, k, v, causal=causal)
    np.testing.assert_allclose(got, jax_ref(q, k, v, causal), **FP32)


@pytest.mark.parametrize("shape", JAX_SHAPES, ids=str)
def test_plain_version_matches_jax_blocked(shape):
    """JAX's blocked jnp path (the model's own attention in JAX) at blocks
    of 16 and 32, and the port's blocked form against it."""
    q, k, v = inputs(shape)
    causal = shape[-1]
    blk = {"blk_q": min(16, shape[1]), "blk_k": min(32, shape[2])}
    want = np.asarray(JL.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, **blk))
    np.testing.assert_allclose(
        port(flash_attention_ref, q, k, v, causal=causal), want, **FP32)
    np.testing.assert_allclose(
        port(TL.flash_attention, q, k, v, causal=causal, use_kernels=False,
             **blk), want, **FP32)


@pytest.mark.parametrize("shape", JAX_SHAPES[1:] + MORE_SHAPES[:3], ids=str)
def test_bf16(shape):
    """bf16 inputs: the plain version within 1 bf16 ulp of JAX's reference,
    and the port's blocked form (q·k rounded to bf16) of JAX's."""
    q, k, v = inputs(shape, seed=5)
    causal = shape[-1]
    got = port(flash_attention_ref, q, k, v, torch.bfloat16, causal=causal)
    np.testing.assert_allclose(got, jax_ref(q, k, v, causal, jnp.bfloat16),
                               **BF16)
    if shape[1] % 16 == 0 and shape[2] % 16 == 0:
        blk = {"blk_q": 16, "blk_k": 16}
        want = JL.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                    for a in (q, k, v)), causal=causal, **blk)
        np.testing.assert_allclose(
            port(TL.flash_attention, q, k, v, torch.bfloat16, causal=causal,
                 use_kernels=False, **blk),
            np.asarray(want.astype(jnp.float32)), **BF16)


def test_causal_mask_is_top_left():
    """Row i sees keys j <= i, both counted from 0, whatever Sq and Sk:
    with Sq < Sk the last keys take no part; with Sq > Sk the rows past Sk
    see every key."""
    q, k, v = inputs((1, 5, 9, 2, 1, 8, 8, True))
    got = port(flash_attention_ref, q, k, v, causal=True)
    # row 0 attends to key 0 alone: its output is v[0]
    np.testing.assert_allclose(got[0, 0, 0], v[0, 0, 0], rtol=1e-6)
    np.testing.assert_allclose(
        got, port(flash_attention_ref, q, k[:, :5], v[:, :5], causal=True),
        rtol=1e-6, atol=1e-6)
    q, k, v = inputs((1, 9, 5, 2, 1, 8, 8, True))
    got = port(flash_attention_ref, q, k, v, causal=True)
    np.testing.assert_allclose(
        got[:, 5:], port(flash_attention_ref, q[:, 5:], k, v, causal=False),
        rtol=1e-6, atol=1e-6)


def test_ops_on_cpu_runs_the_plain_version():
    q, k, v = (torch.tensor(a) for a in inputs(JAX_SHAPES[1]))
    before = dict(ops.launches)
    got = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, flash_attention_ref(q, k, v, causal=True))
    assert torch.equal(ops.flash_attention(q, k, v, causal=False, scale=0.3),
                       flash_attention_ref(q, k, v, causal=False, scale=0.3))
    assert ref.flash_attention_ref is flash_attention_ref
    assert ops.launches == before
    # the model's entry point on the CPU goes through ops as well
    assert torch.equal(TL.flash_attention(q, k, v), got)


def test_blocked_form_needs_divisible_blocks():
    q, k, v = (torch.tensor(a) for a in inputs(MORE_SHAPES[2]))
    with pytest.raises(ValueError, match="Sq % blk_q"):
        TL.flash_attention(q, k, v, blk_q=16, blk_k=16, use_kernels=False)
    # the kernel's path takes any length
    assert TL.flash_attention(q, k, v).shape == q.shape


def test_check_shapes():
    def t(*sh):
        return torch.zeros(sh)

    assert check_shapes(t(2, 7, 6, 16), t(2, 9, 3, 16), t(2, 9, 3, 8)) == (
        2, 7, 9, 6, 3, 16, 8)
    assert check_shapes(t(1, 1, 4, MAX_HEAD), t(1, 1, 1, MAX_HEAD),
                        t(1, 1, 1, MAX_HEAD))[-2:] == (MAX_HEAD, MAX_HEAD)
    with pytest.raises(ValueError, match="H % K must be 0"):
        check_shapes(t(1, 4, 6, 16), t(1, 4, 4, 16), t(1, 4, 4, 16))
    with pytest.raises(ValueError, match="head sizes up to 256"):
        check_shapes(t(1, 4, 2, 264), t(1, 4, 1, 264), t(1, 4, 1, 16))
    with pytest.raises(ValueError, match="head sizes up to 256"):
        check_shapes(t(1, 4, 2, 16), t(1, 4, 1, 16), t(1, 4, 1, 320))
    with pytest.raises(ValueError, match="k must be"):
        check_shapes(t(1, 4, 2, 16), t(1, 5, 1, 16), t(1, 4, 1, 16))
    with pytest.raises(ValueError, match=r"must be \[B, S, heads"):
        check_shapes(t(4, 2, 16), t(1, 4, 1, 16), t(1, 4, 1, 16))
    with pytest.raises(ValueError, match="empty attention"):
        check_shapes(t(1, 0, 2, 16), t(1, 4, 1, 16), t(1, 4, 1, 16))


def test_cuda_wrapper_refuses_before_any_launch():
    """On CPU tensors (or at a head size over 256) the kernel's wrapper
    raises before it builds or launches anything."""
    q, k, v = (torch.tensor(a) for a in inputs(JAX_SHAPES[1]))
    before = dict(ops.launches)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head sizes up to 256"):
        flash_attention_cuda(torch.zeros(1, 4, 2, 512),
                             torch.zeros(1, 4, 1, 512),
                             torch.zeros(1, 4, 1, 512))
    assert ops.launches == before


def test_shared_memory_fits_a_hopper_block_at_every_head_size():
    """The largest tiles (D = Dv = 256) need 213,760 B, under the 227 KB
    (232,448 B) a Hopper block may opt into; tinyllama's D = 64 needs
    66,304 B."""
    assert smem_bytes(64, 64) == 66_304
    assert smem_bytes(MAX_HEAD, MAX_HEAD) == 213_760 <= 232_448


@pytest.mark.parametrize("dtype,D,Dv,want", [
    (torch.bfloat16, 64, 64, "sm90"), (torch.bfloat16, 128, 128, "sm90"),
    (torch.bfloat16, 64, 128, "sm90"), (torch.bfloat16, 128, 64, "sm90"),
    (torch.float32, 64, 64, "simt"), (torch.float32, 128, 128, "simt"),
    (torch.bfloat16, 96, 96, "simt"), (torch.bfloat16, 192, 128, "simt"),
    (torch.bfloat16, 256, 256, "simt"), (torch.bfloat16, 80, 40, "simt"),
    (torch.bfloat16, 32, 32, "simt"), (torch.float16, 64, 64, "simt")],
    ids=str)
def test_route_by_dtype_and_head_size(dtype, D, Dv, want):
    """The documented rule: bf16 with D and Dv in {64, 128} takes the
    tensor-core kernel, everything else the SIMT kernel (fp16 is then
    refused by the wrapper's dtype check)."""
    assert route(dtype, D, Dv) == want


@pytest.mark.parametrize("D,Dv,keys,want", [(64, 64, 128, 82_984),
                                            (128, 128, 64, 99_368),
                                            (64, 128, 64, 66_600),
                                            (128, 64, 64, 82_984)])
def test_tensor_core_kernel_shared_memory_at_each_head_size(D, Dv, keys,
                                                            want):
    """The bf16 q tile (128 rows), 2 stages of K and V tiles, 5 mbarriers
    and 1024 B to align the swizzled tiles: at D = Dv = 64 (128 keys a
    tile) ~80 KB, at D = Dv = 128 (64 keys) ~97 KB, each under the 227 KB
    (232,448 B) a Hopper block may opt into."""
    assert sm90_keys(D, Dv) == keys
    assert smem_bytes_sm90(D, Dv) == want <= 232_448
    assert want == (2 * 128 * D + 2 * 2 * keys * (D + Dv) + 8 * 5 + 1024)


def test_cuda_wrapper_routes_before_it_checks_alignment():
    """On CPU tensors the wrapper refuses before any route, alignment check
    or launch, at both routes' head sizes."""
    before = dict(ops.launches)
    for D in (64, 80):
        q, k, v = (torch.zeros(sh, dtype=torch.bfloat16)
                   for sh in ((1, 4, 2, D), (1, 4, 1, D), (1, 4, 1, D)))
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            flash_attention_cuda(q, k, v)
    assert ops.launches == before
