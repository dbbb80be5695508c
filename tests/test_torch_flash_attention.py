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
    MAX_HEAD, check_shapes, flash_attention_cuda, flash_attention_ref,
    flash_attention_ref_lse, fwd_tiles, route, sm90_keys, smem_bytes,
    smem_bytes_sm90, softmax_scale)
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
    """The SIMT forward's block (two groups' q and p tiles, one K and one
    V tile, fp32 rows of an odd number of float4s): tinyllama's D = 64
    needs 104,448 B (two blocks an SM); the largest block, D = Dv = 128,
    169,984 B; D = Dv = 256 on 32-row tiles 142,336 B; each under the 227
    KB (232,448 B) a Hopper block may opt into."""
    assert smem_bytes(64, 64) == 104_448
    assert 2 * (smem_bytes(64, 64) + 1024) <= 233_472
    assert smem_bytes(128, 128) == 169_984 <= 232_448
    assert smem_bytes(MAX_HEAD, MAX_HEAD) == 142_336 <= 232_448
    assert max(smem_bytes(D, Dv) for D in range(1, MAX_HEAD + 1)
               for Dv in range(1, MAX_HEAD + 1)) == 169_984


def _row_ld(w):
    return 4 * (-(-w // 4) | 1)


# (D, Dv, the tile class's boundary, (q rows, keys, 32-column groups),
# shared memory of a block): the tiles follow max(D, Dv) alone
FWD_TILE_CASES = [
    (1, 1, "the smallest head", (64, 64, 2), 38_912),
    (32, 32, "jamba's 32", (64, 64, 2), 71_680),
    (48, 32, "MLA at smoke width", (64, 64, 2), 83_968),
    (64, 64, "the last of the 64-column class", (64, 64, 2), 104_448),
    (64, 65, "Dv past 64", (64, 64, 4), 104_448),
    (65, 64, "D past 64", (64, 64, 4), 104_448),
    (65, 65, "the first of the 128-column class", (64, 64, 4), 104_448),
    (96, 64, "minicpm3's MLA", (64, 64, 4), 129_024),
    (128, 1, "D at 128, Dv 1", (64, 64, 4), 137_216),
    (128, 128, "the last of the 128-column class", (64, 64, 4), 169_984),
    (129, 129, "the first of the 256-column class", (32, 32, 8), 76_800),
    (1, 129, "Dv past 128", (32, 32, 8), 27_648),
    (192, 128, "deepseek's MLA", (32, 32, 8), 101_376),
    (256, 1, "D at 256, Dv 1", (32, 32, 8), 109_568),
    (256, 256, "the largest head", (32, 32, 8), 142_336)]


@pytest.mark.parametrize("D,Dv,boundary,tiles,want", FWD_TILE_CASES,
                         ids=[c[2] for c in FWD_TILE_CASES])
def test_forward_tiles_at_each_boundary(D, Dv, boundary, tiles, want):
    """``fwd_tiles`` picks the SIMT forward's tiles by max(D, Dv): 64-row
    q tiles and 64-key tiles up to 128 columns (2 or 4 groups of 32 output
    columns a thread), 32 and 32 above; ``smem_bytes`` is the block's two
    q tiles, its K and V tiles and two p tiles, rows of an odd number of
    float4s, under the 232,448 B a Hopper block may opt into."""
    assert fwd_tiles(D, Dv) == tiles
    bq, bk, nq = tiles
    assert 32 * nq >= max(D, Dv)
    assert smem_bytes(D, Dv) == want == 4 * (
        2 * bq * _row_ld(D) + bk * (_row_ld(D) + _row_ld(Dv))
        + 2 * bq * _row_ld(bk)) <= 232_448


def test_forward_tiles_follow_the_larger_head_at_every_size():
    """At every D, Dv <= 256 the tiles depend on max(D, Dv) alone, a
    thread's output columns cover Dv, and the block fits 232,448 B."""
    for D in range(1, MAX_HEAD + 1):
        for Dv in range(1, MAX_HEAD + 1):
            tiles = fwd_tiles(D, Dv)
            assert tiles == fwd_tiles(max(D, Dv), max(D, Dv))
            assert 32 * tiles[2] >= Dv
            assert smem_bytes(D, Dv) <= 232_448


def _masked_row(q, k):
    """q's row 1 of head 0 set to -inf against keys made positive: every
    score of that row is -inf, a row that sees no key."""
    q, k = q.copy(), np.abs(k)
    q[0, 1, 0] = -np.inf
    return q, k


@pytest.mark.parametrize("masked", [False, True],
                         ids=["", "a fully masked row"])
@pytest.mark.parametrize("shape", JAX_SHAPES + MORE_SHAPES, ids=str)
def test_plain_lse_matches_jax_ref_and_float64(shape, masked):
    """``flash_attention_ref_lse``: its output is JAX's
    ``ref.flash_attention_ref``'s (rtol/atol 2e-5; NaN for a row with no
    finite score in both, a softmax over nothing), and its lse is a
    float64 logsumexp of the scaled, masked scores within 2e-6 of its
    magnitude (at least 1; chip_smoke's ``LSE_BAR``: an fp32 ulp or two of
    a log-sum-exp near 6), -inf where every score is -inf."""
    q, k, v = inputs(shape, seed=2)
    B, Sq, Sk, H, K, D, Dv, causal = shape
    if masked:
        q, k = _masked_row(q, k)
    out, lse = flash_attention_ref_lse(*(torch.tensor(a) for a in (q, k, v)),
                                       causal=causal)
    np.testing.assert_allclose(out.numpy(), jax_ref(q, k, v, causal), **FP32)
    with np.errstate(invalid="ignore"):
        s = np.einsum("bqkgd,bpkd->bkgqp",
                      q.astype(np.float64).reshape(B, Sq, K, H // K, D),
                      k.astype(np.float64)) * softmax_scale(D)
    if causal:
        s = np.where(np.arange(Sq)[:, None] >= np.arange(Sk)[None, :], s,
                     -np.inf)
    want = torch.logsumexp(torch.from_numpy(s), -1).reshape(B, H, Sq).numpy()
    got = lse.numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isneginf(got[0, 0, 1]) == masked
    fin = np.isfinite(want)
    assert (np.abs(got[fin] - want[fin])
            <= 2e-6 * np.maximum(np.abs(want[fin]), 1.0)).all()


@pytest.mark.parametrize("dtype,D,Dv,want", [
    (torch.bfloat16, 64, 64, "sm90"), (torch.bfloat16, 128, 128, "sm90"),
    (torch.bfloat16, 64, 128, "sm90"), (torch.bfloat16, 128, 64, "sm90"),
    (torch.float32, 64, 64, "simt"), (torch.float32, 128, 128, "simt"),
    (torch.bfloat16, 96, 96, "simt"), (torch.bfloat16, 192, 128, "sm90"),
    (torch.bfloat16, 256, 256, "sm90"), (torch.bfloat16, 80, 40, "simt"),
    (torch.bfloat16, 32, 32, "simt"), (torch.float16, 64, 64, "simt"),
    (torch.bfloat16, 96, 64, "sm90"), (torch.bfloat16, 48, 32, "simt"),
    (torch.bfloat16, 64, 96, "simt"), (torch.float32, 96, 64, "simt"),
    (torch.float32, 192, 128, "simt"), (torch.float32, 256, 256, "simt")],
    ids=str)
def test_route_by_dtype_and_head_size(dtype, D, Dv, want):
    """The documented rule: bf16 at the seven (D, Dv) pairs of
    ``SM90_PAIRS`` (64 and 128 in any pairing, minicpm3's 96 / 64,
    deepseek's 192 / 128, gemma's 256 / 256) takes the tensor-core kernel,
    everything else the SIMT kernel (fp16 is then refused by the wrapper's
    dtype check): the pairs, not their product (96 / 96, 64 / 96 stay
    SIMT)."""
    assert route(dtype, D, Dv) == want


@pytest.mark.parametrize("D,Dv,keys,want", [(64, 64, 128, 82_984),
                                            (128, 128, 64, 99_368),
                                            (64, 128, 64, 66_600),
                                            (128, 64, 64, 82_984),
                                            (96, 64, 128, 132_136),
                                            (192, 128, 64, 132_136),
                                            (256, 256, 64, 164_904)])
def test_tensor_core_kernel_shared_memory_at_each_head_size(D, Dv, keys,
                                                            want):
    """The bf16 q tile (128 rows; 64 at Dv = 256, where the two
    warpgroups split the columns), 2 stages of K and V tiles, 5 mbarriers
    and 1024 B to align the swizzled tiles, q and K padded to whole
    64-column chunks (D = 96 as 128): at D = Dv = 64 (128 keys a tile) ~80
    KB, at D = Dv = 128 (64 keys) ~97 KB, at D = Dv = 256 ~161 KB, each
    under the 227 KB (232,448 B) a Hopper block may opt into."""
    assert sm90_keys(D, Dv) == keys
    assert smem_bytes_sm90(D, Dv) == want <= 232_448
    dp, rows = -(-D // 64) * 64, 64 if Dv == 256 else 128
    assert want == (2 * rows * dp + 2 * 2 * keys * (dp + Dv) + 8 * 5
                    + 1024)


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
