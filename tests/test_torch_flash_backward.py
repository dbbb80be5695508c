"""The backward of repro_torch's flash_attention on the CPU: its plain
version (``flash_attention_bwd_ref``, the formulas the CUDA kernel
computes) and the autograd Function's CPU backward against ``jax.grad`` of
the JAX package's ``ref.flash_attention_ref`` and of the model's blocked
``models.layers.flash_attention``, on inputs made with numpy from a seed;
the wiring of ``ops.flash_attention``'s Function and of the guard that
keeps every other kernel's output from leaving the autograd graph,
checked with the CUDA launches replaced by stubs (no card here).

Tolerance: fp32 gradients within rtol 1e-5 plus 1e-6 of the gradient's
scale (its largest magnitude); the sums run in another order than JAX's.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.kernels.ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import _build, histogram, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# (B, Sq, Sk, H, K, D, Dv, causal): JAX's five kernel cases, Sq != Sk both
# ways, ragged, MQA, D != Dv (MLA's 48 / 32 at smoke width), non-causal
SHAPES = [(1, 8, 8, 2, 1, 4, 4, True), (2, 64, 64, 4, 2, 16, 16, True),
          (2, 128, 128, 8, 8, 32, 32, True), (1, 64, 64, 4, 1, 32, 16, True),
          (2, 64, 64, 4, 2, 16, 16, False), (1, 48, 80, 4, 2, 16, 16, True),
          (1, 80, 48, 4, 2, 16, 16, True), (2, 37, 37, 4, 2, 16, 16, True),
          (1, 37, 53, 6, 3, 24, 8, False), (2, 40, 40, 4, 4, 48, 32, True),
          (1, 33, 33, 6, 1, 8, 8, True), (1, 20, 70, 2, 2, 8, 12, False)]
RTOL, ATOL_SCALE = 1e-5, 1e-6


def inputs(shape, seed=0):
    """q, k, v and the output's gradient as numpy fp32."""
    B, Sq, Sk, H, K, D, Dv, _ = shape
    rng = np.random.default_rng(seed + sum(shape[:-1]))
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Sk, K, D)).astype(np.float32),
            rng.normal(size=(B, Sk, K, Dv)).astype(np.float32),
            rng.normal(size=(B, Sq, H, Dv)).astype(np.float32))


def jax_grads(fn, q, k, v, do, causal):
    def f(q, k, v):
        return jnp.sum(fn(q, k, v, causal=causal) * jnp.asarray(do))
    grad = jax.jit(jax.grad(f, argnums=(0, 1, 2)))
    g = grad(*map(jnp.asarray, (q, k, v)))
    return [np.asarray(a) for a in g]


def close(got, want, what):
    for name, g, w in zip("qkv", got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(
            g, w, rtol=RTOL, atol=ATOL_SCALE * float(np.abs(w).max()),
            err_msg=f"{what} d{name}")


def plain_backward(q, k, v, do, causal):
    q, k, v, do = map(torch.tensor, (q, k, v, do))
    o, lse = fa.flash_attention_ref_lse(q, k, v, causal=causal)
    return fa.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_matches_jax_grad_of_ref(shape):
    q, k, v, do = inputs(shape)
    causal = shape[-1]
    close(plain_backward(q, k, v, do, causal),
          jax_grads(jref.flash_attention_ref, q, k, v, do, causal),
          "flash_attention_bwd_ref vs jax.grad(ref)")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_function_backward_matches_jax_grad_of_blocked(shape):
    """The model's path: ``layers.flash_attention`` on CPU tensors that
    require grad goes through ``ops.FlashAttention``, whose backward is
    the plain one; JAX differentiates its blocked jnp attention."""
    from repro_torch.models import layers as TL
    q, k, v, do = inputs(shape)
    causal = shape[-1]
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = TL.flash_attention(qt, kt, vt, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (qt, kt, vt), torch.tensor(do))
    close(got, jax_grads(JL.flash_attention, q, k, v, do, causal),
          "Function backward vs jax.grad(blocked)")


@pytest.mark.parametrize("shape", SHAPES[:4], ids=str)
def test_forward_with_lse_is_the_plain_forward(shape):
    """``flash_attention_ref_lse`` gives ``flash_attention_ref``'s output
    bit for bit, and each row's log-sum-exp of the scaled scores."""
    q, k, v, _ = inputs(shape)
    causal = shape[-1]
    qt, kt, vt = map(torch.tensor, (q, k, v))
    out, lse = fa.flash_attention_ref_lse(qt, kt, vt, causal=causal)
    assert torch.equal(out, fa.flash_attention_ref(qt, kt, vt,
                                                   causal=causal))
    B, Sq, H, D = q.shape
    s = np.einsum("bqhd,bphd->bhqp", q.astype(np.float64),
                  np.repeat(k, H // k.shape[2], axis=2)) / np.sqrt(D)
    if causal:
        s = np.where(np.tril(np.ones((Sq, k.shape[1]), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-6)


def test_fully_masked_row_gives_zero_gradients():
    """A row whose lse is -inf (it saw no key; its output row is 0, as the
    kernel writes it) takes p = 0 everywhere: finite, zero dq, and no
    share in dk, dv."""
    shape = (1, 16, 16, 4, 2, 8, 8, True)
    q, k, v, do = map(torch.tensor, inputs(shape)[:4])
    o, lse = fa.flash_attention_ref_lse(q, k, v, causal=True)
    lse[0, 1, 5] = -float("inf")
    o[0, 5, 1] = 0.0
    dq, dk, dv = fa.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=True)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert not dq[0, 5, 1].any()
    do2 = do.clone()
    do2[0, 5, 1] = 0.0
    _, dk2, dv2 = fa.flash_attention_bwd_ref(q, k, v, o, do2, lse,
                                             causal=True)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_gqa_gradients_sum_over_the_query_heads():
    """dk and dv of a KV head are the sums over its G query heads: the
    same attention with K repeated G times gives the same gradient once
    the repeats are summed."""
    shape = (1, 24, 24, 6, 2, 8, 8, True)
    q, k, v, do = map(torch.tensor, inputs(shape))
    o, lse = fa.flash_attention_ref_lse(q, k, v, causal=True)
    dq, dk, dv = fa.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=True)
    kr, vr = (t.repeat_interleave(3, dim=2) for t in (k, v))
    o2, lse2 = fa.flash_attention_ref_lse(q, kr, vr, causal=True)
    dq2, dk2, dv2 = fa.flash_attention_bwd_ref(q, kr, vr, o2, do, lse2,
                                               causal=True)
    torch.testing.assert_close(dq, dq2, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dk, dk2.reshape(1, 24, 2, 3, 8).sum(3),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dv, dv2.reshape(1, 24, 2, 3, 8).sum(3),
                               rtol=1e-5, atol=1e-6)


@pytest.fixture
def routed_as_cuda(monkeypatch):
    """CPU tensors routed down ``ops``' CUDA branches, each launch replaced
    by its plain version and recorded."""
    calls = []

    def fwd(q, k, v, *, causal, scale, with_lse):
        calls.append(("forward", with_lse))
        out, lse = fa.flash_attention_ref_lse(q, k, v, causal=causal,
                                              scale=scale)
        return (out, lse) if with_lse else out

    def bwd(*args, **kw):
        calls.append(("backward", None))
        return fa.flash_attention_bwd_ref(*args, **kw)

    monkeypatch.setattr(ops, "_runs_plain", lambda t: False)
    monkeypatch.setattr(ops, "flash_attention_cuda", fwd)
    monkeypatch.setattr(ops, "flash_attention_bwd_cuda", bwd)
    return calls


def test_cuda_path_keeps_the_graph(routed_as_cuda):
    """On the CUDA branch a forward that needs a gradient asks the kernel
    for lse and goes through the Function, whose backward launches the
    backward kernel; the gradient equals autograd of the plain version.
    Without grad the forward is the plain launch (no lse), as serving's."""
    shape = (2, 24, 24, 4, 2, 8, 8, True)
    q, k, v, do = map(torch.tensor, inputs(shape))
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    assert routed_as_cuda == [("forward", False)]
    qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, causal=True)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (qt, kt, vt), do)
    assert routed_as_cuda[1:] == [("forward", True), ("backward", None)]
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(
        fa.flash_attention_ref(qr, kr, vr, causal=True), (qr, kr, vr), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_bf16_that_needs_a_gradient_is_refused():
    """The backward kernels take fp32 and bf16: an fp16 input that needs
    a gradient is refused, naming the dtypes; a bf16 one (once refused
    too) goes through the Function and gets bf16 gradients."""
    q, k, v, _ = (torch.tensor(a) for a in inputs((1, 8, 8, 2, 1, 4, 4,
                                                   True)))
    with pytest.raises(TypeError, match="take fp32 or bf16, got "
                       "torch.float16"):
        ops.flash_attention(q.half().requires_grad_(), k.half(), v.half())
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    with torch.no_grad():      # serving's bf16 forward is unchanged
        assert ops.flash_attention(qb, kb, vb).dtype == torch.bfloat16
    out = ops.flash_attention(qb.requires_grad_(), kb, vb)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    (dq,) = torch.autograd.grad(out.float().sum(), qb)
    assert dq.dtype == torch.bfloat16 and torch.isfinite(dq.float()).all()


def _meta(*shape, dtype=torch.float32, grad=False):
    """A tensor on the meta device, which no kernel can run on (``ops``
    sends meta to the plain versions unless ``ops._runs_plain`` is
    patched, as below)."""
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def _launched(monkeypatch, module, name):
    calls = []
    monkeypatch.setattr(module, name, lambda *a, **kw: calls.append(name))
    return calls


@pytest.mark.parametrize("kernel", ["ssd_chunk", "top2_confidence",
                                    "grove_aggregate", "tree_traverse",
                                    "fused_fog", "histogram"])
def test_kernels_without_a_backward_refuse_inputs_that_need_one(
        monkeypatch, kernel):
    """Where a kernel without a backward would get an input that requires
    grad, the dispatch raises naming the kernel (and for ssd_chunk, whose
    backward kernel takes fp32 and bf16, an fp16 input, naming the dtypes)
    before any launch; under no_grad, or with no input requiring grad, it
    launches."""
    g = dict(grad=True)
    f16 = torch.float16
    cases = {
        "ssd_chunk": (ops, "ssd_chunk_cuda", lambda gr: ops.ssd_chunk(
            _meta(1, 1, 4, 2, 4, dtype=f16, **gr),
            _meta(1, 1, 2, 4, dtype=f16), _meta(1, 1, 4, 4, dtype=f16),
            _meta(1, 1, 4, 4, dtype=f16))),
        "top2_confidence": (ops, "top2_confidence_cuda",
                            lambda gr: ops.top2_confidence(_meta(4, 5, **gr))),
        "grove_aggregate": (ops, "grove_aggregate_cuda",
                            lambda gr: ops.grove_aggregate(
                                _meta(4, 3), _meta(4, 3, **gr),
                                _meta(4, dtype=torch.bool),
                                _meta(4, dtype=torch.int32), 0.3)),
        "tree_traverse": (ops, "tree_traverse_cuda",
                          lambda gr: ops.tree_traverse(
                              _meta(2, 3, dtype=torch.int32), _meta(2, 3),
                              _meta(2, 4, 5, **gr), _meta(6, 7))),
        "fused_fog": (ops, "fused_fog_on_route",
                      lambda gr: ops.fused_fog(
                          _meta(1, 2, 2, 3, dtype=torch.int32),
                          _meta(1, 2, 2, 3), _meta(1, 2, 2, 4, 5, **gr),
                          _meta(6, 7), _meta(6, dtype=torch.int32),
                          _meta(6), _meta(6, dtype=torch.int32),
                          max_hops=2)),
        "histogram": (histogram, "histogram_level_cuda",
                      lambda gr: histogram.histogram_level(
                          _meta(2, 5, dtype=torch.int32),
                          _meta(5, dtype=torch.int32), _meta(2, 5, **gr),
                          _meta(5, 3, dtype=torch.int32), n_nodes=1,
                          n_bins=4, n_classes=2, matmul_max_r=8))}
    module, name, call = cases[kernel]
    # the CUDA branch for meta tensors (histogram decides by the CPU alone)
    monkeypatch.setattr(ops, "_runs_plain", lambda t: False)
    launched = _launched(monkeypatch, module, name)
    if kernel == "grove_aggregate":
        monkeypatch.setattr(ops, "check_contrib", lambda c: None)
    if kernel == "ssd_chunk":
        raises = pytest.raises(TypeError, match="ssd_chunk's backward "
                               "kernels take fp32 or bf16, got "
                               "torch.float16")
    else:
        raises = pytest.raises(RuntimeError, match=f"{kernel}'s CUDA "
                               "kernel has no backward")
    with raises:
        call(g)
    assert launched == []
    with torch.no_grad():
        call(g)
    call({})
    assert launched == [name, name]


def test_backward_tiles_fit_a_hopper_block_at_every_head_size():
    """The SIMT backward's tiles by head size (64 rows up to 128 columns,
    32 above), and its shared memory under the 227 KB (232,448 B) a
    Hopper block may opt into at every head size up to 256 (142,592 B at
    D = Dv = 256 with 32-row tiles; 64 rows there would need 285,184)."""
    assert fa.bwd_tiles(64, 64) == (64, 64, 1)
    assert fa.bwd_tiles(96, 64) == (64, 64, 2)
    assert fa.bwd_tiles(192, 128) == (32, 32, 4)
    assert fa.bwd_smem_bytes(256, 256) == 142_592
    assert fa.bwd_smem_bytes(64, 64) == 104_960
    for D in range(1, fa.MAX_HEAD + 1):
        for Dv in (1, D, fa.MAX_HEAD):
            keys, rows, nc = fa.bwd_tiles(D, Dv)
            assert 64 * nc >= max(D, Dv) and nc in (1, 2, 4)
            assert keys == rows in (32, 64)
            assert fa.bwd_smem_bytes(D, Dv) <= 232_448


@pytest.mark.parametrize("D,Dv,rows,nc,want", [
    (32, 32, 64, 1, 72_192), (64, 64, 64, 1, 104_960),
    (128, 128, 64, 2, 170_496), (256, 256, 32, 4, 142_592),
    (48, 32, 64, 1, 80_384)], ids=str)
def test_simt_backward_tiles_at_the_widths_it_takes(D, Dv, rows, nc, want):
    """The SIMT backward's tiling at jamba's 32, tinyllama's fp32 64, 128,
    the largest 256 and MLA's smoke 48 / 32: T-row tiles (a thread's
    register tile T / 16 square, 4 columns in each of ``nc`` 64-column
    groups), fp32 rows of an odd number of float4s (D = 64 -> 68 floats,
    48 -> 52, 32 -> 36), a dK/dV block's K, V, q, do, pᵀ and dsᵀ and the
    rows' lse and delta under the 227 KB a block may opt into."""
    assert fa.bwd_tiles(D, Dv) == (rows, rows, nc)
    ld = {w: 4 * (-(-w // 4) | 1) for w in (D, Dv, rows)}
    assert ld[D] % 8 == 4 and ld[Dv] % 8 == 4
    assert fa.bwd_smem_bytes(D, Dv) == want == 4 * (
        2 * rows * (ld[D] + ld[Dv]) + 2 * rows * ld[rows] + 2 * rows
    ) <= 232_448


@pytest.mark.parametrize("D,Dv,split,want", [
    (64, 64, False, 50_712), (128, 128, False, 99_864),
    (64, 128, False, 75_288), (128, 64, False, 75_288),
    (96, 64, False, 75_288), (192, 128, True, 140_824),
    (256, 256, True, 214_552)], ids=str)
def test_tensor_core_backward_shared_memory_at_each_pair(D, Dv, split,
                                                         want):
    """The tensor-core backward's block: its own two bf16 tiles (64 rows,
    D padded to whole 64-column chunks: 96 as 128), 2 stages of loop
    tiles, p^T in fp32 (16 KB) where the dK/dV pass runs two warpgroups
    (D + Dv > 256), the loop tile's lse and delta, 3 mbarriers and 1024 B
    to align the swizzled tiles; each under the 227 KB (232,448 B) a
    Hopper block may opt into, and every pair on the tensor-core route."""
    assert (D, Dv) in fa.SM90_PAIRS
    assert fa.route(torch.bfloat16, D, Dv) == "sm90"
    assert fa.bwd_split_dkdv(D, Dv) is split
    assert fa.bwd_smem_bytes_sm90(D, Dv) == want <= 232_448
    dp = fa.sm90_padded(D)
    assert want == (2 * 64 * (dp + Dv) * 3 + 4 * 64 * 64 * split + 512
                    + 24 + 1024)


def test_backward_wrapper_refuses_before_any_launch():
    q, k, v, do = map(torch.tensor, inputs((1, 8, 8, 2, 1, 4, 4, True)))
    o, lse = fa.flash_attention_ref_lse(q, k, v)
    before = dict(ops.launches)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fa.flash_attention_bwd_cuda(q, k, v, o, do, lse)
    assert ops.launches == before and "flash_attention_bwd" in ops.launches
    assert _build.launches is ops.launches
