"""repro_torch's top2_confidence on the CPU: the plain version against the
JAX package's reference on rows with repeated maxima, the shape rule that
picks the card's launch, and the merge rule of the long-row launch
(csrc/fog_kernels.cu::top2_merge) replayed in numpy over blocks of a row,
which must give the plain version's margin exactly (max and compare round
nothing).  The kernels themselves run in tests/test_torch_cuda.py.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.top2_confidence import (  # noqa: E402
    COLS_PER_BLOCK, SHORT_ROW, row_blocks, top2_confidence_cuda)

SHAPES = [(4, 32000), (4, 50280), (1, 50280), (4, 7), (1000, 10), (3, 65),
          (1, 1)]


def rows_with_ties(B, C, seed=0):
    """Softmax rows with the maximum repeated in every fourth row (at
    columns 1 and C // 2) and the last row all equal."""
    rng = np.random.default_rng(seed + B + C)
    x = rng.random((B, C), dtype=np.float32) * 8
    p = np.exp(x - x.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    top = np.float32(p.max() + 1)
    if C > 1:
        p[::4, 1] = top
        p[::4, C // 2] = top
    if B > 1:
        p[-1] = np.float32(1 / C)
    return p


def merge(a, b):
    """csrc/fog_kernels.cu::top2_merge on (m1, m2, i1) triples."""
    a_wins = a[0] > b[0] or (a[0] == b[0] and a[2] < b[2])
    w, other = (a, b[0]) if a_wins else (b, a[0])
    return (w[0], other if other > w[1] else w[1], w[2])


def blocked_margin(row: np.ndarray, nblk: int, threads: int = 256) -> float:
    """The long-row launch's arithmetic in numpy: each thread's strided
    walk of its block's columns, merged in an arbitrary order."""
    C = row.shape[0]
    cols = -(-C // nblk)
    parts = []
    for blk in range(nblk):
        for t in range(threads):
            s = (-np.inf, -np.inf, 2**31 - 1)
            for c in range(blk * cols + t, min(C, (blk + 1) * cols), threads):
                v = row[c]
                if v > s[0]:
                    s = (v, s[0], c)
                elif v > s[1]:
                    s = (s[0], v, s[2])
            parts.append(s)
    rng = np.random.default_rng(C)
    acc = (-np.inf, -np.inf, 2**31 - 1)
    for j in rng.permutation(len(parts)):
        acc = merge(acc, parts[j])
    return np.float32(abs(np.float32(acc[0]) - np.float32(acc[1])))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_version_matches_jax_with_repeated_maxima(shape):
    p = rows_with_ties(*shape)
    got = ops.top2_confidence(torch.tensor(p))
    want = np.asarray(jref.top2_confidence_ref(jnp.asarray(p)))
    np.testing.assert_array_equal(got.numpy(), want)
    if shape[1] > 1:
        assert (got[::4] == 0).all()


@pytest.mark.parametrize("B,C,want", [
    (4, 32000, 16), (4, 50280, 25), (1, 50280, 25), (1000, 32000, 1),
    (4, 7, 0), (1000, 10, 0), (65536, 10, 0), (3, SHORT_ROW, 0),
    (3, SHORT_ROW + 1, 1), (264, 5000, 1), (2, 10**6, 132)], ids=str)
def test_row_blocks_rule(B, C, want):
    """One thread per row up to SHORT_ROW entries; above it enough blocks
    per row to give the card ~264 blocks, at most one per
    COLS_PER_BLOCK columns, at least one."""
    assert row_blocks(B, C) == want
    if want:
        assert -(-C // want) <= max(COLS_PER_BLOCK, -(-C // want))


@pytest.mark.parametrize("shape,nblk", [((4, 32000), 16), ((1, 50280), 25),
                                        ((4, 3000), 3), ((2, 700), 1)],
                         ids=str)
def test_block_merge_gives_the_plain_margin(shape, nblk):
    """The long-row launch's walk and merge, replayed in numpy, equal the
    plain version bit for bit on rows with ties inside a block and across
    blocks and on a row of equal entries."""
    p = rows_with_ties(*shape, seed=1)
    want = ref.top2_confidence_ref(torch.tensor(p)).numpy()
    got = np.array([blocked_margin(row, nblk) for row in p], np.float32)
    np.testing.assert_array_equal(got, want)


def test_cuda_wrapper_refuses_before_any_launch():
    before = dict(ops.launches)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        top2_confidence_cuda(torch.zeros((4, 100)))
    assert ops.launches == before
