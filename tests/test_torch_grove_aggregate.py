"""repro_torch's grove_aggregate tile kernel, replayed on the CPU: its plan
(every lane served once, the shared memory, the route by C) and its order
of work (a warp's run of rows added, each row walked from the tile) held
against the JAX package's Pallas kernel in interpret mode and the plain
version.

Tolerance: none.  The hop update adds, divides and compares, each rounded
once in float32 in the same order everywhere, so the replay, the plain
version and the Pallas kernel are ``torch.equal`` after a float32 cast.
The cases are ``chip_smoke.aggregate_case``'s, which the card's tests and
``chip_smoke.py`` run through the kernel.
"""
import pytest

torch = pytest.importorskip("torch")

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.grove_aggregate import grove_aggregate_pallas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.grove_aggregate import (  # noqa: E402
    ROUTES, block_warps, grove_aggregate_on_route, grove_aggregate_ref,
    grove_aggregate_tile_replay, plan, tile_max_classes, tile_stride)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import AGG_B, AGG_C, AGG_KINDS, aggregate_case  # noqa: E402

# an H100: SMs, and the shared memory one block may opt into
H100_SMS = 132
H100_SMEM_OPTIN = 232_448


def outputs_equal(got, want):
    for g, w, name in zip(got, want, ("prob", "hops", "live", "margin")):
        g = torch.as_tensor(np.array(g)).to(torch.float32)
        w = torch.as_tensor(np.array(w)).to(torch.float32)
        assert g.shape == w.shape and torch.equal(g, w), name


def three_ways(case, scalar_thresh: bool, block_b: int = 256):
    """The replay on the H100 plan, the plain version and JAX's Pallas
    kernel (interpret mode) on one case; returns the three outputs."""
    prob, contrib, live, hops, thresh = case
    B, C = prob.shape
    th = 0.2 if scalar_thresh else thresh
    args = tuple(map(torch.as_tensor, (prob, contrib, live, hops)))
    th_t = th if scalar_thresh else torch.as_tensor(th)
    p = plan(B, C, H100_SMS, block_b, smem_optin=H100_SMEM_OPTIN)
    replay = grove_aggregate_tile_replay(*args, th_t, p)
    plain = grove_aggregate_ref(*args, th_t)
    jax = grove_aggregate_pallas(*map(jnp.asarray, (prob, contrib, live,
                                                    hops)),
                                 jnp.asarray(th, jnp.float32))
    return replay, plain, jax


@pytest.mark.parametrize("C", AGG_C)
@pytest.mark.parametrize("B", AGG_B)
def test_tile_replay_equals_jax_and_plain(B, C):
    """Every batch around a warp and the bench's, every class count: an
    all-dead warp, an all-live warp and random lanes, per-lane thresholds."""
    case = aggregate_case(np.random.default_rng(B * 31 + C), B, C, "mixed")
    replay, plain, jax = three_ways(case, scalar_thresh=False)
    outputs_equal(replay, plain)
    outputs_equal(replay, jax)


@pytest.mark.parametrize("scalar_thresh", [True, False],
                         ids=["scalar", "per_lane"])
@pytest.mark.parametrize("kind", AGG_KINDS)
@pytest.mark.parametrize("B,C", [(777, 10), (33, 26)])
def test_tile_replay_cases(B, C, kind, scalar_thresh):
    """All-dead and all-live batches, ties at the maximum (margin 0: only
    the first maximum is masked), -0.0 in dead lanes' rows (the plain
    version adds a zero, so it comes out +0.0), scalar and per-lane
    thresholds."""
    case = aggregate_case(np.random.default_rng(len(kind) + C), B, C, kind)
    replay, plain, jax = three_ways(case, scalar_thresh)
    outputs_equal(replay, plain)
    outputs_equal(replay, jax)
    if kind == "ties":
        assert (replay[3][::8] == 0).all()
    if kind == "dead":
        assert not replay[2].any()
        assert torch.equal(replay[1], torch.as_tensor(case[3]))
    if kind == "negzero":
        dead = ~torch.as_tensor(case[2])
        assert not torch.signbit(replay[0][dead]).any()


def test_top_two_of_the_sums_give_the_plain_margin():
    """The tile kernel divides only each row's top two sums: a correctly
    rounded division by one positive number keeps their order, so the
    margin is the plain version's even where the division rounds two
    maxima together and moves the first maximum's index ("ulp" rows one
    float apart, divisors 1-7: some rows do move)."""
    case = aggregate_case(np.random.default_rng(3), 1000, 10, "ulp")
    prob, contrib, live, hops, _ = map(torch.as_tensor, case)
    sums = prob + torch.where(live[:, None], contrib, torch.zeros(()))
    d = torch.clamp(hops + live.to(torch.int32), min=1)[:, None]
    moved = (sums / d.to(torch.float32)).argmax(1) != sums.argmax(1)
    assert moved.any()
    replay, plain, jax = three_ways(case, scalar_thresh=False)
    outputs_equal(replay, plain)
    outputs_equal(replay, jax)


@pytest.mark.parametrize("C", [1, 10, 26, 1000])
@pytest.mark.parametrize("B", [1, 33, 1000, 16_384, 65_536, 65_537])
@pytest.mark.parametrize("block_b", [32, 256, 1024])
@pytest.mark.parametrize("n_sm", [H100_SMS, 7])
def test_plan_serves_every_lane_once(B, C, block_b, n_sm):
    """Every lane falls in exactly one warp of the grid, ragged B included;
    a block is a whole number of warps within block_b, and its tile fits
    the 227 KB a block may hold."""
    p = plan(B, C, n_sm, block_b, smem_optin=H100_SMEM_OPTIN)
    assert p["route"] == "tile"
    seen = np.zeros(B, np.int64)
    for b0, n in block_warps(p, B):
        assert 1 <= n <= 32
        seen[b0:b0 + n] += 1
    assert (seen == 1).all()
    assert p["lanes"] % 32 == 0 and 32 <= p["lanes"] <= block_b
    assert p["threads"] == p["lanes"] and p["grid"] * p["lanes"] >= B
    assert p["smem"] == p["lanes"] * tile_stride(C) * 4 <= H100_SMEM_OPTIN


@pytest.mark.parametrize("B,lanes,grid", [(1000, 32, 32), (16_384, 128, 128),
                                          (65_536, 256, 256)])
def test_plan_spreads_the_bench_batch_over_the_sms(B, lanes, grid):
    """One block per SM at most: 32 blocks of 32 lanes at B = 1000, not 4
    blocks of 256; block_b caps the lanes at 65,536."""
    p = plan(B, 10, H100_SMS, 256, smem_optin=H100_SMEM_OPTIN)
    assert (p["route"], p["lanes"], p["grid"]) == ("tile", lanes, grid)
    assert p["smem"] == lanes * 11 * 4


def test_plan_routes_by_classes_at_the_tile_limit():
    """The tile route takes C while one warp's tile (32 rows of C | 1
    floats) fits 227 KB: 1815 classes; 1816 takes the lane route.  Near
    the limit the shared memory, not block_b, caps the lanes."""
    top = tile_max_classes(H100_SMEM_OPTIN)
    assert top == 1815 and 32 * tile_stride(top) * 4 <= H100_SMEM_OPTIN
    assert 32 * tile_stride(top + 1) * 4 > H100_SMEM_OPTIN
    at = plan(1000, top, H100_SMS, 256, smem_optin=H100_SMEM_OPTIN)
    assert (at["route"], at["lanes"]) == ("tile", 32)
    over = plan(1000, top + 1, H100_SMS, 256, smem_optin=H100_SMEM_OPTIN)
    assert over == {"route": "lane", "lanes": 256, "grid": 4,
                    "threads": 256, "smem": 0}
    half = plan(65_536, 900, H100_SMS, 256, smem_optin=H100_SMEM_OPTIN)
    assert half["lanes"] == 64 and half["smem"] <= H100_SMEM_OPTIN


def test_plan_takes_named_lanes_and_refuses_bad_ones():
    p = plan(1000, 10, H100_SMS, 256, smem_optin=H100_SMEM_OPTIN, lanes=128)
    assert (p["lanes"], p["grid"]) == (128, 8)
    for bad in (16, 48, 2048):
        with pytest.raises(ValueError, match="multiple of 32"):
            plan(1000, 10, H100_SMS, 256, smem_optin=H100_SMEM_OPTIN,
                 lanes=bad)


def test_named_routes_are_the_declared_ones():
    """grove_aggregate_on_route takes the tile kernel or the first port's
    kernel by name, and refuses any other name before it reads a tensor."""
    assert ROUTES == ("tile", "lane")
    with pytest.raises(ValueError, match="route must be one of"):
        grove_aggregate_on_route(None, None, None, None, 0.3, route="warp")


def test_cpu_wrapper_runs_the_plain_version():
    """On CPU tensors ops.grove_aggregate is the plain version and counts
    no launch."""
    prob, contrib, live, hops, thresh = map(torch.as_tensor, aggregate_case(
        np.random.default_rng(0), 70, 10, "mixed"))
    before = dict(ops.launches)
    got = ops.grove_aggregate(prob, contrib, live, hops, thresh)
    assert ops.launches == before
    outputs_equal(got, grove_aggregate_ref(prob, contrib, live, hops,
                                           thresh))
