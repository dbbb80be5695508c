"""One Algorithm-2 hop update (lines 7-11) in one pass, on the card.

Replaces ``repro/kernels/grove_aggregate.py::_aggregate_kernel`` (Pallas
TPU): ``prob += contrib * live``, ``hops += live``, divide by ``max(hops,
1)``, first-max MaxDiff, ``live &= margin < thresh``.  The plain version is
:func:`grove_aggregate_ref`.

Two routes, counted in ``_build.routes``:

``"tile"``  ``csrc/fog_kernels.cu::grove_aggregate_tile_kernel``, the rule:
            :func:`plan`'s ``lanes`` lanes a block (tens of blocks at the
            bench's B = 1000), each warp reading its 32 lanes' rows of
            ``prob`` and ``contrib`` as one contiguous run (16-byte vectors
            where the pointers are aligned), ``contrib`` only for live
            lanes, writing ``prob`` out from the same registers, walking
            each row's sums from a shared-memory tile for their top two and
            dividing only those two (a correctly rounded division by the
            same positive number keeps their order, so the margin equals
            the plain version's).  It takes C while one warp's tile fits a
            block's shared memory (:func:`tile_max_classes`).
``"lane"``  ``grove_aggregate_kernel``, the first port's kernel: one thread
            per lane reading its row in place, ``block_b`` lanes a block;
            the route for larger C, and the comparison ``chip_smoke.py``
            times on the same inputs.

What bounds them at the forest's ``[B, C <= 26]`` (an H100, PERF.md's
kernel table, row 2): not the bytes.  A call moves 0.1-9 MB, 0.00003-0.003
ms at the memory's rate, against ~0.0009 ms for an empty kernel.  The tile
kernel takes 0.0025-0.0029 ms up to B = 16k, whatever its lanes a block:
the launch and one warp's chain (its lanes' live flags, then contrib, the
tile, the row walk, the stores); at 65,536 0.0032-0.0034, 1.2-1.7x the
bytes bound.  The lane kernel takes 0.0055-0.0066 ms up to 16k and 0.012
at 65,536: each thread loads its row's C entries one after another from
4C-byte-strided addresses and divides all C.
:func:`grove_aggregate_tile_replay` replays the tile kernel's plan and
order in PyTorch, for the tests.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import grove_aggregate_ref

__all__ = ["ROUTES", "block_warps", "check_contrib", "grove_aggregate_cuda",
           "grove_aggregate_on_route", "grove_aggregate_ref",
           "grove_aggregate_tile_replay", "plan", "tile_max_classes",
           "tile_stride"]

ROUTES = ("tile", "lane")
# a warp's lanes: the tile kernel's unit of work and of lanes a block
WARP = 32


def tile_stride(C: int) -> int:
    """Floats between two rows of the shared tile: ``C`` rounded up to odd,
    so that 32 threads reading one column each hit 32 banks."""
    return C | 1


def tile_max_classes(smem_optin: int) -> int:
    """The largest C whose one-warp tile fits ``smem_optin`` bytes."""
    c = smem_optin // (WARP * 4)
    return c if c % 2 else c - 1


def plan(B: int, C: int, n_sm: int, block_b: int, *, smem_optin: int,
         lanes: int | None = None) -> dict:
    """The launch of one hop update: ``route`` ("tile" while one warp's
    tile fits ``smem_optin`` bytes, else "lane"), ``lanes`` a block (tile:
    by default ``ceil(B / n_sm)`` rounded up to a warp, so one block per SM
    at most, at least 32 and at most ``block_b`` and what the shared memory
    holds; ``lanes`` overrides the rule; lane: ``block_b``), ``grid``
    blocks, ``threads`` a block (one per lane) and ``smem``, the tile
    kernel's dynamic shared memory (``lanes x tile_stride(C)`` floats).
    At the bench's C = 10 on 132 SMs the rule gives 32 lanes at B = 1000,
    128 at 16,384 and 256 at 65,536, each within 4 % of the fastest of
    32-256 in ``chip_smoke.py --sweep`` (32 lanes at 65,536: 20 % slower)."""
    stride = tile_stride(C)
    fit = smem_optin // (stride * 4) // WARP * WARP
    if fit < WARP:
        return {"route": "lane", "lanes": block_b,
                "grid": -(-B // block_b), "threads": block_b, "smem": 0}
    if lanes is None:
        per_sm = -(-B // n_sm)
        lanes = min(block_b, max(WARP, -(-per_sm // WARP) * WARP))
    if lanes < WARP or lanes % WARP or lanes > 1024:
        raise ValueError(f"lanes is the tile kernel's threads per block: a "
                         f"multiple of {WARP} in [{WARP}, 1024], got {lanes}")
    lanes = min(lanes, fit)
    return {"route": "tile", "lanes": lanes, "grid": -(-B // lanes),
            "threads": lanes, "smem": lanes * stride * 4}


def block_warps(p: dict, B: int):
    """Yield ``(first lane, lanes)`` for every warp of ``p``'s grid, as the
    tile kernel reads its block and warp index."""
    for blk in range(p["grid"]):
        for w in range(p["lanes"] // WARP):
            b0 = blk * p["lanes"] + w * WARP
            if b0 < B:
                yield b0, min(WARP, B - b0)


def grove_aggregate_tile_replay(prob_acc, contrib, live, hops, thresh,
                                p: dict):
    """The tile kernel in plain PyTorch: per warp of plan ``p``, the run of
    its rows added (contrib only where the lane is live, else ``+ 0.0``),
    each row's sums walked in column order for the first maximum and the
    largest other entry, and those two divided by ``max(hops, 1)``; every
    lane served once."""
    B, C = prob_acc.shape
    thresh = torch.as_tensor(thresh, dtype=torch.float32).expand(B)
    prob_out = torch.full_like(prob_acc, float("nan"))
    hops_out = torch.full_like(hops, -1)
    live_out = torch.zeros_like(live)
    margin = torch.full((B,), float("nan"))
    for b0, n in block_warps(p, B):
        rows = slice(b0, b0 + n)
        if (hops_out[rows] != -1).any():
            raise AssertionError(f"lanes {b0}.. served twice")
        lv = live[rows]
        q = torch.where(lv[:, None], contrib[rows], torch.zeros(()))
        tile = prob_acc[rows] + q
        prob_out[rows] = tile
        h = hops[rows] + lv.to(torch.int32)
        m1, m2 = tile[:, 0], torch.full((n,), float("-inf"))
        for c in range(1, C):
            v = tile[:, c]
            up = v > m1
            m2 = torch.where(up, m1, torch.where(v > m2, v, m2))
            m1 = torch.where(up, v, m1)
        d = torch.clamp(h, min=1).to(torch.float32)
        mg = (m1 / d - m2 / d).abs()
        hops_out[rows], margin[rows] = h, mg
        live_out[rows] = lv & (mg < thresh[rows])
    if (hops_out == -1).any():
        raise AssertionError("a lane was not served")
    return prob_out, hops_out, live_out, margin


def check_contrib(contrib: torch.Tensor) -> None:
    """The hop state accumulates in floating point: packed (integer)
    contributions must be dequantized first."""
    if not contrib.dtype.is_floating_point:
        raise ValueError(
            f"grove_aggregate accumulates in floating point; dequantize "
            f"packed contributions before the hop update (got "
            f"{contrib.dtype})")


def grove_aggregate_cuda(prob_acc: torch.Tensor, contrib: torch.Tensor,
                         live: torch.Tensor, hops: torch.Tensor, thresh, *,
                         block_b: int = 256):
    """Fused hop update on CUDA tensors (one kernel launch, on
    :func:`plan`'s route; ``block_b`` caps the lanes a block).

    prob_acc, contrib float32 [B, C]; live bool [B]; hops int32 [B];
    thresh a scalar or float32 [B] -> (prob, hops, live, margin).
    """
    return grove_aggregate_on_route(prob_acc, contrib, live, hops, thresh,
                                    block_b=block_b)


def grove_aggregate_on_route(prob_acc, contrib, live, hops, thresh, *,
                             block_b: int = 256, route: str | None = None,
                             lanes: int | None = None):
    """:func:`grove_aggregate_cuda` on a named route of :data:`ROUTES`
    (``None``: the plan's): ``"tile"`` (``lanes`` overrides the plan's
    lanes a block; raises for C above the tile's limit) or ``"lane"``, the
    first port's kernel with ``block_b`` lanes a block.  For measurements
    and checks that hold the routes side by side."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    _build.check_block(block_b)
    B, C = prob_acc.shape
    dev = prob_acc.device
    thresh = torch.as_tensor(thresh, dtype=torch.float32, device=dev)
    thresh = thresh.expand(B).contiguous()
    for name, t, dt, nd in (("prob_acc", prob_acc, torch.float32, 2),
                            ("contrib", contrib, torch.float32, 2),
                            ("live", live, torch.bool, 1),
                            ("hops", hops, torch.int32, 1)):
        _build.check_cuda(name, t, dt, nd)
    if contrib.shape != prob_acc.shape or live.shape != (B,) \
            or hops.shape != (B,):
        raise ValueError(f"shape mismatch: prob {tuple(prob_acc.shape)}, "
                         f"contrib {tuple(contrib.shape)}, live "
                         f"{tuple(live.shape)}, hops {tuple(hops.shape)}")
    p = plan(B, C, _build.sm_count(dev), block_b,
             smem_optin=_build.smem_optin(dev), lanes=lanes)
    if route == "tile" and p["route"] != "tile":
        raise ValueError(f"the tile route takes C <= "
                         f"{tile_max_classes(_build.smem_optin(dev))}, got "
                         f"C = {C}")
    prob_out = torch.empty_like(prob_acc)
    hops_out = torch.empty_like(hops)
    live_out = torch.empty_like(live)
    margin = torch.empty((B,), dtype=torch.float32, device=dev)
    if B and C:
        args = (prob_acc.data_ptr(), contrib.data_ptr(), live.data_ptr(),
                hops.data_ptr(), thresh.data_ptr(), prob_out.data_ptr(),
                hops_out.data_ptr(), live_out.data_ptr(), margin.data_ptr(),
                B, C)
        if (route or p["route"]) == "lane":
            _build.launch("grove_aggregate", dev, *args, block_b)
        else:
            vec = all(t.data_ptr() % 16 == 0
                      for t in (prob_acc, contrib, prob_out))
            _build.launch("grove_aggregate", dev, *args, p["lanes"],
                          int(vec), p["smem"], entry="grove_aggregate_tile")
    return prob_out, hops_out, live_out, margin
