"""The whole Algorithm-2 loop in one launch, on the card.

Replaces ``repro/kernels/fused_fog.py::_fused_fog_kernel`` (Pallas TPU).
A hop walks grove ``(start + j) % G`` of every head: per tree, ``d``
levels of ``idx = 2*idx + 1 + (x[f] > thr)``, then the leaf row at
``idx - (L-1)``.  Values are dequantized after the gather (int8: the codes
±127 are ±inf thresholds, otherwise ``q * scale``; bf16: exact upcast).
Leaf rows are summed over trees in order and divided by ``t``, accumulated,
divided by ``max(hops, 1)``, and gated on the first-max MaxDiff (minimum
over heads) against the lane's threshold and hop budget.

What bounds it is each lane's chain, not bytes (the bench field is 192
KiB).  :func:`route` picks one of three CUDA routes by the shapes alone, a
stated rule, never by a failure (``_build.routes`` counts each):

* ``"smem"`` and ``"l1"``, the group kernel
  (``csrc/fog_kernels.cu::fused_fog_group_kernel``): a group of
  :func:`group_size` threads serves a lane.  A lane's grove sequence does
  not depend on the gate, so the group walks the trees of the next
  :func:`walk_hops` hops at once, then gates hop by hop in order over the
  leaf rows it found; the ``[O, C]`` accumulators live in registers, split
  by class over the group (``O * ceil(C / group) <= FUSED_ACC``), and each
  head's MaxDiff is merged over the group by shuffles.  ``"smem"`` stages
  the whole field in shared memory once per block by the bulk-copy engine,
  with a grid of at most the blocks the SMs hold at once looping over the
  lanes; ``"l1"`` reads the tables in place through L1, one lane a group.
  ``"smem"`` only where the field fits one block, no group loops and the
  copies move at most :data:`SMEM_COPY_BYTES` in all (:func:`route`):
  each block waits for its copy before it walks, while L1 keeps the few
  hundred nodes a block visits.
* ``"lane"``, the first port's kernel (``fused_fog_kernel``): one thread
  per lane walks the hops' trees in turn, the lane state in a scratch
  buffer the wrapper allocates.  It takes what the group kernel does not
  (lane state over its registers: ``O * ceil(C / 32) > FUSED_ACC``).

``block_b`` is the most CUDA threads a block runs: the lane route runs
exactly ``block_b`` (one lane each); the group routes run at most
``GROUP_THREADS`` (512), and fewer where that spreads the batch over more
SMs (:func:`plan`).  Every route counts as one launch of ``fused_fog``;
:func:`fused_fog_on_route` runs a named route, for the measurements and
checks that hold the routes side by side.

:func:`fused_fog_ref` is the plain version: the same loop in PyTorch.
:func:`fused_fog_group_replay` replays the group kernel's decomposition
(the batch of walks, the gate in hop order, the class split and the
shuffle merge) in PyTorch, for the tests.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.forest.tree import grove_traverse, mean_over_trees
from repro_torch.kernels import _build
from repro_torch.kernels.ref import dequantize_tables, top2_confidence_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

ROUTES = ("smem", "l1", "lane")
# lane-state registers a thread of the group kernel holds
# (csrc/fog_kernels.cu::FUSED_ACC): O * ceil(C / group) of them
FUSED_ACC = 8
MAX_GROUP = 32
# the "smem" route's copies may move at most this many bytes from L2 in
# all (the staged field times the blocks); more, and waiting for them costs
# more than the L1 route's walks lose.  Measured on the bench field only
# (chip_smoke.py's BOUNDARY_GRID, H100): "smem" faster at copies of 3.9,
# 6.8 and 7.7 MB, "l1" faster or within 3 % from 12.6 MB up; where in
# between the line lies, and whether other fields draw it elsewhere, is
# not measured
SMEM_COPY_BYTES = 8 * 2**20
# threads one SM holds at once
SM_THREADS = 2048
# a block stages its groups' x rows in shared memory up to this many bytes,
# else each level gathers x[f] through L1 (F = 784 at 64 groups is 200 KB)
X_STAGE_BYTES = 16 * 1024
# shared memory of one H100 SM, and what the card reserves per block
SM_SMEM_BYTES = 233_472
BLOCK_RESERVED_SMEM = 1024
# the most threads a block of the group kernel runs (its launch bound,
# csrc/fog_kernels.cu::GROUP_THREADS: up to 128 registers a thread, so no
# instance spills); a block of them fills an SM's 65,536 registers
GROUP_THREADS = 512
# the most threads a block runs when nothing chooses (the analytic seed of
# kernels/autotune.py: the group routes run fewer where that spreads the
# batch over more SMs)
FUSED_BLOCK_B = 128


def walk_hops(B: int, max_hops: int, O: int, t: int, C: int,
              n_sm: int) -> int:
    """K, the hops whose trees a lane's group walks at once: ``max_hops``
    while the batch's groups fit the card in one wave of threads (``B x
    group <= n_sm x SM_THREADS``: every lane's chain is then one tree's
    walk), else halved until they fit (at least 1) -- past one wave the
    card is busy, and a lane that exits after hop j wastes the batch's
    later walks (the bench field's mean of 1.21 hops walks ~6.6x the trees
    the gate reads at K = 8).  At the bench field on 132 SMs: K = 8 up to
    B = 16,384, K = 2 at 65,536 (``chip_smoke.py --sweep``: the fastest K
    at B = 1000, 4096 and 65,536, within 4 % of it at 16,384)."""
    K = max_hops
    while K > 1 and B * (group_size(O, t, C, K) or MAX_GROUP) > (
            n_sm * SM_THREADS):
        K = -(-K // 2)
    return K


def group_size(O: int, t: int, C: int, K: int) -> int | None:
    """Threads per lane of the group kernel: the power of two that covers
    the ``K * O * t`` walks of a batch (at most 32), raised until each
    thread's share of the ``[O, C]`` lane state fits ``FUSED_ACC``
    registers; ``None`` when even 32 threads cannot hold it."""
    g = 1
    while g < min(K * O * t, MAX_GROUP):
        g *= 2
    while g <= MAX_GROUP and O * -(-C // g) > FUSED_ACC:
        g *= 2
    return g if g <= MAX_GROUP else None


def region_bytes(n: int) -> int:
    """Shared memory one staged table of ``n`` bytes takes
    (``csrc/fog_stage.cuh::region_bytes``: its start may shift by the
    source's address mod 16)."""
    return (n + 31) // 16 * 16


def table_smem_bytes(O: int, G: int, t: int, depth: int, C: int,
                     itemsize: int) -> int:
    """Shared memory of the whole field staged by the "smem" route: int32
    features, thresholds and leaves at ``itemsize``, two fp32 scales per
    tree, each table in its own region."""
    trees, N = O * G * t, 2**depth - 1
    return (region_bytes(trees * N * 4) + region_bytes(trees * N * itemsize)
            + region_bytes(trees * (N + 1) * C * itemsize)
            + 2 * region_bytes(trees * 4))


def _groups(B: int, O: int, t: int, C: int, F: int, max_hops: int,
            block_b: int, n_sm: int, K: int | None = None) -> dict | None:
    """The group kernel's block shape: ``K`` (by default
    :func:`walk_hops`), ``group`` threads a lane, as many threads as spread
    the batch over every SM (at most ``block_b``), the per-group shared
    memory (leaf rows, and the x row when it fits)."""
    if K is None:
        K = walk_hops(B, max_hops, O, t, C, n_sm)
    group = group_size(O, t, C, K)
    if group is None:
        return None
    per_sm = -(-B // n_sm)                       # lanes per SM
    threads = min(block_b, GROUP_THREADS,
                  max(32, -(-per_sm * group // 32) * 32))
    gpb = threads // group
    stage_x = gpb * F * 4 <= X_STAGE_BYTES
    lane_bytes = gpb * K * O * t * 4 + (gpb * F * 4 if stage_x else 0)
    return {"K": K, "group": group, "threads": threads,
            "groups_per_block": gpb, "stage_x": stage_x,
            "lane_bytes": lane_bytes}


def route(B: int, O: int, G: int, t: int, depth: int, C: int, F: int,
          itemsize: int, max_hops: int, block_b: int, n_sm: int,
          smem_optin: int) -> str:
    """The route a CUDA call takes: ``"lane"`` when the group kernel
    cannot hold the lane state; ``"smem"`` when (1) the field and the
    groups' rows fit one block's shared memory, (2) the "smem" grid gives
    every lane its own group (no group loops) and (3) its copies move at
    most ``SMEM_COPY_BYTES`` from L2 in all; else ``"l1"``.  At the bench
    field (fp32 196,608 B, bf16 106,528 B, int8 61,488 B: each fits) on
    132 SMs with the engine's 128 threads: ``"smem"`` for int8 at B = 1000
    (125 copies, 7.7 MB), ``"l1"`` for fp32 and bf16 there (24.6 and 13.3
    MB) and for all three at 65,536; at B = 128 (64 copies) ``"smem"`` for
    int8 and bf16 (3.9 and 6.8 MB), ``"l1"`` for fp32 (12.6 MB); two fp32
    heads (393 KB) ``"l1"``.  ``chip_smoke.py`` times both routes at
    B = 128, 1000 and 2000 at every precision in every run
    (``BOUNDARY_GRID``); on an H100 the rule's pick was the faster, or
    within 3 %, at all nine."""
    shape = _groups(B, O, t, C, F, max_hops, block_b, n_sm)
    if shape is None:
        return "lane"
    p = plan("smem", B, O, G, t, depth, C, F, itemsize, max_hops, block_b,
             n_sm)
    copies = p["grid"] * table_smem_bytes(O, G, t, depth, C, itemsize)
    if (p["smem"] <= smem_optin
            and p["grid"] * p["groups_per_block"] >= B
            and copies <= SMEM_COPY_BYTES):
        return "smem"
    return "l1"


def plan(route_name: str, B: int, O: int, G: int, t: int, depth: int,
         C: int, F: int, itemsize: int, max_hops: int, block_b: int,
         n_sm: int, K: int | None = None) -> dict:
    """The launch of ``route_name``: threads, grid and dynamic shared
    memory (and, for the group kernel, K -- by default :func:`walk_hops`
    -- the group size and whether x is staged).  The "smem" grid is at
    most the blocks the SMs hold at once (by registers and shared memory);
    its blocks loop over the lanes."""
    if route_name == "lane":
        return {"route": "lane", "threads": block_b,
                "grid": -(-B // block_b), "smem": 0}
    shape = _groups(B, O, t, C, F, max_hops, block_b, n_sm, K)
    if shape is None:
        raise ValueError(f"the group kernel cannot hold the lane state of "
                         f"{O} head(s) x {C} classes")
    smem = 16 + shape["lane_bytes"]
    grid = -(-B // shape["groups_per_block"])
    if route_name == "smem":
        smem += table_smem_bytes(O, G, t, depth, C, itemsize)
        # the blocks an SM holds at once, by registers and shared memory
        per_sm = max(1, min(GROUP_THREADS // shape["threads"],
                            SM_SMEM_BYTES // (smem + BLOCK_RESERVED_SMEM)))
        grid = min(grid, n_sm * per_sm)
    elif route_name != "l1":
        raise ValueError(f"route must be one of {ROUTES}, got {route_name!r}")
    return {"route": route_name, "grid": grid, "smem": smem, **shape}


def _scales(feature, thr_scale, leaf_scale):
    O, G, t, _ = feature.shape
    if thr_scale is None:
        thr_scale = torch.ones((O, G, t, 1), dtype=torch.float32,
                               device=feature.device)
    if leaf_scale is None:
        leaf_scale = torch.ones((O, G, t, 1, 1), dtype=torch.float32,
                                device=feature.device)
    return thr_scale, leaf_scale


def fused_fog_ref(feature, threshold, leaf, x, start, thresh, budget,
                  thr_scale=None, leaf_scale=None, *, max_hops: int,
                  block_b: int = 128):
    """Plain PyTorch Algorithm 2 over head-stacked packed tables.

    Same arguments and results as :func:`fused_fog_cuda`; ``block_b`` has
    no effect here.  Every lane is walked each hop and dead lanes are
    masked; the loop stops once no lane is live.
    """
    thr_scale, leaf_scale = _scales(feature, thr_scale, leaf_scale)
    thr, lf = dequantize_tables(threshold, leaf, thr_scale, leaf_scale)
    B = x.shape[0]
    O, G = feature.shape[:2]
    C = leaf.shape[4]
    prob = torch.zeros((O, B, C), dtype=torch.float32, device=x.device)
    live = torch.ones((B,), dtype=torch.bool, device=x.device)
    hops = torch.zeros((B,), dtype=torch.int32, device=x.device)
    start = start.to(torch.long)
    for j in range(max_hops):
        if not bool(live.any()):
            break
        g = (start + j) % G
        for o in range(O):
            contrib = mean_over_trees(
                grove_traverse(feature[o], thr[o], lf[o], x, g))
            prob[o] = prob[o] + torch.where(live[:, None], contrib,
                                            torch.zeros_like(contrib))
        hops = hops + live.to(torch.int32)
        denom = torch.clamp(hops, min=1).to(torch.float32)
        margin = top2_confidence_ref(
            (prob / denom[None, :, None]).reshape(O * B, C))
        margin = margin.reshape(O, B).amin(dim=0)   # min over heads
        live = live & (margin < thresh) & (hops < budget)
    denom = torch.clamp(hops, min=1).to(torch.float32)
    proba = (prob / denom[None, :, None]).permute(1, 0, 2).contiguous()
    return proba, hops


@functools.lru_cache(maxsize=1024)
def _launch_plan(route_name: str | None, B: int, O: int, G: int, t: int,
                 depth: int, C: int, F: int, itemsize: int, max_hops: int,
                 block_b: int, n_sm: int, smem_optin: int,
                 K: int | None) -> dict:
    """:func:`plan` of ``route_name`` (``None``: the route :func:`route`
    picks), once per call shape: the rules cost ~25 us of Python a call on
    a path the host bounds."""
    if route_name is None:
        route_name = route(B, O, G, t, depth, C, F, itemsize, max_hops,
                           block_b, n_sm, smem_optin)
    return plan(route_name, B, O, G, t, depth, C, F, itemsize, max_hops,
                block_b, n_sm, K)


def _top2_partials(v: torch.Tensor, group: int) -> list:
    """Each group thread's (max, first index of it, largest other) over
    its classes ``c = r, r + group, ...`` of ``v [B, C]``; a thread with no
    class holds (-inf, -inf, C)."""
    B, C = v.shape
    out = []
    for r in range(group):
        if r >= C:
            ninf = torch.full((B,), float("-inf"), device=v.device)
            out.append((ninf, torch.full((B,), C, device=v.device), ninf))
            continue
        cols = torch.arange(r, C, group, device=v.device)
        sub = v[:, cols]
        pos = torch.argmax(sub, dim=1)          # the first maximum
        m1 = sub.gather(1, pos[:, None])[:, 0]
        rest = sub.scatter(1, pos[:, None], float("-inf"))
        out.append((m1, cols[pos], rest.amax(dim=1)))
    return out


def _top2_merge(a: tuple, b: tuple) -> tuple:
    """csrc/fog_kernels.cu::top2_merge: the larger maximum (the lower index
    on a tie), and the larger of its second and the other's maximum."""
    a_wins = (a[0] > b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))
    w = tuple(torch.where(a_wins, x, y) for x, y in zip(a, b))
    other = torch.where(a_wins, b[0], a[0])
    return w[0], w[1], torch.maximum(w[2], other)


def group_margin(v: torch.Tensor, group: int) -> torch.Tensor:
    """MaxDiff of ``v [B, C]`` as the group kernel takes it: per-thread
    partials, then the xor-shuffle butterfly; thread 0's result."""
    parts = _top2_partials(v, group)
    off = group // 2
    while off:
        parts = [_top2_merge(parts[r], parts[r ^ off]) for r in range(group)]
        off //= 2
    m1, _, m2 = parts[0]
    return (m1 - m2).abs()


def fused_fog_group_replay(feature, threshold, leaf, x, start, thresh,
                           budget, thr_scale=None, leaf_scale=None, *,
                           max_hops: int, hops_per_walk: int, group: int):
    """The group kernel's decomposition in plain PyTorch: every lane's
    trees for the next ``hops_per_walk`` hops walked as one batch, then
    the gate hop by hop in order over those leaf rows, each head's MaxDiff
    merged as ``group`` threads merge it (:func:`group_margin`).  Same
    arguments and results as :func:`fused_fog_ref`."""
    thr_scale, leaf_scale = _scales(feature, thr_scale, leaf_scale)
    thr, lf = dequantize_tables(threshold, leaf, thr_scale, leaf_scale)
    B = x.shape[0]
    O, G, t = feature.shape[:3]
    C = leaf.shape[4]
    acc = torch.zeros((O, B, C), dtype=torch.float32, device=x.device)
    live = torch.ones((B,), dtype=torch.bool, device=x.device)
    hops = torch.zeros((B,), dtype=torch.int32, device=x.device)
    start = start.to(torch.long)
    tf = torch.tensor(float(t), device=x.device)
    for j0 in range(0, max_hops, hops_per_walk):
        if not bool(live.any()):
            break
        nk = min(hops_per_walk, max_hops - j0)
        # the batch: every lane's hops j0 .. j0+nk-1, every head and tree
        g = (start[:, None] + j0 + torch.arange(nk, device=x.device)) % G
        xr = x.repeat_interleave(nk, dim=0)
        rows = [grove_traverse(feature[o], thr[o], lf[o], xr, g.reshape(-1))
                .reshape(B, nk, t, C) for o in range(O)]
        for jj in range(nk):
            hops = hops + live.to(torch.int32)
            denom = torch.clamp(hops, min=1).to(torch.float32)[:, None]
            margin = torch.full((B,), float("inf"), device=x.device)
            for o in range(O):
                con = rows[o][:, jj, 0]
                for tr in range(1, t):              # trees in order
                    con = con + rows[o][:, jj, tr]
                acc[o] = torch.where(live[:, None], acc[o] + con / tf,
                                     acc[o])
                margin = torch.minimum(margin,
                                       group_margin(acc[o] / denom, group))
            live = live & (margin < thresh) & (hops < budget)
    denom = torch.clamp(hops, min=1).to(torch.float32)
    proba = (acc / denom[None, :, None]).permute(1, 0, 2).contiguous()
    return proba, hops


def fused_fog_cuda(feature, threshold, leaf, x, start, thresh, budget,
                   thr_scale=None, leaf_scale=None, *, max_hops: int,
                   block_b: int = 128):
    """One-launch Algorithm 2 over head-stacked packed CUDA tables, on the
    route :func:`route` picks.

    feature    int32           [O, G, t, 2**d - 1]
    threshold  fp32|bf16|int8  [O, G, t, 2**d - 1]
    leaf       same dtype      [O, G, t, 2**d, C]
    thr_scale  float32         [O, G, t, 1]      (default ones)
    leaf_scale float32         [O, G, t, 1, 1]   (default ones)
    x float32 [B, F]; start int32 [B] in [0, G); thresh float32 [B];
    budget int32 [B].  Feature indices must be < F.
    returns    (proba float32 [B, O, C], hops int32 [B])
    """
    return fused_fog_on_route(feature, threshold, leaf, x, start, thresh,
                              budget, thr_scale, leaf_scale,
                              max_hops=max_hops, block_b=block_b)


def fused_fog_on_route(feature, threshold, leaf, x, start, thresh, budget,
                       thr_scale=None, leaf_scale=None, *, max_hops: int,
                       block_b: int = 128, route: str | None = None,
                       hops_per_walk: int | None = None):
    """:func:`fused_fog_cuda` on a named route of :data:`ROUTES` (``None``:
    the rule's), the group routes walking ``hops_per_walk`` hops at once
    (``None``: :func:`walk_hops`).  For measurements and checks that hold
    the routes side by side; a route the shapes do not fit raises."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    _build.check_block(block_b)
    thr_scale, leaf_scale = _scales(feature, thr_scale, leaf_scale)
    if threshold.dtype not in _DTYPE_CODE or leaf.dtype != threshold.dtype:
        raise TypeError(f"tables must be fp32, bf16 or int8 with one dtype, "
                        f"got threshold {threshold.dtype}, leaf {leaf.dtype}")
    for name, t, dt, nd in (
            ("feature", feature, torch.int32, 4),
            ("threshold", threshold, threshold.dtype, 4),
            ("leaf", leaf, threshold.dtype, 5),
            ("thr_scale", thr_scale, torch.float32, 4),
            ("leaf_scale", leaf_scale, torch.float32, 5),
            ("x", x, torch.float32, 2), ("start", start, torch.int32, 1),
            ("thresh", thresh, torch.float32, 1),
            ("budget", budget, torch.int32, 1)):
        _build.check_cuda(name, t, dt, nd)
    B, F = x.shape
    O, G, t, N = feature.shape
    L, C = leaf.shape[3], leaf.shape[4]
    depth = int(np.log2(L) + 0.5)
    if (N != L - 1 or L != 2**depth or threshold.shape != feature.shape
            or leaf.shape[:3] != feature.shape[:3]
            or any(v.shape != (B,) for v in (start, thresh, budget))):
        raise ValueError(
            f"inconsistent shapes: feature {tuple(feature.shape)}, threshold "
            f"{tuple(threshold.shape)}, leaf {tuple(leaf.shape)}, x "
            f"{tuple(x.shape)}, start/thresh/budget {tuple(start.shape)}/"
            f"{tuple(thresh.shape)}/{tuple(budget.shape)}")
    proba = torch.empty((B, O, C), dtype=torch.float32, device=x.device)
    hops = torch.empty((B,), dtype=torch.int32, device=x.device)
    if not B:
        return proba, hops
    optin = _build.smem_optin(x.device)
    p = _launch_plan(route, B, O, G, t, depth, C, F,
                     threshold.element_size(), max_hops, block_b,
                     _build.sm_count(x.device), optin, hops_per_walk)
    name = p["route"]
    if name == "smem" and p["smem"] > optin:
        raise ValueError(f"the field needs {p['smem']} B of shared memory on "
                         f"the \"smem\" route; the device allows {optin}")
    tables = (_DTYPE_CODE[threshold.dtype], feature.data_ptr(),
              threshold.data_ptr(), leaf.data_ptr(), thr_scale.data_ptr(),
              leaf_scale.data_ptr(), x.data_ptr(), start.data_ptr(),
              thresh.data_ptr(), budget.data_ptr(), proba.data_ptr(),
              hops.data_ptr())
    if name == "lane":
        # per-lane [O, C] accumulators plus one [C] grove contribution
        scratch = torch.empty(((O + 1) * C * B,), dtype=torch.float32,
                              device=x.device)
        _build.launch("fused_fog", x.device, *tables, scratch.data_ptr(), B,
                      F, O, G, t, depth, C, max_hops, block_b)
    else:
        _build.launch("fused_fog", x.device, *tables, B, F, O, G, t, depth,
                      C, max_hops, p["K"], p["group"], p["grid"],
                      p["threads"], int(p["stage_x"]), p["smem"],
                      entry=f"fused_fog_{name}")
    return proba, hops
