"""The grove ring: the paper's Figure 3 mapping (port of
``repro.core.fog_ring``).

The ASIC pins grove g to a processing element and forwards uncertain
inputs over a req/ack handshake to the element holding grove g+1.  Here
groves are pinned to ring shards and each lane's whole queue entry -- its
input row, probability array, hop count, liveness, grove index, threshold
and hop budget -- moves one shard down the ring per hop.  A
:class:`RingMesh` names the shards and carries the handshake:

* ``RingMesh(n)``: n shards stacked on one device.  State is ``[n, b, ...]``
  and the handshake is ``torch.roll(·, 1, 0)``; one H100 runs the ring so.
* ``RingMesh(n, group)``: one shard per rank of a ``torch.distributed``
  process group (n == its size).  Rank r walks only its own groves' rows,
  sends its lanes to rank r+1 and receives rank r-1's with
  ``batch_isend_irecv``, and at the end every rank all-gathers proba and
  hops in batch order.

Grove placement is strided (``forest.pack._grove_order``): with n shards
and G groves shard s hosts {s, s+n, s+2n, ...}, so grove g+1 always lives
one shard down from grove g.  With one grove per shard a hop is one
``tree_traverse`` over every stacked shard; with several, each lane
gathers its own grove (plain PyTorch, as in the JAX package).  The hop
update is ``grove_aggregate`` -- its CUDA kernel with ``use_kernels``,
else the plain ``ref.grove_aggregate_ref`` -- so hops, labels and proba
equal Algorithm 2's reference loop from the same start groves.

The deprecated ``fog_ring_eval`` shim is not ported.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.grove import GroveCollection
from repro_torch.core.policy import NO_BUDGET
from repro_torch.forest.pack import ForestPack, _grove_order
from repro_torch.forest.tree import grove_traverse, mean_over_trees
from repro_torch.kernels import ops, ref

__all__ = ["RingMesh", "reorder_tables", "ring_eval"]

# the most lanes one block of the ring's tree_traverse launches serves
# (kernels/tree_traverse.py::lane_plan)
TRAVERSE_BLOCK_B = 128


class RingMesh:
    """The ring's ``n_shards`` shards: stacked on the caller's device
    (``group=None``) or one per rank of ``group``."""

    def __init__(self, n_shards: int, group=None):
        if n_shards < 1:
            raise ValueError(f"a ring needs at least one shard, got "
                             f"{n_shards}")
        if group is not None and dist.get_world_size(group) != n_shards:
            raise ValueError(
                f"a process-group ring has one shard per rank: the group "
                f"has {dist.get_world_size(group)} ranks, not {n_shards}")
        self.n_shards = n_shards
        self.group = group

    @property
    def local(self) -> slice:
        """The shards this process holds: all of them, or its rank's."""
        if self.group is None:
            return slice(0, self.n_shards)
        r = dist.get_rank(self.group)
        return slice(r, r + 1)

    def shift(self, state: tuple) -> tuple:
        """The handshake: every shard's ``[S, b, ...]`` queue entries move
        to the next shard, the last shard's to the first."""
        if self.group is None:
            return tuple(torch.roll(v, 1, 0) for v in state)
        if self.n_shards == 1:
            return state
        x, prob, hops, live, gidx, thresh, budget = (v[0] for v in state)
        # the whole entry in two buffers: the floats and the ints
        floats = torch.cat([x, prob, thresh[:, None]], 1)
        ints = torch.stack([hops, live.to(torch.int32),
                            gidx.to(torch.int32), budget], 1)
        r = dist.get_rank(self.group)
        nxt = dist.get_global_rank(self.group, (r + 1) % self.n_shards)
        prv = dist.get_global_rank(self.group, (r - 1) % self.n_shards)
        got_f, got_i = torch.empty_like(floats), torch.empty_like(ints)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, floats, nxt, self.group, tag=0),
            dist.P2POp(dist.isend, ints, nxt, self.group, tag=1),
            dist.P2POp(dist.irecv, got_f, prv, self.group, tag=0),
            dist.P2POp(dist.irecv, got_i, prv, self.group, tag=1)])
        for req in reqs:
            req.wait()
        F, C = x.shape[1], prob.shape[1]
        return tuple(v[None] for v in (
            got_f[:, :F], got_f[:, F:F + C], got_i[:, 0], got_i[:, 1] != 0,
            got_i[:, 2].to(gidx.dtype), got_f[:, F + C], got_i[:, 3]))

    def gather(self, *tensors: torch.Tensor) -> tuple:
        """Each ``[S, b, ...]`` tensor as every shard's rows ``[n, b, ...]``
        in shard order, on every process."""
        if self.group is None:
            return tensors
        out = []
        for v in tensors:
            parts = [torch.empty_like(v) for _ in range(self.n_shards)]
            dist.all_gather(parts, v.contiguous(), group=self.group)
            out.append(torch.cat(parts))
        return tuple(out)


def reorder_tables(gc: GroveCollection, n_shards: int):
    """Strided-reordered fp32 (feature, threshold, leaf) for the ring.  A
    pack gives the same reorder, scales included, at any precision, from
    ``ForestPack.layout("ring", n_shards)``."""
    order = torch.as_tensor(_grove_order(gc.n_groves, n_shards),
                            device=gc.feature.device)
    return gc.feature[order], gc.threshold[order], gc.leaf[order]


def _normalize_tables(tables):
    """Accept the fp32 3-tuple or a packed 5-tuple with per-tree scales;
    return the 5-tuple form."""
    if len(tables) == 5:
        return tuple(tables)
    feature, threshold, leaf = tables
    G, k = feature.shape[:2]
    return (feature, threshold, leaf,
            torch.ones((G, k, 1), dtype=torch.float32,
                       device=feature.device),
            torch.ones((G, k, 1, 1), dtype=torch.float32,
                       device=feature.device))


def _eval_block_grove(feature, threshold, leaf, thr_scale, leaf_scale, x,
                      use_kernels: bool):
    """One grove per shard: every stacked shard's lanes walk its grove,
    ``[S, t, ...]`` tables x ``[S, b, F]`` -> ``[S, b, C]``.
    ``use_kernels`` runs the tree_traverse kernel (its plain version on the
    CPU); otherwise the plain version runs on any device."""
    if use_kernels:
        return ops.tree_traverse(feature, threshold, leaf, x, thr_scale,
                                 leaf_scale, block_b=TRAVERSE_BLOCK_B)
    return ref.tree_traverse_ref(feature, threshold, leaf, x, thr_scale,
                                 leaf_scale)


def _eval_gather_grove(feature, threshold, leaf, x, local_idx):
    """Several groves per shard: each lane gathers its own grove.

    Dequantized tables ``[S, m, t, ...]``, ``x [S, b, F]``, ``local_idx
    [S, b]`` (the lane's grove among its shard's m) -> ``[S, b, C]``."""
    S, m = feature.shape[:2]
    b = x.shape[1]
    grove = (torch.arange(S, device=x.device)[:, None] * m
             + local_idx).reshape(-1)
    flat = [a.reshape(S * m, *a.shape[2:]) for a in (feature, threshold,
                                                      leaf)]
    out = mean_over_trees(grove_traverse(*flat, x.reshape(S * b, -1),
                                         grove))
    return out.reshape(S, b, -1)


def ring_eval(pack_or_gc, x: torch.Tensor, start, thresh, max_hops: int,
              mesh: RingMesh, *, use_kernels: bool = False, tables=None,
              hop_budget=None):
    """Run the ring with explicit per-lane start groves.

    ``pack_or_gc`` is a single-output :class:`ForestPack` or a
    :class:`GroveCollection`.  ``start`` must hold exactly B/n lanes per
    residue class ``start % n`` (``engine.sample_starts(..., n_shards=n)``
    draws such starts).  Lanes are stably sorted onto their start grove's
    shard, walked, rotated back and returned in batch order: ``(proba
    [B, C], hops [B])``.  ``thresh`` and ``hop_budget`` are scalars or
    per-lane ``[B]`` vectors; ``tables`` is an optional ring layout, the
    fp32 3-tuple of :func:`reorder_tables` or the packed 5-tuple of
    ``ForestPack.layout("ring", n)``.  With a process group, every rank
    passes the same arguments and gets the whole result.
    """
    B = x.shape[0]
    G = pack_or_gc.n_groves
    n = mesh.n_shards
    dev = x.device
    if B % n:
        raise ValueError(f"batch B={B} must divide over {n} ring shards")
    if G % n:
        raise ValueError(f"n_groves={G} does not divide over {n} ring "
                         "shards")
    if not isinstance(start, torch.Tensor):
        start = torch.tensor(np.asarray(start))   # a copy: may be read-only
    start = start.to(device=dev, dtype=torch.long)
    host = start.cpu()
    if tuple(host.shape) != (B,) or bool(((host < 0) | (host >= G)).any()):
        raise ValueError(f"start must hold B={B} grove indices in [0, {G})")
    # each shard's queue must be exactly B/n lanes, or a lane would walk
    # another shard's groves
    counts = torch.bincount(host % n, minlength=n)
    if not bool((counts == B // n).all()):
        raise ValueError(
            f"start groves not stratified over {n} shards (per-shard lane "
            f"counts {counts.tolist()}); draw them with "
            f"engine.sample_starts(generator, B, G, n_shards={n})")
    if tables is None:
        tables = (pack_or_gc.layout("ring", n)
                  if isinstance(pack_or_gc, ForestPack)
                  else reorder_tables(pack_or_gc, n))
    m, b = G // n, B // n
    loc = mesh.local
    # the shards this process holds: tables [S, m, ...], lanes [S, b, ...]
    feature, threshold, leaf, thr_scale, leaf_scale = (
        a.reshape(n, m, *a.shape[1:])[loc].to(dev)
        for a in _normalize_tables(tables))
    thresh = torch.as_tensor(thresh, dtype=torch.float32,
                             device=dev).expand(B)
    budget = torch.as_tensor(NO_BUDGET if hop_budget is None else hop_budget,
                             dtype=torch.int32, device=dev).expand(B)
    perm = torch.argsort(start % n, stable=True)
    inv = torch.argsort(perm)
    xs, gidx, th, bud = (v[perm].reshape(n, b, *v.shape[1:])[loc]
                         .contiguous() for v in (x, start, thresh, budget))
    S, C = xs.shape[0], leaf.shape[-1]
    if m > 1:
        threshold, leaf = ref.dequantize_tables(threshold, leaf, thr_scale,
                                                leaf_scale)
    update = ops.grove_aggregate if use_kernels else ref.grove_aggregate_ref
    prob = torch.zeros((S, b, C), dtype=torch.float32, device=dev)
    hops = torch.zeros((S, b), dtype=torch.int32, device=dev)
    live = torch.ones((S, b), dtype=torch.bool, device=dev)
    for _ in range(max_hops):
        if m == 1:
            contrib = _eval_block_grove(feature[:, 0], threshold[:, 0],
                                        leaf[:, 0], thr_scale[:, 0],
                                        leaf_scale[:, 0], xs, use_kernels)
        else:
            contrib = _eval_gather_grove(feature, threshold, leaf, xs,
                                         gidx // n)
        prob, hops, live, _ = update(
            prob.reshape(S * b, C), contrib.reshape(S * b, C),
            live.reshape(-1), hops.reshape(-1), th.reshape(-1))
        prob, hops = prob.reshape(S, b, C), hops.reshape(S, b)
        live = live.reshape(S, b) & (hops < bud)     # per-lane energy cap
        gidx = (gidx + 1) % G
        xs, prob, hops, live, gidx, th, bud = mesh.shift(
            (xs, prob, hops, live, gidx, th, bud))
    # after max_hops rotations a lane's state sits max_hops shards down
    # from where it entered: rotate it back (the identity when n divides
    # max_hops) so the rows line up with the sorted batch
    prob, hops = (torch.roll(v, -max_hops, 0)
                  for v in mesh.gather(prob, hops))
    proba = prob / torch.clamp(hops, min=1)[..., None].to(torch.float32)
    return proba.reshape(B, C)[inv], hops.reshape(B)[inv]
