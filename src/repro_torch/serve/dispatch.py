"""Data-parallel serving plane: replicate the model, shard the batch (port
of ``repro.serve.dispatch``).

The ring backend shards *groves* across a mesh; this module shards the
*batch*.  A :class:`DeviceDispatcher` owns N replicas of one decode path,
each bound to its own ``(torch.device, CUDA stream)`` pair and to a fixed
contiguous span of the batcher's slots (slot ``i`` lives on replica
``i // span`` forever, so per-replica state — packed tables, KV caches,
feature buffers — never migrates).  The device list may repeat a device:
``[cuda:0] * 4`` is four replicas on one card, each on its own stream
(``[cpu] * 2`` in the CPU tests, where there are no streams).

Dispatch is asynchronous: each step the
:class:`~repro_torch.serve.scheduler.ContinuousBatcher` calls
:meth:`DeviceDispatcher.dispatch` once per bucket; the dispatcher calls
each intersecting replica under its stream (every allocation and launch of
a replica is ordered on that stream), copies the replica's ``[span]``
outputs into pinned host buffers with ``non_blocking=True``, records one
CUDA event per call, and returns WITHOUT blocking.  :meth:`harvest`
synchronizes the events of everything in flight — the one host sync of a
step — then scatters the per-span outputs back into full ``[n_slots]``
arrays.  A bucket that touches a span dispatches the FULL span (the
per-lane threshold/budget vectors carry the group's lanes) and only the
group's lanes are harvested from it.

Memory across streams: a replica's resident buffers are allocated under
its own stream and used only there.  Packed tables a dispatch reads are
held by its :class:`Pending` until harvest has synchronized it, so a
:class:`~repro_torch.registry.PackCache` eviction cannot hand their memory
to another stream while a launch still reads it.  Pinned staging buffers
come from PyTorch's pinned-memory allocator, which reuses a block only
after the copies recorded on it have finished.

:class:`ForestReplicaServer` is the factory for the paper's workload:
forest classification serving, one pending feature row per slot, a
ForestPack replica (per precision) per replica.  Its packed protocol
(:meth:`ForestReplicaServer.packed_factory`) keeps the slot state on the
device and launches ``fused_fog`` once per (replica, bucket) dispatch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.policy import NO_BUDGET, FogPolicy, LanePolicies
from repro_torch.serve.scheduler import _host, _takes_bucket


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def replicate(tree, devices: Sequence) -> list:
    """One copy of ``tree`` per device (model replication for the
    data-parallel plane): a tensor, a module, a
    :class:`~repro_torch.forest.pack.ForestPack`, or dicts / lists /
    tuples of them."""
    return [_to(tree, torch.device(d)) for d in devices]


def _stream_of(device: torch.device):
    """A new CUDA stream on ``device`` (None off the card)."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def _on(stream):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _on_card(a) -> bool:
    return isinstance(a, torch.Tensor) and a.device.type == "cuda"


def _stage(outputs: tuple):
    """Start copying a replica's CUDA outputs into pinned host buffers on
    the current stream (``non_blocking``) and record one event after the
    copies.  Returns (host-side outputs, event or None); host and CPU
    values pass through."""
    if not any(_on_card(a) for a in outputs):
        return outputs, None
    out = tuple(torch.empty(a.shape, dtype=a.dtype, pin_memory=True).copy_(
        a, non_blocking=True) if _on_card(a) else a for a in outputs)
    event = torch.cuda.Event()
    event.record()
    return out, event


@dataclasses.dataclass
class Pending:
    """One in-flight decode call on one replica."""

    device: int                  # dispatcher replica index
    precision: str | None        # the precision group this call serves
    lanes: np.ndarray            # global lane indices to harvest from it
    local: np.ndarray            # those lanes' offsets inside the span
    logits: object               # [span, C] (pinned host once staged)
    hops: object                 # [span] | None
    dispatched_at: float = 0.0
    # the (model, version) registry bucket this call serves (None = the
    # single built-in model)
    bucket: tuple | None = None
    # packed-protocol outputs: argmax labels and per-lane modeled pJ
    # computed in the dispatch, so harvest never downloads [span, C]
    # probabilities or re-prices hops on the host
    nxt: object | None = None    # [span] int32
    energy: object | None = None  # [span] float32
    # the CUDA event recorded after the outputs' copies (None off the card)
    event: object | None = None
    # the packed tables the launch reads, held until harvest
    pack: object | None = None
    # the packed dispatch's drawn starts and knobs resolved against the
    # step's defaults, (start, thresh, budget) [span]: ServedSpan's own
    # device tensors, held until harvest
    inputs: tuple | None = None


class DeviceDispatcher:
    """Fan one continuous batch out over per-replica decode paths.

    decode_factory(index, device, span) -> decode_fn(tokens [span],
        lengths [span], policy with [span] lane vectors) -> (logits, hops)
        The factory builds ONE replica: it places that replica's state on
        ``device`` (it runs under the replica's stream) and must return
        without blocking on results.  ``tokens``/``lengths`` arrive as
        numpy slices.
    devices: the replicas' devices (default: every CUDA device, which
        raises without a card); a device may repeat — each replica gets its
        own CUDA stream.

    The dispatcher is bound to a slot count by the batcher
    (:meth:`bind`); ``n_slots`` must divide evenly over the replicas.
    """

    def __init__(self, decode_factory: Callable,
                 devices: Sequence | None = None):
        if devices is None:
            from repro_torch.launch.mesh import serve_devices
            devices = serve_devices()
        if not devices:
            raise ValueError("DeviceDispatcher needs at least one device")
        self.devices = [torch.device(d) for d in devices]
        for d in self.devices:
            if d.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"replica device {d}: no CUDA device is "
                                   "available; pass CPU devices to run the "
                                   "plain path")
        self.decode_factory = decode_factory
        self.span: int | None = None
        self._fns: list[Callable] | None = None
        self.streams = [_stream_of(d) for d in self.devices]
        # per-replica dispatch queues, drained at harvest time
        self._queues: list[list[Pending]] = [[] for _ in self.devices]
        # replica calls made so far (one per Pending)
        self.n_dispatches = 0

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def bind(self, n_slots: int) -> None:
        """Partition ``n_slots`` into per-replica spans and build the
        replicas, each under its own stream (idempotent for the same slot
        count)."""
        if self.span is not None:
            if self.span * self.n_devices != n_slots:
                raise ValueError(
                    f"dispatcher already bound to "
                    f"{self.span * self.n_devices} slots, cannot rebind "
                    f"to {n_slots}")
            return
        if n_slots % self.n_devices:
            raise ValueError(
                f"n_slots={n_slots} must divide evenly over "
                f"{self.n_devices} devices (fixed per-device spans)")
        self.span = n_slots // self.n_devices
        fns = []
        for i, d in enumerate(self.devices):
            with _on(self.streams[i]):
                fns.append(self.decode_factory(i, d, self.span))
        self._fns = fns
        self._fn_buckets = [_takes_bucket(fn) for fn in self._fns]

    @property
    def bucket_aware(self) -> bool:
        """Can the replicas route (model, version) buckets?  True only
        when EVERY replica decode fn takes a ``bucket`` keyword."""
        if self._fns is None:
            raise ValueError("dispatcher not bound; construct the batcher "
                             "(or call bind) first")
        return all(self._fn_buckets)

    def device_of(self, lane: int) -> int:
        """Which replica serves a global lane index."""
        if self.span is None:
            raise ValueError("dispatcher not bound; construct the batcher "
                             "(or call bind) first")
        return lane // self.span

    def lane_devices(self, lanes) -> np.ndarray:
        """Vectorized :meth:`device_of` (telemetry labeling)."""
        return np.asarray(lanes, np.int64) // self.span

    # -- the dispatch/harvest cycle ---------------------------------------
    def dispatch(self, tokens: np.ndarray, lengths: np.ndarray,
                 policy: FogPolicy, lanes,
                 bucket: tuple | None = None) -> list[Pending]:
        """Enqueue one bucket's lanes, without blocking.

        ``policy`` carries the group's static knobs and the FULL-batch
        per-lane vectors; ``lanes`` are the global lane indices belonging
        to this group; ``bucket`` is the (model, version) registry bucket
        (None = the single built-in model).  Every replica whose span
        intersects ``lanes`` gets one decode call over its whole span.
        """
        if self._fns is None:
            self.bind(len(tokens))
        lanes = np.asarray(lanes, np.int64)
        thr = np.asarray(policy.threshold)
        bud = (np.asarray(policy.hop_budget)
               if policy.hop_budget is not None else None)
        out = []
        for d in np.unique(lanes // self.span):
            d = int(d)
            lo, hi = d * self.span, (d + 1) * self.span
            sl = slice(lo, hi)
            span_pol = policy.replace(
                threshold=thr[sl] if thr.ndim else policy.threshold,
                hop_budget=(bud[sl] if bud is not None and bud.ndim
                            else policy.hop_budget))
            mine = lanes[(lanes >= lo) & (lanes < hi)]
            if not self._fn_buckets[d] and bucket is not None:
                raise ValueError(
                    f"device {d}'s decode replica is not bucket-aware "
                    "(no bucket= parameter) but the batch carries "
                    f"registry bucket {bucket!r}")
            kw = {"bucket": bucket} if self._fn_buckets[d] else {}
            with _on(self.streams[d]):
                logits, hops = self._fns[d](tokens[sl], lengths[sl],
                                            span_pol, **kw)
                (logits, hops), event = _stage((logits, hops))
            p = Pending(device=d, precision=policy.precision, lanes=mine,
                        local=mine - lo, logits=logits, hops=hops,
                        dispatched_at=time.perf_counter(), bucket=bucket,
                        event=event)
            self._queues[d].append(p)
            out.append(p)
        self.n_dispatches += len(out)
        return out

    # -- the packed (device-resident) cycle -------------------------------
    @property
    def packed(self) -> bool:
        """True when every replica speaks the packed protocol: resident
        slot state updated via :meth:`admit_lanes` / :meth:`retire_lanes`
        splices, dispatches that take only the step's default knobs, and
        ``(next, hops, energy)`` outputs (see
        :meth:`ForestReplicaServer.packed_factory`)."""
        if self._fns is None:
            raise ValueError("dispatcher not bound; construct the batcher "
                             "(or call bind) first")
        return all(getattr(fn, "packed", False) for fn in self._fns)

    def admit_lane(self, lane: int, row, thr: float, bud: int) -> None:
        """Stage one lane's feature row + resolved policy knobs onto its
        replica (applied as a device splice at the replica's next
        dispatch).  ``row=None`` re-stamps the policy knobs only."""
        self._fns[lane // self.span].admit(lane % self.span, row, thr, bud)

    def admit_lanes(self, lanes, rows, thr, bud) -> None:
        """Bulk :meth:`admit_lane`: one vectorized staging write per
        intersecting replica.  ``rows`` is ``[k, n_features]`` aligned with
        ``lanes`` (or None for a knob-only re-stamp); ``thr`` / ``bud`` are
        ``[k]``."""
        lanes = np.asarray(lanes, np.int64)
        thr = np.asarray(thr, np.float32)
        bud = np.asarray(bud, np.int32)
        devs = lanes // self.span
        for d in np.unique(devs):
            m = devs == d
            self._fns[int(d)].admit_many(
                lanes[m] - int(d) * self.span,
                None if rows is None else rows[m], thr[m], bud[m])

    def retire_lane(self, lane: int) -> None:
        """Stage one lane DEAD on its replica (freed slot: exits on hop 1
        until re-admitted; an admit in the same step overrides it)."""
        self._fns[lane // self.span].retire(lane % self.span)

    def retire_lanes(self, lanes) -> None:
        """Bulk :meth:`retire_lane` (one staging write per replica)."""
        lanes = np.asarray(lanes, np.int64)
        devs = lanes // self.span
        for d in np.unique(devs):
            self._fns[int(d)].retire_many(
                lanes[devs == d] - int(d) * self.span)

    def dispatch_packed(self, lanes, default_thresh: float,
                        default_budget: int, precision: str | None = None,
                        bucket: tuple | None = None) -> list[Pending]:
        """Enqueue one bucket's lanes on the packed protocol, without
        blocking: every intersecting replica runs its whole span from
        RESIDENT state — the only per-dispatch inputs are the step's
        default threshold/budget scalars (lanes without explicit policies
        resolve against them on the device, so a governor rung change
        costs no re-splice)."""
        lanes = (np.fromiter(lanes, np.int64, len(lanes))
                 if not isinstance(lanes, np.ndarray)
                 else lanes.astype(np.int64))
        out = []
        for d in np.unique(lanes // self.span):
            d = int(d)
            lo = d * self.span
            mine = lanes[(lanes >= lo) & (lanes < lo + self.span)]
            fn = self._fns[d]
            with _on(self.streams[d]):
                nxt, hops, energy = fn(float(default_thresh),
                                       int(default_budget), precision,
                                       bucket=bucket)
                (nxt, hops, energy), event = _stage((nxt, hops, energy))
            p = Pending(device=d, precision=precision, lanes=mine,
                        local=mine - lo, logits=None, hops=hops,
                        dispatched_at=time.perf_counter(), bucket=bucket,
                        nxt=nxt, energy=energy, event=event,
                        pack=getattr(fn, "last_pack", None),
                        inputs=getattr(fn, "last_inputs", None))
            self._queues[d].append(p)
            out.append(p)
        self.n_dispatches += len(out)
        return out

    def _drain(self, what: str) -> list[Pending]:
        pending = [p for q in self._queues for p in q]
        for q in self._queues:
            q.clear()
        if not pending:
            raise ValueError(f"{what}() with nothing dispatched")
        # the single synchronization point of the whole step
        for p in pending:
            if p.event is not None:
                p.event.synchronize()
        return pending

    def harvest_packed(self, n_slots: int):
        """Drain the packed queues: one synchronization over every
        dispatch's event, then scatter each group's lanes into full-batch
        HOST arrays.

        Returns ``(next [n_slots] int32, hops [n_slots] int64,
        energy_pj [n_slots] float64, dispatches)`` — no probabilities
        cross to the host and nothing is re-priced here."""
        pending = self._drain("harvest_packed")
        nxt = np.zeros((n_slots,), np.int32)
        hops = np.zeros((n_slots,), np.int64)
        energy = np.zeros((n_slots,), np.float64)
        for p in pending:
            nxt[p.lanes] = _host(p.nxt)[p.local]
            hops[p.lanes] = _host(p.hops)[p.local]
            energy[p.lanes] = _host(p.energy)[p.local]
        return nxt, hops, energy, pending

    def harvest(self, n_slots: int):
        """Drain every replica queue: ONE synchronization over all
        in-flight outputs, then scatter the group lanes back into
        full-batch arrays.

        Returns ``(logits [n_slots, C], hops [n_slots] | None,
        dispatches)`` — logits/hops as HOST numpy arrays — where
        ``dispatches`` is the drained :class:`Pending` list (replica /
        precision / lane bookkeeping for telemetry).
        """
        pending = self._drain("harvest")
        hops_present = [p.hops is not None for p in pending]
        if any(hops_present) != all(hops_present):
            raise ValueError(
                "inconsistent decode replicas: some returned hop telemetry "
                "and some returned hops=None")
        logits = None
        hops = None
        for p in pending:
            lg = _host(p.logits)
            if logits is None:
                logits = np.zeros((n_slots,) + lg.shape[1:], lg.dtype)
                if p.hops is not None:
                    hops = np.zeros((n_slots,), np.int64)
            logits[p.lanes] = lg[p.local]
            if p.hops is not None:
                hops[p.lanes] = _host(p.hops)[p.local]
        return logits, hops, pending


def _launch(pack, x, max_hops: int, backend: str) -> tuple[int, dict]:
    """(block_b, route and K keywords) of one dispatch: the per-hop
    kernels' default threads, or on the fused backend the engine's lookup,
    ``kernels/autotune.py::best_config`` for the span's lanes (a measured
    entry's chunk is not taken: a span is one launch)."""
    from repro_torch.core.engine import DEFAULT_BLOCK_B
    from repro_torch.kernels import autotune
    if backend != "fused":
        return DEFAULT_BLOCK_B, {}
    cfg = autotune.best_config(pack, x.shape[1], x.shape[0], max_hops,
                               x.device)
    return cfg.block_b, {"route": cfg.route,
                         "hops_per_walk": cfg.hops_per_walk}


def _serve_eval(pack, x, generator, thresh, budget, *, max_hops: int,
                backend: str, start=None):
    """One span's decode: the start-grove draw (from ``generator`` unless
    ``start`` is given) and the Algorithm-2 evaluation.  The conveniences
    of ``FogEngine.eval`` (policy resolution, report pricing) are bypassed:
    ``_eval_core`` is the same conformance-tested state machine every
    backend shares.  Returns (proba, hops)."""
    from repro_torch.core.engine import _eval_core
    if start is None:
        start = torch.randint(0, pack.n_groves, (x.shape[0],),
                              generator=generator, device=x.device,
                              dtype=torch.int32)
    block_b, kw = _launch(pack, x, max_hops, backend)
    res = _eval_core(pack, x, start, thresh, budget, max_hops, backend,
                     block_b, False, **kw)
    return res.proba, res.hops


class ServedSpan(NamedTuple):
    """One packed dispatch's outputs (``next``, ``hops``, ``energy``) and
    the inputs it drew or resolved (``start``, ``thresh``, ``budget``)."""

    next: torch.Tensor
    hops: torch.Tensor
    energy: torch.Tensor
    start: torch.Tensor
    thresh: torch.Tensor
    budget: torch.Tensor


def _serve_eval_packed(pack, x, generator, thresh, budget, def_thresh,
                       def_budget, per_hop_pj, transfer_pj, *,
                       max_hops: int, backend: str,
                       start=None) -> ServedSpan:
    """The packed protocol's whole decode step over RESIDENT span state:
    the start-grove draw (from ``generator`` on the span's device unless
    ``start`` is given), per-lane default resolution (NaN-threshold /
    negative-budget lanes take the step's default rung scalars), the
    Algorithm-2 evaluation (``backend="fused"``: one ``fused_fog`` launch),
    its argmax and the affine energy price
    ``h * per_hop + max(h - 1, 0) * transfer`` in float32, each product
    rounded on its own.  ``def_thresh`` .. ``transfer_pj`` are 0-d tensors
    on the span's device, so a dispatch uploads nothing."""
    from repro_torch.core.engine import _eval_core
    if start is None:
        start = torch.randint(0, pack.n_groves, (x.shape[0],),
                              generator=generator, device=x.device,
                              dtype=torch.int32)
    thr = torch.where(torch.isnan(thresh), def_thresh, thresh)
    bud = torch.where(budget < 0, def_budget, budget)
    block_b, kw = _launch(pack, x, max_hops, backend)
    res = _eval_core(pack, x, start, thr, bud, max_hops, backend, block_b,
                     False, **kw)
    h = res.hops.to(torch.float32)
    energy = h * per_hop_pj + torch.clamp(h - 1.0, min=0.0) * transfer_pj
    return ServedSpan(res.label, res.hops, energy, start, thr, bud)


def _upload(device: torch.device, *arrays):
    """Host arrays as tensors on ``device``: through pinned buffers with
    ``non_blocking`` copies on the current stream on the card (the host
    arrays are fresh copies the caller never rewrites; the pinned buffers
    are not reused before their copies finish), as they are on the CPU."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.require(a, requirements=("C", "W")))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return out


class ForestReplicaServer:
    """Forest classification serving behind a :class:`DeviceDispatcher`.

    Each slot holds one pending feature row; each replica holds
    :class:`~repro_torch.forest.pack.ForestPack` copies (one per precision
    in ``precisions``, so per-request ``FogPolicy(precision=...)``
    contracts dispatch against resident tables instead of re-packing
    mid-step).

        server = ForestReplicaServer(gc, n_features=16)
        disp = DeviceDispatcher(server.packed_factory, [cuda] * 4)
        batcher = ContinuousBatcher(128, None, server.prefill,
                                    dispatcher=disp)
        batcher.submit(Request(rid=0, prompt=x_row, max_new_tokens=1))

    ``Request.prompt`` is the feature row (float, ``[n_features]``); the
    decode "logits" are the forest's class probabilities and ``hops`` is
    the paper's per-example energy quantity, so the whole mixed-QoS /
    governor / admission-control machinery applies unchanged.

    Multi-tenant mode: pass ``registry=`` (a
    :class:`~repro_torch.registry.ModelRegistry`) and ``cache=`` (a
    :class:`~repro_torch.registry.PackCache`) and the replicas become
    bucket-aware — a dispatch carrying ``bucket=(tenant, version)``
    evaluates that tenant version's pack, fetched through the byte-budgeted
    cache (one copy per device, traffic-weighted eviction, lazy reload
    from the artifact).  ``gc`` may then be ``None``: bucketless
    dispatches need a built-in model and raise without one.

    Randomness: replica ``i`` draws each dispatch's ``[span]`` start groves
    from a ``torch.Generator`` on its device seeded with ``seed + i``.
    ``draw_starts(index, step, span, n_groves)`` replaces that draw (the
    tests feed the JAX package's draws through it); ``step`` counts the
    replica's dispatches from 1.
    """

    def __init__(self, gc, n_features: int, *, backend: str = "fused",
                 precisions: Sequence[str] = ("fp32",), seed: int = 0,
                 registry=None, cache=None,
                 draw_starts: Callable | None = None):
        from repro_torch.core.policy import check_backend
        from repro_torch.forest.pack import ForestPack
        check_backend(backend)
        if backend == "ring":
            raise ValueError("the serving plane shards the batch; the ring "
                             "backend shards groves — serve with 'fused', "
                             "'pallas' or 'reference'")
        if (registry is None) != (cache is None):
            raise ValueError(
                "registry mode needs BOTH registry= and cache= (the cache "
                "enforces the byte budget the replicas load through)")
        self.registry = registry
        self.cache = cache
        if gc is None:
            if registry is None:
                raise ValueError(
                    "ForestReplicaServer needs a grove collection/pack, "
                    "or registry= + cache= for multi-tenant serving")
            self._packs = {}
        elif isinstance(gc, ForestPack):
            self._packs = {gc.precision: gc}
            for p in precisions:
                if p not in self._packs:
                    self._packs[p] = gc.astype(p)
        else:
            self._packs = {p: ForestPack.from_groves(gc, p)
                           for p in precisions}
        self.default_precision = tuple(precisions)[0]
        self.n_features = int(n_features)
        self.backend = backend
        self.seed = seed
        self.draw_starts = draw_starts
        self._buffers: dict[int, np.ndarray] = {}
        self._span: int | None = None
        self._steps: dict[int, int] = {}
        self._energy_models: dict[tuple, object] = {}
        self._devices: dict[int, object] = {}
        # (precision, bucket) -> (per_hop_pj, transfer_pj) host floats
        self._hop_costs: dict[tuple, tuple] = {}

    @property
    def n_groves(self) -> int:
        if not self._packs:
            raise ValueError("registry-mode server has no built-in model; "
                             "ask a bucket's pack for its grove count")
        return self._packs[self.default_precision].n_groves

    def energy_model(self, precision: str | None = None,
                     tenant: str | None = None,
                     version: int | None = None):
        """The pricing :class:`~repro_torch.core.energy.EnergyModel` for
        one precision's packed tables (cached).  In registry mode pass
        ``tenant`` (and optionally ``version``, default live) to price
        that tenant's topology — tenants' forests need not match."""
        from repro_torch.core.energy import EnergyModel
        precision = precision or self.default_precision
        if tenant is not None:
            if self.registry is None:
                raise ValueError("tenant-keyed energy models need a "
                                 "registry-mode server")
            if version is None:
                version = self.registry.live_version(tenant)
            key = (precision, tenant, int(version))
            m = self._energy_models.get(key)
            if m is None:
                pack = self.cache.get(tenant, version, precision)
                m = EnergyModel.from_pack(pack, self.n_features)
                self._energy_models[key] = m
            return m
        key = (precision, None, None)
        m = self._energy_models.get(key)
        if m is None:
            m = EnergyModel.from_pack(self._packs[precision],
                                      self.n_features)
            self._energy_models[key] = m
        return m

    def _pack_for(self, index: int, device, packs: dict, prec: str,
                  bucket):
        if bucket is not None:
            # registry bucket: this device's copy of the (tenant, version)
            # pack at the group's precision, through the byte-budgeted
            # cache (lazy reload after eviction)
            if self.cache is None:
                raise ValueError(
                    f"replica {index} got bucket {bucket!r} but the "
                    "server has no registry/cache (single-model mode)")
            tenant, version = bucket
            return self.cache.device_pack(tenant, version, prec, device)
        if packs:
            return packs[prec]
        raise ValueError(
            "registry-mode server got a bucketless dispatch; requests must "
            "carry Request.model (no built-in default model was "
            "constructed)")

    def _starts(self, index: int, step: int, span: int, n_groves: int,
                device):
        """This dispatch's given start draw as a device tensor, or None
        (the replica's generator draws)."""
        if self.draw_starts is None:
            return None
        start = self.draw_starts(index, step, span, n_groves)
        if isinstance(start, torch.Tensor):
            return start.to(device=device, dtype=torch.int32)
        return _upload(device, np.asarray(start, np.int32))[0]

    def _replica(self, index: int, device, span: int):
        """What both protocols place per replica: the built-in packs on
        the device, the replica's generator and its dispatch counter."""
        self._span = span
        self._devices[index] = device
        packs = {p: pack.to(device) for p, pack in self._packs.items()}
        generator = torch.Generator(device=device)
        generator.manual_seed(self.seed + index)
        self._steps[index] = 0
        return packs, generator

    def factory(self, index: int, device, span: int):
        """The :class:`DeviceDispatcher` ``decode_factory`` contract: the
        rows are uploaded each dispatch and the probabilities come back."""
        packs, generator = self._replica(index, device, span)
        buf = np.zeros((span, self.n_features), np.float32)
        self._buffers[index] = buf
        backend = self.backend

        def decode(tokens, lengths, policy, bucket=None):
            # tokens/lengths are the slot-model plumbing; the forest serves
            # the span's feature rows.  A fresh start-grove draw per
            # dispatch keeps the rotation-start randomization honest under
            # continuous refill.
            step = self._steps[index] = self._steps[index] + 1
            thr = np.broadcast_to(
                np.asarray(policy.threshold, np.float32), (span,))
            bud = (np.broadcast_to(
                       np.asarray(policy.hop_budget, np.int32), (span,))
                   if policy.hop_budget is not None
                   else np.full((span,), NO_BUDGET, np.int32))
            prec = policy.precision or self.default_precision
            pack = self._pack_for(index, device, packs, prec, bucket)
            # a blocking copy: the next prefill may rewrite buf
            x = torch.from_numpy(buf).to(device)
            thr_t, bud_t = _upload(device, thr, bud)
            return _serve_eval(
                pack, x, generator, thr_t, bud_t, max_hops=pack.n_groves,
                backend=backend,
                start=self._starts(index, step, span, pack.n_groves,
                                   device))

        return decode

    def _hop_cost(self, prec: str, bucket, pack):
        """Cached (per_hop_pj, transfer_pj) host floats for one pack's
        topology at one precision — the inputs of the dispatch's affine
        energy price (each replica keeps its own device copies)."""
        key = (prec, bucket)
        c = self._hop_costs.get(key)
        if c is None:
            from repro_torch.core.energy import EnergyModel
            m = EnergyModel.from_pack(pack, self.n_features)
            c = (float(m.per_hop_pj), float(m.transfer_pj))
            self._hop_costs[key] = c
        return c

    def packed_factory(self, index: int, device, span: int):
        """Packed-protocol replica: per-slot feature rows and policy
        vectors live as PERSISTENT buffers on the replica's device,
        updated in place when the batcher admits/retires lanes
        (:func:`~repro_torch.core.engine.splice_slot_state`, one splice
        per dispatch over every lane staged since the last), and each
        dispatch runs :func:`_serve_eval_packed` — start draw, default
        resolution, one ``fused_fog`` launch, argmax and energy pricing.
        ``step()`` therefore pays no per-step row uploads, policy
        re-assembly or probability downloads; three ``[span]`` vectors
        come back per dispatch.

        The splice is in place although the previous dispatch may still be
        running: both are on the replica's stream, so the splice runs after
        the launch that reads the old rows.  Its host side reads fresh
        copies (``mirror[idx]``), never memory the host rewrites later.
        """
        from repro_torch.core.engine import splice_slot_state
        packs, generator = self._replica(index, device, span)
        backend = self.backend
        lp = LanePolicies(span)
        # resident state, allocated under the replica's stream (the
        # dispatcher builds replicas under it)
        state = {
            "x": torch.zeros((span, self.n_features), dtype=torch.float32,
                             device=device),
            "thr": torch.from_numpy(lp.thresh.copy()).to(device),
            "bud": torch.from_numpy(lp.budget.copy()).to(device),
        }
        # the step's default knobs as 0-d device tensors (governor rungs
        # form a small set), and this replica's energy pricing scalars
        knob_cache: dict[tuple, tuple] = {}
        hop_cache: dict[tuple, tuple] = {}
        # host mirror of the resident feature rows: the staging target for
        # admits (one vectorized write per burst) and the row source of
        # the splice
        mirror = np.zeros((span, self.n_features), np.float32)
        self._buffers[index] = mirror

        def admit_many(locals_, rows, thr, bud) -> None:
            if rows is not None:
                rows = np.asarray(rows, np.float32)
                if rows.shape[-1] != self.n_features:
                    raise ValueError(
                        f"request feature rows have {rows.shape[-1]} "
                        f"features, server expects {self.n_features}")
                mirror[locals_] = rows
            lp.stamp_many(locals_, thr, bud)

        def admit(local: int, row, thr: float, bud: int) -> None:
            admit_many(np.asarray([local]),
                       None if row is None
                       else np.asarray(row, np.float32).reshape(1, -1),
                       thr, bud)

        def retire_many(locals_) -> None:
            lp.retire_many(locals_)

        def retire(local: int) -> None:
            retire_many(np.asarray([local]))

        def _apply_staged() -> None:
            # one splice over all three buffers, driven by the knob dirty
            # set (every row admit also stamps knobs, so it covers the row
            # writes; rows come from the mirror, which is current for
            # admitted lanes and harmlessly stale for retired ones)
            if lp.dirty:
                idx, thr, bud = lp.take_dirty()
                state["x"], state["thr"], state["bud"] = splice_slot_state(
                    state["x"], state["thr"], state["bud"],
                    *_upload(device, idx, mirror[idx], thr, bud))

        def decode(def_thresh, def_budget, precision=None, bucket=None):
            _apply_staged()
            prec = precision or self.default_precision
            pack = self._pack_for(index, device, packs, prec, bucket)
            hk = (prec, bucket)
            hop = hop_cache.get(hk)
            if hop is None:
                per_hop_pj, transfer_pj = self._hop_cost(prec, bucket, pack)
                hop = hop_cache[hk] = (
                    torch.tensor(per_hop_pj, dtype=torch.float32,
                                 device=device),
                    torch.tensor(transfer_pj, dtype=torch.float32,
                                 device=device))
            ck = (float(def_thresh), int(def_budget))
            knobs = knob_cache.get(ck)
            if knobs is None:
                knobs = knob_cache[ck] = (
                    torch.tensor(ck[0], dtype=torch.float32, device=device),
                    torch.tensor(ck[1], dtype=torch.int32, device=device))
            step = self._steps[index] = self._steps[index] + 1
            out = _serve_eval_packed(
                pack, state["x"], generator, state["thr"], state["bud"],
                knobs[0], knobs[1], hop[0], hop[1], max_hops=pack.n_groves,
                backend=backend,
                start=self._starts(index, step, span, pack.n_groves,
                                   device))
            decode.last_pack = pack
            decode.last_inputs = (out.start, out.thresh, out.budget)
            return out.next, out.hops, out.energy

        decode.packed = True
        decode.admit = admit
        decode.admit_many = admit_many
        decode.retire = retire
        decode.retire_many = retire_many
        decode.last_pack = None
        decode.last_inputs = None
        return decode

    def prefill(self, slot: int, prompt: np.ndarray) -> int:
        """Store the request's feature row in its slot's host buffer (the
        non-packed path uploads it at the next dispatch)."""
        if self._span is None:
            raise ValueError("server not bound; construct the batcher "
                             "with its DeviceDispatcher first")
        row = np.asarray(prompt, np.float32).reshape(-1)
        if row.shape[0] != self.n_features:
            raise ValueError(
                f"request feature row has {row.shape[0]} features, "
                f"server expects {self.n_features}")
        self._buffers[slot // self._span][slot % self._span] = row
        return 1
