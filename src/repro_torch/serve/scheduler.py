"""Batched request scheduler for serving (continuous batching + FoG; port
of ``repro.serve.scheduler``).

A slot-based continuous-batching scheduler: a fixed decode batch of
``n_slots`` lanes; finished/empty lanes are refilled from the request queue
each step (the standard vLLM-style slot model, minus paged KV — caches here
are dense per-slot rings).  With FoG decode enabled, per-step grove usage
(hops) is accumulated per request, giving the per-request energy/FLOP
accounting that mirrors the paper's per-input hop counter.

Mixed-QoS serving: every :class:`Request` may carry its own
:class:`~repro_torch.core.policy.FogPolicy` (threshold / hop budget).
Each step the scheduler assembles the slots' scalar policies into one
per-lane batch policy (:func:`repro_torch.core.policy.assemble`) and hands
it to a policy-aware ``decode_fn(tokens, lengths, policy)`` — one
continuous batch, one decode path, every lane buying its own
accuracy/energy point.  Two-arg ``decode_fn(tokens, lengths)`` callables
work too.  ``tokens`` / ``lengths`` reach ``decode_fn`` as int32 CPU
tensors; the decode path moves them to its device.

Mixed-precision serving: a request's policy may additionally set
``precision`` ("fp32" | "bf16" | "int8" packed tables).  Precision selects
the tables a launch reads, so it cannot ride the per-lane vectors; instead the
scheduler buckets the step's slots by precision and dispatches ``decode_fn``
once per distinct precision present (each call still carries the full
per-lane threshold/budget vectors; each slot's outputs are harvested from
its own precision's call).  A homogeneous batch — the common case — still
costs exactly one dispatch.

Data-parallel serving: hand the batcher a
:class:`~repro_torch.serve.dispatch.DeviceDispatcher` instead of a
``decode_fn`` and each precision group's dispatch fans out across the
dispatcher's replicas (fixed per-replica slot spans, each replica on its
own device and CUDA stream, one synchronization over every replica's
events at harvest) — the slot model, policy assembly and telemetry are
unchanged; only the execution plane widens.

Admission control: ``max_queue`` bounds the request queue.  When it is
full, ``shed_policy`` decides who pays: ``"reject"`` sheds the incoming
request (``submit`` returns False), ``"oldest"`` evicts the oldest queued
request to admit the new one.  Shed requests are marked ``req.shed``,
collected in ``batcher.shed_requests``, and counted in
``ServeStats.n_shed`` / ``shed_rate`` — overload becomes a measured,
bounded signal instead of an unbounded latency tail.

Energy governance: install an
:class:`~repro_torch.serve.governor.EnergyGovernor`
and the batcher serves under an nJ/classification SLO — each step's default
policy is the governor's active ladder rung, every step's hop telemetry
feeds its rolling estimate, and the governor steps down the ladder (tighten
threshold -> int8 -> cut hop budget) on a breach, back up when headroom
returns.  A request may carry ``energy_budget_nj`` instead of an explicit
policy: the governor resolves it against the calibrated frontier into the
highest-accuracy rung fitting that budget (hop budget clamped so the
contract is hard).  Telemetry lives in :class:`ServeStats`.  The JAX
package's deprecated ``HopMeter`` shim (``meter=`` and the ``meter``
property) is not ported, by design.

``decode_fn``'s calling convention is read from its signature
(:func:`_policy_mode`, :func:`_takes_bucket`), which sees through
``functools.partial``.
"""
from __future__ import annotations

import dataclasses
import heapq
import inspect
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.core.policy import (BUDGET_DEFAULT, NO_BUDGET,
                                     THRESH_DEFAULT, FogPolicy, assemble,
                                     lane_knobs)


def _host(a) -> np.ndarray:
    """A decode output as a host numpy array (tensors are copied off their
    device)."""
    if isinstance(a, torch.Tensor):
        return (a if a.device.type == "cpu" else a.cpu()).detach().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [P] int32
    max_new_tokens: int = 32
    # per-request QoS contract (scalar threshold / hop budget); None = the
    # batcher's default policy
    policy: FogPolicy | None = None
    # per-request energy contract: resolved at submit() into a policy via
    # the batcher's governor (mutually exclusive with an explicit policy)
    energy_budget_nj: float | None = None
    # registry tenant this request evaluates against (None = the batcher's
    # single built-in model, the pre-registry behavior)
    model: str | None = None
    # QoS tier label for per-tier shed/done/energy telemetry (ServeStats
    # breaks out counters per distinct label)
    tier: str = "default"
    # the registry version serving this request: resolved ONCE at slot
    # assignment (registry.route) and pinned, so a hot-swap mid-decode
    # never migrates an in-flight request between versions.  Pre-set it to
    # bypass routing.
    version: int | None = None
    # filled by the scheduler:
    generated: list = dataclasses.field(default_factory=list)
    hops: list = dataclasses.field(default_factory=list)
    done: bool = False
    # set by admission control when the request is dropped under overload
    shed: bool = False
    # wall-clock stamps for latency accounting: submit() stamps t_submit
    # (shed requests included — the shed tail is part of the latency
    # story), completion stamps t_done.  Callers may pre-stamp t_submit.
    t_submit: float | None = None
    t_done: float | None = None

    @property
    def tenant(self) -> str | None:
        """Alias of ``model`` (the registry/ledger vocabulary)."""
        return self.model


@dataclasses.dataclass
class ServeStats:
    """Fleet-level serving telemetry: hop counts of every decoded event, plus modeled pJ when a governor (or
    its energy model) is installed to price them."""

    total_hops: int = 0
    n_events: int = 0
    total_pj: float = 0.0
    has_energy: bool = False
    # events that actually carried a pJ price — the mean_energy_nj
    # denominator.  Mixing priced and unpriced updates (governor installed
    # mid-run, hops-only telemetry) must not deflate the mean.
    n_priced: int = 0
    # admission-control counters (bounded queue)
    n_offered: int = 0
    n_shed: int = 0
    # per-QoS-tier breakdown: tier label -> {n_done, n_shed, n_events,
    # total_pj, n_priced}.  Canary judging and gold-tier SLOs need the
    # split the fleet totals average away.
    tiers: dict = dataclasses.field(default_factory=dict)

    def _tier(self, tier: str) -> dict:
        t = self.tiers.get(tier)
        if t is None:
            t = self.tiers[tier] = {"n_done": 0, "n_shed": 0, "n_events": 0,
                                    "total_pj": 0.0, "n_priced": 0}
        return t

    def note_shed(self, tier: str = "default") -> None:
        self.n_shed += 1
        self._tier(tier)["n_shed"] += 1

    def note_done(self, tier: str = "default") -> None:
        self._tier(tier)["n_done"] += 1

    def note_done_many(self, counts: dict) -> None:
        """Batched :meth:`note_done`: ``{tier: completions}`` — one dict
        walk per harvest instead of a lookup per completed lane."""
        for tier, k in counts.items():
            self._tier(tier)["n_done"] += k

    def update(self, hops, energy_pj=None, tiers=None) -> None:
        """Fold one batch of decoded events in.  ``energy_pj`` may carry
        NaN for events nothing could price (a ledgered batch with an
        unledgered tenant) — only finite entries feed the energy totals.
        ``tiers`` optionally labels each event with its request's QoS tier
        for the per-tier breakdown."""
        h = np.asarray(hops)
        self.total_hops += int(h.sum())
        self.n_events += int(h.size)
        priced = None
        if energy_pj is not None:
            e = np.asarray(energy_pj, np.float64)
            priced = np.isfinite(e)
            self.total_pj += float(e[priced].sum())
            self.n_priced += int(priced.sum())
            if priced.any():
                self.has_energy = True
        if tiers is not None:
            e = (np.asarray(energy_pj, np.float64)
                 if energy_pj is not None else None)
            for i, tier in enumerate(tiers):
                t = self._tier(tier)
                t["n_events"] += 1
                if priced is not None and priced[i]:
                    t["total_pj"] += float(e[i])
                    t["n_priced"] += 1

    def tier_summary(self) -> dict:
        """{tier: {n_done, n_shed, n_events, mean_energy_nj}} — the
        per-tier view the fleet means hide."""
        return {tier: {"n_done": t["n_done"], "n_shed": t["n_shed"],
                       "n_events": t["n_events"],
                       "mean_energy_nj": t["total_pj"] * 1e-3
                       / max(1, t["n_priced"])}
                for tier, t in sorted(self.tiers.items())}

    def reset(self) -> None:
        self.total_hops = 0
        self.n_events = 0
        self.total_pj = 0.0
        self.has_energy = False
        self.n_priced = 0
        self.n_offered = 0
        self.n_shed = 0
        self.tiers = {}

    @property
    def mean_hops(self) -> float:
        return self.total_hops / max(1, self.n_events)

    @property
    def mean_energy_nj(self) -> float:
        """Mean modeled nJ per PRICED decoded event (0.0 until priced
        telemetry arrives).  Unpriced events (no governor / hops-only
        updates) are excluded from the denominator."""
        return self.total_pj * 1e-3 / max(1, self.n_priced)

    @property
    def shed_rate(self) -> float:
        """Fraction of offered requests shed by admission control."""
        return self.n_shed / max(1, self.n_offered)

    def summary(self, n_groves: int) -> str:
        s = (f"hops/event {self.mean_hops:.2f} "
             f"(grove fraction {self.mean_hops / max(1, n_groves):.2f}, "
             f"{self.n_events} events)")
        if self.has_energy:
            s += f", {self.mean_energy_nj:.3f} nJ/event"
        if self.n_shed:
            s += (f", shed {self.n_shed}/{self.n_offered} "
                  f"({100 * self.shed_rate:.1f}%)")
        return s


@dataclasses.dataclass
class SlotState:
    request: Request | None = None
    length: int = 0               # tokens already in this slot's cache


def _policy_mode(decode_fn: Callable) -> str:
    """How decode_fn accepts the batch policy.

    ``"positional"``  three-plus positional params (or ``*args``): called
                      ``decode_fn(tokens, lengths, policy)``
    ``"keyword"``     a KEYWORD_ONLY ``policy`` param (also reachable
                      through ``functools.partial``, whose signature
                      ``inspect`` resolves): called
                      ``decode_fn(tokens, lengths, policy=policy)``
    ``"legacy"``      two-arg decode; never sees a policy
    """
    try:
        params = inspect.signature(decode_fn).parameters.values()
    except (TypeError, ValueError):   # builtins / C callables: assume legacy
        return "legacy"
    positional = [p for p in params
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    if (len(positional) >= 3
            or any(p.kind == p.VAR_POSITIONAL for p in params)):
        return "positional"
    if any(p.kind == p.KEYWORD_ONLY and p.name == "policy" for p in params):
        return "keyword"
    return "legacy"


def _takes_policy(decode_fn: Callable) -> bool:
    """Does decode_fn accept a policy argument (positional or kw-only)?"""
    return _policy_mode(decode_fn) != "legacy"


def _takes_bucket(decode_fn: Callable) -> bool:
    """Does decode_fn accept a ``bucket`` keyword ((model, version)
    routing for registry-backed multi-tenant serving)?"""
    try:
        params = inspect.signature(decode_fn).parameters
    except (TypeError, ValueError):
        return False
    p = params.get("bucket")
    return p is not None and p.kind in (p.KEYWORD_ONLY,
                                        p.POSITIONAL_OR_KEYWORD)


class ContinuousBatcher:
    """Drives decode_fn over a fixed slot batch, refilling as lanes finish.

    decode_fn(tokens [n_slots] int32, lengths [n_slots] int32
              [, policy: FogPolicy with per-lane [n_slots] knobs])
        -> (logits [n_slots, V], hops [n_slots] | None)
        (the policy param may be positional or KEYWORD_ONLY ``*, policy``)
    prefill_fn(slot, prompt) -> int  (returns prompt length in cache)
    default_policy: applied to slots whose request carries no policy (and
        to empty lanes); its static knobs select the evaluation path.
    governor: optional EnergyGovernor — when set, the *governor's active
        rung* replaces default_policy each step, per-step hop telemetry
        feeds its rolling estimate, and requests may carry
        ``energy_budget_nj`` contracts.
    dispatcher: optional :class:`~repro_torch.serve.dispatch.DeviceDispatcher` —
        the data-parallel execution plane.  Mutually exclusive with
        ``decode_fn`` (pass ``decode_fn=None``); always policy-aware.
    max_queue: admission-control bound on the request queue (None =
        unbounded, the pre-existing behavior).
    shed_policy: who is shed when the queue is full — ``"reject"`` the
        incoming request (submit returns False) or evict the ``"oldest"``
        queued request.
    registry: optional :class:`~repro_torch.registry.ModelRegistry` —
        requests carrying ``model=`` are routed to a version at slot
        assignment and pinned to it.
    pipeline: packed dispatcher only — harvest step t's dispatch at the
        start of step t+1, so the host's work for t+1 overlaps the card's
        work for t.
    telemetry_every: packed dispatcher only — replay buffered telemetry
        every k harvests (and at :meth:`flush`) instead of every step.
    """

    def __init__(self, n_slots: int, decode_fn: Callable | None,
                 prefill_fn: Callable, eos_id: int = 1,
                 default_policy: FogPolicy | None = None,
                 governor=None, dispatcher=None,
                 max_queue: int | None = None, shed_policy: str = "reject",
                 registry=None, pipeline: bool = False,
                 telemetry_every: int = 1):
        self.slots = [SlotState() for _ in range(n_slots)]
        self.queue: deque[Request] = deque()
        self.decode_fn = decode_fn
        self.prefill_fn = prefill_fn
        self.eos_id = eos_id
        self.completed: list[Request] = []
        self.default_policy = (default_policy if default_policy is not None
                               else FogPolicy())
        if self.default_policy.per_lane:
            raise ValueError(
                "default_policy must carry scalar knobs; the batcher "
                "assembles the per-lane vectors itself each step")
        # ``governor`` accepts either one EnergyGovernor (fleet-wide SLO)
        # or a TenantLedger (per-tenant SLOs, one governor per tenant)
        self.ledger = None
        if governor is not None and hasattr(governor, "governor_for"):
            self.ledger = governor
            governor = None
        self.governor = governor
        self.dispatcher = dispatcher
        self.registry = registry
        self._packed = False
        if dispatcher is not None:
            if decode_fn is not None:
                raise ValueError(
                    "pass either decode_fn or dispatcher, not both (the "
                    "dispatcher owns the per-device decode replicas)")
            dispatcher.bind(n_slots)
            self._packed = dispatcher.packed
            self._policy_mode = "dispatch"
        else:
            if decode_fn is None:
                raise ValueError(
                    "decode_fn is required when no dispatcher is given")
            self._policy_mode = _policy_mode(decode_fn)
        self._policy_aware = self._policy_mode != "legacy"
        if shed_policy not in ("reject", "oldest"):
            raise ValueError(f"unknown shed_policy {shed_policy!r}; "
                             "pick 'reject' or 'oldest'")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None = unbounded)")
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self.shed_requests: list[Request] = []
        # the dispatcher's drained Pending list from the last step (device /
        # precision / lane bookkeeping for the load harness)
        self.last_dispatches: list = []
        # maintained per-lane decode inputs (empty lanes stay 0): rebuilding
        # these with a per-slot Python loop every step is measurable serial
        # time at serving-scale slot counts
        self._tokens = np.zeros((n_slots,), np.int32)
        self._lengths = np.zeros((n_slots,), np.int32)
        if governor is not None:
            # a governor that can never act must be rejected loudly — a
            # silently unenforced SLO is worse than no governor at all
            if governor.model is None:
                raise ValueError(
                    "the batcher's governor needs an energy model to price "
                    "hop telemetry; construct EnergyGovernor(..., "
                    "model=...)")
            if not self._policy_aware:
                raise ValueError(
                    "a governor needs a policy-aware decode_fn(tokens, "
                    "lengths, policy) — a legacy two-arg decode_fn would "
                    "never serve the governor's rung policy")
        if self.ledger is not None and not self._policy_aware:
            raise ValueError(
                "a tenant ledger needs a policy-aware decode path — a "
                "legacy two-arg decode_fn would never serve any tenant's "
                "rung policy")
        # can this execution plane route (model, version) buckets?  The
        # dispatcher introspects its replicas at bind; a plain decode_fn
        # must take a ``bucket`` keyword itself.
        if dispatcher is not None:
            self._bucket_aware = dispatcher.bucket_aware
        else:
            self._bucket_aware = _takes_bucket(decode_fn)
        # -- packed fast path (device-resident slot state) ----------------
        if pipeline and not self._packed:
            raise ValueError(
                "pipeline=True needs a packed dispatcher (replicas built "
                "from ForestReplicaServer.packed_factory — resident slot "
                "state is what makes overlapping dispatch with host "
                "bookkeeping safe)")
        if telemetry_every < 1:
            raise ValueError("telemetry_every must be >= 1")
        if telemetry_every > 1 and not self._packed:
            raise ValueError(
                "telemetry_every > 1 needs the packed dispatch path "
                "(the legacy step accounts inline)")
        self.pipeline = bool(pipeline)
        self.telemetry_every = int(telemetry_every)
        # empty-slot min-heap + occupancy mask: the packed step never walks
        # all n_slots in Python — refill pops the heap, harvest walks only
        # the occupied lanes, bucket membership is maintained incrementally
        self._free: list[int] = list(range(n_slots))
        self._occ_mask = np.zeros((n_slots,), bool)
        self._n_active = 0
        self._bucket_lanes: dict[tuple, set[int]] = {}
        self._lane_key: list[tuple | None] = [None] * n_slots
        self._inflight = False
        self._inflight_occ: np.ndarray | None = None
        self._tel_buf: list[tuple] = []
        self._steps_since_flush = 0
        # per-phase host-time accumulators (ns) for the packed step — the
        # bench-serve-profile breakdown reads these
        self.phase_ns = {"harvest": 0, "bookkeep": 0, "telemetry": 0,
                         "refill": 0, "dispatch": 0}
        self.n_steps = 0
        # fleet-level FoG accounting: hop counts (and, with a governor's
        # energy model, modeled pJ) of every decoded token
        self.stats = ServeStats()

    def submit(self, req: Request) -> bool:
        """Validate, resolve energy contracts, then admit or shed.

        Returns True if the request was admitted to the queue, False if it
        was shed by admission control (``shed_policy="reject"`` with a full
        queue).  Invalid requests still raise — shedding is a load signal,
        not an error-swallowing path.
        """
        # stamp at the door: shed requests carry a submit time too (the
        # shed tail is part of the latency story), admitted requests keep
        # any pre-stamp the harness set
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        if req.model is not None:
            if self.registry is None and req.version is None:
                raise ValueError(
                    f"request {req.rid}: Request.model={req.model!r} needs "
                    "a registry to resolve the serving version (construct "
                    "ContinuousBatcher(..., registry=ModelRegistry(dir)), "
                    "or pre-set Request.version)")
            if not self._bucket_aware:
                raise ValueError(
                    f"request {req.rid}: Request.model={req.model!r} needs "
                    "a bucket-aware decode path (a decode_fn/replica "
                    "taking bucket=) to route (model, version) buckets")
        if req.energy_budget_nj is not None:
            if req.policy is not None:
                raise ValueError(
                    f"request {req.rid}: pass either policy or "
                    "energy_budget_nj, not both (the budget is resolved "
                    "into a policy)")
            gov = self.governor
            if gov is None and self.ledger is not None:
                gov = self.ledger.governor_for(req.tenant)
            if gov is None:
                raise ValueError(
                    f"request {req.rid}: energy_budget_nj needs a "
                    "governor (construct ContinuousBatcher(..., "
                    "governor=EnergyGovernor(frontier, ...)) or ledger "
                    "an EnergyGovernor for this request's tenant)")
            pol = gov.policy_for_budget(req.energy_budget_nj)
            # the per-request contract is the per-lane/bucketed knobs only
            # (threshold, hop budget, precision); any static knobs the
            # ladder rung inherited from the fleet default (backend,
            # max_hops, ...) stay with the fleet default — they select the
            # evaluation path and would otherwise trip the static-knob
            # rejection below
            req.policy = FogPolicy(threshold=pol.threshold,
                                   hop_budget=pol.hop_budget,
                                   precision=pol.precision)
        if req.policy is not None:
            if req.policy.per_lane:
                raise ValueError(
                    f"request {req.rid}: per-request policies are scalar "
                    "contracts; the batcher assembles the per-lane vectors")
            # precision is static too, but the batcher handles it by
            # dispatching one program per precision group (see step())
            rejected = tuple(k for k in req.policy.static_overrides
                             if k != "precision")
            if rejected:
                raise ValueError(
                    f"request {req.rid}: policy sets static knobs "
                    f"{rejected} — those select the "
                    "evaluation path and cannot vary per request; set "
                    "them on the batcher's default_policy (per-request "
                    "knobs are threshold, hop_budget and precision)")
        self.stats.n_offered += 1
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            if self.shed_policy == "reject":
                self._shed(req)
                return False
            # "oldest": evict the head of the queue to admit the newcomer
            self._shed(self.queue.popleft())
        self.queue.append(req)
        return True

    def _shed(self, req: Request) -> None:
        req.shed = True
        self.shed_requests.append(req)
        self.stats.note_shed(req.tier)

    def _refill(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.request is None and self.queue:
                req = self.queue.popleft()
                if (req.model is not None and req.version is None
                        and self.registry is not None):
                    # resolve the serving version HERE, once: the request
                    # rides this version to completion even if a publish
                    # hot-swaps the tenant's live version mid-decode
                    req.version = self.registry.route(req.model, req.rid)
                slot.request = req
                slot.length = self.prefill_fn(i, req.prompt)
                self._tokens[i] = req.prompt[-1]
                self._lengths[i] = slot.length

    @property
    def active(self) -> int:
        if self._packed:
            return self._n_active
        return sum(1 for s in self.slots if s.request is not None)

    def _tenant_rung(self, req: Request) -> FogPolicy | None:
        """The ledgered rung policy billing this request's tenant (None
        when no ledger, or the ledger knows neither tenant nor default)."""
        if self.ledger is None:
            return None
        gov = self.ledger.governor_for(req.tenant)
        return None if gov is None else gov.current

    def lane_policy(self) -> FogPolicy:
        """The current batch policy: slot policies stacked into per-lane
        threshold / hop-budget vectors.  A slot without its own policy gets
        its tenant's ledgered rung (ledger mode), else the default — the
        fleet governor's active ladder rung when one is installed."""
        default = (self.governor.current if self.governor is not None
                   else self.default_policy)
        pols: list[FogPolicy | None] = []
        for s in self.slots:
            if s.request is None or s.request.policy is not None:
                pols.append(s.request.policy if s.request else None)
            else:
                pols.append(self._tenant_rung(s.request))
        return assemble(pols, default=default)

    def _bucket_groups(self) -> dict:
        """Slot indices keyed by ``(model, version, precision)`` — the
        serving bucket.  One decode dispatch per key; the legacy
        single-model batch degenerates to ``(None, None, precision)`` keys
        (precision None = the default program), so a homogeneous batch
        still costs exactly one dispatch."""
        groups: dict[tuple, list[int]] = {}
        for i, s in enumerate(self.slots):
            if s.request is None:
                key = (None, None, None)
            else:
                req = s.request
                prec = (req.policy.precision if req.policy is not None
                        else None)
                if prec is None:
                    rung = self._tenant_rung(req)
                    if rung is not None:
                        prec = rung.precision
                key = (req.model, req.version, prec)
            groups.setdefault(key, []).append(i)
        none_key = (None, None, None)
        none_idxs = groups.get(none_key)
        if none_idxs is not None and len(groups) > 1 and all(
                self.slots[i].request is None for i in none_idxs):
            # lanes in the default group are all empty: don't spend a
            # dispatch on them, fold into an arbitrary real group (outputs
            # discarded)
            groups.pop(none_key)
            next(iter(groups.values())).extend(none_idxs)
        return groups

    # -- the packed fast path ---------------------------------------------
    #
    # With a packed dispatcher (ForestReplicaServer.packed_factory) the hot
    # loop stops re-assembling and re-uploading per-step state: feature
    # rows and per-lane policy vectors are PERSISTENT device buffers,
    # admits/retires stage splices, each bucket dispatch passes only the
    # step's default-rung scalars, and one fused_fog launch per span
    # returns (next, hops, energy) — no logits download, no host argmax,
    # no host pricing.  ``pipeline=True`` double-buffers the loop: step t's
    # dispatch is harvested at the START of step t+1, so the host's
    # refill/splice/bookkeeping for t+1 overlaps device compute of t.  The
    # request -> (slot, dispatch) mapping is IDENTICAL to the synchronous
    # mode (completions are processed before the next refill in both), so
    # the pipelined path is bit-equivalent under a fixed seed — only the
    # wall-clock interleaving changes (see tests/test_serve_equivalence).
    #
    # Telemetry is buffered and replayed in order every ``telemetry_every``
    # steps (and at :meth:`flush`): the governor/ledger/registry see
    # exactly the per-step batches they would have seen live, just later —
    # rung transitions therefore take effect at flush boundaries.

    def _step_packed(self) -> int:
        pc = time.perf_counter_ns
        t0 = pc()
        if self._inflight:
            self._process_harvest()
        t1 = pc()
        self._refill_packed()
        t2 = pc()
        self.phase_ns["refill"] += t2 - t1
        if self._n_active:
            self._dispatch_packed()
            t3 = pc()
            self.phase_ns["dispatch"] += t3 - t2
            if not self.pipeline:
                self._process_harvest()
        self.n_steps += 1
        return self._n_active

    def _refill_packed(self) -> None:
        if not self.queue or not self._free:
            return
        q, free = self.queue, self._free
        slots, occ_mask = self.slots, self._occ_mask
        registry, ledger = self.registry, self.ledger
        lane_key, bucket_lanes = self._lane_key, self._bucket_lanes
        heappop, popleft = heapq.heappop, q.popleft
        lanes, rows, thrs, buds = [], [], [], []
        n_admitted = 0
        while q and free:
            i = heappop(free)
            req = popleft()
            if (req.model is not None and req.version is None
                    and registry is not None):
                # pin the serving version at slot assignment, exactly like
                # the legacy refill (hot-swap never migrates in-flight work)
                req.version = registry.route(req.model, req.rid)
            slot = slots[i]
            slot.request = req
            slot.length = 1          # one resident feature row per slot
            occ_mask[i] = True
            n_admitted += 1
            pol = req.policy
            if pol is not None:
                thr, bud = lane_knobs(pol)
                prec = pol.precision
            else:
                rung = (None if ledger is None
                        else self._tenant_rung(req))
                if rung is not None:
                    # tenant-ledger lanes are stamped CONCRETE at their
                    # tenant's current rung (re-stamped when a flush
                    # transitions that governor); fleet-default lanes stay
                    # sentinels and track the rung at every dispatch
                    thr, bud = lane_knobs(rung)
                    prec = rung.precision
                else:
                    thr, bud = THRESH_DEFAULT, BUDGET_DEFAULT
                    prec = None
            lanes.append(i)
            rows.append(req.prompt)
            thrs.append(thr)
            buds.append(bud)
            key = (req.model, req.version, prec)
            lane_key[i] = key
            bucket = bucket_lanes.get(key)
            if bucket is None:
                bucket = bucket_lanes[key] = set()
            bucket.add(i)
        self._n_active += n_admitted
        if lanes:
            # one vectorized staging write per replica for the whole burst
            self.dispatcher.admit_lanes(
                np.asarray(lanes, np.int64),
                np.asarray(rows, np.float32), thrs, buds)

    def _retire_lane(self, i: int) -> None:
        """Host-side slot bookkeeping of one freed lane (the device-side
        dead-stamp is batched by the caller via ``retire_lanes``)."""
        s = self.slots[i]
        s.request = None
        s.length = 0
        self._occ_mask[i] = False
        self._n_active -= 1
        heapq.heappush(self._free, i)
        key = self._lane_key[i]
        if key is not None:
            self._bucket_lanes[key].discard(i)
            self._lane_key[i] = None

    def _dispatch_packed(self) -> None:
        default = (self.governor.current if self.governor is not None
                   else self.default_policy)
        def_thr = float(np.asarray(default.threshold))
        def_bud = (int(np.asarray(default.hop_budget))
                   if default.hop_budget is not None else NO_BUDGET)
        for key in list(self._bucket_lanes):
            lanes = self._bucket_lanes[key]
            if not lanes:
                del self._bucket_lanes[key]
                continue
            model, version, prec = key
            eff_prec = prec if prec is not None else default.precision
            bucket = None if model is None else (model, version)
            self.dispatcher.dispatch_packed(
                lanes, def_thr, def_bud, precision=eff_prec, bucket=bucket)
        self._inflight = True
        self._inflight_occ = np.flatnonzero(self._occ_mask)

    def _process_harvest(self) -> None:
        pc = time.perf_counter_ns
        t0 = pc()
        nxt, hops, energy, pend = self.dispatcher.harvest_packed(
            len(self.slots))
        self.last_dispatches = pend
        self._inflight = False
        occ = self._inflight_occ
        t1 = pc()
        self.phase_ns["harvest"] += t1 - t0
        occ_l = occ.tolist()
        nxt_l = nxt[occ].tolist()
        hops_l = hops[occ].tolist()
        now = time.perf_counter()
        reqs = []
        retired = []
        done_tiers: dict[str, int] = {}
        slots, eos = self.slots, self.eos_id
        completed_append = self.completed.append
        retire = self._retire_lane
        for j, i in enumerate(occ_l):
            s = slots[i]
            req = s.request
            reqs.append(req)
            tok = nxt_l[j]
            gen = req.generated
            gen.append(tok)
            req.hops.append(hops_l[j])
            s.length += 1
            if tok == eos or len(gen) >= req.max_new_tokens:
                req.done = True
                if req.t_submit is not None:
                    req.t_done = now
                tier = req.tier
                done_tiers[tier] = done_tiers.get(tier, 0) + 1
                completed_append(req)
                retire(i)
                retired.append(i)
        if done_tiers:
            self.stats.note_done_many(done_tiers)
        if retired:
            # one bulk dead-stamp per replica (an admit in the same step
            # simply overwrites the staged entry)
            self.dispatcher.retire_lanes(retired)
        t2 = pc()
        self.phase_ns["bookkeep"] += t2 - t1
        if occ.size:
            self._tel_buf.append((hops[occ], energy[occ], reqs, occ))
            self._steps_since_flush += 1
            if self._steps_since_flush >= self.telemetry_every:
                self._flush_telemetry()
        self.phase_ns["telemetry"] += pc() - t2

    def _flush_telemetry(self) -> None:
        """Replay the buffered per-step telemetry batches IN ORDER: the
        governor/ledger observe+step per batch exactly as the inline path
        would have, the fleet stats and registry per-version stats fold in
        the same events — deferral changes when the consumers see the
        telemetry (flush boundaries), never what they see."""
        buf, self._tel_buf = self._tel_buf, []
        self._steps_since_flush = 0
        if not buf:
            return
        ledger_trans = None
        if self.ledger is not None:
            govs = [g for _, g in self.ledger.items()]
            if self.ledger.default is not None:
                govs.append(self.ledger.default)
            ledger_trans = [(g, len(g.transitions)) for g in govs]
        fleet_batches = []
        for hops, energy, reqs, lanes in buf:
            tiers = [r.tier for r in reqs]
            devices = (self.dispatcher.lane_devices(lanes)
                       if self.dispatcher is not None else None)
            e = energy
            if self.governor is not None:
                fleet_batches.append((e, devices))
            elif self.ledger is not None:
                # per-tenant governance, NaN for lanes no governor bills —
                # identical grouping to the legacy inline _account
                e = energy.copy()
                by_tenant: dict[str | None, list[int]] = {}
                for i, r in enumerate(reqs):
                    by_tenant.setdefault(r.tenant, []).append(i)
                for tenant, idxs in by_tenant.items():
                    gov = self.ledger.governor_for(tenant)
                    if gov is None:
                        e[idxs] = np.nan
                        continue
                    gov.ingest([(e[idxs],
                                 None if devices is None
                                 else devices[idxs])])
            self.stats.update(hops, e, tiers=tiers)
            if self.registry is not None:
                by_version: dict[tuple, list[int]] = {}
                for i, r in enumerate(reqs):
                    if r.model is not None and r.version is not None:
                        by_version.setdefault(
                            (r.model, r.version), []).append(i)
                for (tenant, version), idxs in by_version.items():
                    self.registry.stats_for(tenant, version).update(
                        hops[idxs], e[idxs],
                        tiers=[tiers[i] for i in idxs])
        if self.governor is not None and fleet_batches:
            self.governor.ingest(fleet_batches)
        if ledger_trans is not None and any(
                len(g.transitions) != n for g, n in ledger_trans):
            # a tenant rung moved: its concrete lane stamps (and rung-
            # precision bucket keys) are stale — re-stamp the occupied
            # default-policy lanes
            self._restamp_default_lanes()

    def _restamp_default_lanes(self) -> None:
        lanes, thrs, buds = [], [], []
        for i in np.flatnonzero(self._occ_mask).tolist():
            req = self.slots[i].request
            if req is None or req.policy is not None:
                continue
            rung = self._tenant_rung(req)
            if rung is None:
                continue
            thr, bud = lane_knobs(rung)
            lanes.append(i)
            thrs.append(thr)
            buds.append(bud)
            key = (req.model, req.version, rung.precision)
            if key != self._lane_key[i]:
                self._bucket_lanes[self._lane_key[i]].discard(i)
                self._lane_key[i] = key
                self._bucket_lanes.setdefault(key, set()).add(i)
        if lanes:
            self.dispatcher.admit_lanes(lanes, None, thrs, buds)

    def flush(self) -> None:
        """Drain the pipelined loop: harvest any in-flight dispatch, then
        replay ALL buffered telemetry.  After flush() the governor/ledger/
        registry/stats state is exactly what the synchronous per-step loop
        would hold — call it before reading telemetry mid-run and once
        after the last step.  A no-op on the legacy (non-packed) path,
        which accounts inline."""
        if not self._packed:
            return
        if self._inflight:
            self._process_harvest()
        self._flush_telemetry()

    def step(self) -> int:
        """One decode step across all active slots.  Returns #active.

        On the packed path with ``pipeline=True`` this harvests the
        PREVIOUS step's dispatch and launches this step's — completions
        surface one ``step()`` call later; :meth:`flush` drains the tail.
        """
        if self._packed:
            return self._step_packed()
        self._refill()
        occ = [i for i, s in enumerate(self.slots) if s.request is not None]
        if not occ:
            return 0
        tokens = self._tokens
        lengths = self._lengths
        if self._policy_mode == "dispatch":
            # data-parallel plane: enqueue every (model, version,
            # precision) bucket without blocking (each replica on its own
            # stream), then harvest everything behind ONE synchronization
            base = self.lane_policy()
            for (model, version, prec), idxs in self._bucket_groups().items():
                pol = base if prec is None else base.replace(precision=prec)
                bucket = None if model is None else (model, version)
                self.dispatcher.dispatch(tokens, lengths, pol, idxs,
                                         bucket=bucket)
            logits, hops, self.last_dispatches = self.dispatcher.harvest(
                len(self.slots))
        elif self._policy_aware:
            base = self.lane_policy()
            groups = self._bucket_groups()
            n = len(self.slots)
            logits, hops = None, None
            for (model, version, prec), idxs in groups.items():
                pol = base if prec is None else base.replace(precision=prec)
                bucket = None if model is None else (model, version)
                lg, hp = self._call_decode(tokens, lengths, pol,
                                           bucket=bucket)
                if len(groups) == 1:
                    logits, hops = lg, hp
                    break
                if logits is None:
                    logits = np.zeros(tuple(lg.shape), np.float32)
                    hops = None if hp is None else np.zeros((n,), np.int64)
                idxs = np.asarray(idxs)
                logits[idxs] = _host(lg)[idxs]
                if hp is not None:
                    hops[idxs] = _host(hp)[idxs]
        else:
            logits, hops = self.decode_fn(torch.as_tensor(tokens),
                                          torch.as_tensor(lengths))
        if isinstance(logits, torch.Tensor):
            # the argmax on the logits' device; only [n_slots] comes back
            nxt = _host(torch.argmax(logits, dim=-1))
        else:
            # dispatcher harvests host-side; keep the argmax there too
            nxt = np.argmax(logits, axis=-1)
        hops = _host(hops) if hops is not None else None
        if hops is None and self.governor is not None:
            raise ValueError(
                "the governor needs hop telemetry but decode_fn returned "
                "hops=None; the energy SLO cannot be enforced")
        occa = np.asarray(occ, np.int64)
        self._tokens[occa] = nxt[occa]
        self._lengths[occa] += 1
        # bulk host conversion: per-item ``int(arr[i])`` reads are ~10x the
        # cost of one tolist() at serving-scale slot counts
        nxt_l = nxt.tolist()
        hops_l = hops.tolist() if hops is not None else None
        step_hops = []
        now = time.perf_counter()
        for i in occ:
            s = self.slots[i]
            req = s.request
            tok = nxt_l[i]
            req.generated.append(tok)
            if hops_l is not None:
                h = hops_l[i]
                req.hops.append(h)
                step_hops.append((h, req, i))
            s.length += 1
            if tok == self.eos_id or len(req.generated) >= req.max_new_tokens:
                req.done = True
                if req.t_submit is not None:
                    req.t_done = now
                self.stats.note_done(req.tier)
                self.completed.append(req)
                self.slots[i] = SlotState()
                self._tokens[i] = 0
                self._lengths[i] = 0
        if step_hops:
            self._account(step_hops)
        return self.active

    def _call_decode(self, tokens, lengths, pol, bucket=None):
        """One decode dispatch, honoring the fn's policy calling convention
        (positional third arg vs KEYWORD_ONLY ``policy``) and passing the
        (model, version) bucket only to bucket-aware fns."""
        kw = {}
        if bucket is not None:
            kw["bucket"] = bucket
        if self._policy_mode == "keyword":
            return self.decode_fn(torch.as_tensor(tokens),
                                  torch.as_tensor(lengths), policy=pol, **kw)
        return self.decode_fn(torch.as_tensor(tokens),
                              torch.as_tensor(lengths), pol, **kw)

    def _account(self, step_hops: list) -> None:
        """Fold one step's active-lane (hops, request, lane) tuples into
        the fleet telemetry and let the governance plane react.  Each lane
        is priced at ITS OWN effective precision — the request policy's,
        falling back to its billing governor's active rung — so
        mixed-precision batches are billed at the byte widths they
        actually dispatched and an int8 step-down shows up as a measured
        saving.  With a TenantLedger the telemetry is grouped by tenant
        first: each tenant's governor sees only its own traffic, so one
        tenant's expensive burst can never walk another tenant's ladder.
        On the data-parallel plane each sample is additionally labeled
        with its serving device for per-device rolling estimates; with a
        registry, each (tenant, version) group also feeds its per-version
        ServeStats (the canary-judging evidence)."""
        hops = np.asarray([h for h, _, _ in step_hops])
        tiers = [req.tier for _, req, _ in step_hops]
        lanes = [lane for _, _, lane in step_hops]
        devices = (self.dispatcher.lane_devices(lanes)
                   if self.dispatcher is not None else None)
        energy_pj = None

        def price_into(out, gov, entries):
            """Price ``entries`` (index, req) with one governor, grouping
            by effective precision (one lane_pj call per precision)."""
            rung_prec = gov.current.precision
            groups: dict[str | None, list[int]] = {}
            for i, req in entries:
                prec = (req.policy.precision if req is not None
                        and req.policy is not None else None)
                groups.setdefault(
                    prec if prec is not None else rung_prec, []).append(i)
            for prec, idxs in groups.items():
                out[idxs] = np.asarray(
                    gov.model_for(prec).lane_pj(hops[idxs]))

        if self.governor is not None:
            energy_pj = np.empty(len(step_hops), np.float64)
            price_into(energy_pj, self.governor,
                       [(i, req) for i, (_, req, _) in enumerate(step_hops)])
            self.governor.observe(energy_pj=energy_pj, devices=devices)
            self.governor.step()
        elif self.ledger is not None:
            # per-tenant governance: group by tenant, price each group at
            # its own governor's models, observe/step each independently.
            # NaN marks lanes no governor bills (unledgered tenant, no
            # default) — counted as events, excluded from energy means.
            energy_pj = np.full(len(step_hops), np.nan)
            by_tenant: dict[str | None, list[int]] = {}
            for i, (_, req, _) in enumerate(step_hops):
                by_tenant.setdefault(req.tenant, []).append(i)
            for tenant, idxs in by_tenant.items():
                gov = self.ledger.governor_for(tenant)
                if gov is None:
                    continue
                price_into(energy_pj, gov,
                           [(i, step_hops[i][1]) for i in idxs])
                gov.observe(energy_pj=energy_pj[idxs],
                            devices=None if devices is None
                            else devices[idxs])
                gov.step()
        self.stats.update(hops, energy_pj, tiers=tiers)
        if self.registry is not None:
            by_version: dict[tuple, list[int]] = {}
            for i, (_, req, _) in enumerate(step_hops):
                if req.model is not None and req.version is not None:
                    by_version.setdefault(
                        (req.model, req.version), []).append(i)
            for (tenant, version), idxs in by_version.items():
                self.registry.stats_for(tenant, version).update(
                    hops[idxs],
                    None if energy_pj is None else energy_pj[idxs],
                    tiers=[tiers[i] for i in idxs])

    def run(self, max_steps: int = 10000) -> list[Request]:
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            self.step()
            steps += 1
        self.flush()
        return self.completed
