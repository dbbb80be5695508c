"""FogEngine — Algorithm 2 with pluggable backends (port of
``repro.core.engine``).

==============  =============================================================
backend         per-hop update implementation
==============  =============================================================
``reference``   plain PyTorch (``kernels.ref.grove_aggregate_ref``), the
                oracle; runs on any device
``pallas``      the per-hop kernel backend: the grove walk in PyTorch, then
                the fused hop-update CUDA kernel (``kernels.ops
                .grove_aggregate``) — one launch per hop.  The name is the
                JAX package's, which saved artifacts carry
``fused``       the ENTIRE Algorithm-2 loop in one CUDA launch
                (``kernels.ops.fused_fog``)
``ring``        the grove ring (``core.fog_ring``) over a ``RingMesh``:
                groves pinned to shards, lanes forwarded one shard per hop;
                with ``use_kernels`` each hop is one ``tree_traverse``
                launch over every stacked shard and one ``grove_aggregate``
==============  =============================================================

Every runtime knob lives in a :class:`~repro_torch.core.policy.FogPolicy`;
the canonical call is

    engine.eval(x, generator, policy=FogPolicy(threshold=0.3))

where ``generator`` is a ``torch.Generator`` that draws each lane's start
grove.  ``eval(x, start=...)`` takes the draws instead (the tests feed the
JAX package's own draws through it).  Every backend runs the identical
update math, so labels and per-lane hop counts are bit-identical across
backends for the same starts.

On a CPU engine (``device="cpu"``) the kernel backends run the kernels'
plain versions; on a CUDA engine they launch the kernels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.confidence import maxdiff
from repro_torch.core.energy import EnergyModel, EnergyReport
from repro_torch.core.fog_ring import RingMesh, ring_eval
from repro_torch.core.grove import GroveCollection
from repro_torch.core.policy import PRECISIONS, FogPolicy, check_backend
from repro_torch.forest.pack import ForestPack
from repro_torch.kernels import autotune, ops, ref
from repro_torch.kernels._build import check_block
from repro_torch.kernels.fused_fog import FUSED_BLOCK_B  # noqa: F401

# CUDA threads per block of the per-hop kernels when nothing chooses one
# (the fused kernel's come from kernels/autotune.py::best_config)
DEFAULT_BLOCK_B = 256


@dataclasses.dataclass(frozen=True)
class FogResult:
    """The one result contract every backend returns.

    proba: [B, C] (or [B, O, C] multi-output) final normalized probabilities
    label: [B]    (or [B, O]) argmax labels
    hops:  [B]    groves that processed each example, 1-based — the energy
                  quantity
    """
    proba: torch.Tensor
    label: torch.Tensor
    hops: torch.Tensor


@dataclasses.dataclass(frozen=True)
class EvalReport(FogResult):
    """What ``FogEngine.eval`` returns: the FogResult contract plus energy.

    energy_pj: [B] estimated pJ per example — ``model.lane_pj(hops)``,
               computed on the evaluation's device
    model:     the :class:`~repro_torch.core.energy.EnergyModel` it was
               priced with (topology + the precision the evaluation ran at)
    """
    energy_pj: torch.Tensor = None
    model: EnergyModel = None

    @property
    def precision(self) -> str:
        return self.model.precision

    @property
    def mean_energy_pj(self) -> float:
        return float(self.energy_pj.mean())

    @property
    def mean_energy_nj(self) -> float:
        return self.mean_energy_pj * 1e-3

    def energy_report(self) -> EnergyReport:
        """Float64 post-hoc report over this evaluation's hops."""
        return self.model.report(self.hops.cpu().numpy())


def _as_tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A tensor on ``device``; host arrays are copied (they may be
    read-only views, e.g. of JAX arrays)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def sample_starts(generator: torch.Generator, B: int, G: int,
                  device=None, *, n_shards: int = 1) -> torch.Tensor:
    """Random start grove per example (Algorithm 2 line 3): int32 [B],
    uniform over [0, G), drawn on the generator's device.

    For an ``n_shards`` ring the draw is stratified: exactly B/n lanes
    start in each residue class ``start % n``, so the shards' queues are
    equal, while each lane stays uniform over all G groves.  ``n_shards=1``
    is the plain draw.
    """
    gd = generator.device
    if n_shards == 1:
        start = torch.randint(0, G, (B,), generator=generator, device=gd,
                              dtype=torch.int32)
    else:
        if B % n_shards or G % n_shards:
            raise ValueError(
                f"batch B={B} and n_groves G={G} must both divide over "
                f"{n_shards} ring shards")
        shard = torch.arange(n_shards, dtype=torch.int32, device=gd).repeat(
            B // n_shards)
        shard = shard[torch.randperm(B, generator=generator, device=gd)]
        offset = torch.randint(0, G // n_shards, (B,), generator=generator,
                               device=gd, dtype=torch.int32)
        start = shard + n_shards * offset
    return start.to(device) if device is not None else start


def hop_update(prob, contrib, live, hops, thresh, *, backend: str = "reference",
               block_b: int = DEFAULT_BLOCK_B):
    """One Algorithm-2 hop update (lines 7-11), dispatched by backend.

    ``thresh`` is a scalar or per-lane ``[B]`` vector.  Returns
    (prob, hops, live, margin).
    """
    _check_step_backend(backend)
    if backend == "pallas":
        return ops.grove_aggregate(prob, contrib, live, hops, thresh,
                                   block_b=block_b)
    return ref.grove_aggregate_ref(prob, contrib, live, hops, thresh)


def confidence_margin(probs: torch.Tensor, *, backend: str = "reference",
                      block_b: int = DEFAULT_BLOCK_B) -> torch.Tensor:
    """MaxDiff margin [..., C] -> [...]; "pallas" routes the top-2 kernel."""
    _check_step_backend(backend)
    if backend == "pallas" and probs.ndim == 2:
        return ops.top2_confidence(probs, block_b=block_b)
    return maxdiff(probs)


def _check_step_backend(backend: str) -> None:
    if backend not in ("reference", "pallas"):
        raise ValueError(f"unknown step backend {backend!r}; "
                         "pick 'reference' or 'pallas'")


# --------------------------------------------------------------------------
# evaluation core.  Multi-output heads are flattened to [B*O, C] so the same
# hop update serves both; the min-over-outputs rule is applied on margins.
# --------------------------------------------------------------------------

def _contrib(pack: ForestPack, g_idx, x):
    """Per-hop grove contribution, flattened over output heads: [B*O, C]."""
    if pack.n_heads == 1:
        return pack.predict_proba(0, g_idx, x)
    rows = [pack.predict_proba(o, g_idx, x) for o in range(pack.n_heads)]
    return torch.stack(rows, dim=1).reshape(-1, pack.n_classes)


def _repeat_lanes(v, n_out):
    """[B] lane state -> [B*O] (each head shares its lane's liveness)."""
    return v if n_out == 1 else torch.repeat_interleave(v, n_out)


def _step(pack, x, start, thresh, budget, j, prob, live, hops, backend,
          block_b):
    """Shared hop body: returns updated (prob, live, hops) for [B*O, C]."""
    O = pack.n_heads
    g_idx = (start.to(torch.long) + j) % pack.n_groves
    contrib = _contrib(pack, g_idx, x)
    prob, hops_f, live_f, margin = hop_update(
        prob, contrib, _repeat_lanes(live, O), _repeat_lanes(hops, O),
        _repeat_lanes(thresh, O), backend=backend, block_b=block_b)
    if O == 1:
        return prob, live_f & (hops_f < budget), hops_f
    # min-over-outputs rule: a lane stays live until EVERY head is confident
    margin = margin.reshape(-1, O).amin(dim=1)
    hops = hops_f.reshape(-1, O)[:, 0]
    live = live & (margin < thresh) & (hops < budget)
    return prob, live, hops


def _eval_core(pack: ForestPack, x, start, thresh, budget, max_hops: int,
               backend: str, block_b: int, lazy: bool, *,
               route: str | None = None,
               hops_per_walk: int | None = None) -> FogResult:
    """One evaluation of the whole batch.  ``route`` and ``hops_per_walk``
    (the fused backend's; ``None``: the launch rule's) come from
    :func:`repro_torch.kernels.autotune.best_config`."""
    B = x.shape[0]
    O = pack.n_heads
    C = pack.n_classes
    if backend == "fused":
        # the whole early-exit state machine runs inside ONE kernel launch;
        # `lazy` is moot (each lane's loop exits when the lane dies)
        feat, thr, leaf, ts, ls = pack.layout("fused")
        proba, hops = ops.fused_fog(feat, thr, leaf, x, start, thresh, budget,
                                    ts, ls, max_hops=max_hops,
                                    block_b=block_b, route=route,
                                    hops_per_walk=hops_per_walk)
        if O == 1:
            proba = proba[:, 0]
        return FogResult(proba=proba,
                         label=torch.argmax(proba, dim=-1).to(torch.int32),
                         hops=hops)
    dev = x.device
    prob = torch.zeros((B * O, C), dtype=torch.float32, device=dev)
    live = torch.ones((B,), dtype=torch.bool, device=dev)
    hops = torch.zeros((B,), dtype=torch.int32, device=dev)
    for j in range(max_hops):
        if lazy and not bool(live.any()):
            break
        prob, live, hops = _step(pack, x, start, thresh, budget, j, prob,
                                 live, hops, backend, block_b)
    denom = torch.clamp(_repeat_lanes(hops, O), min=1)[:, None]
    prob_norm = prob / denom.to(torch.float32)
    if O > 1:
        prob_norm = prob_norm.reshape(B, O, C)
    return FogResult(proba=prob_norm,
                     label=torch.argmax(prob_norm, dim=-1).to(torch.int32),
                     hops=hops)


# --------------------------------------------------------------------------
# device-resident lane state (the serving plane's splice path)
# --------------------------------------------------------------------------

def _lane_index(idx, device: torch.device) -> torch.Tensor:
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.long).reshape(-1)
    return torch.as_tensor(np.asarray(idx, np.int64).reshape(-1),
                           device=device)


def _lane_values(vals, like: torch.Tensor) -> torch.Tensor:
    if isinstance(vals, torch.Tensor):
        return vals.to(device=like.device, dtype=like.dtype)
    return torch.as_tensor(np.asarray(vals), device=like.device).to(
        like.dtype)


def _splice_into(buf: torch.Tensor, idx: torch.Tensor, vals,
                 donate: bool) -> torch.Tensor:
    n = buf.shape[0]
    if idx.numel() > n:
        raise ValueError(f"splice of {idx.numel()} lanes into a {n}-lane "
                         "buffer")
    out = buf if donate else buf.clone()
    return out.index_copy_(0, idx, _lane_values(vals, buf))


def splice_lanes(buf: torch.Tensor, idx, vals, *,
                 donate: bool = True) -> torch.Tensor:
    """Row update ``buf[idx] = vals`` of a device-resident lane buffer.

    With ``donate=True`` (the default) ``buf`` is updated in place
    (``index_copy_``) and returned.  Pass ``donate=False`` when another
    reader may still need ``buf`` as it was — a dispatch on another stream,
    or a caller holding the old state: a new tensor is returned and ``buf``
    stays readable and unchanged (one buffer copy, trivial at per-span
    row-buffer sizes).  On one stream an in-place splice enqueued after a
    launch is ordered after it, so the serving replicas donate.

    ``idx`` and ``vals`` may be host arrays or tensors; host values are
    copied to ``buf``'s device.
    """
    idx = _lane_index(idx, buf.device)
    if idx.numel() == 0:
        return buf
    return _splice_into(buf, idx, vals, donate)


def splice_slot_state(x: torch.Tensor, thr: torch.Tensor, bud: torch.Tensor,
                      idx, rows, t, b, *, donate: bool = True):
    """:func:`splice_lanes` over a replica's THREE slot buffers (feature
    rows, thresholds, hop budgets) sharing ONE lane index set, moved to the
    device once.  Same contract: ``donate=True`` updates the three in place
    and returns them; ``donate=False`` returns three new tensors and leaves
    the sources unchanged."""
    idx = _lane_index(idx, x.device)
    if idx.numel() == 0:
        return x, thr, bud
    return (_splice_into(x, idx, rows, donate),
            _splice_into(thr, idx, t, donate),
            _splice_into(bud, idx, b, donate))


# --------------------------------------------------------------------------
# packed-table ownership
# --------------------------------------------------------------------------

class TableCache:
    """One :class:`ForestPack` per precision on the engine's device."""

    def __init__(self, gcs_fn, device: torch.device):
        # a zero-arg callable, not the groves themselves: an engine seeded
        # with a loaded pack serves it without ever materializing fp32
        # tables — groves are only realized if ANOTHER precision is asked
        self._gcs_fn = gcs_fn
        self.device = device
        self._packs: dict[str, ForestPack] = {}

    def seed(self, pack: ForestPack) -> None:
        """Adopt an existing pack as the cached entry for its precision."""
        self._packs[pack.precision] = pack.to(self.device)

    def pack(self, precision: str) -> ForestPack:
        """The packed tables at ``precision`` (built on first use)."""
        if precision not in self._packs:
            gcs = self._gcs_fn()
            gc = gcs if len(gcs) > 1 else gcs[0]
            self._packs[precision] = ForestPack.from_groves(
                gc, precision).to(self.device)
        return self._packs[precision]


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

class FogEngine:
    """Owns the Algorithm-2 state machine; backends plug in the hop update.

    gc:        GroveCollection, a tuple of them (multi-output heads with
               identical (n_groves, grove_size)), or a
               :class:`~repro_torch.forest.pack.ForestPack` (adopted into
               the table cache; its precision becomes the engine default).
    device:    where tables live and evaluation runs; default ``"cuda"``,
               which raises without a card — pass ``device="cpu"`` for the
               plain PyTorch path.
    policy:    default :class:`FogPolicy` for ``eval`` calls without one.
               A per-call policy REPLACES it; only its None-valued knobs
               fall back to the engine defaults below.
    mesh:      a :class:`~repro_torch.core.fog_ring.RingMesh`, required by
               the ring backend; ``n_groves`` must divide over its shards.
    use_kernels: ring only -- walk each shard's grove with the
               tree_traverse kernel and update with the grove_aggregate
               kernel (needs one grove per shard).
    """

    def __init__(self, gc, *, backend: str = "reference",
                 block_b: int | None = None,
                 chunk_b: int | str | None = None,
                 mesh: RingMesh | None = None, use_kernels: bool = False,
                 lazy: bool = False, policy: FogPolicy | None = None,
                 precision: str | None = None, device=None):
        check_backend(backend)
        self.device = resolve_device(device)
        self._seed_pack = gc if isinstance(gc, ForestPack) else None
        if self._seed_pack is not None:
            self._gcs = None
        else:
            self._gcs = (tuple(gc) if isinstance(gc, (tuple, list))
                         else (gc,))
            g0 = self._gcs[0]
            for g in self._gcs[1:]:
                if (g.n_groves, g.grove_size) != (g0.n_groves,
                                                  g0.grove_size):
                    raise ValueError(
                        "multi-output heads need identical (n_groves, "
                        f"grove_size); got {(g.n_groves, g.grove_size)} vs "
                        f"{(g0.n_groves, g0.grove_size)}")
        if precision is None:
            precision = (self._seed_pack.precision
                         if self._seed_pack is not None else "fp32")
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}; "
                             f"pick from {PRECISIONS}")
        self.backend = backend
        self.block_b = block_b
        self.chunk_b = chunk_b
        self.precision = precision
        self.mesh = mesh
        self.use_kernels = use_kernels
        self.lazy = lazy
        self.policy = policy if policy is not None else FogPolicy()
        self.tables = TableCache(lambda: self.gcs, self.device)
        self._energy_models: dict[tuple[str, int], EnergyModel] = {}
        self._n_features: int | None = None
        self._checked: set[tuple[str, int]] = set()
        if self._seed_pack is not None:
            self.tables.seed(self._seed_pack)
        if use_kernels and backend != "ring":
            raise ValueError("use_kernels applies to the ring backend only "
                             "(the pallas backend always runs the hop-"
                             "update kernel)")
        if backend == "ring":
            self._check_ring_config(lazy=lazy, chunk_b=chunk_b)

    def _check_ring_config(self, *, lazy: bool, chunk_b) -> None:
        if self.mesh is None:
            raise ValueError("ring backend needs a mesh (a RingMesh)")
        if self.multi_output:
            raise NotImplementedError("ring backend is single-output")
        if lazy or chunk_b is not None:
            raise ValueError("lazy/chunk_b are not supported on the ring "
                             "backend (the ring always runs the fixed "
                             "max_hops rotation schedule)")
        n_shards = self.mesh.n_shards
        if self.n_groves % n_shards:
            raise ValueError(f"n_groves={self.n_groves} not divisible by "
                             f"{n_shards} ring shards")
        if self.use_kernels and self.n_groves != n_shards:
            raise ValueError("use_kernels needs one grove per shard (the "
                             "multi-grove gather path has no tree_traverse "
                             "kernel)")

    # -- properties ------------------------------------------------------
    @property
    def gcs(self) -> tuple[GroveCollection, ...]:
        """Per-head GroveCollections; for a pack-seeded engine these are
        dequantized fp32 views, realized only on first access."""
        if self._gcs is None:
            self._gcs = self._seed_pack.to_groves()
        return self._gcs

    @property
    def n_groves(self) -> int:
        if self._seed_pack is not None:
            return self._seed_pack.n_groves
        return self._gcs[0].n_groves

    @property
    def n_shards(self) -> int:
        """Ring shards the start draw is stratified over (1 off the ring)."""
        if self.backend == "ring" and self.mesh is not None:
            return self.mesh.n_shards
        return 1

    @property
    def multi_output(self) -> bool:
        if self._seed_pack is not None:
            return self._seed_pack.n_heads > 1
        return len(self._gcs) > 1

    # -- policy resolution ----------------------------------------------
    def resolve(self, policy: FogPolicy | None = None) -> FogPolicy:
        """Fill a policy's None knobs from the engine defaults."""
        p = policy if policy is not None else self.policy
        backend = p.backend if p.backend is not None else self.backend
        block_b = p.block_b if p.block_b is not None else self.block_b
        # left None on the fused backend: the evaluation then consults
        # kernels/autotune.py::best_config for the batch it is given
        if block_b is None and backend != "fused":
            block_b = DEFAULT_BLOCK_B
        return p.replace(
            max_hops=p.max_hops if p.max_hops is not None else self.n_groves,
            backend=backend,
            block_b=block_b,
            chunk_b=p.chunk_b if p.chunk_b is not None else self.chunk_b,
            lazy=p.lazy if p.lazy is not None else self.lazy,
            precision=(p.precision if p.precision is not None
                       else self.precision))

    # -- evaluation ------------------------------------------------------
    def eval(self, x, generator: torch.Generator | None = None, *,
             policy: FogPolicy | None = None,
             start=None) -> EvalReport:
        """GCEval(X, policy) — Algorithm 2, any backend.

        Start groves come from ``generator`` (a ``torch.Generator``), or
        are given as ``start`` (int ``[B]``).  On the ring the draw is
        stratified over the mesh's shards, and given starts must be.
        """
        p = self.resolve(policy)
        if p.block_b is not None:
            check_block(p.block_b)
        ring = p.backend == "ring"
        if ring:
            self._check_ring_config(lazy=bool(p.lazy), chunk_b=p.chunk_b)
        x = _as_tensor(x, torch.float32, self.device)
        B = x.shape[0]
        thresh_v = p.lane_thresholds(B, self.device)
        budget_v = p.lane_budgets(B, self.device)
        if start is None:
            if generator is None:
                raise ValueError("pass a torch.Generator (or start=) to draw "
                                 "the start groves")
            start = sample_starts(generator, B, self.n_groves, self.device,
                                  n_shards=self.mesh.n_shards if ring else 1)
        else:
            start = _as_tensor(start, torch.int32, self.device)
            if tuple(start.shape) != (B,):
                raise ValueError(f"start has shape {tuple(start.shape)}, "
                                 f"batch is {B}")
        pack = self._checked_pack(p.precision, x.shape[1])
        if ring:
            res = self._eval_ring(pack, x.contiguous(), start, thresh_v,
                                  budget_v, p.max_hops)
        else:
            res = self._eval_chunked(pack, x.contiguous(), start.contiguous(),
                                     thresh_v, budget_v, p)
        self._n_features = int(x.shape[1])
        model = self.energy_model(p.precision, x.shape[1])
        return EvalReport(proba=res.proba, label=res.label, hops=res.hops,
                          energy_pj=model.lane_pj(res.hops), model=model)

    def energy_model(self, precision: str | None = None,
                     n_features: int | None = None) -> EnergyModel:
        """The engine's :class:`EnergyModel` at ``precision`` (default: the
        engine default precision).  ``n_features`` defaults to the last
        evaluation's; pass it explicitly when pricing before any eval."""
        precision = precision if precision is not None else self.precision
        if n_features is None:
            n_features = self._n_features
            if n_features is None:
                raise ValueError(
                    "n_features unknown before the first eval; pass "
                    "energy_model(precision, n_features=...) explicitly")
        key = (precision, int(n_features))
        model = self._energy_models.get(key)
        if model is None:
            model = EnergyModel.from_pack(
                self.tables.pack(precision), n_features)
            self._energy_models[key] = model
        return model

    def _checked_pack(self, precision: str, F: int) -> ForestPack:
        """The pack at ``precision``, checked once per input width."""
        pack = self.tables.pack(precision)
        if (precision, F) not in self._checked:
            # the kernels gather x[b, feature] unchecked: a pack (e.g. a
            # loaded artifact) must only name features the input has
            lo, hi = int(pack.feature.min()), int(pack.feature.max())
            if lo < 0 or hi >= F:
                raise ValueError(f"the forest tests features {lo}..{hi} but "
                                 f"the input has {F}")
            self._checked.add((precision, F))
        return pack

    def _eval_ring(self, pack: ForestPack, x, start, thresh, budget,
                   max_hops: int) -> FogResult:
        proba, hops = ring_eval(
            pack, x, start, thresh, max_hops, self.mesh,
            use_kernels=self.use_kernels,
            tables=pack.layout("ring", self.mesh.n_shards), hop_budget=budget)
        return FogResult(proba=proba,
                         label=torch.argmax(proba, dim=-1).to(torch.int32),
                         hops=hops)

    def _eval_chunked(self, pack: ForestPack, x, start, thresh, budget,
                      p: FogPolicy) -> FogResult:
        """The evaluation, split into chunks where a chunk size applies.

        On the fused backend an unset ``block_b`` takes the route, K and
        threads of :func:`~repro_torch.kernels.autotune.best_config` for
        this batch, and ``chunk_b`` None or ``"auto"`` its chunk (only a
        measured entry has one).  An explicit ``block_b`` or int
        ``chunk_b`` is honoured as it is (the launch rule picks route and
        K).  Elsewhere ``"auto"`` never chunks."""
        B = x.shape[0]
        block_b, cb, kw = p.block_b, p.chunk_b, {}
        if p.backend == "fused" and (block_b is None
                                     or not isinstance(cb, int)):
            cfg = autotune.best_config(pack, x.shape[1], B, p.max_hops,
                                       self.device)
            if block_b is None:
                block_b = cfg.block_b
                kw = {"route": cfg.route, "hops_per_walk": cfg.hops_per_walk}
            if not isinstance(cb, int):
                cb = cfg.chunk_b
        if not isinstance(cb, int):
            cb = None
        return run_chunked(
            lambda *a: _eval_core(pack, *a, p.max_hops, p.backend, block_b,
                                  p.lazy, **kw),
            x, start, thresh, budget, cb)


def fused_eval(pack: ForestPack, x, start, thresh, budget, max_hops: int,
               cfg: "autotune.TuneResult") -> FogResult:
    """The fused evaluation on ``cfg``'s route, K, threads and chunk (what
    ``FogEngine`` runs when ``best_config`` returns ``cfg``)."""
    return run_chunked(lambda *a: _eval_core(
        pack, *a, max_hops, "fused", cfg.block_b, False, route=cfg.route,
        hops_per_walk=cfg.hops_per_walk), x, start, thresh, budget,
        cfg.chunk_b)


def run_chunked(core, x, start, thresh, budget, cb: int | None) -> FogResult:
    """``core(x, start, thresh, budget)`` over the whole batch, or over
    chunks of ``cb`` lanes, concatenated."""
    B = x.shape[0]
    if cb is None or B <= cb:
        return core(x, start, thresh, budget)
    pad = (-B) % cb
    if pad:  # dead-pad the tail chunk: padded lanes get thresh=-1 /
        # budget=1, so any margin clears the gate and they die on hop 1
        x = torch.cat([x, x[:1].expand(pad, -1)])
        start = torch.cat([start, start.new_zeros((pad,))])
        thresh = torch.cat([thresh, thresh.new_full((pad,), -1.0)])
        budget = torch.cat([budget, budget.new_ones((pad,))])
    chunks = [core(x[i:i + cb], start[i:i + cb], thresh[i:i + cb],
                   budget[i:i + cb])
              for i in range(0, B + pad, cb)]
    return FogResult(*(torch.cat([getattr(c, f) for c in chunks])[:B]
                       for f in ("proba", "label", "hops")))
