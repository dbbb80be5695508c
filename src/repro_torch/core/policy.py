"""FogPolicy — the runtime-knob contract for Algorithm-2 evaluation (port
of ``repro.core.policy``).

===============  ============================================================
knob             meaning
===============  ============================================================
``threshold``    MaxDiff confidence gate — a scalar for the whole batch, or a
                 per-lane ``[B]`` vector
``max_hops``     global hop cap; None = n_groves
``hop_budget``   per-lane hop cap — scalar or ``[B]`` int; a lane stops
                 hopping once it has consumed its budget even if unconfident
``backend``      "reference" | "pallas" | "fused" | "ring"; None = engine
                 default.  "pallas" names the per-hop kernel backend (the
                 name the JAX package writes into saved artifacts); "ring"
                 needs an engine built with a ``RingMesh``
``block_b``      CUDA threads per block (a multiple of 32, at most 1024;
                 for the fused kernel the most a block runs); None =
                 engine default (fused: the autotuner's pick, with its
                 route and K; ``kernels/autotune.py``)
``chunk_b``      batch chunking: an int, ``"auto"`` or None (fused: chunk
                 where a measured autotuner entry says so; elsewhere
                 never)
``lazy``         stop the per-hop loop once every lane is dead, instead of
                 running all ``max_hops`` hops; None = engine default
``precision``    packed-table dtype: "fp32" | "bf16" | "int8"
===============  ============================================================
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.forest.pack import PRECISIONS  # noqa: F401  (re-export)

BACKENDS = ("reference", "pallas", "fused", "ring")

# per-lane "no budget" sentinel: hops < NO_BUDGET is always true for any
# reachable hop count, so unbudgeted lanes are capped by max_hops alone
NO_BUDGET = 2**31 - 1

# knobs of the JAX package's policy dicts that only steer its Pallas kernels
_TPU_ONLY_KNOBS = ("interpret", "compact")


def margin_backend(backend: "str | None") -> str:
    """The confidence-margin implementation the LM early-exit gate runs
    for an engine backend: the kernel-flavoured backends ("pallas",
    "fused") route the top-2 kernel, every other (incl. "ring", which has
    no meaning for the layer-grove gate) the plain reference."""
    return "pallas" if backend in ("pallas", "fused") else "reference"


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; pick from {BACKENDS}")


@dataclasses.dataclass(frozen=True)
class FogPolicy:
    """Every runtime knob of one Algorithm-2 evaluation, in one object."""

    threshold: float | torch.Tensor = 0.3
    max_hops: int | None = None
    hop_budget: int | torch.Tensor | None = None
    backend: str | None = None
    block_b: int | None = None
    chunk_b: int | str | None = None
    lazy: bool | None = None
    precision: str | None = None

    def __post_init__(self):
        if self.backend is not None:
            check_backend(self.backend)
        if self.precision is not None and self.precision not in PRECISIONS:
            raise ValueError(f"unknown precision {self.precision!r}; "
                             f"pick from {PRECISIONS} (or None)")
        if self.max_hops is not None and self.max_hops < 1:
            raise ValueError(f"max_hops must be >= 1, got {self.max_hops}")
        if isinstance(self.chunk_b, str):
            if self.chunk_b != "auto":
                raise ValueError(f"chunk_b must be an int, 'auto' or None, "
                                 f"got {self.chunk_b!r}")
        elif self.chunk_b is not None and self.chunk_b < 1:
            raise ValueError(f"chunk_b must be >= 1, got {self.chunk_b}")
        # a lane always spends its first hop before any gate can fire, so a
        # budget below 1 is unsatisfiable
        if self.hop_budget is not None:
            if bool((torch.as_tensor(self.hop_budget) < 1).any()):
                raise ValueError(
                    f"hop_budget must be >= 1 everywhere (the first hop is "
                    f"always spent), got {self.hop_budget}")

    def replace(self, **kw) -> "FogPolicy":
        """A copy with some knobs changed (frozen dataclass idiom)."""
        return dataclasses.replace(self, **kw)

    @property
    def per_lane(self) -> bool:
        """True when threshold or hop_budget carries a per-lane vector."""
        return (getattr(self.threshold, "ndim", 0) > 0
                or getattr(self.hop_budget, "ndim", 0) > 0)

    @property
    def static_overrides(self) -> tuple[str, ...]:
        """Names of the static knobs this policy sets (non-None).  Static
        knobs select the evaluation path, so contexts that share one path
        across many policies (the serving scheduler) reject them on
        per-request policies — except ``precision``, which the scheduler
        handles by dispatching once per precision group."""
        return tuple(k for k in ("max_hops", "backend", "block_b",
                                 "chunk_b", "lazy", "precision")
                     if getattr(self, k) is not None)

    # -- persistence -----------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-safe scalar-knob dict.  Per-lane policies are batch-shaped
        state and refuse to serialize."""
        if self.per_lane:
            raise ValueError(
                "cannot serialize a per-lane policy (its threshold/"
                "hop_budget vectors are batch-shaped)")

        def scalar(v):
            if isinstance(v, torch.Tensor):
                return v.item()
            return v if v is None else np.asarray(v).item()

        return {"threshold": scalar(self.threshold),
                "max_hops": self.max_hops,
                "hop_budget": scalar(self.hop_budget),
                "backend": self.backend, "block_b": self.block_b,
                "chunk_b": self.chunk_b, "lazy": self.lazy,
                "precision": self.precision}

    @classmethod
    def from_dict(cls, d: dict) -> "FogPolicy":
        """Inverse of :meth:`to_dict`.  Also reads the JAX package's dicts,
        whose TPU-only ``interpret`` and ``compact`` knobs have no meaning
        here (one thread per lane already stops walking dead lanes)."""
        return cls(**{k: v for k, v in d.items()
                      if k not in _TPU_ONLY_KNOBS})

    # -- lane-vector materialization (the engine's single entry) ---------
    def lane_thresholds(self, B: int, device=None) -> torch.Tensor:
        """``threshold`` as a per-lane float32 ``[B]`` tensor on ``device``."""
        t = torch.as_tensor(self.threshold, dtype=torch.float32,
                            device=device)
        if t.ndim == 0:
            return t.expand(B).contiguous()
        if tuple(t.shape) != (B,):
            raise ValueError(
                f"per-lane threshold has shape {tuple(t.shape)}, batch is {B}")
        return t.contiguous()

    def lane_budgets(self, B: int, device=None) -> torch.Tensor:
        """``hop_budget`` as a per-lane int32 ``[B]`` tensor (NO_BUDGET where
        unset — the max_hops bound still applies)."""
        if self.hop_budget is None:
            return torch.full((B,), NO_BUDGET, dtype=torch.int32,
                              device=device)
        b = torch.as_tensor(self.hop_budget, dtype=torch.int32, device=device)
        if b.ndim == 0:
            return b.expand(B).contiguous()
        if tuple(b.shape) != (B,):
            raise ValueError(
                f"per-lane hop_budget has shape {tuple(b.shape)}, batch is {B}")
        return b.contiguous()


# -- device-resident per-lane policy state (the packed serving path) -------
#
# The continuous batcher's packed path keeps each span's per-lane threshold
# / hop-budget vectors RESIDENT on the serving device and splices only the
# lanes that changed (admit / retire), instead of re-assembling and
# re-uploading full vectors every step.  Lanes without an explicit
# per-request policy carry sentinels — NaN threshold / negative budget —
# that each dispatch resolves against the step's default rung
# (``torch.where``), so a governor rung change never forces a re-splice.
# Retired lanes are stamped DEAD: threshold -1 confirms on the first hop
# (MaxDiff >= 0 > -1 always) and budget 1 hard-caps it, so an empty lane
# costs one hop instead of walking the default policy.

THRESH_DEFAULT = float("nan")
BUDGET_DEFAULT = -1
DEAD_THRESH = -1.0
DEAD_BUDGET = 1


def lane_knobs(policy: "FogPolicy | None") -> tuple[float, int]:
    """One lane's resident (threshold, hop_budget) encoding: concrete
    values for an explicit policy (an unset hop_budget is NO_BUDGET — the
    per-request contract fully overrides the default, matching
    :func:`assemble`), default sentinels otherwise."""
    if policy is None:
        return THRESH_DEFAULT, BUDGET_DEFAULT
    bud = (int(policy.hop_budget)
           if policy.hop_budget is not None else NO_BUDGET)
    return float(policy.threshold), bud


class LanePolicies:
    """Host mirror of one span's resident per-lane policy vectors, with
    dirty-lane tracking: the serving replica drains :meth:`take_dirty` into
    a device splice right before each dispatch.  All lanes start DEAD (the
    span serves nothing until admits arrive)."""

    def __init__(self, n: int):
        self.n = int(n)
        self.thresh = np.full((n,), DEAD_THRESH, np.float32)
        self.budget = np.full((n,), DEAD_BUDGET, np.int32)
        self._dirty = np.zeros((n,), bool)

    def stamp(self, lane: int, thr: float, bud: int) -> None:
        """Raw per-lane write (admit resolved knobs, flush re-stamps)."""
        self.thresh[lane] = thr
        self.budget[lane] = bud
        self._dirty[lane] = True

    def stamp_many(self, lanes, thr, bud) -> None:
        """Vectorized :meth:`stamp`: one bulk write per refill."""
        self.thresh[lanes] = thr
        self.budget[lanes] = bud
        self._dirty[lanes] = True

    def admit(self, lane: int, policy: "FogPolicy | None" = None) -> None:
        self.stamp(lane, *lane_knobs(policy))

    def retire(self, lane: int) -> None:
        self.stamp(lane, DEAD_THRESH, DEAD_BUDGET)

    def retire_many(self, lanes) -> None:
        self.stamp_many(lanes, DEAD_THRESH, DEAD_BUDGET)

    @property
    def dirty(self) -> bool:
        return bool(self._dirty.any())

    def take_dirty(self):
        """``(idx, thresh, budget)`` of every lane staged since the last
        take (idx ascending, for deterministic splices), clearing the
        mask."""
        idx = np.flatnonzero(self._dirty).astype(np.int32)
        self._dirty[idx] = False
        return idx, self.thresh[idx], self.budget[idx]

    def resolve(self, default: "FogPolicy") -> tuple[np.ndarray, np.ndarray]:
        """The full effective vectors under ``default`` — the host-side
        reference of what the dispatch's ``torch.where`` resolution
        computes."""
        thr = np.where(np.isnan(self.thresh),
                       np.float32(np.asarray(default.threshold)),
                       self.thresh).astype(np.float32)
        def_bud = (int(np.asarray(default.hop_budget))
                   if default.hop_budget is not None else NO_BUDGET)
        bud = np.where(self.budget < 0, np.int32(def_bud),
                       self.budget).astype(np.int32)
        return thr, bud


def assemble(policies: Sequence["FogPolicy | None"],
             default: "FogPolicy | None" = None) -> FogPolicy:
    """Stack per-request scalar policies into one per-lane batch policy.

    The continuous-batching scheduler holds one (possibly absent) scalar
    policy per slot; this builds the single ``FogPolicy`` whose ``threshold``
    / ``hop_budget`` are ``[n_slots]`` vectors, so one decode step serves
    mixed-QoS traffic.  Static knobs (backend, block_b, ...) come from
    ``default``.  The vectors are host numpy: the scheduler assembles and
    re-slices them every step, and each decode path moves them to its own
    device.
    """
    default = default if default is not None else FogPolicy()
    thr = [float(p.threshold if p is not None else default.threshold)
           for p in policies]
    budgets = [(p.hop_budget if p is not None else default.hop_budget)
               for p in policies]
    budget_vec = None
    if any(b is not None for b in budgets):
        budget_vec = np.asarray(
            [int(b) if b is not None else NO_BUDGET for b in budgets],
            np.int32)
    return default.replace(threshold=np.asarray(thr, np.float32),
                           hop_budget=budget_vec)
