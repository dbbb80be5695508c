"""Pareto frontier over FogPolicy grids (port of ``repro.core.frontier``):
Fig. 5's operating-point selection as an API.

The paper picks a run-time operating point by sweeping the threshold knob
and reading accuracy against energy.  This module sweeps the engine's
runtime-knob plane (threshold x hop budget x precision x backend), prunes
it to the Pareto frontier (no surviving policy is beaten on BOTH accuracy
and energy), and answers the budget question directly:

    from repro_torch.core import build_frontier, auto_policy

    frontier = build_frontier(engine, x_cal, y_cal)
    policy = auto_policy(engine, x_cal, y_cal, energy_budget_nj=2.0)

Every point is priced by the engine's own :class:`EvalReport` telemetry
(the :class:`~repro_torch.core.energy.EnergyModel` at the precision the
evaluation ran at).  The frontier serializes to the JAX package's dict
layout (:meth:`Frontier.to_dict`), so model artifacts carry their
calibrated operating points between the packages.

Every policy of a sweep sees the same start groves: ``start`` when given,
else one draw from ``generator`` (default: seeded with 0 on the engine's
device), as the JAX package reuses one key for every policy.

By construction the frontier is *monotone*: sorted by energy ascending,
accuracy strictly increases (:meth:`Frontier.check_monotone`).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.engine import sample_starts
from repro_torch.core.policy import FogPolicy


@dataclasses.dataclass(frozen=True)
class FrontierPoint:
    """One calibrated operating point: a scalar FogPolicy and its measured
    accuracy / modeled energy on the calibration set."""

    policy: FogPolicy
    accuracy: float
    energy_nj: float          # mean modeled nJ / classification
    mean_hops: float

    @property
    def edp(self) -> float:
        """Energy-delay product (delay proxy: mean hops, as in budget.py)."""
        return self.energy_nj * self.mean_hops

    def __str__(self) -> str:
        knobs = [f"thr={_mean(self.policy.threshold):.2f}"]
        if self.policy.hop_budget is not None:
            knobs.append(f"budget={int(self.policy.hop_budget)}")
        if self.policy.precision is not None:
            knobs.append(self.policy.precision)
        return (f"[{' '.join(knobs)}] acc={self.accuracy:.3f} "
                f"E={self.energy_nj:.3f}nJ hops={self.mean_hops:.2f}")

    def to_dict(self) -> dict:
        return {"policy": self.policy.to_dict(),
                "accuracy": float(self.accuracy),
                "energy_nj": float(self.energy_nj),
                "mean_hops": float(self.mean_hops)}

    @classmethod
    def from_dict(cls, d: dict) -> "FrontierPoint":
        return cls(policy=FogPolicy.from_dict(d["policy"]),
                   accuracy=d["accuracy"], energy_nj=d["energy_nj"],
                   mean_hops=d["mean_hops"])


def _mean(v) -> float:
    """A scalar knob, or the mean of a per-lane vector."""
    return float(torch.as_tensor(v, dtype=torch.float64).mean())


def _labels(y) -> np.ndarray:
    return y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


class Frontier:
    """The Pareto-optimal subset of a calibrated policy sweep.

    Points are stored energy-ascending; along that order accuracy strictly
    increases (dominated and duplicate-accuracy points are pruned), so
    ``under_budget`` is a reverse scan and ``ladder`` is the reversed list.
    """

    def __init__(self, points: Sequence[FrontierPoint]):
        pts = sorted(points, key=lambda p: (p.energy_nj, -p.accuracy))
        frontier: list[FrontierPoint] = []
        for p in pts:
            if not frontier or p.accuracy > frontier[-1].accuracy:
                frontier.append(p)
        self.points: tuple[FrontierPoint, ...] = tuple(frontier)
        if not self.points:
            raise ValueError("cannot build a frontier from zero points")

    def __len__(self) -> int:
        return len(self.points)

    def __iter__(self):
        return iter(self.points)

    def __str__(self) -> str:
        return "\n".join(str(p) for p in self.points)

    def under_budget(self, energy_budget_nj: float) -> FrontierPoint:
        """Highest-accuracy point with energy <= budget.  Raises ValueError
        when even the cheapest point exceeds the budget."""
        ok = [p for p in self.points if p.energy_nj <= energy_budget_nj]
        if not ok:
            raise ValueError(
                f"energy budget {energy_budget_nj:.3f} nJ is below the "
                f"cheapest frontier point ({self.points[0].energy_nj:.3f} "
                f"nJ, {self.points[0]})")
        return ok[-1]          # energy-ascending == accuracy-ascending

    def ladder(self) -> list[FrontierPoint]:
        """Quality-descending walk: rung 0 is the most accurate (most
        expensive) point, the last rung the cheapest."""
        return list(reversed(self.points))

    def check_monotone(self) -> None:
        """Raise unless no point has both lower accuracy and higher energy
        than a neighbor."""
        for a, b in zip(self.points, self.points[1:]):
            if not (b.energy_nj >= a.energy_nj and b.accuracy > a.accuracy):
                raise AssertionError(
                    f"frontier not monotone: {b} does not improve on {a}")

    def to_dict(self) -> dict:
        return {"points": [p.to_dict() for p in self.points]}

    @classmethod
    def from_dict(cls, d: dict) -> "Frontier":
        """Restore a stored frontier VERBATIM, with no re-sorting or
        re-pruning, so :meth:`check_monotone` can still fail on it.  The
        stored order must be energy-ascending (``under_budget`` relies on
        it)."""
        points = tuple(FrontierPoint.from_dict(p) for p in d["points"])
        if not points:
            raise ValueError("cannot restore a frontier with zero points")
        energies = [p.energy_nj for p in points]
        if any(b < a for a, b in zip(energies, energies[1:])):
            raise ValueError("frontier dump is not energy-sorted")
        f = cls.__new__(cls)
        f.points = points
        return f


# ------------------------------------------------------ point selection ----
# Rules shared by budget.py's design sweeps (TopologyPoint lists) and the
# frontier sweeps: any object with .accuracy, .edp and a threshold (its own
# attribute or on .policy) qualifies.

def _threshold_of(p) -> float:
    t = getattr(p, "threshold", None)
    if t is None:
        t = _mean(p.policy.threshold)
    return float(t)


def select_min_edp(points: Sequence, accuracy_slack: float = 0.02):
    """Min-EDP point whose accuracy is within ``slack`` of the best (the
    paper's Fig. 4 design pick)."""
    best_acc = max(p.accuracy for p in points)
    ok = [p for p in points if p.accuracy >= best_acc - accuracy_slack]
    return min(ok, key=lambda p: p.edp)


def find_opt_threshold(points: Sequence, tolerance: float = 0.005):
    """FoG_opt: the smallest threshold above which accuracy stops
    increasing (paper §4.2)."""
    pts = sorted(points, key=_threshold_of)
    best_acc = max(p.accuracy for p in pts)
    for p in pts:
        if p.accuracy >= best_acc - tolerance:
            return p
    return pts[-1]


# ---------------------------------------------------------------- sweeps ----
def default_grid(thresholds: Sequence[float] | None = None,
                 hop_budgets: Sequence[int | None] | None = None,
                 precisions: Sequence[str | None] | None = None,
                 backends: Sequence[str | None] | None = None,
                 base: FogPolicy | None = None) -> list[FogPolicy]:
    """The default calibration grid: threshold x hop budget x precision x
    backend, stamped onto ``base``.  An axis left None inherits the base
    policy's own knob; precision also sweeps "int8" unless overridden."""
    base = base if base is not None else FogPolicy()
    if thresholds is None:
        thresholds = (0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 0.9, 1.1)
    if hop_budgets is None:
        hop_budgets = (base.hop_budget,)
    if precisions is None:
        precisions = tuple(dict.fromkeys((base.precision, "int8")))
    if backends is None:
        backends = (base.backend,)
    return [base.replace(threshold=float(t), hop_budget=hb,
                         precision=pr, backend=be)
            for pr in precisions for be in backends
            for hb in hop_budgets for t in thresholds]


def _calibration_starts(engine, batch: int,
                       generator: torch.Generator | None = None,
                       start=None) -> torch.Tensor:
    """The start groves every policy of a sweep shares: ``start`` as given,
    else one draw from ``generator`` (default: seeded with 0 on the
    engine's device), stratified over a ring engine's shards."""
    if start is not None:
        return start
    if generator is None:
        generator = torch.Generator(device=engine.device).manual_seed(0)
    return sample_starts(generator, batch, engine.n_groves, engine.device,
                         n_shards=engine.n_shards)


def sweep_policies(engine, x_cal, y_cal, policies: Iterable[FogPolicy],
                   generator: torch.Generator | None = None,
                   start=None) -> list[FrontierPoint]:
    """Price a policy grid on calibration data: one engine evaluation per
    policy from the same starts, accuracy from labels, energy from the
    EvalReport's own model."""
    y = _labels(y_cal)
    start = _calibration_starts(engine, len(y), generator, start)
    points = []
    seen: set = set()
    for pol in policies:
        # stamp the RESOLVED precision on the stored policy, so a point
        # keeps describing what runs after it travels in an artifact
        pol = pol.replace(precision=engine.resolve(pol).precision)
        if not pol.per_lane:
            # resolution can collapse grid points: one eval per policy
            k = tuple(sorted(pol.to_dict().items()))
            if k in seen:
                continue
            seen.add(k)
        res = engine.eval(x_cal, policy=pol, start=start)
        rep = res.energy_report()
        points.append(FrontierPoint(
            policy=pol,
            accuracy=float((res.label.cpu().numpy() == y).mean()),
            energy_nj=rep.per_example_nj,
            mean_hops=float(res.hops.cpu().numpy().mean())))
    return points


def build_frontier(engine, x_cal, y_cal,
                   policies: Iterable[FogPolicy] | None = None,
                   generator: torch.Generator | None = None,
                   start=None) -> Frontier:
    """Sweep (default: :func:`default_grid`) and prune to the frontier."""
    if policies is None:
        policies = default_grid()
    return Frontier(sweep_policies(engine, x_cal, y_cal, policies,
                                   generator, start))


def auto_policy(engine, x_cal, y_cal, energy_budget_nj: float,
                policies: Iterable[FogPolicy] | None = None,
                generator: torch.Generator | None = None,
                start=None) -> FogPolicy:
    """The paper's Fig. 5 operating-point selection as one call: the
    highest-accuracy FogPolicy whose calibrated energy fits the budget."""
    frontier = build_frontier(engine, x_cal, y_cal, policies, generator,
                              start)
    return frontier.under_budget(energy_budget_nj).policy
