"""Design-time topology search (Figure 4) and EDP budgeting (port of
``repro.core.budget``).

The paper sweeps (n_groves x trees_per_grove) topologies of a fixed forest,
evaluates accuracy and EDP on validation data, and picks the min-EDP design
at maximum accuracy; the threshold then becomes the run-time knob (Fig 5).

Every sweep point is a :class:`~repro_torch.core.policy.FogPolicy`, so a
winning point goes straight to ``FogEngine.eval(..., policy=point)`` or
``FogClassifier(policy=point)``.  Energy comes from the engine's
:class:`~repro_torch.core.engine.EvalReport` and is reported in
nJ/classification.  The selection rules are the generic ones of
:mod:`repro_torch.core.frontier`.

Each evaluation draws its start groves from a generator seeded with
``seed`` on the engine's device, or takes them as ``start``.  Engines run
on ``device`` (default ``"cuda"``) with the ``"fused"`` backend (one kernel
launch per point) unless the caller picks another.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core import frontier as _frontier
from repro_torch.core.engine import FogEngine
from repro_torch.core.grove import split
from repro_torch.core.policy import FogPolicy
from repro_torch.forest.tree import TensorForest


@dataclasses.dataclass(frozen=True)
class TopologyPoint:
    n_groves: int
    grove_size: int
    threshold: float
    accuracy: float
    energy_nj: float     # mean energy per classification
    delay: float         # mean hops (latency proxy, cycles ~ hops * grove latency)
    edp: float           # energy * delay
    policy: FogPolicy = dataclasses.field(default=FogPolicy(), compare=False)

    def __str__(self) -> str:
        return (f"{self.n_groves}x{self.grove_size} thr={self.threshold:.2f} "
                f"acc={self.accuracy:.3f} E={self.energy_nj:.3f}nJ "
                f"D={self.delay:.2f} EDP={self.edp:.3f}")


def _as_policy(policy) -> FogPolicy:
    """Accept a FogPolicy or a bare threshold float."""
    if isinstance(policy, FogPolicy):
        return policy
    return FogPolicy(threshold=float(policy))


def evaluate_topology(forest: TensorForest, grove_size: int, x_val, y_val,
                      policy: FogPolicy | float, max_hops: int | None = None,
                      seed: int = 0, backend: str = "fused", device=None,
                      start=None) -> TopologyPoint:
    """Accuracy / energy / EDP of one (topology, policy) design point.

    ``policy`` is the runtime-knob contract (a bare float is a scalar
    threshold; ``max_hops`` then caps the loop).  A policy's own
    ``backend`` knob wins over ``backend``.
    """
    pol = _as_policy(policy)
    if max_hops is not None and pol.max_hops is None:
        pol = pol.replace(max_hops=max_hops)
    gc = split(forest, grove_size)
    engine = FogEngine(gc, backend=backend, device=device)
    gen = (torch.Generator(device=engine.device).manual_seed(seed)
           if start is None else None)
    res = engine.eval(x_val, gen, policy=pol, start=start)
    acc = float(np.mean(res.label.cpu().numpy() == _frontier._labels(y_val)))
    e_nj = res.energy_report().per_example_nj
    delay = float(res.hops.cpu().numpy().mean())
    thresh_scalar = _frontier._mean(pol.threshold)
    return TopologyPoint(gc.n_groves, grove_size, thresh_scalar, acc,
                         e_nj, delay, e_nj * delay, policy=pol)


def policy_sweep(forest: TensorForest, grove_size: int, x_val, y_val,
                 policies: Iterable[FogPolicy], seed: int = 0,
                 backend: str = "fused", device=None,
                 start=None) -> list[TopologyPoint]:
    """Evaluate a grid of FogPolicy design points on a fixed topology."""
    return [evaluate_topology(forest, grove_size, x_val, y_val, p, seed=seed,
                              backend=backend, device=device, start=start)
            for p in policies]


def topology_sweep(forest: TensorForest, x_val, y_val,
                   policy: FogPolicy | float = 0.3, backend: str = "fused",
                   device=None, start=None) -> list[TopologyPoint]:
    """Figure 4: every (groves x grove_size) factorization of the forest.

    ``start`` gives each topology's start groves: a callable
    ``n_groves -> [B]`` or a dict keyed by ``n_groves``; ``None`` draws
    them from a generator seeded with 0."""
    pol = _as_policy(policy)
    t = forest.n_trees
    starts = start.__getitem__ if isinstance(start, dict) else start
    return [evaluate_topology(
                forest, k, x_val, y_val, pol, backend=backend, device=device,
                start=None if starts is None else starts(t // k))
            for k in range(1, t + 1) if t % k == 0]


def select_min_edp(points: list[TopologyPoint],
                   accuracy_slack: float = 0.02) -> TopologyPoint:
    """Min-EDP point whose accuracy is within ``slack`` of the best."""
    return _frontier.select_min_edp(points, accuracy_slack)


def threshold_sweep(forest: TensorForest, grove_size: int, x_val, y_val,
                    thresholds: Sequence[float] | np.ndarray | None = None,
                    backend: str = "fused", device=None,
                    start=None) -> list[TopologyPoint]:
    """Figure 5: run-time tunability curve for a fixed topology (a
    FogPolicy grid varying only the threshold knob)."""
    if thresholds is None:
        thresholds = np.asarray([0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 0.9, 1.0])
    return policy_sweep(forest, grove_size, x_val, y_val,
                        [FogPolicy(threshold=float(t)) for t in thresholds],
                        backend=backend, device=device, start=start)


def find_opt_threshold(points: list[TopologyPoint],
                       tolerance: float = 0.005) -> TopologyPoint:
    """FoG_opt: the smallest threshold above which accuracy stops
    increasing (paper §4.2)."""
    return _frontier.find_opt_threshold(points, tolerance)
