"""FogClassifier — a scikit-learn-style facade over the whole FoG pipeline
(port of ``repro.sklearn``).

One object wraps forest training (Algorithm 1's GCTrain), the grove split,
FogEngine construction and policy-driven evaluation:

    from repro_torch.sklearn import FogClassifier

    clf = FogClassifier(n_trees=16, grove_size=2, max_depth=8,
                        trainer="device")
    clf.fit(X_train, y_train)               # on the card by default
    clf.set_energy_budget(2.0, X_cal, y_cal)
    clf.quantize("int8")
    clf.save("model.npz")
    FogClassifier.load("model.npz").predict(X_test)

Training, the tables and every evaluation live on ``device`` (default
``"cuda"``; ``device="cpu"`` runs the plain PyTorch path).  The default
backend is ``"fused"``: one CUDA launch per evaluation.  Start groves come
from a ``torch.Generator`` seeded with ``seed`` on the engine's device
(fixed, so repeated predictions are deterministic), from a caller's
``generator``, or are given as ``start``.

Artifacts are the JAX package's ``.npz`` v1 pack plus the same facade state
(``FogClassifier.save``/``load`` in either package read each other's).
``set_energy_budget`` calibrates a Pareto frontier over the runtime knobs
(:mod:`repro_torch.core.frontier`) and pins the highest-accuracy policy
meeting the budget; ``profile()`` then reports measured-vs-budget.  The
serving governor (``governor()``) is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import EvalReport, FogEngine
from repro_torch.core.frontier import Frontier, build_frontier, default_grid
from repro_torch.core.grove import split
from repro_torch.core.policy import PRECISIONS, FogPolicy
from repro_torch.forest.pack import ForestPack
from repro_torch.forest.train import TrainConfig, train_random_forest

_PARAMS = ("n_trees", "grove_size", "max_depth", "policy", "backend", "seed",
           "train_cfg", "precision", "trainer", "device")


class FogClassifier:
    """Energy-efficient random-forest classifier (Field of Groves).

    Parameters
    ----------
    n_trees:    forest size n (Algorithm 1 line 2)
    grove_size: trees per grove k (the Split factor); n % k must be 0
    max_depth:  tree depth cap for training
    policy:     default :class:`FogPolicy` for prediction calls
    backend:    default engine backend ("fused" | "pallas" | "reference")
    seed:       training seed, and the fixed start-grove draw for predict
    train_cfg:  optional full :class:`TrainConfig`; n_trees/max_depth/seed
                above override its corresponding fields
    precision:  default packed-table dtype ("fp32" | "bf16" | "int8")
    trainer:    ``"host"`` (numpy CART) | ``"device"`` (level-wise
                histogram induction, :mod:`repro_torch.forest.grow`);
                ``None`` defers to ``train_cfg.trainer``
    device:     where the device trainer, the tables and evaluation run;
                ``None`` is ``"cuda"``
    """

    def __init__(self, n_trees: int = 16, grove_size: int = 2,
                 max_depth: int = 8, *, policy: FogPolicy | None = None,
                 backend: str = "fused", seed: int = 0,
                 train_cfg: TrainConfig | None = None,
                 precision: str = "fp32", trainer: str | None = None,
                 device=None):
        self.n_trees = n_trees
        self.grove_size = grove_size
        self.max_depth = max_depth
        self.policy = policy if policy is not None else FogPolicy()
        self.backend = backend
        self.seed = seed
        self.train_cfg = train_cfg
        self.precision = precision
        self.trainer = trainer
        self.device = device

    # -- sklearn param protocol ------------------------------------------
    def get_params(self, deep: bool = True) -> dict:
        return {k: getattr(self, k) for k in _PARAMS}

    def set_params(self, **params) -> "FogClassifier":
        for k, v in params.items():
            if k not in _PARAMS:
                raise ValueError(f"unknown parameter {k!r}; "
                                 f"valid: {_PARAMS}")
            setattr(self, k, v)
        return self

    # -- fitted artifacts --------------------------------------------------
    # properties, so a model loaded from a packed artifact serves without
    # dequantizing: the fp32 views realize only on first access
    @property
    def gc_(self):
        gc = getattr(self, "_gc", None)
        if gc is None:
            if not hasattr(self, "engine_"):
                raise AttributeError("gc_ (classifier is not fitted)")
            gc = self._gc = self.engine_.gcs[0]
        return gc

    @gc_.setter
    def gc_(self, value):
        self._gc = value

    @property
    def forest_(self):
        forest = getattr(self, "_forest", None)
        if forest is None:
            if not hasattr(self, "engine_"):
                raise AttributeError("forest_ (classifier is not fitted)")
            forest = self._forest = self.gc_.as_forest()
        return forest

    @forest_.setter
    def forest_(self, value):
        self._forest = value

    # -- estimator API ----------------------------------------------------
    def fit(self, X, y, n_classes: int | None = None) -> "FogClassifier":
        """GCTrain(n, k, X, y): train the forest, split it into groves,
        build the engine on ``device``."""
        if self.n_trees % self.grove_size:
            raise ValueError(
                f"n_trees={self.n_trees} must be divisible by "
                f"grove_size={self.grove_size}")
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.int32)
        if n_classes is None:
            n_classes = int(y.max()) + 1
        cfg = self.train_cfg if self.train_cfg is not None else TrainConfig()
        cfg = dataclasses.replace(cfg, n_trees=self.n_trees,
                                  max_depth=self.max_depth, seed=self.seed)
        if self.trainer is not None:
            cfg = dataclasses.replace(cfg, trainer=self.trainer)
        self.forest_ = train_random_forest(X, y, n_classes, cfg,
                                           device=self.device)
        self.gc_ = split(self.forest_, self.grove_size)
        self.engine_ = FogEngine(self.gc_, backend=self.backend,
                                 policy=self.policy,
                                 precision=self.precision,
                                 device=self.device)
        self.n_classes_ = n_classes
        self.n_features_in_ = X.shape[1]
        self._hops: list[tuple[np.ndarray, object]] = []
        return self

    def _check_fitted(self) -> None:
        if not hasattr(self, "engine_"):
            raise RuntimeError("FogClassifier is not fitted; call fit(X, y)")

    def _generator(self, generator, start):
        """The caller's generator, else (without ``start``) the fixed
        seed-derived one."""
        if generator is None and start is None:
            generator = torch.Generator(
                device=self.engine_.device).manual_seed(self.seed)
        return generator

    def evaluate(self, X, *, policy: FogPolicy | None = None,
                 generator: torch.Generator | None = None,
                 start=None) -> EvalReport:
        """Full Algorithm-2 evaluation: the EvalReport (proba/label/hops
        plus per-lane ``energy_pj`` and the pricing EnergyModel).  Hop
        counts feed the profile accounting."""
        self._check_fitted()
        res = self.engine_.eval(X, self._generator(generator, start),
                                policy=policy, start=start)
        self._hops.append((res.hops.cpu().numpy(), res.model))
        return res

    def predict(self, X, *, policy: FogPolicy | None = None,
                generator: torch.Generator | None = None,
                start=None) -> np.ndarray:
        """Predicted labels [B]."""
        return self.evaluate(X, policy=policy, generator=generator,
                             start=start).label.cpu().numpy()

    def predict_proba(self, X, *, policy: FogPolicy | None = None,
                      generator: torch.Generator | None = None,
                      start=None) -> np.ndarray:
        """Hop-normalized class probabilities [B, C]."""
        return self.evaluate(X, policy=policy, generator=generator,
                             start=start).proba.cpu().numpy()

    def score(self, X, y, *, policy: FogPolicy | None = None,
              generator: torch.Generator | None = None,
              start=None) -> float:
        """Mean accuracy on (X, y) under the given (or default) policy."""
        return float(np.mean(self.predict(X, policy=policy,
                                          generator=generator, start=start)
                             == np.asarray(y)))

    # -- the paper's energy story -----------------------------------------
    def profile(self) -> dict:
        """Hop/energy accounting over everything classified since fit (or
        the last :meth:`reset_profile`): mean hops, modeled nJ per
        classification (each batch priced by its own EvalReport's model),
        totals and the hop histogram; with a pinned energy budget also the
        budget and ``within_budget``."""
        self._check_fitted()
        budget = getattr(self, "energy_budget_nj_", None)
        if not self._hops:
            out = {"n_classified": 0, "mean_hops": 0.0,
                   "energy_nj_per_classification": 0.0,
                   "total_energy_nj": 0.0, "hops_histogram": {}}
        else:
            hops = np.concatenate([h for h, _ in self._hops])
            total_pj = sum(model.report(h).total_pj
                           for h, model in self._hops)
            vals, counts = np.unique(hops, return_counts=True)
            out = {
                "n_classified": int(hops.size),
                "mean_hops": float(hops.mean()),
                "energy_nj_per_classification": total_pj * 1e-3 / hops.size,
                "total_energy_nj": total_pj * 1e-3,
                "hops_histogram": {int(v): int(c)
                                   for v, c in zip(vals, counts)},
            }
        if budget is not None:
            out["energy_budget_nj"] = float(budget)
            # None until traffic exists: "no evidence yet" is not a breach
            out["within_budget"] = (
                None if out["n_classified"] == 0
                else out["energy_nj_per_classification"] <= budget)
        return out

    def reset_profile(self) -> None:
        """Clear the hop/energy accounting."""
        self._check_fitted()
        self._hops.clear()

    # -- energy budgets ----------------------------------------------------
    def set_energy_budget(self, energy_budget_nj: float, X_cal, y_cal, *,
                          policies=None,
                          generator: torch.Generator | None = None,
                          start=None) -> "FogClassifier":
        """Calibrate-and-pin: build the Pareto frontier over the runtime
        knobs on (X_cal, y_cal) and make the highest-accuracy policy
        meeting ``energy_budget_nj`` the default for later calls.

        The frontier is kept on ``self.frontier_`` (and persisted by
        :meth:`save`).  The profile accounting is reset.  Raises ValueError
        when no frontier point fits the budget, leaving the previous state
        intact.  Returns ``self``.
        """
        self._check_fitted()
        if self.policy.per_lane:
            raise ValueError(
                "cannot calibrate a budget on a per-lane default policy "
                "(its threshold/hop_budget vectors are batch-shaped); set "
                "scalar knobs and pass per-lane vectors per call")
        if policies is None:
            # sweep threshold x precision ON TOP OF the configured policy,
            # so the knobs the grid does not vary survive the pin
            policies = default_grid(base=self.policy)
        frontier = build_frontier(
            self.engine_, np.asarray(X_cal, np.float32), np.asarray(y_cal),
            policies, self._generator(generator, start), start)
        # select BEFORE committing any state
        point = frontier.under_budget(float(energy_budget_nj))
        self.frontier_ = frontier
        self.energy_budget_nj_ = float(energy_budget_nj)
        self.policy = point.policy
        self.engine_.policy = point.policy
        self.reset_profile()
        return self

    def governor(self, energy_budget_nj: float | None = None, **kw):
        """The serving ``EnergyGovernor`` is not ported yet (ROADMAP A8)."""
        raise NotImplementedError(
            "the serving EnergyGovernor is not ported yet: ROADMAP A8")

    # -- precision & persistence ------------------------------------------
    def quantize(self, precision: str = "int8") -> "FogClassifier":
        """Switch the default evaluation precision (no retraining).  A
        default policy that pins its own ``precision`` is re-pinned too.
        Returns ``self``."""
        self._check_fitted()
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}; "
                             f"pick from {PRECISIONS}")
        self.precision = precision
        self.engine_.precision = precision
        if self.policy.precision is not None:
            self.policy = self.policy.replace(precision=precision)
            self.engine_.policy = self.policy
        return self

    def save(self, path, *, precision: str | None = None):
        """Persist the fitted model as a versioned ForestPack ``.npz``: the
        packed tables plus the facade state (default policy, and the energy
        budget and its frontier when calibrated).

        With a frontier aboard the pack is saved at the highest-fidelity
        precision any rung uses (an fp32 pack re-quantizes int8 rungs
        exactly; an int8 pack cannot rebuild an fp32 rung), and an explicit
        ``precision`` below that raises.  Without one, the pinned policy's
        precision (else the estimator default).  ``train_cfg`` is not
        persisted; a per-lane default policy cannot be.
        """
        self._check_fitted()
        if self.policy.per_lane:
            raise ValueError(
                "cannot save a per-lane default policy (its threshold/"
                "hop_budget vectors are batch-shaped); set scalar knobs on "
                "the default policy and pass per-lane vectors per call")
        frontier = getattr(self, "frontier_", None)
        needed = None
        if frontier is not None:
            rung_precs = {p.policy.precision for p in frontier.points}
            needed = next(q for q in PRECISIONS
                          if q in rung_precs or None in rung_precs)
        prec = precision
        if prec is None:
            prec = needed or (self.policy.precision
                              if self.policy.precision is not None
                              else self.precision)
        elif needed is not None and (PRECISIONS.index(prec)
                                     > PRECISIONS.index(needed)):
            raise ValueError(
                f"cannot save at precision={prec!r}: the calibrated "
                f"frontier carries {needed} rungs whose tables an {prec} "
                "pack cannot reconstruct; save without precision=, or "
                f"recalibrate on an all-{prec} grid first")
        pack = self.engine_.tables.pack(prec)
        extra = {
            "estimator": "FogClassifier",
            "n_trees": self.n_trees, "grove_size": self.grove_size,
            "max_depth": self.max_depth, "backend": self.backend,
            "seed": self.seed, "n_classes": self.n_classes_,
            "n_features_in": self.n_features_in_,
            "policy": self.policy.to_dict(),
        }
        if frontier is not None:
            extra["frontier"] = frontier.to_dict()
        if getattr(self, "energy_budget_nj_", None) is not None:
            extra["energy_budget_nj"] = self.energy_budget_nj_
        return pack.save(path, extra=extra)

    @classmethod
    def load(cls, path, *, device=None) -> "FogClassifier":
        """Reconstruct a fitted classifier from a ``save`` artifact of
        either package, on ``device`` (default ``"cuda"``).  The engine
        evaluates the stored pack directly (its precision becomes the
        default), so an int8 artifact never materializes fp32 tables."""
        pack, extra = ForestPack.load_with_meta(path)
        if extra.get("estimator") != "FogClassifier":
            raise ValueError(
                f"{path} is a ForestPack artifact but not a FogClassifier "
                f"save (estimator={extra.get('estimator')!r})")
        policy = (FogPolicy.from_dict(extra["policy"]) if "policy" in extra
                  else None)
        clf = cls(n_trees=extra["n_trees"], grove_size=extra["grove_size"],
                  max_depth=extra["max_depth"], backend=extra["backend"],
                  seed=extra["seed"], precision=pack.precision,
                  policy=policy, device=device)
        clf.engine_ = FogEngine(pack, backend=clf.backend, policy=clf.policy,
                                device=device)
        clf.n_classes_ = extra["n_classes"]
        clf.n_features_in_ = extra["n_features_in"]
        if "frontier" in extra:
            clf.frontier_ = Frontier.from_dict(extra["frontier"])
            try:
                clf.frontier_.check_monotone()
            except AssertionError as e:
                raise ValueError(
                    f"{path}: persisted frontier is corrupt: {e}") from e
        if "energy_budget_nj" in extra:
            clf.energy_budget_nj_ = float(extra["energy_budget_nj"])
        clf._hops = []
        return clf

    # -- repr --------------------------------------------------------------
    def __repr__(self) -> str:
        # engine metadata, not gc_: repr must never trigger a dequantize
        fitted = (f", fitted {self.engine_.n_groves}x{self.grove_size}"
                  if hasattr(self, "engine_") else "")
        return (f"FogClassifier(n_trees={self.n_trees}, "
                f"grove_size={self.grove_size}, max_depth={self.max_depth}, "
                f"backend={self.backend!r}{fitted})")
