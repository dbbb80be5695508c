"""The paper's evaluation harness on the port: the classifier zoo of Table 1
on each dataset (counterpart of the JAX package's ``benchmarks/common.py``,
which imports JAX, so the port keeps its own).

Five datasets (synthetic twins of the paper's UCI sets), a forest of 16
trees per dataset at a per-dataset depth, trained by the host CART with
seed 0, split into 8 groves of 2 (the paper's min-EDP pick).  Forests and
datasets are cached per process.

Start groves: ``start_for(n_groves) -> [B]`` gives a topology's draws (the
JAX package's ``sample_starts(jax.random.key(0), B, n_groves)`` in the
tests); without it every evaluation draws from a ``torch.Generator``
seeded with 0 on the device.  Baselines train from ``baseline_params``
(the port's trees, e.g. carried from JAX) or from the port's own init.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.baselines import ALL_BASELINES
from repro_torch.core import (FogEngine, FogPolicy, find_opt_threshold,
                              rf_report, split, threshold_sweep)
from repro_torch.data import Dataset, make_dataset
from repro_torch.forest import (TensorForest, TrainConfig, rf_predict,
                                train_random_forest)

DATASETS = ["isolet", "penbased", "mnist", "letter", "segmentation"]
N_TREES = 16
# deeper trees for the wide / many-class datasets (the JAX package's
# EDP-trained depths)
DEPTHS = {"isolet": 12, "mnist": 12, "letter": 11, "penbased": 9,
          "segmentation": 8}
GROVE_SIZE = 2          # 8 x 2
COLUMNS = ["svm_lr", "svm_rbf", "mlp", "cnn", "rf", "fog_max", "fog_opt"]
FOG_MAX_THRESHOLD = 1.1  # above 1: every grove votes


def depth_for(name: str) -> int:
    return DEPTHS.get(name, 8)


@functools.lru_cache(maxsize=None)
def dataset(name: str) -> Dataset:
    return make_dataset(name)


@functools.lru_cache(maxsize=None)
def forest_for(name: str) -> TensorForest:
    """The dataset's forest on the CPU (host CART, seed 0)."""
    ds = dataset(name)
    return train_random_forest(ds.x_train, ds.y_train, ds.n_classes,
                               TrainConfig(n_trees=N_TREES,
                                           max_depth=depth_for(name),
                                           seed=0))


def forest_on(forest: TensorForest, device) -> TensorForest:
    return TensorForest(*(a.to(device) for a in (
        forest.feature, forest.threshold, forest.leaf)))


def draw(device, start):
    """(generator, start) for ``FogEngine.eval``: the given starts, else a
    generator seeded with 0 on ``device``."""
    if start is not None:
        return None, start
    return torch.Generator(device=device).manual_seed(0), None


@dataclasses.dataclass
class ClassifierResult:
    name: str
    accuracy: float
    energy_nj: float
    # x [B, F] on the device -> labels [B]: the trained classifier
    predict: Callable | None = dataclasses.field(default=None, compare=False,
                                                 repr=False)


def _fog_predict(engine: FogEngine, policy: FogPolicy, start) -> Callable:
    def predict(x):
        gen, st = draw(engine.device, start)
        return engine.eval(x, gen, policy=policy, start=st).label
    return predict


def evaluate_all(name: str, *, device=None, backend: str = "fused",
                 start_for: Callable | None = None,
                 baseline_params: dict | None = None
                 ) -> dict[str, ClassifierResult]:
    """Accuracy and modeled energy of the seven classifiers on one dataset:
    the four baselines, then :func:`evaluate_forest`'s RF, FoG_max and
    FoG_opt."""
    dev = resolve_device(device)
    ds = dataset(name)
    out: dict[str, ClassifierResult] = {}
    for key, train in ALL_BASELINES.items():
        m = train(ds, params=None if baseline_params is None
                  else baseline_params[key], device=dev)
        out[key] = ClassifierResult(key, m.accuracy, m.energy_nj,
                                    functools.partial(m.predict, m.params))
    out.update(evaluate_forest(name, device=dev, backend=backend,
                               start_for=start_for))
    return out


def evaluate_forest(name: str, *, device=None, backend: str = "fused",
                    start_for: Callable | None = None
                    ) -> dict[str, ClassifierResult]:
    """Table 1's forest columns on one dataset: RF (majority vote), FoG_max
    (threshold 1.1, every grove votes) and FoG_opt (the accuracy-optimal
    threshold of the 8 x 2 sweep).  FoG runs on ``backend``."""
    dev = resolve_device(device)
    ds = dataset(name)
    out: dict[str, ClassifierResult] = {}
    rf = forest_for(name)
    rf_dev = forest_on(rf, dev)
    x_test = torch.as_tensor(ds.x_test, device=dev)
    rf_acc = float(np.mean(rf_predict(rf_dev, x_test).cpu().numpy()
                           == ds.y_test))
    e_rf = rf_report(len(ds.y_test), rf.n_trees, depth_for(name),
                     ds.n_classes)
    out["rf"] = ClassifierResult("rf", rf_acc, e_rf.per_example_nj,
                                 functools.partial(rf_predict, rf_dev))

    gc = split(rf, GROVE_SIZE)
    start = None if start_for is None else start_for(gc.n_groves)
    engine = FogEngine(gc, backend=backend, device=dev)
    # FoG_max: energy from the EvalReport's own model
    fog_max = FogPolicy(threshold=FOG_MAX_THRESHOLD)
    gen, st = draw(dev, start)
    res = engine.eval(x_test, gen, policy=fog_max, start=st)
    acc = float(np.mean(res.label.cpu().numpy() == ds.y_test))
    out["fog_max"] = ClassifierResult(
        "fog_max", acc, res.energy_report().per_example_nj,
        _fog_predict(engine, fog_max, start))

    # FoG_opt: the accuracy-optimal threshold of the sweep
    pts = threshold_sweep(rf, GROVE_SIZE, ds.x_test, ds.y_test,
                          backend=backend, device=dev, start=start)
    opt = find_opt_threshold(pts)
    out["fog_opt"] = ClassifierResult("fog_opt", opt.accuracy, opt.energy_nj,
                                      _fog_predict(engine, opt.policy, start))
    return out


def evaluate_datasets(datasets, **kw) -> dict[str, dict]:
    """``evaluate_all`` over ``datasets``: {dataset: {column: result}}."""
    return {name: evaluate_all(name, **kw) for name in datasets}
