"""Energy model — per-classification energy accounting (port of
``repro.core.energy``; the arithmetic is the JAX package's, bit for bit).

The paper extracts per-block PPA from Cadence/Aladdin at 40 nm and sums
per-op energies over each classifier's evaluation path.  Offline we do the
same arithmetic with published 40/45 nm per-op energies (Horowitz, ISSCC'14
"Computing's energy problem"), counting ops *exactly* from the algorithms:

FoG energy is owned by :class:`EnergyModel` — a frozen dataclass whose
per-classification cost is a *pure function* of (pack precision, topology,
hops): ``lane_pj(hops)`` is affine in the hop count
(``hops * per_hop_pj + (hops-1) * transfer_pj``), so the same object serves
post-hoc reports (:meth:`EnergyModel.report`, float64 — ``fp32`` reproduces
the pre-EnergyModel ``fog_energy`` numbers bit-for-bit), live per-lane
telemetry inside :class:`~repro_torch.core.engine.EvalReport` (``lane_pj``
on device tensors), and the governor's inverse question (:meth:`hops_within` —
the largest hop budget affordable under a pJ budget).  ``fog_energy``
remains as a thin wrapper.

Op-count recipes:

  DT       : d node-reads + d feature-reads + d comparisons (visited path only)
  RF       : t * DT + majority vote (t int adds)
  grove    : k * DT + prob accumulate (C fp adds) + MaxDiff (C comparisons)
  FoG      : sum over inputs of hops * grove + hop transfer (queue-entry
             copy over the handshake: Gamma bytes SRAM write + read)
  SVM_lr   : C*F MACs
  SVM_rbf  : n_sv * (F dist-MACs + exp) + n_sv MACs
  MLP/CNN  : layer MACs + activation evals

Energy ratios between classifiers — the paper's claims — depend only on op
counts and these constants, not on our container's hardware.

Table precision: the FoG paths take the :mod:`repro_torch.forest.pack` precision
("fp32" | "bf16" | "int8") and scale SRAM read energy by the *actual bytes
per node* — a node entry is {feature idx 2B, threshold 4/2/1B, offset 2B} —
and shrink the SRAM array capacity term accordingly (per-access energy grows
~sqrt(capacity)), so quantized packs show up directly in the fog_energy
report.  ``fp32`` reproduces the original accounting exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.forest.pack import PRECISION_BYTES

# ---- per-op energies, picojoules (Horowitz ISSCC'14, 45nm; paper: 40nm) ----
E_INT8_ADD = 0.03
E_INT32_ADD = 0.1
E_FP32_ADD = 0.9
E_INT8_MULT = 0.2
E_FP32_MULT = 3.7
E_FP32_MAC = E_FP32_ADD + E_FP32_MULT          # 4.6
E_CMP8 = 0.03                                   # 8-bit comparator (DT node, byte features)
E_CMP32 = 0.1
E_EXP = 20.0                                    # LUT + interpolation mult
E_SRAM_R32 = 5.0                                # local SRAM read, per 32b word
E_SRAM_W32 = 5.0
PJ = 1e-12
NJ = 1e-9


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    total_pj: float
    per_example_pj: float

    @property
    def per_example_nj(self) -> float:
        return self.per_example_pj * 1e-3

    def __str__(self) -> str:
        # the human-facing unit is nJ/classification everywhere (frontier
        # logs, sweep rows, bench output) — never raw pJ totals
        return f"{self.per_example_nj:.3f} nJ/example"


# ---------------------------------------------------------------- trees ----
def _sram_scale(capacity_bytes: float) -> float:
    """Per-access energy grows ~sqrt(capacity) (bitline/wordline length);
    E_SRAM_R32 is calibrated for an 8 KB array."""
    return max(1.0, np.sqrt(capacity_bytes / 8192.0))


def tree_bytes(depth: int, n_classes: int, precision: str = "fp32") -> float:
    """Node table {feature idx 2B, threshold 4/2/1B, offset 2B} + byte
    leaves.  ``precision`` is the packed threshold width (forest.pack);
    the paper's byte-addressable leaves are byte-wide at every precision."""
    node_bytes = 4.0 + PRECISION_BYTES[precision]
    return (2**depth - 1) * node_bytes + 2**depth * n_classes


def dt_energy_pj(depth: int, n_classes: int = 10,
                 precision: str = "fp32") -> float:
    """One decision tree, one example: the visited root-to-leaf path.
    SRAM access energy scales with the tree's table size (a depth-12
    ISOLET tree needs a ~140 KB array, not the 8 KB baseline) and with the
    actual bytes per node entry — an int8-threshold node reads 5 of the
    fp32 entry's 8 bytes, and its array is smaller."""
    s = _sram_scale(tree_bytes(depth, n_classes, precision))
    # node read: {feature idx, threshold, offset} = 4 + threshold bytes
    # (fp32: 8 B = 2 words, the original accounting); feature read: 1 word
    node_words = (4.0 + PRECISION_BYTES[precision]) / 4.0
    per_node = (node_words * E_SRAM_R32) * s + E_SRAM_R32 + E_CMP8
    return depth * per_node


def rf_energy_pj(n_trees: int, depth: int, n_classes: int) -> float:
    vote = n_trees * E_INT32_ADD + n_classes * E_CMP32
    return n_trees * dt_energy_pj(depth, n_classes) + vote


def grove_energy_pj(grove_size: int, depth: int, n_classes: int,
                    precision: str = "fp32") -> float:
    # the data queue stores one BYTE per class (§3.2.2 footnote: byte-
    # addressable Probability Array) -> int8 accumulate, word-packed SRAM
    words = max(1, (n_classes + 3) // 4)
    agg = n_classes * E_INT8_ADD + words * (E_SRAM_R32 + E_SRAM_W32)
    conf = n_classes * E_CMP8 + E_INT8_ADD                     # MaxDiff pass
    return (grove_size * dt_energy_pj(depth, n_classes, precision)
            + agg + conf)


def hop_transfer_energy_pj(n_features: int, n_classes: int) -> float:
    """Queue-entry copy over the handshake: Gamma = 1 + F + 1 + C bytes."""
    gamma_words = int(np.ceil((1 + n_features + 1 + n_classes) / 4))
    return gamma_words * (E_SRAM_R32 + E_SRAM_W32)


# ---------------------------------------------------------- EnergyModel ----
class AffineHopCost:
    """Shared hops -> pJ arithmetic: anything exposing ``per_hop_pj`` and
    ``transfer_pj`` prices a hop vector the same affine way.  Mixed into
    :class:`EnergyModel` (tree-topology pricing) and :class:`AffineEnergy`
    (raw per-hop costs, e.g. the LM layer-grove gate)."""

    def lane_pj(self, hops):
        """Per-example pJ for a [B] hop vector: a tensor is priced in
        float32 on its own device (EvalReport telemetry), anything else as
        a numpy array on the host."""
        if isinstance(hops, torch.Tensor):
            return (hops * self.per_hop_pj
                    + torch.clamp(hops - 1, min=0) * self.transfer_pj)
        h = np.asarray(hops)
        return (h * self.per_hop_pj
                + np.maximum(h - 1, 0) * self.transfer_pj)

    def report(self, hops) -> EnergyReport:
        """Float64 post-hoc report — the original ``fog_energy`` arithmetic,
        bit-for-bit."""
        per_ex = self.lane_pj(np.asarray(hops, np.float64))
        return EnergyReport(float(per_ex.sum()), float(per_ex.mean()))

    def mean_pj(self, mean_hops: float) -> float:
        """Expected pJ/classification at a mean hop count (affinity in hops
        makes the mean exact for any hop distribution with that mean, as
        long as every example hops at least once — which Algorithm 2
        guarantees)."""
        return (mean_hops * self.per_hop_pj
                + max(mean_hops - 1.0, 0.0) * self.transfer_pj)

    def hops_within(self, budget_pj: float) -> int:
        """Largest per-example hop budget whose worst-case cost fits
        ``budget_pj`` (>= 1: the first hop is always spent — a budget below
        one hop's cost still buys one hop, matching FogPolicy.hop_budget's
        floor)."""
        per_extra = self.per_hop_pj + self.transfer_pj
        return max(1, int((budget_pj - self.per_hop_pj) // per_extra) + 1)


@dataclasses.dataclass(frozen=True)
class AffineEnergy(AffineHopCost):
    """Affine hops -> pJ pricing from raw per-hop costs, for evaluation
    paths with no tree topology — the LM layer-grove early-exit gate prices
    a "hop" as one layer-block's MACs.  Same contract as
    :class:`EnergyModel` (``lane_pj`` / ``report`` / ``hops_within``), so
    the serving governor accepts either."""

    per_hop_pj: float
    transfer_pj: float = 0.0
    precision: str = "fp32"


@dataclasses.dataclass(frozen=True)
class EnergyModel(AffineHopCost):
    """Per-classification FoG energy as a pure function of (precision,
    topology, hops).

    One frozen, hashable object per (topology, precision) pair: the engine
    stamps it on every :class:`~repro_torch.core.engine.EvalReport`, and
    :meth:`hops_within` turns a pJ budget into a hop budget.  The cost
    is affine in hops::

        pJ(example) = hops * per_hop_pj + max(hops - 1, 0) * transfer_pj

    (the first grove receives its input from the processor, so an example
    pays one fewer handshake transfer than it pays grove evaluations).
    ``fp32`` reproduces the pre-EnergyModel ``fog_energy`` accounting
    bit-for-bit.
    """

    grove_size: int
    depth: int
    n_classes: int
    n_features: int
    precision: str = "fp32"

    @property
    def per_hop_pj(self) -> float:
        """One grove evaluation: k tree walks + accumulate + MaxDiff."""
        return grove_energy_pj(self.grove_size, self.depth, self.n_classes,
                               self.precision)

    @property
    def transfer_pj(self) -> float:
        """One queue-entry handshake copy between groves."""
        return hop_transfer_energy_pj(self.n_features, self.n_classes)

    @classmethod
    def from_pack(cls, pack, n_features: int) -> "EnergyModel":
        """Model of a :class:`~repro_torch.forest.pack.ForestPack`'s geometry at
        the pack's own precision."""
        return cls(pack.grove_size, pack.depth, pack.n_classes,
                   int(n_features), pack.precision)


def fog_energy(hops: np.ndarray, grove_size: int, depth: int,
               n_classes: int, n_features: int,
               precision: str = "fp32") -> EnergyReport:
    """hops: [B] groves-used per example (FogResult.hops); ``precision`` is
    the packed-table dtype the evaluation ran at (scales the per-node SRAM
    bytes — the paper's dominant energy term).  Thin wrapper over
    :meth:`EnergyModel.report`."""
    return EnergyModel(grove_size, depth, n_classes, n_features,
                       precision).report(hops)


def rf_report(batch: int, n_trees: int, depth: int, n_classes: int) -> EnergyReport:
    e = rf_energy_pj(n_trees, depth, n_classes)
    return EnergyReport(e * batch, e)


# ------------------------------------------------------------ baselines ----
def svm_lr_energy_pj(n_features: int, n_classes: int) -> float:
    return n_classes * n_features * (E_FP32_MAC + E_SRAM_R32)


def svm_rbf_energy_pj(n_features: int, n_classes: int, n_sv: int) -> float:
    per_sv = n_features * (E_FP32_ADD + E_FP32_MULT + E_SRAM_R32) + E_EXP + E_FP32_MAC
    return n_sv * per_sv


def mlp_energy_pj(layer_sizes: list[int]) -> float:
    """layer_sizes: [F, h1, ..., C]."""
    e = 0.0
    for a, b in zip(layer_sizes[:-1], layer_sizes[1:]):
        e += a * b * (E_FP32_MAC + E_SRAM_R32) + b * E_EXP   # matmul + activation
    return e


def cnn_energy_pj(conv_macs: int, dense_macs: int, activations: int) -> float:
    return (conv_macs + dense_macs) * (E_FP32_MAC + E_SRAM_R32) + activations * E_EXP
