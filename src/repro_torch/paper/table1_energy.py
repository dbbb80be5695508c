"""Table 1 (bottom): modeled energy (nJ) per classification, 7 x 5, and
each column's geometric-mean ratio to FoG_opt (port of
``benchmarks/table1_energy.py``).

The paper's ratios at comparable accuracy (:data:`PAPER_RATIOS`): FoG_opt
~1.48x below RF, ~24x below SVM_RBF, ~2.5x below the MLP, ~34.7x below the
CNN, and ~6.5x above SVM_LR.
"""
from __future__ import annotations

import numpy as np

from repro_torch.paper.common import COLUMNS

# column energy / FoG_opt's, as the paper reports them (PAPER.md)
PAPER_RATIOS = {"svm_lr": 1 / 6.5, "svm_rbf": 24.0, "mlp": 2.5,
                "cnn": 34.7, "rf": 1.48}


def geomean_ratios(results: dict) -> dict[str, float]:
    """Per column, the geometric mean over datasets of its energy over
    FoG_opt's."""
    ratios = {c: [] for c in COLUMNS}
    for res in results.values():
        for c in COLUMNS:
            if res["fog_opt"].energy_nj > 0:
                ratios[c].append(res[c].energy_nj / res["fog_opt"].energy_nj)
    return {c: float(np.exp(np.mean(np.log(np.maximum(ratios[c], 1e-9)))))
            for c in COLUMNS}


def run(results: dict) -> list[str]:
    """The rows, from ``common.evaluate_datasets``' results."""
    rows = ["dataset," + ",".join(COLUMNS)]
    for name, res in results.items():
        rows.append(name + "," + ",".join(
            f"{res[c].energy_nj:.2f}" for c in COLUMNS))
    ratios = geomean_ratios(results)
    rows.append("geomean_ratio_vs_fog_opt," + ",".join(
        f"{ratios[c]:.2f}" for c in COLUMNS))
    return rows
