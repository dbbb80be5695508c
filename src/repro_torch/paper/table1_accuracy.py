"""Table 1 (top): accuracy of 7 classifiers x 5 datasets (port of
``benchmarks/table1_accuracy.py``) from ``common.evaluate_datasets``'
results."""
from __future__ import annotations

from repro_torch.paper.common import COLUMNS


def run(results: dict) -> list[str]:
    rows = ["dataset," + ",".join(COLUMNS)]
    for name, res in results.items():
        rows.append(name + "," + ",".join(
            f"{res[c].accuracy * 100:.1f}" for c in COLUMNS))
    return rows
