"""Figure 5: run-time tunability -- accuracy and EDP against the threshold,
8 x 2 against 4 x 4 (port of ``benchmarks/fig5_threshold.py``).

``starts(dataset, n_groves) -> [B]`` gives the start groves; without it
each point draws from a generator seeded with 0.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import threshold_sweep
from repro_torch.paper import common
from repro_torch.paper.common import dataset, forest_for

THRESHOLDS = np.asarray([0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 0.9, 1.0])


def run(datasets=None, *, device=None, starts=None) -> list[str]:
    rows = ["dataset,topology,threshold,accuracy,energy_nj,edp"]
    for name in datasets or common.DATASETS:
        ds = dataset(name)
        rf = forest_for(name)
        for grove_size, label in [(2, "8x2"), (4, "4x4")]:
            start = (None if starts is None
                     else starts(name, rf.n_trees // grove_size))
            for p in threshold_sweep(rf, grove_size, ds.x_test, ds.y_test,
                                     THRESHOLDS, device=device,
                                     start=start):
                rows.append(f"{name},{label},{p.threshold:.2f},"
                            f"{p.accuracy:.4f},{p.energy_nj:.4f},"
                            f"{p.edp:.5f}")
    return rows
