"""Figure 4: accuracy and EDP as a function of the FoG topology (groves x
size), at threshold 0.3 (port of ``benchmarks/fig4_topology.py``).

``starts(dataset, n_groves) -> [B]`` gives each topology's start groves;
without it each draws from a generator seeded with 0.
"""
from __future__ import annotations

import functools

from repro_torch.core import FogPolicy, select_min_edp, topology_sweep
from repro_torch.paper.common import dataset, forest_for


def run(datasets=("isolet", "penbased"), *, device=None,
        starts=None) -> list[str]:
    rows = ["dataset,topology,threshold,accuracy,energy_nj,mean_hops,edp"]
    for name in datasets:
        ds = dataset(name)
        pts = topology_sweep(
            forest_for(name), ds.x_test, ds.y_test,
            policy=FogPolicy(threshold=0.3), device=device,
            start=None if starts is None else functools.partial(starts,
                                                                name))
        for p in pts:
            rows.append(f"{name},{p.n_groves}x{p.grove_size},{p.threshold},"
                        f"{p.accuracy:.4f},{p.energy_nj:.3f},{p.delay:.2f},"
                        f"{p.edp:.4f}")
        pick = select_min_edp(pts)
        rows.append(f"{name},SELECTED:{pick.n_groves}x{pick.grove_size},"
                    f"{pick.threshold},{pick.accuracy:.4f},"
                    f"{pick.energy_nj:.3f},{pick.delay:.2f},{pick.edp:.4f}")
    return rows
