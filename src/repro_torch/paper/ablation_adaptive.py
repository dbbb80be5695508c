"""Ablation (beyond the paper): is ADAPTIVITY what earns FoG's energy win?
(port of ``benchmarks/ablation_adaptive.py``)

At each threshold, FoG's mean trees used g* against a static forest of the
first round(g* / grove_size) x grove_size trees, every input using all of
them (a truncated RF).  If adaptive beats static at equal trees, the
paper's mechanism, not merely using fewer trees, earns the saving.

``starts(dataset, n_groves) -> [B]`` gives the start groves; without it
each evaluation draws from a generator seeded with 0.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import FogEngine, FogPolicy, split
from repro_torch.forest import forest_votes
from repro_torch.paper.common import dataset, draw, forest_for, forest_on

THRESHOLDS = (0.1, 0.3, 0.5, 0.7)


def run(datasets=("penbased", "letter"), *, device=None,
        starts=None) -> list[str]:
    dev = resolve_device(device)
    rows = ["dataset,thresh,fog_acc,fog_mean_trees,static_trees,static_acc,"
            "adaptive_gain"]
    for name in datasets:
        ds = dataset(name)
        rf = forest_for(name)
        gc = split(rf, 2)
        engine = FogEngine(gc, backend="fused", device=dev)
        x = torch.as_tensor(ds.x_test, device=dev)
        start = None if starts is None else starts(name, gc.n_groves)
        for thresh in THRESHOLDS:
            gen, st = draw(dev, start)
            res = engine.eval(x, gen, policy=FogPolicy(threshold=thresh),
                              start=st)
            fog_acc = float(np.mean(res.label.cpu().numpy() == ds.y_test))
            mean_trees = float(res.hops.cpu().numpy().mean()) * gc.grove_size
            k = max(2, round(mean_trees / gc.grove_size) * gc.grove_size)
            static = forest_on(rf.slice_trees(0, min(k, rf.n_trees)), dev)
            votes = forest_votes(static, x)
            st_acc = float(np.mean(torch.argmax(votes, -1).cpu().numpy()
                                   == ds.y_test))
            rows.append(f"{name},{thresh},{fog_acc:.4f},{mean_trees:.1f},"
                        f"{min(k, rf.n_trees)},{st_acc:.4f},"
                        f"{fog_acc - st_acc:+.4f}")
    return rows
