"""The paper's tables and figures on the port, as CSV blocks (the paper
sections of the JAX package's ``benchmarks/run.py``):

    python -m repro_torch.paper.run [--quick] [--only SECTION,...]
                                    [--device cpu]

Sections: table1_accuracy, table1_energy, fig4_topology, fig5_threshold,
ablation_adaptive.  ``--quick`` evaluates Table 1 and Figure 5 on penbased
and segmentation only (Figure 4 and the ablation keep their datasets, as
the JAX runner's do).  Runs on the card unless ``--device`` names
another.  FoG runs on the ``fused`` backend.  Table 1's two halves
share one evaluation.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.paper import (ablation_adaptive, common, fig4_topology,
                               fig5_threshold, table1_accuracy,
                               table1_energy)

QUICK_DATASETS = ["penbased", "segmentation"]


def sections(*, quick: bool = False, device=None) -> dict:
    """{section: () -> CSV rows}; Table 1 is evaluated once, on first
    use."""
    datasets = QUICK_DATASETS if quick else common.DATASETS
    results: dict = {}

    def table1() -> dict:
        if not results:
            results.update(common.evaluate_datasets(datasets,
                                                    device=device))
        return results

    return {
        "table1_accuracy": lambda: table1_accuracy.run(table1()),
        "table1_energy": lambda: table1_energy.run(table1()),
        "fig4_topology": lambda: fig4_topology.run(device=device),
        "fig5_threshold": lambda: fig5_threshold.run(datasets,
                                                     device=device),
        "ablation_adaptive": lambda: ablation_adaptive.run(device=device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="Table 1 and Figure 5 on two datasets")
    ap.add_argument("--only", default=None,
                    help="comma-separated section names")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    secs = sections(quick=args.quick, device=args.device)
    only = set(args.only.split(",")) if args.only else set(secs)
    unknown = only - set(secs)
    if unknown:
        ap.error(f"unknown sections {sorted(unknown)}; pick from "
                 f"{sorted(secs)}")
    for name, fn in secs.items():
        if name not in only:
            continue
        print(f"\n===== {name} =====", flush=True)
        t0 = time.time()
        for row in fn():
            print(row)
        print(f"----- {name} done in {time.time() - t0:.1f}s", flush=True)
    print("\nall paper sections passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
