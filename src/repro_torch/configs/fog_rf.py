"""The paper's own system: FoG-of-random-forest configuration (§4.1).

Not an LM architecture — this is the classifier the paper builds.  The
values reflect the paper's min-EDP design pick (16 DTs in an 8x2 topology,
threshold as the run-time knob) and drive examples/quickstart.py,
benchmarks/table1_*, fig4, fig5.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class FogRFConfig:
    n_trees: int = 16
    n_groves: int = 8           # the paper's selected 8x2 topology
    grove_size: int = 2
    max_depth: int = 8          # per-dataset depths in benchmarks/common.py
    threshold: float = 0.5      # FoG_opt operating point (accuracy-optimal)
    max_hops: int = 8           # = n_groves: the whole forest at most
    datasets: tuple = ("isolet", "penbased", "mnist", "letter", "segmentation")


CONFIG = FogRFConfig()
