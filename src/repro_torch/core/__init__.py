from repro_torch.core.confidence import maxdiff, maxdiff_multioutput, top2
from repro_torch.core.grove import (GroveCollection, gc_train,
                                    grove_predict_proba, split)
from repro_torch.core.policy import (BACKENDS, NO_BUDGET, PRECISIONS,
                                    FogPolicy, margin_backend)
from repro_torch.core.energy import (
    AffineEnergy, AffineHopCost, EnergyModel, EnergyReport, fog_energy,
    rf_report, dt_energy_pj, rf_energy_pj, grove_energy_pj,
    svm_lr_energy_pj, svm_rbf_energy_pj, mlp_energy_pj, cnn_energy_pj,
)
from repro_torch.core.fog_ring import RingMesh, ring_eval
from repro_torch.core.engine import (EvalReport, FogEngine, FogResult,
                                     TableCache, confidence_margin,
                                     hop_update, sample_starts)
from repro_torch.core.budget import (
    TopologyPoint, evaluate_topology, policy_sweep, topology_sweep,
    select_min_edp, threshold_sweep, find_opt_threshold,
)
from repro_torch.core.frontier import (
    Frontier, FrontierPoint, auto_policy, build_frontier, default_grid,
    sweep_policies,
)
from repro_torch.forest.pack import ForestPack

__all__ = [
    "maxdiff", "maxdiff_multioutput", "top2",
    "GroveCollection", "gc_train", "split", "grove_predict_proba",
    "BACKENDS", "NO_BUDGET", "PRECISIONS", "FogPolicy", "margin_backend",
    "AffineEnergy", "AffineHopCost", "EnergyModel", "EnergyReport",
    "fog_energy", "rf_report", "dt_energy_pj", "rf_energy_pj",
    "grove_energy_pj", "svm_lr_energy_pj", "svm_rbf_energy_pj",
    "mlp_energy_pj", "cnn_energy_pj",
    "EvalReport", "FogEngine", "FogResult", "TableCache",
    "confidence_margin", "hop_update", "sample_starts", "ForestPack",
    "RingMesh", "ring_eval",
    "TopologyPoint", "evaluate_topology", "policy_sweep", "topology_sweep",
    "select_min_edp", "threshold_sweep", "find_opt_threshold",
    "Frontier", "FrontierPoint", "auto_policy", "build_frontier",
    "default_grid", "sweep_policies",
]
