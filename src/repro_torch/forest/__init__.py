from repro_torch.forest.tree import (TensorForest, forest_proba,
                                     grove_traverse, mean_over_trees,
                                     pad_forest, traverse_one)
from repro_torch.forest.pack import (PACK_FORMAT_VERSION, PRECISION_BYTES,
                                     PRECISIONS, ForestPack)
from repro_torch.forest.train import (TRAINERS, TrainConfig, bin_features,
                                      quantile_bin_edges, train_random_forest)

__all__ = [
    "TensorForest", "forest_proba", "grove_traverse", "mean_over_trees",
    "pad_forest", "traverse_one",
    "ForestPack", "PRECISIONS", "PRECISION_BYTES", "PACK_FORMAT_VERSION",
    "TRAINERS", "TrainConfig", "train_random_forest", "quantile_bin_edges",
    "bin_features",
]
