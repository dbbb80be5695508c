from repro_torch.forest.tree import (TensorForest, forest_proba,
                                     forest_votes, grove_traverse,
                                     mean_over_trees, pad_forest,
                                     traverse_one)
from repro_torch.forest.pack import (PACK_FORMAT_VERSION, PRECISION_BYTES,
                                     PRECISIONS, ForestPack)
from repro_torch.forest.train import (GAIN_EPS, TRAINERS, TrainConfig,
                                      bin_features, quantile_bin_edges,
                                      resolve_max_features,
                                      train_random_forest)
from repro_torch.forest.grow import grow_forest
from repro_torch.forest.rf import rf_predict, rf_predict_proba

__all__ = [
    "TensorForest", "forest_proba", "forest_votes", "grove_traverse",
    "mean_over_trees", "pad_forest", "traverse_one",
    "ForestPack", "PRECISIONS", "PRECISION_BYTES", "PACK_FORMAT_VERSION",
    "GAIN_EPS", "TRAINERS", "TrainConfig", "train_random_forest",
    "quantile_bin_edges", "bin_features", "resolve_max_features",
    "grow_forest", "rf_predict", "rf_predict_proba",
]
