from repro_torch.baselines.carry import params_from_jax
from repro_torch.baselines.train import (
    ALL_BASELINES, BASELINE_INIT, FitSetup, TrainedModel, fit_setup,
    fp32_products, train_cnn, train_mlp, train_svm_lr, train_svm_rbf,
)

__all__ = ["ALL_BASELINES", "BASELINE_INIT", "FitSetup", "TrainedModel",
           "fit_setup", "fp32_products", "params_from_jax", "train_cnn",
           "train_mlp", "train_svm_lr", "train_svm_rbf"]
