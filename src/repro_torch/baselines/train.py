"""Shared trainer for the baseline classifiers (paper §4.1 experimental set;
port of ``repro.baselines.train``).

One minibatch-AdamW loop drives all four baselines; each baseline supplies
a (params, logits_fn, loss_fn) triple: softmax cross-entropy for the MLP
and the CNN, multiclass hinge for the SVMs.  The loop is the JAX
package's: ``n // batch`` steps an epoch (the tail dropped), each epoch's
order drawn by ``np.random.default_rng(seed).permutation``, so both
packages visit the same minibatches; gradients come from autograd.

:func:`fit_setup` holds how each baseline trains (its tree, logits, loss,
learning rate and epochs), for the ``train_*`` functions and for checks
that take a few of their steps.

Each ``train_*`` takes ``params``: ``None`` draws the port's own init from
a ``torch.Generator`` seeded with ``seed`` on the device (equal to JAX's
init in distribution only); carried JAX params
(:func:`repro_torch.baselines.carry.params_from_jax`) start both packages
from the same point.  Training and prediction run their products in full
float32 (TF32 off, and cuDNN off for training, restored afterwards), so
the card computes what the CPU does up to the order of its sums.
"""
from __future__ import annotations

import contextlib
import dataclasses
from functools import partial
from typing import Callable

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.baselines import cnn as cnn_mod
from repro_torch.baselines import mlp as mlp_mod
from repro_torch.baselines import svm as svm_mod
from repro_torch.data.synth import Dataset
from repro_torch.optim import adamw, tree_leaves, tree_map, tree_unflatten


@contextlib.contextmanager
def fp32_products(cudnn: bool = True):
    """Products and convolutions in float32, not TF32, inside the block.
    ``cudnn=False``, as training runs, also takes the convolutions from
    PyTorch's own kernels, not cuDNN's: cuDNN's float32 algorithms round
    the CNN's convolutions differently enough to change which entry a max
    pool picks, and the card's training then parts from the CPU's.
    Prediction keeps cuDNN, far faster on the CNN (PERF.md)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = saved[2] and cudnn
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.enabled) = saved


def _xent(scores: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    rows = torch.arange(scores.shape[0], device=scores.device)
    return -torch.mean(torch.log_softmax(scores, dim=-1)[rows, y])


@dataclasses.dataclass
class TrainedModel:
    name: str
    params: object
    predict: Callable   # (params, x [B, F] tensor) -> labels [B]
    accuracy: float
    energy_nj: float    # modeled energy per classification


def _fit(params, logits_fn, loss_fn, ds: Dataset, *, epochs=30, batch=128,
         lr=1e-3, weight_decay=1e-4, seed=0, device=None):
    """AdamW over ``epochs`` passes of ``n // batch`` minibatches."""
    dev = resolve_device(device)
    init, update = adamw(lr=lr, weight_decay=weight_decay)
    params = tree_map(lambda p: p.to(dev), params)
    state = init(params)
    x = torch.as_tensor(ds.x_train, dtype=torch.float32, device=dev)
    y = torch.as_tensor(ds.y_train, dtype=torch.long, device=dev)
    n = x.shape[0]
    steps_per_epoch = max(n // batch, 1)
    rng = np.random.default_rng(seed)
    perms = torch.as_tensor(np.stack([rng.permutation(n)
                                      for _ in range(epochs)]), device=dev)
    with fp32_products(cudnn=False):
        for e in range(epochs):
            for i in range(steps_per_epoch):
                idx = perms[e, i * batch:(i + 1) * batch]
                leaves = [p.detach().requires_grad_()
                          for p in tree_leaves(params)]
                loss = loss_fn(logits_fn(tree_unflatten(params, leaves),
                                         x[idx]), y[idx])
                grads = torch.autograd.grad(loss, leaves)
                with torch.no_grad():
                    params, state = update(
                        tree_unflatten(params, grads), state,
                        tree_unflatten(params, [p.detach() for p in leaves]))
    return params


def _predictor(scores_fn) -> Callable:
    def predict(params, x: torch.Tensor) -> torch.Tensor:
        with fp32_products(), torch.no_grad():
            return torch.argmax(scores_fn(params, x), dim=-1)
    return predict


def _accuracy(predict, params, ds: Dataset, dev) -> float:
    x = torch.as_tensor(ds.x_test, dtype=torch.float32, device=dev)
    return float(np.mean(predict(params, x).cpu().numpy() == ds.y_test))


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


# each baseline's init: (generator, n_features, n_classes, ...) -> params
BASELINE_INIT = {
    "svm_lr": svm_mod.init_linear_svm,
    "svm_rbf": svm_mod.init_rbf_svm,
    "mlp": mlp_mod.init_mlp,
    "cnn": cnn_mod.init_cnn,
}


@dataclasses.dataclass(frozen=True)
class FitSetup:
    """What ``_fit`` trains for one baseline: the tree it steps, the logits
    over that tree, the loss, the learning rate and the epochs;
    ``assemble`` makes the baseline's params of the trained tree."""
    tree: object
    logits: Callable
    loss: Callable
    lr: float
    epochs: int
    assemble: Callable

    def fit(self, ds: Dataset, *, epochs: int | None = None, device=None):
        """The trained tree (``epochs`` overrides the baseline's own)."""
        return _fit(self.tree, self.logits, self.loss, ds,
                    epochs=self.epochs if epochs is None else epochs,
                    lr=self.lr, device=device)


def fit_setup(name: str, params, n_features: int, device=None) -> FitSetup:
    """How ``train_<name>`` trains ``params``: the SVMs at lr 3e-3 on the
    hinge, the MLP and the CNN at 1e-3 on cross-entropy, the CNN for 20
    epochs, the others 30."""
    keep = lambda tree: tree  # noqa: E731
    if name == "svm_lr":
        return FitSetup(params, svm_mod.linear_svm_scores,
                        svm_mod.multiclass_hinge_loss, 3e-3, 30, keep)
    if name == "svm_rbf":
        dev = resolve_device(device)
        lift = svm_mod.RFFParams(params.omega.to(dev), params.phase.to(dev),
                                 params.linear)
        # only the linear head trains; omega/phase are the fixed RFF lift
        return FitSetup(
            lift.linear, lambda lin, x: svm_mod.linear_svm_scores(
                lin, svm_mod.rff_lift(lift, x)),
            svm_mod.multiclass_hinge_loss, 3e-3, 30,
            lambda head: svm_mod.RFFParams(lift.omega, lift.phase, head))
    if name == "mlp":
        return FitSetup(params, mlp_mod.mlp_logits, _xent, 1e-3, 30, keep)
    if name == "cnn":
        return FitSetup(params, partial(cnn_mod.cnn_logits,
                                        n_features=n_features),
                        _xent, 1e-3, 20, keep)
    raise ValueError(f"unknown baseline {name!r}; pick from "
                     f"{sorted(BASELINE_INIT)}")


def _trained(name: str, params, ds: Dataset, dev: torch.device):
    setup = fit_setup(name, params, ds.n_features, dev)
    return setup.assemble(setup.fit(ds, device=dev))


def train_svm_lr(ds: Dataset, seed: int = 0, *, params=None,
                 device=None) -> TrainedModel:
    dev = resolve_device(device)
    if params is None:
        params = BASELINE_INIT["svm_lr"](_generator(dev, seed),
                                         ds.n_features, ds.n_classes)
    params = _trained("svm_lr", params, ds, dev)
    pred = _predictor(svm_mod.linear_svm_scores)
    return TrainedModel("svm_lr", params, pred,
                        _accuracy(pred, params, ds, dev),
                        svm_mod.svm_lr_energy_nj(ds.n_features,
                                                 ds.n_classes))


def train_svm_rbf(ds: Dataset, seed: int = 0, n_rff: int = 512, *,
                  params=None, device=None) -> TrainedModel:
    dev = resolve_device(device)
    if params is None:
        params = BASELINE_INIT["svm_rbf"](_generator(dev, seed),
                                          ds.n_features, ds.n_classes,
                                          n_rff=n_rff)
    params = _trained("svm_rbf", params, ds, dev)
    pred = _predictor(svm_mod.rbf_svm_scores)
    with fp32_products(), torch.no_grad():
        train_scores = svm_mod.rbf_svm_scores(params, torch.as_tensor(
            ds.x_train, dtype=torch.float32, device=dev)).cpu().numpy()
    n_sv = svm_mod.count_support_vectors(train_scores, ds.y_train)
    return TrainedModel("svm_rbf", params, pred,
                        _accuracy(pred, params, ds, dev),
                        svm_mod.svm_rbf_energy_nj(ds.n_features,
                                                  ds.n_classes, n_sv))


def train_mlp(ds: Dataset, seed: int = 0,
              hidden: tuple[int, ...] = (128, 64), *, params=None,
              device=None) -> TrainedModel:
    dev = resolve_device(device)
    if params is None:
        params = BASELINE_INIT["mlp"](_generator(dev, seed), ds.n_features,
                                      ds.n_classes, hidden)
    params = _trained("mlp", params, ds, dev)
    pred = _predictor(mlp_mod.mlp_logits)
    return TrainedModel("mlp", params, pred,
                        _accuracy(pred, params, ds, dev),
                        mlp_mod.mlp_energy_nj(ds.n_features, ds.n_classes,
                                              hidden))


def train_cnn(ds: Dataset, seed: int = 0, *, params=None,
              device=None) -> TrainedModel:
    dev = resolve_device(device)
    if params is None:
        params = BASELINE_INIT["cnn"](_generator(dev, seed), ds.n_features,
                                      ds.n_classes)
    params = _trained("cnn", params, ds, dev)
    pred = _predictor(partial(cnn_mod.cnn_logits, n_features=ds.n_features))
    return TrainedModel("cnn", params, pred,
                        _accuracy(pred, params, ds, dev),
                        cnn_mod.cnn_energy_nj(ds.n_features, ds.n_classes))


ALL_BASELINES = {
    "svm_lr": train_svm_lr,
    "svm_rbf": train_svm_rbf,
    "mlp": train_mlp,
    "cnn": train_cnn,
}
