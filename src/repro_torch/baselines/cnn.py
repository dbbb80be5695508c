"""CNN baseline (paper §4.1): a small LeNet-style net (port of
``repro.baselines.cnn``).

Tabular datasets are folded to the nearest square "image"; the energy
counts the conv MACs.  The JAX package computes in NHWC with HWIO conv
weights; the port keeps torch's NCHW and OIHW, and matches JAX where the
layouts meet:

* a 3x3 ``SAME`` conv is ``padding=1``;
* the 2x2 stride-2 ``SAME`` max pool pads an odd side with -inf at the
  end, which is ``max_pool2d(..., ceil_mode=True)`` (sides 5 -> 3 -> 2,
  25 -> 13 -> 7);
* the features are flattened in NHWC order, so ``fc1``'s rows are JAX's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.energy import cnn_energy_pj


def image_side(n_features: int) -> int:
    return max(4, int(math.ceil(math.sqrt(n_features))))


def fold_to_image(x: torch.Tensor, n_features: int) -> torch.Tensor:
    """[B, F] -> [B, 1, side, side], zero-padded to side**2 features."""
    side = image_side(n_features)
    x = F.pad(x, (0, side * side - n_features))
    return x.reshape(-1, 1, side, side)


def pooled_side(side: int) -> int:
    """The side after two stride-2 SAME pools: ceil(ceil(s/2)/2)."""
    return -(-(-(-side // 2)) // 2)


def init_cnn(gen: torch.Generator, n_features: int, n_classes: int,
             channels: tuple[int, int] = (8, 16), dense: int = 64):
    """Conv weights OIHW, dense weights [in, out]; drawn from ``gen``."""
    dev = gen.device
    c1, c2 = channels
    flat = pooled_side(image_side(n_features)) ** 2 * c2

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    return {
        "conv1": {"w": normal(c1, 1, 3, 3) * 0.1,
                  "b": torch.zeros((c1,), device=dev)},
        "conv2": {"w": normal(c2, c1, 3, 3) * 0.1,
                  "b": torch.zeros((c2,), device=dev)},
        "fc1": {"w": normal(flat, dense) * math.sqrt(2.0 / flat),
                "b": torch.zeros((dense,), device=dev)},
        "fc2": {"w": normal(dense, n_classes) * 0.1,
                "b": torch.zeros((n_classes,), device=dev)},
    }


def _conv(x, layer):
    return torch.relu(F.conv2d(x, layer["w"], layer["b"], padding=1))


def _pool(x):
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def cnn_logits(params, x: torch.Tensor, n_features: int) -> torch.Tensor:
    img = fold_to_image(x, n_features)
    h = _pool(_conv(img, params["conv1"]))
    h = _pool(_conv(h, params["conv2"]))
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)      # NHWC order
    h = torch.relu(h @ params["fc1"]["w"] + params["fc1"]["b"])
    return h @ params["fc2"]["w"] + params["fc2"]["b"]


def cnn_energy_nj(n_features: int, n_classes: int,
                  channels: tuple[int, int] = (8, 16), dense: int = 64
                  ) -> float:
    side = image_side(n_features)
    c1, c2 = channels
    s1 = -(-side // 2)
    s2 = -(-s1 // 2)
    conv1_macs = side * side * 9 * 1 * c1
    conv2_macs = s1 * s1 * 9 * c1 * c2
    dense_macs = s2 * s2 * c2 * dense + dense * n_classes
    acts = side * side * c1 + s1 * s1 * c2 + dense
    return cnn_energy_pj(conv1_macs + conv2_macs, dense_macs, acts) * 1e-3
