"""Tensorized decision trees (port of ``repro.forest.tree``).

A forest of ``t`` complete binary trees of depth ``d`` over ``C`` classes
is three tensors:

  feature   int32   [t, 2**d - 1]      feature index tested at each internal node
  threshold float32 [t, 2**d - 1]      split threshold (x[f] > thr -> right)
  leaf      float32 [t, 2**d, C]       per-leaf class distribution

Nodes below a real leaf are padded: feature 0, threshold +inf (always go
left), and the real leaf's distribution is replicated to every descendant
leaf slot, so the dense walk returns what the pointer walk would.  Node
``i``'s children are ``2i + 1`` (left) and ``2i + 2`` (right); after ``d``
levels the walk sits at node ``idx`` and reads leaf ``idx - (2**d - 1)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TensorForest:
    """A forest of ``t`` depth-``d`` complete binary trees over ``C`` classes."""

    feature: torch.Tensor    # int32 [t, 2**d - 1]
    threshold: torch.Tensor  # float32 [t, 2**d - 1]
    leaf: torch.Tensor       # float32 [t, 2**d, C]

    @classmethod
    def from_numpy(cls, feature, threshold, leaf) -> "TensorForest":
        """Copy host arrays (numpy, or anything ``np.asarray`` reads) into
        CPU tensors at the canonical dtypes."""
        return cls(torch.tensor(np.asarray(feature, np.int32)),
                   torch.tensor(np.asarray(threshold, np.float32)),
                   torch.tensor(np.asarray(leaf, np.float32)))

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def depth(self) -> int:
        return int(np.log2(self.leaf.shape[1]) + 0.5)

    @property
    def n_classes(self) -> int:
        return self.leaf.shape[2]

    def slice_trees(self, start: int, count: int) -> "TensorForest":
        """Trees ``start .. start + count - 1`` (a truncated forest)."""
        return TensorForest(
            self.feature[start:start + count],
            self.threshold[start:start + count],
            self.leaf[start:start + count],
        )

    def stack_groves(self, grove_size: int) -> "TensorForest":
        """Reshape [t, ...] -> [n_groves, k, ...] (Algorithm 1's Split)."""
        t = self.n_trees
        if t % grove_size:
            raise ValueError(f"{t} trees do not split into groves of "
                             f"{grove_size}")
        g = t // grove_size
        return TensorForest(
            self.feature.reshape(g, grove_size, -1),
            self.threshold.reshape(g, grove_size, -1),
            self.leaf.reshape(g, grove_size, self.leaf.shape[1],
                              self.leaf.shape[2]),
        )


def traverse_one(feature: torch.Tensor, threshold: torch.Tensor,
                 leaf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Walk one tree for one example.  Returns the leaf distribution [C]."""
    depth = int(np.log2(leaf.shape[0]) + 0.5)
    idx = 0
    for _ in range(depth):
        f = int(feature[idx])
        idx = 2 * idx + 1 + int(bool(x[f] > threshold[idx]))
    return leaf[idx - (leaf.shape[0] - 1)]


def grove_traverse(feature: torch.Tensor, threshold: torch.Tensor,
                   leaf: torch.Tensor, x: torch.Tensor,
                   grove: torch.Tensor | None = None) -> torch.Tensor:
    """Leaf distribution each lane reaches in each tree: [B, t, C].

    Tables are ``[t, ...]`` shared by every lane, or ``[G, t, ...]`` with
    ``grove [B]`` naming each lane's grove.  Thresholds are compared as
    given (fp32).  The walk gathers one node per (lane, tree) per level,
    so it never materializes a per-lane copy of the tables.
    """
    t = feature.shape[-2]
    n_leaves = leaf.shape[-2]
    depth = int(np.log2(n_leaves) + 0.5)
    B = x.shape[0]
    tr = torch.arange(t, device=x.device)[None, :]
    sel = (tr,) if grove is None else (grove.long()[:, None], tr)
    idx = torch.zeros((B, t), dtype=torch.long, device=x.device)
    for _ in range(depth):
        f = feature[sel + (idx,)]                           # [B, t]
        thr = threshold[sel + (idx,)]
        xv = torch.gather(x, 1, f.long())
        idx = 2 * idx + 1 + (xv > thr).long()
    return leaf[sel + (idx - (n_leaves - 1),)]              # [B, t, C]


def mean_over_trees(per_tree: torch.Tensor) -> torch.Tensor:
    """[B, t, C] -> [B, C]: sum the trees in order, then divide by ``t``.

    The divisor is a tensor on the operand's device: CUDA divides by a
    Python scalar through its reciprocal, which rounds differently."""
    t = per_tree.shape[1]
    acc = per_tree[:, 0]
    for i in range(1, t):
        acc = acc + per_tree[:, i]
    return acc / acc.new_full((), t)


def forest_proba(forest: TensorForest, x: torch.Tensor) -> torch.Tensor:
    """Mean leaf distribution over trees: [B, C].  (sklearn predict_proba.)"""
    return mean_over_trees(
        grove_traverse(forest.feature, forest.threshold, forest.leaf, x))


def forest_votes(forest: TensorForest, x: torch.Tensor) -> torch.Tensor:
    """Per-tree hard votes -> fp32 one-hot counts [B, C] (conventional RF).

    Each tree votes for the first maximum of its leaf distribution."""
    per_tree = grove_traverse(forest.feature, forest.threshold, forest.leaf,
                              x)
    votes = torch.argmax(per_tree, dim=-1)                     # [B, t]
    return torch.nn.functional.one_hot(votes, forest.n_classes).sum(
        dim=1).to(torch.float32)


def pad_forest(forests: list[TensorForest]) -> TensorForest:
    """Stack single-tree forests (possibly different depths) to common depth."""
    max_depth = max(f.depth for f in forests)
    out = []
    for f in forests:
        while f.depth < max_depth:
            n_leaf = f.leaf.shape[1]
            rows = f.feature.shape[0]
            # graft each leaf as a subtree root: the new level always goes left
            new_feature = torch.cat(
                [f.feature, torch.zeros((rows, n_leaf), dtype=torch.int32)], 1)
            new_threshold = torch.cat(
                [f.threshold, torch.full((rows, n_leaf), float("inf"))], 1)
            # each leaf fills both children; the right one is never reached
            new_leaf = torch.repeat_interleave(f.leaf, 2, dim=1)
            f = TensorForest(new_feature, new_threshold, new_leaf)
        out.append(f)
    return TensorForest(
        torch.cat([f.feature for f in out], 0),
        torch.cat([f.threshold for f in out], 0),
        torch.cat([f.leaf for f in out], 0),
    )
