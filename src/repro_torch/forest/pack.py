"""ForestPack — the packed representation of grove tables (port of
``repro.forest.pack``).

Dense head-stacked ``[O, G, k, ...]`` feature/threshold/leaf tensors with a
dtype spec:

==========  ===============================================================
precision   table storage
==========  ===============================================================
``fp32``    float32 thresholds/leaves (the training arrays verbatim)
``bf16``    bfloat16 thresholds/leaves, upcast exactly to fp32 on use
``int8``    symmetric per-tree-scaled int8 with fp32 scales; ±127 in the
            thresholds encode the ±inf padding sentinels
==========  ===============================================================

The quantization grids are the JAX package's, bit for bit: per-tree scales
are ``(amax over finite entries + 1e-12) / qmax`` in fp32, rounding is
half-to-even, thresholds clip to [-126, 126].  Packing always computes on
the CPU (CUDA divides by a Python scalar through its reciprocal, which
rounds differently) and the result moves to the source tables' device.

Packs persist as the JAX package's v1 ``.npz`` artifact, field for field:
bf16 tables are stored as their uint16 bits.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch._device import resolve_device

# the table dtype spec every layer shares (FogPolicy.precision's domain)
PRECISIONS = ("fp32", "bf16", "int8")

# bump when the .npz field layout changes; loaders reject newer artifacts
PACK_FORMAT_VERSION = 1

_TABLE_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16,
                "int8": torch.int8}
# threshold bytes per node entry, used by the energy model's byte accounting
PRECISION_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; "
                         f"pick from {PRECISIONS}")


def _per_tree_scale(x: torch.Tensor, dims: tuple[int, ...],
                    qmax: int) -> torch.Tensor:
    """Symmetric per-tree int8 scale: amax over the tree's *finite*
    entries / qmax.  Non-finite entries are the padding sentinels and get
    their own int8 code."""
    finite = torch.where(torch.isfinite(x), x.abs(), torch.zeros_like(x))
    amax = finite.amax(dim=dims, keepdim=True) + 1e-12
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which rounds differently from the CPU and from JAX
    return amax / amax.new_full((), qmax)


def _quantize_leaf(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _quantize_thr(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Thresholds use the [-126, 126] grid; ±127 encode the ±inf padding
    sentinels so "always go left" nodes survive quantization exactly."""
    q = torch.clamp(torch.round(x / scale), -126, 126)
    q = torch.where(x == float("inf"), torch.full_like(q, 127), q)
    q = torch.where(x == float("-inf"), torch.full_like(q, -127), q)
    return q.to(torch.int8)


def _grove_order(G: int, n_shards: int) -> np.ndarray:
    """The ring's strided grove placement: reorder groves so shard s's
    contiguous block is {s, s+n, s+2n, ...}; grove g then sits on shard
    g % n at local offset g // n (``core/fog_ring.py`` reads it from here,
    so the pack needs no import of the ring)."""
    m = G // n_shards
    return np.arange(G).reshape(m, n_shards).T.reshape(-1)


def _tensor(a, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a)).to(dtype)


@dataclasses.dataclass
class ForestPack:
    """Packed grove tables for ``O`` output heads x ``G`` groves x ``k`` trees.

    feature    int32            [O, G, k, 2**d - 1]
    threshold  fp32|bf16|int8   [O, G, k, 2**d - 1]
    leaf       fp32|bf16|int8   [O, G, k, 2**d, C]
    thr_scale  float32          [O, G, k, 1]       per-tree dequant scales
    leaf_scale float32          [O, G, k, 1, 1]    (ones unless ``int8``)
    """

    feature: torch.Tensor
    threshold: torch.Tensor
    leaf: torch.Tensor
    thr_scale: torch.Tensor
    leaf_scale: torch.Tensor
    precision: str = "fp32"
    # derived-table cache: name -> table tuple (dequantized views)
    _layouts: dict = dataclasses.field(default_factory=dict, init=False,
                                       repr=False, compare=False)

    def __post_init__(self):
        _check_precision(self.precision)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_groves(cls, gc, precision: str = "fp32") -> "ForestPack":
        """Pack a GroveCollection (or tuple of heads) at the given precision,
        on the groves' device.  ``fp32`` stores the training arrays
        verbatim."""
        gcs = tuple(gc) if isinstance(gc, (tuple, list)) else (gc,)
        g0 = gcs[0]
        for g in gcs[1:]:
            if (g.feature.shape != g0.feature.shape
                    or g.leaf.shape != g0.leaf.shape):
                raise ValueError(
                    "packed multi-output heads need identical table shapes "
                    f"(one [O, G, k, ...] stack); got leaf "
                    f"{tuple(g.leaf.shape)} vs {tuple(g0.leaf.shape)} — pad "
                    "shallower heads to a common depth first "
                    "(forest.tree.pad_forest grafts leaves without changing "
                    "predictions)")
        feature = torch.stack([g.feature.to(torch.int32) for g in gcs])
        thr = torch.stack([g.threshold.to(torch.float32) for g in gcs])
        leaf = torch.stack([g.leaf.to(torch.float32) for g in gcs])
        return cls._pack(feature, thr, leaf, precision)

    @classmethod
    def from_numpy(cls, feature, threshold, leaf, thr_scale, leaf_scale,
                   precision: str) -> "ForestPack":
        """Adopt already-packed host arrays (e.g. ``np.asarray`` of the JAX
        package's pack fields) as CPU tensors, without re-quantizing."""
        _check_precision(precision)
        thr, lf = np.asarray(threshold), np.asarray(leaf)
        if precision == "bf16":
            # numpy has no bfloat16: carry the raw bits across
            thr = torch.tensor(thr.view(np.uint16).view(np.int16)).view(
                torch.bfloat16)
            lf = torch.tensor(lf.view(np.uint16).view(np.int16)).view(
                torch.bfloat16)
        else:
            thr = _tensor(thr, _TABLE_DTYPE[precision])
            lf = _tensor(lf, _TABLE_DTYPE[precision])
        return cls(_tensor(feature, torch.int32), thr, lf,
                   _tensor(thr_scale, torch.float32),
                   _tensor(leaf_scale, torch.float32), precision)

    @classmethod
    def _pack(cls, feature, thr_f32, leaf_f32, precision: str) -> "ForestPack":
        _check_precision(precision)
        O, G, k = feature.shape[:3]
        ts = torch.ones((O, G, k, 1), dtype=torch.float32,
                        device=feature.device)
        ls = torch.ones((O, G, k, 1, 1), dtype=torch.float32,
                        device=feature.device)
        if precision == "int8":
            ts = _per_tree_scale(thr_f32, dims=(3,), qmax=126)
            ls = _per_tree_scale(leaf_f32, dims=(3, 4), qmax=127)
            thr, leaf = _quantize_thr(thr_f32, ts), _quantize_leaf(leaf_f32, ls)
        else:
            dt = _TABLE_DTYPE[precision]
            thr, leaf = thr_f32.to(dt), leaf_f32.to(dt)
        return cls(feature, thr, leaf, ts, ls, precision)

    def to(self, device=None) -> "ForestPack":
        """The pack on ``device`` (default ``"cuda"``; raises without a
        card unless ``device="cpu"``)."""
        dev = resolve_device(device)
        return ForestPack(self.feature.to(dev), self.threshold.to(dev),
                          self.leaf.to(dev), self.thr_scale.to(dev),
                          self.leaf_scale.to(dev), self.precision)

    def astype(self, precision: str) -> "ForestPack":
        """Repack at another precision (from the dequantized fp32 values)."""
        if precision == self.precision:
            return self
        feat, thr, leaf = self.dequantize()
        return ForestPack._pack(feat, thr, leaf, precision)

    # -- shape & size accounting ------------------------------------------
    @property
    def n_heads(self) -> int:
        return self.feature.shape[0]

    @property
    def n_groves(self) -> int:
        return self.feature.shape[1]

    @property
    def grove_size(self) -> int:
        return self.feature.shape[2]

    @property
    def n_leaves(self) -> int:
        return self.leaf.shape[3]

    @property
    def n_classes(self) -> int:
        return self.leaf.shape[4]

    @property
    def depth(self) -> int:
        return int(np.log2(self.n_leaves) + 0.5)

    @property
    def table_bytes(self) -> int:
        """Total packed bytes (feature + threshold + leaf + dequant scales)."""
        return int(sum(a.numel() * a.element_size()
                       for a in (self.feature, self.threshold, self.leaf,
                                 self.thr_scale, self.leaf_scale)))

    # -- dequantization ----------------------------------------------------
    def dequantize(self):
        """(feature, threshold fp32, leaf fp32) — the exact values every
        backend compares/accumulates (int8 -> q * scale; bf16 -> upcast).
        Computed once per pack."""
        if "dequantized" not in self._layouts:
            from repro_torch.kernels.ref import dequantize_tables
            thr, leaf = dequantize_tables(self.threshold, self.leaf,
                                          self.thr_scale, self.leaf_scale)
            self._layouts["dequantized"] = (self.feature, thr, leaf)
        return self._layouts["dequantized"]

    def to_groves(self) -> tuple:
        """Dequantized per-head GroveCollections (fp32 evaluation views)."""
        from repro_torch.core.grove import GroveCollection
        feat, thr, leaf = self.dequantize()
        return tuple(GroveCollection(feat[o], thr[o], leaf[o])
                     for o in range(self.n_heads))

    # -- layouts -----------------------------------------------------------
    def layout(self, name: str, n_shards: int = 1):
        """Table tuple for one evaluation layout.

        ``"fused"``  the canonical head-stacked ``[O, G, ...]`` storage plus
                     scales, served as-is.
        ``"ring"``   head-0 tables strided-reordered for ``n_shards`` ring
                     shards (shard s hosts groves ``{s, s+n, ...}``), scales
                     reordered alongside; computed once per
                     ``(name, n_shards)``.
        """
        if name == "fused":
            return (self.feature, self.threshold, self.leaf,
                    self.thr_scale, self.leaf_scale)
        if name != "ring":
            raise ValueError(f"unknown layout {name!r}; "
                             "pick 'fused' or 'ring'")
        key = (name, n_shards)
        if key not in self._layouts:
            if self.n_heads != 1:
                raise NotImplementedError("ring layout is single-output")
            if n_shards < 1 or self.n_groves % n_shards:
                raise ValueError(f"n_groves={self.n_groves} does not divide "
                                 f"over {n_shards} ring shards")
            order = torch.as_tensor(_grove_order(self.n_groves, n_shards),
                                    device=self.feature.device)
            self._layouts[key] = tuple(
                a[0][order] for a in (self.feature, self.threshold,
                                      self.leaf, self.thr_scale,
                                      self.leaf_scale))
        return self._layouts[key]

    # -- per-lane gathered evaluation -------------------------------------
    def predict_proba(self, head: int, g_idx: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
        """Grove(g_idx[b]).predict_prob(x[b]) against the packed tables:
        [B, C].  The walk compares and accumulates the dequantized values
        (elementwise, so identical to dequantizing after each gather)."""
        from repro_torch.forest.tree import grove_traverse, mean_over_trees
        feat, thr, leaf = self.dequantize()
        return mean_over_trees(
            grove_traverse(feat[head], thr[head], leaf[head], x, g_idx))

    # -- persistence -------------------------------------------------------
    def save(self, path, extra: dict | None = None) -> Path:
        """Write a versioned ``.npz`` model artifact (the JAX package's v1
        format).  bf16 tables are stored as raw uint16 bits; ``extra`` is a
        JSON-serializable dict returned by ``load_with_meta``."""
        path = Path(path)
        thr, leaf = self.threshold.cpu(), self.leaf.cpu()
        if self.precision == "bf16":
            thr = thr.view(torch.int16).numpy().view(np.uint16)
            leaf = leaf.view(torch.int16).numpy().view(np.uint16)
        else:
            thr, leaf = thr.numpy(), leaf.numpy()
        with open(path, "wb") as f:
            np.savez(
                f,
                format_version=np.int64(PACK_FORMAT_VERSION),
                precision=np.str_(self.precision),
                feature=self.feature.cpu().numpy(),
                threshold=thr,
                leaf=leaf,
                thr_scale=self.thr_scale.cpu().numpy(),
                leaf_scale=self.leaf_scale.cpu().numpy(),
                extra_json=np.str_(json.dumps(extra or {})),
            )
        return path

    @classmethod
    def load(cls, path) -> "ForestPack":
        return cls.load_with_meta(path)[0]

    # every field a v1 artifact must carry; validated at load so a
    # truncated/foreign .npz fails with a schema error, not a raw KeyError
    _REQUIRED_FIELDS = ("precision", "feature", "threshold", "leaf",
                        "thr_scale", "leaf_scale", "extra_json")

    @classmethod
    def load_with_meta(cls, path) -> tuple["ForestPack", dict]:
        """(pack on the CPU, extra-metadata dict) from a ``save`` artifact."""
        with np.load(Path(path), allow_pickle=False) as z:
            if "format_version" not in z:
                raise ValueError(
                    f"{path} is not a ForestPack artifact (missing "
                    "format_version; this build writes/reads format "
                    f"v{PACK_FORMAT_VERSION})")
            version = int(z["format_version"])
            if version > PACK_FORMAT_VERSION:
                raise ValueError(
                    f"{path} is ForestPack format v{version}; this build "
                    f"reads up to v{PACK_FORMAT_VERSION} — upgrade the code "
                    "or re-export the model")
            missing = [k for k in cls._REQUIRED_FIELDS if k not in z]
            if missing:
                raise ValueError(
                    f"{path} is a corrupt/truncated ForestPack v{version} "
                    f"artifact: missing fields {missing} (format "
                    f"v{PACK_FORMAT_VERSION} requires "
                    f"{list(cls._REQUIRED_FIELDS)})")
            precision = str(z["precision"])
            if precision not in PRECISIONS:
                raise ValueError(
                    f"{path}: artifact precision {precision!r} is not a "
                    f"supported table dtype (pick from {PRECISIONS})")
            pack = cls.from_numpy(z["feature"], z["threshold"], z["leaf"],
                                  z["thr_scale"], z["leaf_scale"], precision)
            extra = json.loads(str(z["extra_json"]))
        return pack, extra
