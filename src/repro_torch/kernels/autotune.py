"""Histogram-path configuration for the device trainer (port of the
histogram half of ``repro.kernels.autotune``).

The trainer's per-level histogram has two paths (``kernels/histogram.py``):
the CUDA kernel, and the segment-sum twin.  ``histogram_level`` takes the
kernel while the level's ``nodes * n_classes`` rows are at most
``matmul_max_r`` (the JAX package's name for the crossover) and the twin
above it.  Configurations are keyed by the trainer signature

    key = ("hist", n_trees, depth, n_features, n_bins, n_classes)

``best_hist_config(...)`` answers with a measured entry for a CUDA device
when one exists, else with the analytic seed, without benchmarking.
``tune_histogram()`` times the kernel against the twin per level on the
card and caches the winner; set ``FOG_TORCH_HIST_CACHE=/path/file.json`` to
persist winners across processes (loaded lazily, written atomically).  This
file is the port's own: the JAX package's ``FOG_AUTOTUNE_CACHE`` holds no
measurement of this card and is never read.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import torch

CACHE_ENV = "FOG_TORCH_HIST_CACHE"

# in-process table: key tuple -> HistConfig
_CACHE: dict[tuple, "HistConfig"] = {}
_LOADED_FROM: str | None = None


@dataclass(frozen=True)
class HistConfig:
    """One trainer-histogram configuration: the kernel's threads per block
    and the path crossover (see kernels/histogram.py)."""
    block: int
    matmul_max_r: int                 # the CUDA kernel while R <= this
    measured_s: float | None = None   # None: analytic seed, never measured
    source: str = "analytic"          # "analytic" | "measured" | "cache-file"

    def to_dict(self) -> dict:
        return {"block": self.block, "matmul_max_r": self.matmul_max_r,
                "measured_s": self.measured_s, "source": self.source}


def hist_key(n_trees: int, depth: int, n_features: int, n_bins: int,
             n_classes: int) -> tuple:
    """The trainer signature a tuned histogram config is valid for."""
    return ("hist", int(n_trees), int(depth), int(n_features), int(n_bins),
            int(n_classes))


def analytic_hist_config(n_trees: int, depth: int, n_features: int,
                         n_bins: int, n_classes: int,
                         device=None) -> HistConfig:
    """Seed histogram config, answered without benchmarking.

    On a CUDA device the kernel writes the level's output once, and adds
    each weight once, in shared memory; the twin zeroes the same output
    and adds whole one-hot rows into it.  So the seed sends every level of
    the signature to the kernel.  On the
    CPU the kernel slot is the plain one-hot contraction, whose work grows
    with the rows, and the segment-sum twin always wins: the seed is
    twin-everywhere.
    """
    from repro_torch.kernels.histogram import DEFAULT_BLOCK
    dev = torch.device("cuda" if device is None else device)
    top = 0 if dev.type != "cuda" else (1 << (depth - 1)) * n_classes
    return HistConfig(block=DEFAULT_BLOCK, matmul_max_r=top)


def best_hist_config(n_trees: int, depth: int, n_features: int, n_bins: int,
                     n_classes: int, device=None) -> HistConfig:
    """The config the device trainer uses on ``device`` (default CUDA): a
    measured entry for this signature on a CUDA device, else the analytic
    seed."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        _load_cache_file()
        hit = _CACHE.get(hist_key(n_trees, depth, n_features, n_bins,
                                  n_classes))
        if hit is not None:
            return hit
    return analytic_hist_config(n_trees, depth, n_features, n_bins,
                                n_classes, dev)


def _sync_s(fn, device: torch.device, repeats: int) -> float:
    """Best-of-``repeats`` seconds of ``fn`` between two synchronizes,
    after one warm call."""
    fn()
    best = None
    for _ in range(repeats):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        t = time.perf_counter() - t0
        best = t if best is None else min(best, t)
    return best


def tune_histogram(n_trees: int, depth: int, n_features: int, n_bins: int,
                   n_classes: int, *, n_samples: int, seed: int = 0,
                   repeats: int = 3, persist: bool = True, device=None,
                   blocks: tuple[int, ...] = (128, 256, 512)) -> HistConfig:
    """Measured histogram sweep on synthetic level shapes, on the card.

    Times the kernel over the ``blocks`` ladder at a shallow probe level,
    then each level's kernel against the segment-sum twin (its one-hot
    rows built once, as the trainer builds them).  ``matmul_max_r`` is the
    largest row count up to which the kernel wins at every level; the walk
    stops at the first level the twin wins, since the dispatcher tests
    ``R <= matmul_max_r``.  The winner is cached under the trainer
    signature (and persisted to ``$FOG_TORCH_HIST_CACHE`` when set and
    ``persist``).
    """
    from repro_torch.kernels import histogram
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError("tune_histogram times the CUDA kernel; it needs a "
                         f"CUDA device, got {dev}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randint(0, n_classes, (n_samples,), generator=gen, device=dev,
                      dtype=torch.int32)
    bins = torch.randint(0, n_bins, (n_samples, n_features), generator=gen,
                         device=dev, dtype=torch.uint8)
    w = torch.ones((n_trees, n_samples), dtype=torch.float32, device=dev)
    wu = histogram.onehot_rows(bins, w, n_bins)

    def node_at(level: int) -> torch.Tensor:
        return torch.randint(0, 1 << level, (n_trees, n_samples),
                             generator=gen, device=dev, dtype=torch.int32)

    probe = min(2, depth - 1)
    node = node_at(probe)
    kw = dict(n_nodes=1 << probe, n_bins=n_bins, n_classes=n_classes)
    times = {b: _sync_s(lambda b=b: histogram.histogram_level_cuda(
        node, y, w, bins, block=b, **kw), dev, repeats) for b in blocks}
    block = min(times, key=times.get)

    matmul_max_r, total, kernel_alive = 0, 0.0, True
    for level in range(depth):
        node = node_at(level)
        kw = dict(n_nodes=1 << level, n_bins=n_bins, n_classes=n_classes)
        t_sc = _sync_s(lambda: histogram.histogram_level_scatter(
            node, y, w, bins, wu=wu, **kw), dev, repeats)
        if not kernel_alive:
            total += t_sc
            continue
        t_k = _sync_s(lambda: histogram.histogram_level_cuda(
            node, y, w, bins, block=block, **kw), dev, repeats)
        total += min(t_k, t_sc)
        if t_k < t_sc:
            matmul_max_r = (1 << level) * n_classes
        else:
            kernel_alive = False

    best = HistConfig(block=block, matmul_max_r=matmul_max_r,
                      measured_s=total, source="measured")
    _CACHE[hist_key(n_trees, depth, n_features, n_bins, n_classes)] = best
    if persist:
        _save_cache_file()
    return best


def clear_cache() -> None:
    """Drop every in-process entry (does not touch the cache file)."""
    global _LOADED_FROM
    _CACHE.clear()
    _LOADED_FROM = None


def _load_cache_file() -> None:
    global _LOADED_FROM
    path = os.environ.get(CACHE_ENV)
    if not path or _LOADED_FROM == path:
        return
    _LOADED_FROM = path
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return
    for kstr, cfg in raw.items():
        parts = kstr.split("/")
        key = (parts[0], *map(int, parts[1:]))
        if key in _CACHE:       # fresher in-process measurements win
            continue
        _CACHE[key] = HistConfig(block=int(cfg["block"]),
                                 matmul_max_r=int(cfg["matmul_max_r"]),
                                 measured_s=cfg.get("measured_s"),
                                 source="cache-file")


def _save_cache_file() -> None:
    path = os.environ.get(CACHE_ENV)
    if not path:
        return
    payload = {"/".join(map(str, k)): v.to_dict() for k, v in _CACHE.items()}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
