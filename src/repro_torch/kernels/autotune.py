"""Measured configurations of the fused FoG kernel and of the trainer's
histogram (port of ``repro.kernels.autotune``), one table and one cache
file for both.

**The fused half.**  A configuration is what the port's fused launch
chooses (``kernels/fused_fog.py``): the route (``"smem"``, ``"l1"`` or
``"lane"``), K (``hops_per_walk``, the hops whose trees a lane's group
walks at once; ``None`` on the lane route, which walks one hop at a
time), ``block_b`` (the most threads a block runs, the cap ``_groups``
takes) and ``chunk_b`` (``None``, or the lanes of each launch when the
engine splits the batch).  JAX's ``compact`` knob has no field: the port's
kernel keeps no live-lane compaction to switch (each lane's group stops
when the lane dies), so there is nothing to measure.  Entries are keyed by

    key = (precision, n_heads, n_groves, grove_size, depth, n_classes,
           n_features, batch bucket)

JAX's pack signature plus the batch rounded up to a power of two: on the
card K and the route move with B (``fused_fog.walk_hops`` and
``fused_fog.route``), where in JAX's VMEM model they did not.

``best_config(...)`` is what ``FogEngine`` (and the serving plane, and
through the engine the paper path) consults when ``block_b`` is unset: on
a CUDA device a measured entry wins; otherwise the ANALYTIC SEED answers,
which is the launch rule itself (``fused_fog.route``, ``walk_hops``,
:data:`~repro_torch.kernels.fused_fog.FUSED_BLOCK_B` threads, no chunk),
so an untuned engine launches what the rule launches.  ``tune()`` times
every route the shapes fit x K x ``block_b`` on the card, and chunked
evaluation where chunks keep K at ``max_hops``, each candidate held
``torch.equal`` to the seed's output before it may win.

**The histogram half.**  The trainer's per-level histogram has two paths
(``kernels/histogram.py``): the CUDA kernel, and the segment-sum twin.
``histogram_level`` takes the kernel while the level's ``nodes *
n_classes`` rows are at most ``matmul_max_r`` (the JAX package's name for
the crossover) and the twin above it.  Its entries are keyed by the
trainer signature

    key = ("hist", n_trees, depth, n_features, n_bins, n_classes)

``best_hist_config(...)`` answers with a measured entry for a CUDA device
when one exists, else with the analytic seed, without benchmarking;
``tune_histogram()`` times the kernel against the twin per level.

Measured entries of either kind steer CUDA devices only: a CPU engine or
trainer always takes the seed.  Set ``FOG_TORCH_AUTOTUNE_CACHE=/path/
file.json`` to persist winners across processes (loaded lazily, written
atomically; both kinds in one file).  The file is the port's own: the JAX
package's ``FOG_AUTOTUNE_CACHE`` holds no measurement of this card and is
never read.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

CACHE_ENV = "FOG_TORCH_AUTOTUNE_CACHE"
# the sweep's threads-per-block ladder
BLOCKS = (64, 128, 256, 512)

# in-process table: key tuple -> TuneResult | HistConfig
_CACHE: dict[tuple, "TuneResult | HistConfig"] = {}
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


@dataclass(frozen=True)
class TuneResult:
    """One ``fused_fog`` launch configuration: the route, K (``None`` on
    the lane route, or for the rule's), the most threads a block runs and
    the chunk (``None``: the whole batch in one launch).  ``route=None``
    is the rule's pick at launch (the CPU's seed: the plain version has
    no route)."""
    route: str | None
    hops_per_walk: int | None
    block_b: int
    chunk_b: int | None = None
    measured_s: float | None = None   # None: analytic seed, never measured
    source: str = "analytic"          # "analytic" | "measured" | "cache-file"

    def to_dict(self) -> dict:
        return {"route": self.route, "hops_per_walk": self.hops_per_walk,
                "block_b": self.block_b, "chunk_b": self.chunk_b,
                "measured_s": self.measured_s, "source": self.source}

    def describe(self) -> str:
        k = "" if self.hops_per_walk is None else f" K={self.hops_per_walk}"
        c = "" if self.chunk_b is None else f" chunk {self.chunk_b}"
        return f"{self.route}{k} block_b={self.block_b}{c}"


def _fused_fog():
    # imported at first use: kernels.fused_fog imports kernels.ref, which
    # imports forest, whose trainer imports this module
    from repro_torch.kernels import fused_fog
    return fused_fog


def batch_bucket(batch: int) -> int:
    """The batch rounded up to a power of two (the key's last entry)."""
    return 1 << max(0, int(batch) - 1).bit_length()


def pack_key(pack, n_features: int, batch: int) -> tuple:
    """The (precision, field size, batch bucket) signature a tuned config
    is valid for."""
    return (pack.precision, pack.n_heads, pack.n_groves, pack.grove_size,
            pack.depth, pack.n_classes, int(n_features), batch_bucket(batch))


def _shape(pack, n_features: int) -> tuple:
    """(O, G, t, depth, C, F, itemsize): the launch rules' field shape."""
    return (pack.n_heads, pack.n_groves, pack.grove_size, pack.depth,
            pack.n_classes, int(n_features), pack.threshold.element_size())


@functools.lru_cache(maxsize=4096)
def _seed(B: int, O: int, G: int, t: int, depth: int, C: int, F: int,
          itemsize: int, max_hops: int, n_sm: int, optin: int) -> TuneResult:
    ff = _fused_fog()
    name = ff.route(B, O, G, t, depth, C, F, itemsize, max_hops,
                    ff.FUSED_BLOCK_B, n_sm, optin)
    K = None if name == "lane" else ff.walk_hops(B, max_hops, O, t, C, n_sm)
    return TuneResult(route=name, hops_per_walk=K, block_b=ff.FUSED_BLOCK_B)


def seed_config(pack, n_features: int, batch: int, max_hops: int, *,
                n_sm: int | None, smem_optin: int | None) -> TuneResult:
    """The analytic seed: the launch rule at this batch on a card of
    ``n_sm`` SMs and ``smem_optin`` bytes of shared memory a block --
    ``fused_fog.route`` at :data:`~repro_torch.kernels.fused_fog
    .FUSED_BLOCK_B` threads, ``walk_hops``, no chunk.  Without a card
    (``n_sm=None``) the route is left to the launch (``None``)."""
    ff = _fused_fog()
    if n_sm is None:
        return TuneResult(route=None, hops_per_walk=None,
                          block_b=ff.FUSED_BLOCK_B)
    return _seed(int(batch), *_shape(pack, n_features), int(max_hops),
                 int(n_sm), int(smem_optin))


def _fit(cfg: TuneResult, pack, n_features: int, batch: int,
         max_hops: int, n_sm: int, optin: int) -> TuneResult:
    """A measured entry at this exact batch: K at most ``max_hops``, and
    the "smem" route only where its block still fits the card's shared
    memory at the lanes a launch takes (a bucket spans batches whose
    blocks differ), else "l1" with the same K and threads."""
    ff = _fused_fog()
    K = cfg.hops_per_walk
    if K is not None:
        K = min(K, max_hops)
    name = cfg.route
    if name == "smem":
        B = min(batch, cfg.chunk_b or batch)
        p = ff.plan("smem", B, *_shape(pack, n_features), max_hops,
                    cfg.block_b, n_sm, K)
        if p["smem"] > optin:
            name = "l1"
    if (name, K) == (cfg.route, cfg.hops_per_walk):
        return cfg
    return dataclasses.replace(cfg, route=name, hops_per_walk=K)


def best_config(pack, n_features: int, batch: int, max_hops: int,
                device=None) -> TuneResult:
    """The config a fused evaluation of ``batch`` lanes on ``device``
    (default CUDA) takes when ``block_b`` is unset: a measured entry for
    this signature on a CUDA device, else the analytic seed."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return seed_config(pack, n_features, batch, max_hops, n_sm=None,
                           smem_optin=None)
    n_sm, optin = _build.sm_count(dev), _build.smem_optin(dev)
    _load_cache_file()
    hit = _CACHE.get(pack_key(pack, n_features, batch))
    if hit is None:
        return seed_config(pack, n_features, batch, max_hops, n_sm=n_sm,
                           smem_optin=optin)
    return _fit(hit, pack, n_features, batch, max_hops, n_sm, optin)


def hop_ladder(max_hops: int) -> list[int]:
    """K's candidates: ``max_hops``, then halvings (rounded up) to 1."""
    out, K = [max_hops], max_hops
    while K > 1:
        K = -(-K // 2)
        out.append(K)
    return out


def chunk_lanes(pack, n_features: int, max_hops: int, n_sm: int) -> int:
    """The largest batch for which ``walk_hops`` still gives ``max_hops``
    (0 when the group kernel cannot hold the lane state)."""
    ff = _fused_fog()
    O, _, t, _, C, _, _ = _shape(pack, n_features)
    group = ff.group_size(O, t, C, max_hops)
    return 0 if group is None else n_sm * ff.SM_THREADS // group


def candidates(pack, n_features: int, batch: int, max_hops: int, *,
               n_sm: int, smem_optin: int,
               blocks: tuple[int, ...] = BLOCKS) -> list[TuneResult]:
    """The sweep: the seed first, then every route the shapes fit x K in
    :func:`hop_ladder` x ``blocks`` (one candidate per distinct launch),
    then chunks of :func:`chunk_lanes` on the seed's rule where that is
    under the batch."""
    ff = _fused_fog()
    shape = _shape(pack, n_features)
    seed = seed_config(pack, n_features, batch, max_hops, n_sm=n_sm,
                       smem_optin=smem_optin)
    out, seen = [seed], set()

    def launch(name, K, b):
        p = ff.plan(name, batch, *shape, max_hops, b, n_sm, K)
        return (name, tuple(sorted(p.items())))

    seen.add(launch(seed.route, seed.hops_per_walk, seed.block_b))
    for name in ff.ROUTES:
        for b in blocks:
            for K in ([None] if name == "lane" else hop_ladder(max_hops)):
                try:
                    sig = launch(name, K, b)
                except ValueError:          # lane state over the registers
                    continue
                if sig in seen or (name == "smem"
                                   and dict(sig[1])["smem"] > smem_optin):
                    continue
                seen.add(sig)
                out.append(TuneResult(route=name, hops_per_walk=K, block_b=b))
    lanes = chunk_lanes(pack, n_features, max_hops, n_sm)
    if 0 < lanes < batch:
        out.append(dataclasses.replace(
            _seed(lanes, *shape, max_hops, n_sm, smem_optin), chunk_b=lanes))
    return out


# clock cycles the card sleeps before a timed batch of calls (~10 ms at
# the H100's 1.98 GHz), and the calls a batch holds: the host enqueues the
# batch while the card sleeps, so the events between the sleep and the end
# of the batch time the device's work alone, not the host's ~0.1 ms of
# Python a call (an eval's kernel takes ~0.01 ms)
SLEEP_CYCLES = 20_000_000
CALLS_PER_TIMING = 10


def _event_s(fn, repeats: int) -> float:
    """Best-of-``repeats`` device seconds of one ``fn`` call: CUDA events
    around ``CALLS_PER_TIMING`` calls enqueued behind a sleeping kernel,
    after one warm call."""
    fn()
    best = None
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(CALLS_PER_TIMING):
            fn()
        end.record()
        end.synchronize()
        t = start.elapsed_time(end) / 1e3 / CALLS_PER_TIMING
        best = t if best is None else min(best, t)
    return best


def tune(pack, x, start, thresh, budget, *, max_hops: int,
         repeats: int = 3, persist: bool = True,
         blocks: tuple[int, ...] = BLOCKS,
         report: list | None = None) -> TuneResult:
    """Measured sweep of :func:`candidates` on the card.

    ``x/start/thresh/budget`` (CUDA tensors) should be representative of
    the traffic: K's best value moves with how early lanes exit.  Each
    candidate runs the engine's fused evaluation (``_eval_core`` through
    ``ops.fused_fog`` on its route and K, chunked as the engine chunks);
    its proba and hops must be ``torch.equal`` to the seed's, else it
    raises naming the route, K and threads (a kernel fault, not a tuning
    result).  Then it is timed with CUDA events, warm, best of
    ``repeats`` (:func:`_event_s`: the device's time, the host's hidden
    behind a sleeping kernel).  The fastest is cached under
    :func:`pack_key` (and persisted to ``$FOG_TORCH_AUTOTUNE_CACHE`` when
    set and ``persist``); ``report``, if given, receives every
    ``(candidate, seconds)``."""
    ff = _fused_fog()
    from repro_torch.core.engine import fused_eval
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"tune times the CUDA kernel; it needs a CUDA "
                         f"device, got {dev}")
    B, F = x.shape
    n_sm, optin = _build.sm_count(dev), _build.smem_optin(dev)

    def run(cfg: TuneResult):
        return fused_eval(pack, x, start, thresh, budget, max_hops, cfg)

    cands = candidates(pack, F, B, max_hops, n_sm=n_sm, smem_optin=optin,
                       blocks=blocks)
    want = run(cands[0])
    best: TuneResult | None = None
    for cfg in cands:
        got = run(cfg)
        if not (torch.equal(got.proba, want.proba)
                and torch.equal(got.hops, want.hops)):
            p = ff.plan(cfg.route, cfg.chunk_b or B, *_shape(pack, F),
                        max_hops, cfg.block_b, n_sm, cfg.hops_per_walk)
            raise RuntimeError(
                f"fused_fog on route {cfg.route}, K={cfg.hops_per_walk}, "
                f"{p['threads']} threads a block (block_b {cfg.block_b}, "
                f"chunk {cfg.chunk_b}) differs from the seed "
                f"{cands[0].describe()} on the same inputs")
        t = _event_s(lambda: run(cfg), repeats)
        if report is not None:
            report.append((cfg, t))
        if best is None or t < best.measured_s:
            best = dataclasses.replace(cfg, measured_s=t, source="measured")
    _CACHE[pack_key(pack, F, B)] = best
    if persist:
        _save_cache_file()
    return best


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
    signature (and persisted to ``$FOG_TORCH_AUTOTUNE_CACHE`` when set and
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
        if key[0] == "hist":
            _CACHE[key] = HistConfig(block=int(cfg["block"]),
                                     matmul_max_r=int(cfg["matmul_max_r"]),
                                     measured_s=cfg.get("measured_s"),
                                     source="cache-file")
        else:
            _CACHE[key] = TuneResult(
                route=cfg["route"], hops_per_walk=cfg["hops_per_walk"],
                block_b=int(cfg["block_b"]), chunk_b=cfg["chunk_b"],
                measured_s=cfg.get("measured_s"), source="cache-file")


def _save_cache_file() -> None:
    path = os.environ.get(CACHE_ENV)
    if not path:
        return
    payload = {"/".join(map(str, k)): v.to_dict() for k, v in _CACHE.items()}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
