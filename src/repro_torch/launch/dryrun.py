"""Dry run of an (arch x shape) cell on one card, on the ``meta`` device
(the one-card counterpart of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--out results.jsonl]

For a cell of ``train.loop.SHAPES`` this builds the model at full width
in bf16 on ``meta`` (shapes and dtypes, no values: ``layers.MetaDraws``),
then runs the step a user would run -- the train step's loss and
gradient (``train.loop.loss_and_grads``) for a train shape, the prefill
or the decode step (``serve.decode``) for the others -- on inputs of
``input_specs``' shapes, under ``torch.utils.flop_counter.FlopCounterMode``
and :class:`WorkCounter`, which sums each op's input and output bytes and
tracks the peak of live tensor bytes.  These stand for JAX's
``cost_analysis()`` flops and bytes accessed and its
``memory_analysis()``.  Meta runs no kernel: ``kernels.ops`` sends every
op to its plain path there, except ``flash_attention`` and its backward,
which only allocate their kernels' outputs (out and lse; dq, dk, dv) and
are priced as the kernels' work (``launch.roofline.flash_work`` and
``bwd_work``: the products over the live (query, key) pairs, each input
read once).  So the FLOPs, bytes and peak are those of the path the card
runs, remat's second forward included; the kernels' own scratch (a few
bytes a row) is not counted, and the other kernels count as their plain
versions.  The counted FLOPs are reported beside the model FLOPs
(``launch.cost``); neither is corrected.

A train cell with ``accum_steps = k`` runs one microbatch of ``B / k``
(the others are the same graph): its FLOPs and bytes times k, its peak
beside a float32 accumulator tree.  The record holds the parameter,
gradient, moment, accumulator and cache bytes, the peak estimate and
whether it fits in the card's 80 GB.  A cell ``shape_supported`` refuses
is skipped with its reason; a cell that fails on meta is reported with
its error.

``--mesh 16x16`` or ``--mesh 2x16x16`` (JAX's production mesh and its
``--multipod`` one) adds each card's share of the state under the
sharding plan (``launch.sharding``): each leaf's numel over the product
of its spec's axis sizes, times its bytes, for the parameters, the
gradients, the AdamW moments (fp32) and the cache, beside the one-card
figures (``per_device``).  This is the counterpart of the per-device
``argument_bytes`` of JAX's dry run at its mesh; the activations and the
peak stay one card's (``activations_divided: false``), and no mesh is
built.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels import ops
from repro_torch.launch.cost import RooflineTerms, analytic_model_flops
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.launch.roofline import bwd_work, flash_work
from repro_torch.launch.sharding import (cache_shardings, local_bytes,
                                         param_shardings, use_fsdp)
from repro_torch.models import transformer as T
from repro_torch.models.layers import MetaDraws
from repro_torch.optim import adamw
from repro_torch.serve.decode import make_prefill_step, make_serve_step
from repro_torch.train.loop import (SHAPES, ShapeSpec, input_specs,
                                    loss_and_grads, microbatches,
                                    shape_supported)

META = torch.device("meta")
# the card's memory, as its name gives it (an H100 80GB holds a little
# more: the verdict is conservative)
CARD_BYTES = 80e9
# ``--mesh``: the shapes of JAX's production meshes
MESHES = {"16x16": production_mesh_shape(),
          "2x16x16": production_mesh_shape(multi_pod=True)}


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree) -> int:
    return sum(nbytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def per_device_state(cfg, mesh_name: str, params, held: dict) -> dict:
    """One card's bytes of the state ``held`` beside ``params`` (the
    ``moments`` and ``cache`` of :func:`count_step`) under the sharding
    plan on the mesh ``MESHES[mesh_name]``; gradients as the parameters
    where moments are held (a train cell)."""
    mesh = MESHES[mesh_name]
    specs = param_shardings(cfg, mesh, params)
    train = "moments" in held
    rec = {"mesh": mesh_name, "fsdp": use_fsdp(cfg),
           "param_bytes": local_bytes(params, specs, mesh)}
    rec["grad_bytes"] = rec["param_bytes"] if train else 0
    rec["moment_bytes"] = (local_bytes(held["moments"], (specs, specs), mesh)
                           if train else 0)
    cache = held.get("cache")
    rec["cache_bytes"] = (local_bytes(cache, cache_shardings(cfg, mesh,
                                                             cache), mesh)
                          if cache is not None else 0)
    rec["state_bytes"] = sum(rec[k] for k in ("param_bytes", "grad_bytes",
                                              "moment_bytes", "cache_bytes"))
    rec["activations_divided"] = False
    return rec


class WorkCounter(TorchDispatchMode):
    """Counts, for the ops run under it, the bytes each reads and writes
    (its tensor inputs and outputs; views move none) and the peak of the
    live bytes of the storages they create.  Storages made before (the
    parameters, the optimizer state, the inputs) are given to
    :meth:`hold` and counted once in ``held``."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.held = 0
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def hold(self, tree) -> None:
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st not in self._seen:
                    self._seen[st] = True
                    self.held += st.nbytes()

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(nbytes(t) for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            if st not in self._seen:
                self._seen[st] = True
                n = st.nbytes()
                self.live += n
                weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def step_inputs(cfg, sp: ShapeSpec, dev: torch.device) -> dict:
    """The cell's inputs on ``dev``: allocations on meta, zeros (token 0)
    elsewhere."""
    make = torch.empty if dev.type == "meta" else torch.zeros
    return {k: make(sh, dtype=dt, device=dev)
            for k, (sh, dt) in input_specs(cfg, sp).items()}


def _train(cfg, sp: ShapeSpec, params, accum_steps: int) -> tuple:
    """One microbatch's loss and gradient: (the call, the work
    multiplier, the state held beside it by name)."""
    dev = params.embed.device
    batch = {k: v[0] for k, v in microbatches(
        step_inputs(cfg, sp, dev), accum_steps).items()}
    state = adamw()[0]({k: p.detach() for k, p in params.named_parameters()})
    acc = ([torch.zeros(p.shape, dtype=torch.float32, device=dev)
            for p in params.parameters()] if accum_steps > 1 else [])
    held = {"moments": (state.mu, state.nu), "accumulator": acc,
            "inputs": batch}
    return (lambda: loss_and_grads(params, cfg, batch)), accum_steps, held


def _serve(cfg, sp: ShapeSpec, params, fog: bool) -> tuple:
    """The prefill or the decode step (as :func:`_train`)."""
    dev = params.embed.device
    inp = step_inputs(cfg, sp, dev)
    key = "embeds" if cfg.frontend else (
        "tokens" if sp.kind == "prefill" else "token")
    if sp.kind == "prefill":
        step, _ = make_prefill_step(cfg, dev, batch=sp.global_batch,
                                    seq_len=sp.seq_len,
                                    param_dtype=params.embed.dtype)
        return (lambda: step(params, inp[key])), 1, {"inputs": inp}
    step, spec = make_serve_step(cfg, dev, batch=sp.global_batch,
                                 max_seq=sp.seq_len, fog=fog,
                                 param_dtype=params.embed.dtype)
    cache = T.cache_init(cfg, sp.global_batch, sp.seq_len,
                         params.embed.dtype, device=dev)
    knobs = [torch.empty(sh, dtype=dt, device=dev)
             for k, (sh, dt) in spec.items() if k.startswith("fog_")]
    return ((lambda: step(params, cache, inp[key], sp.seq_len - 1, *knobs)),
            1, {"cache": cache, "inputs": (inp, knobs)})


def stand_in_work(calls: list) -> dict:
    """The attention kernels' work over ``ops.stand_in_calls``' records:
    FLOPs of the products they need, and the bytes of their inputs (their
    outputs' allocations are counted as ops)."""
    flops = n_bytes = 0
    for kind, q, k, v, itemsize, causal, in_bytes in calls:
        (B, Sq, H, D), (Sk, K), Dv = q, k[1:3], v[-1]
        work = (flash_work(B, Sq, Sk, H, K, D, Dv, itemsize, causal)
                if kind == "flash_attention" else
                bwd_work(B, Sq, Sk, H, K, D, Dv, causal))
        flops += work["ops"]
        n_bytes += in_bytes
    return {"flops": flops, "bytes": n_bytes}


def count_step(cfg, sp: ShapeSpec, params, *, fog: bool = False,
               accum_steps: int = 1, mesh: str | None = None) -> dict:
    """Run the step of ``sp``'s kind on ``params``' device (meta, or the
    CPU for a small check) under the counters: its FLOPs and bytes (times
    the microbatches; ``attention_flops`` those of the attention kernels'
    stand-ins), the bytes of what it holds and its peak; with ``mesh``
    (a key of :data:`MESHES`) one card's share of the state under the
    sharding plan (:func:`per_device_state`)."""
    if sp.kind == "train":
        run, k, held = _train(cfg, sp, params, accum_steps)
    else:
        run, k, held = _serve(cfg, sp, params, fog)
    counter = WorkCounter()
    counter.hold((params.state_dict(), held))
    ops.stand_in_calls = calls = []
    try:
        with FlopCounterMode(display=False) as flops, counter:
            out = run()
    finally:
        ops.stand_in_calls = None
    if sp.kind == "prefill":
        held["cache"] = out[1]
    del out
    kernels = stand_in_work(calls)
    param_bytes = tree_bytes(params.state_dict())
    per_device = ({} if mesh is None else
                  {"per_device": per_device_state(cfg, mesh, params, held)})
    return {
        "counted_flops": float(k * (flops.get_total_flops()
                                    + kernels["flops"])),
        "counted_bytes": float(k * (counter.bytes + kernels["bytes"])),
        "attention_flops": float(k * kernels["flops"]),
        "param_bytes": param_bytes,
        "grad_bytes": param_bytes if sp.kind == "train" else 0,
        "moment_bytes": tree_bytes(held.get("moments", ())),
        "accumulator_bytes": tree_bytes(held.get("accumulator", ())),
        "cache_bytes": tree_bytes(held.get("cache", ())),
        "held_bytes": counter.held, "activation_peak_bytes": counter.peak,
        "peak_bytes": counter.held + counter.peak, **per_device,
    }


def dryrun_cell(arch: str, shape: str, *, fog: bool = False,
                accum_steps: int = 1, mesh: str | None = None,
                verbose: bool = True) -> dict:
    """Count one cell on meta; returns its record (raises on failure)."""
    cfg = get_arch(arch)
    ok, why = shape_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "skipped": True, "why": why}
    sp = SHAPES[shape]
    t0 = time.perf_counter()
    params = T.init_params(cfg, MetaDraws(), torch.bfloat16, device=META)
    counts = count_step(cfg, sp, params, fog=fog, accum_steps=accum_steps,
                        mesh=mesh)
    terms = RooflineTerms(arch, shape, counts["counted_flops"],
                          counts["counted_bytes"],
                          analytic_model_flops(cfg, shape))
    peak = counts["peak_bytes"]
    rec = {
        "arch": arch, "shape": shape, "kind": sp.kind, "device": "meta",
        "fog": fog, "accum_steps": accum_steps, "skipped": False,
        "seconds": round(time.perf_counter() - t0, 2),
        "model_flops": terms.model_flops,
        "useful_flops_ratio": terms.useful_flops_ratio,
        "compute_s": terms.compute_s, "memory_s": terms.memory_s,
        "dominant": terms.dominant,
        "roofline_fraction": terms.roofline_fraction,
        **counts, "fits_80gb": peak <= CARD_BYTES,
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape}{' (fog)' if fog else ''}"
              f"{f' k={accum_steps}' if accum_steps > 1 else ''}: "
              f"{rec['seconds']:.1f}s on meta | counted "
              f"{terms.counted_flops:.3g} FLOP (model {terms.model_flops:.3g},"
              f" ratio {terms.useful_flops_ratio:.2f}) "
              f"{terms.counted_bytes:.3g} B -> {terms.dominant}-bound "
              f"{terms.step_time_s * 1e3:.1f} ms | peak {peak / 1e9:.2f} GB "
              f"({'fits' if rec['fits_80gb'] else 'does not fit'} in 80 GB)",
              flush=True)
        if mesh is not None:
            pd = rec["per_device"]
            print(f"[dryrun] {arch} x {shape} on {mesh} (FSDP "
                  f"{'on' if pd['fsdp'] else 'off'}): a card holds params "
                  f"{pd['param_bytes'] / 1e9:.3f} GB, grads "
                  f"{pd['grad_bytes'] / 1e9:.3f}, moments "
                  f"{pd['moment_bytes'] / 1e9:.3f}, cache "
                  f"{pd['cache_bytes'] / 1e9:.3f}: state "
                  f"{pd['state_bytes'] / 1e9:.3f} GB (activations not "
                  f"divided)", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="count an (arch x shape) "
                                 "cell on the meta device")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fog", action="store_true",
                    help="run the FoG early-exit decode step")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--mesh", default=None, choices=sorted(MESHES),
                    help="add one card's share of the state under the "
                    "sharding plan on this mesh")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in sorted(ARCHS) for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    failures = []
    for arch, shape in cells:
        try:
            rec = dryrun_cell(arch, shape, fog=args.fog, mesh=args.mesh)
        except Exception as e:  # noqa: BLE001 -- reported, never dropped
            traceback.print_exc()
            failures.append((arch, shape, str(e)))
            rec = {"arch": arch, "shape": shape, "error": str(e)}
        if rec.get("skipped"):
            print(f"[dryrun] {arch} x {shape}: skipped ({rec['why']})")
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    if failures:
        print(f"FAILED cells: {failures}", file=sys.stderr)
        return 1
    print("all cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
