"""The LM training CLI (port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 300 \
        [--smoke] [--ckpt-dir DIR [--ckpt-every 50] [--resume]] [--device cpu]

    torchrun --nproc-per-node N -m repro_torch.launch.train ... [--device cpu]

``--smoke`` trains the reduced config of the same family; without it the
config is the full one.  Parameters start in fp32 from the port's
generator (seeded with ``--seed``), as JAX's CLI inits in fp32; tokens
come from ``data.lm_data.batch_at_step`` (the same batches as JAX's),
and the audio/VLM configs (``cfg.frontend``) train from embeddings drawn
by a ``torch.Generator`` seeded with the step.  Heartbeats, periodic
checkpoints in JAX's layout and resume from the newest one, as JAX's
CLI does.  Every config trains, the Mamba ones included (``--arch
mamba2-2.7b`` at full width fits one 80 GB card in fp32: the step's
update frees as it goes, ``train.loop``).

Started with a world size in the environment (``torchrun``), the CLI
trains on the host mesh, as JAX's always does: it initialises the
process group (``nccl`` with one card a rank, ``gloo`` with ``--device
cpu``), places the model by the sharding plan on
``launch.mesh.make_host_mesh()`` and trains with ``make_train_step(...,
mesh=)`` (each rank a slice of ``--batch``); rank 0 prints, every rank
beats its own heartbeat (``host{rank}``), every rank takes part in
each checkpoint, which rank 0 writes (synchronously), and ``--resume``
restores onto the mesh.  Without one it trains on one device, its
checkpoints written on a thread.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.configs import get_arch, smoke_config
from repro_torch.data.lm_data import DataConfig, batch_at_step
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import (opt_shardings, param_shardings,
                                         shard_tree)
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import Heartbeat
from repro_torch.train.loop import make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="train an LM config")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of the same family")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def step_batch(cfg, dcfg: DataConfig, step: int, dev: torch.device) -> dict:
    """The batch of ``step`` on ``dev``: tokens and labels from
    ``batch_at_step``, or for a front-end config embeddings ``[B, S, d]``
    ~ N(0, 0.02²) from a generator seeded with ``step + 1``, and labels."""
    b = batch_at_step(dcfg, step)
    labels = torch.as_tensor(b["labels"] % cfg.vocab_size, device=dev)
    if cfg.frontend:
        gen = torch.Generator(device=dev).manual_seed(step + 1)
        emb = torch.randn((dcfg.global_batch, dcfg.seq_len, cfg.d_model),
                          generator=gen, device=dev) * 0.02
        return {"embeds": emb, "labels": labels}
    return {"tokens": torch.as_tensor(b["tokens"] % cfg.vocab_size,
                                      device=dev), "labels": labels}


def start_group(device) -> torch.device | None:
    """Initialise the process group when the environment names a world
    size (``torchrun``'s ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``): ``gloo`` for ``--device cpu``,
    else ``nccl`` with the card ``LOCAL_RANK``.  Returns the rank's
    device, or None without a world size."""
    if "WORLD_SIZE" not in os.environ:
        return None
    if resolve_device(device).type == "cpu":
        dist.init_process_group("gloo")
        return torch.device("cpu")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", device_id=dev)
    return dev


def main(argv=None) -> dict:
    """Run the CLI; returns ``{"steps", "losses", "grad_norms"}`` of the
    steps it ran, and the final ``params`` and ``opt_state`` (on the
    mesh: ``DTensor``s, whose process group is gone)."""
    args = build_parser().parse_args(argv)
    dev = start_group(args.device)
    try:
        return train(args, dev)
    finally:
        if dev is not None:
            dist.destroy_process_group()


def train(args, group_dev: torch.device | None) -> dict:
    """The training loop of :func:`main`, on the host mesh when
    ``group_dev`` (the rank's device) is given."""
    mesh = None if group_dev is None else make_host_mesh()
    dev = group_dev or resolve_device(args.device)
    rank = 0 if mesh is None else dist.get_rank()
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    on = ("" if mesh is None else
          f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} ")
    if rank == 0:
        print(f"[train] arch={cfg.name} {on}device={dev} B={args.batch} "
              f"S={args.seq}")
    step_fn, init_opt = make_train_step(cfg, lr=args.lr,
                                        total_steps=args.steps, device=dev,
                                        mesh=mesh)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), torch.float32, device=dev)
    specs = None
    if mesh is not None:
        specs = (param_shardings(cfg, mesh, params),
                 opt_shardings(cfg, mesh, params))
        params = shard_tree(params, mesh, specs[0])
    opt_state = init_opt(params)

    start_step = 0
    if (args.resume and args.ckpt_dir
            and ckpt.latest_step(args.ckpt_dir) is not None):
        (params, opt_state), start_step = ckpt.restore(
            (params, opt_state), args.ckpt_dir, shardings=specs, mesh=mesh)
        if rank == 0:
            print(f"[train] resumed from step {start_step}")

    dcfg = DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    hb = Heartbeat(args.ckpt_dir, f"host{rank}") if args.ckpt_dir else None
    if hb:
        hb.path.parent.mkdir(parents=True, exist_ok=True)
    writer = None
    out = {"steps": [], "losses": [], "grad_norms": []}
    metrics = None
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = step_batch(cfg, dcfg, step, dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        out["steps"].append(step)
        out["losses"].append(float(metrics["loss"]))
        out["grad_norms"].append(float(metrics["grad_norm"]))
        if hb:
            hb.beat(step)
        if rank == 0 and (step % args.log_every == 0
                          or step == args.steps - 1):
            print(f"[train] step {step:5d} loss {out['losses'][-1]:.4f} "
                  f"gnorm {out['grad_norms'][-1]:.3f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            if writer is not None:
                writer.join()
            writer = ckpt.save(step + 1, (params, opt_state), args.ckpt_dir,
                               async_write=mesh is None)
    if writer is not None:
        writer.join()
    if metrics is not None and rank == 0:
        print(f"[train] done: final loss {out['losses'][-1]:.4f}")
    out.update(params=params, opt_state=opt_state)
    return out


if __name__ == "__main__":
    main()
