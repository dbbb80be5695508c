"""The LM training CLI (port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 300 \
        [--smoke] [--ckpt-dir DIR [--ckpt-every 50] [--resume]] [--device cpu]

``--smoke`` trains the reduced config of the same family; without it the
config is the full one, on one card.  Parameters start in fp32 from the
port's generator (seeded with ``--seed``), as JAX's CLI inits in fp32;
tokens come from ``data.lm_data.batch_at_step`` (the same batches as
JAX's), and the audio/VLM configs (``cfg.frontend``) train from
embeddings drawn by a ``torch.Generator`` seeded with the step.
Heartbeats, periodic async checkpoints in JAX's layout and resume from
the newest one, as JAX's CLI does; JAX's host mesh has no counterpart
on one card.  Every config trains, the Mamba ones included
(``--arch mamba2-2.7b`` at full width fits one 80 GB card in fp32: the
step's update frees as it goes, ``train.loop``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_arch, smoke_config
from repro_torch.data.lm_data import DataConfig, batch_at_step
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


def main(argv=None) -> dict:
    """Run the CLI; returns ``{"steps", "losses", "grad_norms"}`` of the
    steps it ran, and the final ``params`` and ``opt_state``."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    print(f"[train] arch={cfg.name} device={dev} B={args.batch} "
          f"S={args.seq}")
    step_fn, init_opt = make_train_step(cfg, lr=args.lr,
                                        total_steps=args.steps, device=dev)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), torch.float32, device=dev)
    opt_state = init_opt(params)

    start_step = 0
    if (args.resume and args.ckpt_dir
            and ckpt.latest_step(args.ckpt_dir) is not None):
        (params, opt_state), start_step = ckpt.restore((params, opt_state),
                                                       args.ckpt_dir)
        print(f"[train] resumed from step {start_step}")

    dcfg = DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    hb = Heartbeat(args.ckpt_dir, "host0") if args.ckpt_dir else None
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
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {out['losses'][-1]:.4f} "
                  f"gnorm {out['grad_norms'][-1]:.3f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            if writer is not None:
                writer.join()
            writer = ckpt.save(step + 1, (params, opt_state), args.ckpt_dir,
                               async_write=True)
    if writer is not None:
        writer.join()
    if metrics is not None:
        print(f"[train] done: final loss {out['losses'][-1]:.4f}")
    out.update(params=params, opt_state=opt_state)
    return out


if __name__ == "__main__":
    main()
