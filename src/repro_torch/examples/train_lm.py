"""Train a ~100M-parameter LM with checkpoints and resume (the port's
counterpart of the JAX package's ``examples/train_lm.py``).

    python -m repro_torch.examples.train_lm [--steps 300]     # on the card
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \
        --steps 4 --batch 2 --seq 64

The tinyllama family narrowed to ~100M parameters (8 layers, d_model 768,
12 query and 4 KV heads, d_ff 2048, vocab 8192), fp32 from the port's
generator (seed 0), AdamW at 3e-4 on ``batch_at_step``'s batches.  It
checkpoints every 100 steps and after the last into ``--ckpt-dir``
(default ``build/train_lm_ckpt`` in the repository) and resumes from the
newest checkpoint there.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_arch, param_count
from repro_torch.data.lm_data import DataConfig
from repro_torch.launch.train import step_batch
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import make_train_step

DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / "train_lm_ckpt"
CKPT_EVERY = 100


def config():
    """The ~100M tinyllama-family config."""
    return dataclasses.replace(
        get_arch("tinyllama-1.1b"), name="tinyllama-100m", n_layers=8,
        d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=8192)


def main(argv=None) -> dict:
    """Run the example; returns ``{"start", "losses"}``."""
    ap = argparse.ArgumentParser(description="train a ~100M LM")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config()
    print(f"model: {cfg.name} ({param_count(cfg)[0] / 1e6:.0f}M params)")
    step_fn, init_opt = make_train_step(cfg, lr=3e-4, total_steps=args.steps,
                                        device=dev)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           torch.float32, device=dev)
    opt_state = init_opt(params)
    start = 0
    if ckpt.latest_step(args.ckpt_dir) is not None:
        (params, opt_state), start = ckpt.restore((params, opt_state),
                                                  args.ckpt_dir)
        print(f"resumed from step {start}")

    dcfg = DataConfig(cfg.vocab_size, args.seq, args.batch, seed=0)
    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        params, opt_state, m = step_fn(params, opt_state,
                                       step_batch(cfg, dcfg, step, dev))
        losses.append(float(m["loss"]))
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"({time.time() - t0:.0f}s)", flush=True)
        if (step + 1) % CKPT_EVERY == 0 or step == args.steps - 1:
            ckpt.save(step + 1, (params, opt_state), args.ckpt_dir)
    print("training done; checkpoint in", args.ckpt_dir)
    return {"start": start, "losses": losses}


if __name__ == "__main__":
    main()
