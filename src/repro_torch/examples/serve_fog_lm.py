"""Serve a small LM with batched requests and FoG early-exit decoding (the
port's counterpart of the JAX package's ``examples/serve_fog_lm.py``).

    python -m repro_torch.examples.serve_fog_lm              # on the card
    PYTHONPATH=src python -m repro_torch.examples.serve_fog_lm --device cpu

The continuous batcher drives ``decode_step_fog`` with mixed-QoS traffic:
every request carries its own ``FogPolicy`` (threshold and hop budget),
the batcher assembles them into per-lane vectors, and one decode step
serves the whole batch.  Per-request groves per token (hops) are the LM's
counterpart of the paper's energy meter: easy tokens exit after one
grove, hard ones use the whole stack, and the budget tier never exceeds
its cap.

JAX's settings: tinyllama-1.1b's smoke config cut to 4 layers in 4
layer-groves, fp32 weights (the port's generator, seed 0), 4 slots of
``MAX_SEQ`` 160 positions, three tiers (premium 0.05, standard 0.01,
budget 0.05 with a hop budget of 2), 8 requests of 24-token prompts from
``DataConfig(vocab, 32, 8, seed=7)``, 16 new tokens each.  Each slot's
prefill is spliced into the batch cache, and the batch shares one
position counter, its longest length, as JAX's demo does.  Untrained
weights give tiny logit margins; 0.01 shows the per-token variation.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import smoke_config
from repro_torch.core.policy import FogPolicy
from repro_torch.data.lm_data import DataConfig, batch_at_step
from repro_torch.launch.serve import _splice_tree
from repro_torch.models import transformer as T
from repro_torch.models.fog_exit import decode_step_fog, grove_boundaries
from repro_torch.serve.scheduler import ContinuousBatcher, Request

N_SLOTS, MAX_SEQ, THRESH = 4, 160, 0.01
N_REQUESTS, PROMPT, MAX_NEW = 8, 24, 16
# three QoS tiers sharing one continuous batch: premium (hop until really
# confident), standard, and a budget tier capped at 2 groves per token
TIERS = {
    "premium": FogPolicy(threshold=0.05),
    "standard": FogPolicy(threshold=THRESH),
    "budget": FogPolicy(threshold=0.05, hop_budget=2),
}


def config():
    """tinyllama-1.1b's smoke config at 4 layers in 4 layer-groves."""
    return smoke_config("tinyllama-1.1b").scaled(n_layers=4, fog_groups=4)


def serve(params: T.LM, cfg, device) -> list[Request]:
    """Serve the demo's requests with ``params`` on ``device``; returns
    the finished requests."""
    dev = resolve_device(device)
    state = {"caches": T.cache_init(cfg, N_SLOTS, MAX_SEQ, torch.float32,
                                    device=dev)}

    def prefill_fn(slot: int, prompt: np.ndarray) -> int:
        # per-slot prefill: run the prompt row, splice its cache into the
        # batch's
        _, c = T.prefill(params, cfg, tokens=torch.as_tensor(
            np.asarray(prompt))[None].to(dev), max_seq=MAX_SEQ)
        state["caches"] = _splice_tree(state["caches"], c, slot, N_SLOTS)
        return len(prompt)

    def decode_fn(tokens, lengths, policy):
        # the batch shares one position counter in this demo: the longest
        # length; the policy carries the per-lane knobs the batcher built
        length = int(np.asarray(lengths).max())
        logits, state["caches"], hops = decode_step_fog(
            params, cfg, torch.as_tensor(np.asarray(tokens)).to(dev),
            state["caches"], length, policy)
        return logits, hops

    batcher = ContinuousBatcher(N_SLOTS, decode_fn, prefill_fn, eos_id=-1,
                                default_policy=TIERS["standard"])
    dcfg = DataConfig(cfg.vocab_size, 32, 8, seed=7)
    for rid in range(N_REQUESTS):
        prompt = batch_at_step(dcfg, rid)["tokens"][0, :PROMPT]
        batcher.submit(Request(rid=rid, prompt=prompt, max_new_tokens=MAX_NEW,
                               policy=TIERS[tier(rid)]))
    return batcher.run(max_steps=200)


def tier(rid: int) -> str:
    return list(TIERS)[rid % len(TIERS)]


def main(argv=None) -> dict:
    """Run the example; returns ``{"done", "params", "cfg"}``."""
    ap = argparse.ArgumentParser(description="mixed-QoS FoG LM serving")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           torch.float32, device=dev)
    done = serve(params, cfg, dev)
    n_groups = len(grove_boundaries(cfg))
    print(f"served {len(done)} requests, {n_groups} groves, mixed QoS tiers")
    for req in sorted(done, key=lambda r: r.rid):
        h = np.asarray(req.hops, np.float64)
        print(f"  req {req.rid} [{tier(req.rid):>8}]: "
              f"{len(req.generated)} tokens, "
              f"mean groves/token {h.mean():.2f}  "
              f"(flops frac vs full stack: {h.mean() / n_groups:.2f})")
    return {"done": done, "params": params, "cfg": cfg}


if __name__ == "__main__":
    main()
