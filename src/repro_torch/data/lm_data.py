"""Deterministic synthetic token batches for the LM side (port of
``repro.data.lm_data``; numpy only, so the same step gives the same
tokens in both packages).

Seeded per (step, host), so every restart reproduces the same sequence of
batches and each data shard sees distinct tokens.  A zipf-ish unigram
draw with short-range induction patterns (the second half of every
window repeats its first half) gives the tokens some structure.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def deterministic_data_key(base_seed: int, step: int) -> int:
    """Step-indexed PRNG stream: the data order at step N does not depend
    on the crash history (copy of ``repro.train.fault``'s)."""
    return (base_seed * 1_000_003 + step) % (2**31 - 1)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    induction_period: int = 64   # repeat window: makes in-context structure


def batch_at_step(cfg: DataConfig, step: int, *, host: int = 0,
                  n_hosts: int = 1) -> dict[str, np.ndarray]:
    """Batch for ``step``; host h draws rows [h*B/n, (h+1)*B/n)."""
    rng = np.random.default_rng(deterministic_data_key(cfg.seed, step) + host)
    b = cfg.global_batch // n_hosts
    ranks = np.arange(1, cfg.vocab_size + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(cfg.vocab_size, size=(b, cfg.seq_len + 1), p=probs)
    P = cfg.induction_period
    for start in range(0, cfg.seq_len + 1 - P, P):
        half = P // 2
        toks[:, start + half : start + P] = toks[:, start : start + half]
    tokens = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)
    return {"tokens": tokens, "labels": labels}
