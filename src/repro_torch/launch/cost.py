"""Cost terms of an LM cell on one card (port of the analytic half of
``repro.launch.hlo_cost``).

:func:`analytic_model_flops` is JAX's config arithmetic: 6ND for a train
cell, 2ND for a prefill, and for a decode step 2N per sequence plus the
attention reads over the cache, N the active parameters
(``configs.base.param_count``, MoE-aware).  :class:`RooflineTerms` is the
one-card counterpart of JAX's: a cell's counted FLOPs and bytes (from
``launch.dryrun``'s run on the ``meta`` device) over one H100's dense
bf16 rate and HBM rate (``launch.roofline.H100_SXM_BF16``), the term
that dominates, and ``roofline_fraction``, the model FLOPs over the peak
over the step time (the MFU the bound allows).

JAX's HLO parser (``HloCostModel``, ``collective_bytes_from_hlo``,
``extract``) and its collective terms read XLA's compiled text and a
mesh's collectives; they have no counterpart here: the port compiles no
HLO and one card runs no collective.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, param_count
from repro_torch.launch.roofline import H100_SXM_BF16, MachineSpec
from repro_torch.train.loop import SHAPES


def analytic_model_flops(cfg: ArchConfig, shape_name: str) -> float:
    """6ND for train; 2ND per generated token for decode; 2ND_prompt for
    prefill.  N = active params (MoE-aware)."""
    sp = SHAPES[shape_name]
    _, active = param_count(cfg)
    tokens = sp.global_batch * sp.seq_len
    if sp.kind == "train":
        return 6.0 * active * tokens
    if sp.kind == "prefill":
        return 2.0 * active * tokens
    # decode: one token per sequence + attention reads over the cache
    flops = 2.0 * active * sp.global_batch
    if not cfg.ssm:
        hd = cfg.resolved_head_dim
        kv_flops = 4.0 * cfg.n_layers * cfg.n_heads * hd * sp.seq_len
        flops += kv_flops * sp.global_batch
    return flops


@dataclasses.dataclass
class RooflineTerms:
    """One cell's counted work on one card against a spec's peaks."""
    arch: str
    shape: str
    counted_flops: float          # FLOPs of the step's ops as run
    counted_bytes: float          # bytes each op reads and writes
    model_flops: float            # analytic_model_flops
    spec: MachineSpec = H100_SXM_BF16

    @property
    def compute_s(self) -> float:
        return self.counted_flops / self.spec.peak_flops

    @property
    def memory_s(self) -> float:
        return self.counted_bytes / self.spec.peak_bw

    @property
    def dominant(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    @property
    def step_time_s(self) -> float:
        """No-overlap bound: the slower of the two terms."""
        return max(self.compute_s, self.memory_s)

    @property
    def useful_flops_ratio(self) -> float:
        """Model FLOPs over counted FLOPs (remat's second forward, a plain
        attention's full score matrix and MoE routing push it below 1)."""
        return (self.model_flops / self.counted_flops
                if self.counted_flops else 0.0)

    @property
    def roofline_fraction(self) -> float:
        """Model FLOPs over the peak over the step time: the MFU at the
        bound."""
        ideal = self.model_flops / self.spec.peak_flops
        return ideal / self.step_time_s if self.step_time_s else 0.0

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | "
                f"{self.compute_s*1e3:.1f} | {self.memory_s*1e3:.1f} | "
                f"{self.dominant} | {self.model_flops:.3g} | "
                f"{self.useful_flops_ratio:.2f} | "
                f"{self.roofline_fraction:.2f} |")
