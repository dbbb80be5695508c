"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.configs import (
    tinyllama_1_1b, minicpm3_4b, granite_34b, gemma_2b, mamba2_2_7b,
    musicgen_large, grok1_314b, deepseek_v3_671b, chameleon_34b,
    jamba_1_5_large_398b,
)

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [
        tinyllama_1_1b.CONFIG,
        minicpm3_4b.CONFIG,
        granite_34b.CONFIG,
        gemma_2b.CONFIG,
        mamba2_2_7b.CONFIG,
        musicgen_large.CONFIG,
        grok1_314b.CONFIG,
        deepseek_v3_671b.CONFIG,
        chameleon_34b.CONFIG,
        jamba_1_5_large_398b.CONFIG,
    ]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced config of the same family: small width/depth/experts/vocab,
    same structural features (GQA ratios, MLA, MoE pattern, hybrid period)."""
    c = get_arch(name)
    kv = max(1, min(c.n_kv_heads, 2))
    heads = max(kv * 2, 4)
    over: dict = dict(
        n_layers=max(2, min(c.n_layers, 4)),
        d_model=128, n_heads=heads, n_kv_heads=kv, head_dim=32,
        d_ff=256, vocab_size=512, fog_groups=2,
    )
    if c.ssm:
        over.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
        if c.attn_layer_period:       # hybrid: keep 1:k-1 interleave
            over.update(n_layers=2 * c.attn_layer_period,
                        attn_layer_period=c.attn_layer_period)
        else:
            over.update(n_layers=4)
    if c.moe:
        over.update(n_experts=min(c.n_experts, 8),
                    experts_per_token=min(c.experts_per_token, 2),
                    moe_d_ff=64 if c.moe_d_ff else 0,
                    moe_first_k_dense=min(c.moe_first_k_dense, 1),
                    # drop-free routing so decode==forward exactly in tests
                    capacity_factor=float(min(c.n_experts, 8)))
        if c.moe_first_k_dense:
            over["n_layers"] = over.get("n_layers", 4) + 1
    if c.mla:
        over.update(q_lora_rank=48, kv_lora_rank=32,
                    qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
                    head_dim=48)
    return dataclasses.replace(c, **over, name=c.name + "-smoke")
