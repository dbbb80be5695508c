"""Jamba-1.5-Large 398B — Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer [arXiv:2403.19887; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536, act="silu",
    moe=True, n_experts=16, experts_per_token=2, moe_period=2,
    ssm=True, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    attn_layer_period=8, attn_layer_offset=4,
    long_context=True, fog_groups=4,
)
