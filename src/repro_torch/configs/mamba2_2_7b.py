"""Mamba2-2.7B — attention-free SSD [arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=50280, act="silu",
    ssm=True, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    long_context=True, fog_groups=4,
)
