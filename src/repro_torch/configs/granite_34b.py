"""Granite-34B-Code — llama-arch, MQA (kv=1) [arXiv:2405.04324; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, act="gelu", gated_ffn=False,
    rope_theta=10000.0, fog_groups=4,
)
