"""Gemma-2B — GeGLU, head_dim=256, MQA [arXiv:2403.08295; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab_size=256000, act="gelu", head_dim=256,
    tie_embeddings=True, rope_theta=10000.0, fog_groups=3,
)
