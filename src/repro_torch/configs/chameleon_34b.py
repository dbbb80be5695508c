"""Chameleon-34B — early-fusion VLM over VQ image+text tokens; VQ frontend
stubbed to precomputed patch embeddings [arXiv:2405.09818; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536, act="silu",
    frontend="vlm", fog_groups=4,
)
