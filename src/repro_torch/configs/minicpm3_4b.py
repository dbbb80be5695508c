"""MiniCPM3-4B — dense with MLA [hf:openbmb/MiniCPM3-4B; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab_size=73448, act="silu",
    mla=True, q_lora_rank=768, kv_lora_rank=256,
    qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64, head_dim=96,
    rope_theta=10000.0, fog_groups=4,
)
