"""DeepSeek-V3 671B — MLA + 1 shared + 256 routed top-8 MoE + MTP
[arXiv:2412.19437; hf].  d_ff=2048 is the per-expert (fine-grained) width;
the 3 leading layers are dense with d_ff=18432 per the paper."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab_size=129280, act="silu",
    moe=True, n_experts=256, experts_per_token=8, n_shared_experts=1,
    moe_d_ff=2048, moe_first_k_dense=3, capacity_factor=1.25,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128, head_dim=192,
    mtp=True, fog_groups=4,
)
