"""Architecture config schema shared by all assigned architectures."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | ssm | moe | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    act: str = "silu"           # silu -> SwiGLU, gelu -> GeGLU
    gated_ffn: bool = True      # False -> plain 2-matrix MLP (granite, musicgen)
    tie_embeddings: bool = False
    rope_theta: float = 10000.0

    # ---- MoE ----
    moe: bool = False
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0            # per-expert hidden dim (deepseek-style fine-grained)
    moe_period: int = 1          # MoE every k-th layer (jamba: 2)
    moe_first_k_dense: int = 0   # leading dense layers (deepseek: 3)
    capacity_factor: float = 1.25
    # shard each expert's d_ff over `model` instead of experts (EP): for
    # small expert counts this replaces the dispatch/combine collectives
    # with one row-parallel all-reduce per MoE layer
    moe_tp_within_expert: bool = False

    # ---- MLA ----
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # ---- SSM (mamba2 / hybrid) ----
    ssm: bool = False
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_layer_period: int = 0   # hybrid: 1 attention layer per this many
    attn_layer_offset: int = 0

    # ---- extras ----
    mtp: bool = False            # deepseek multi-token prediction head
    frontend: str | None = None  # 'audio' | 'vlm' -> stub embeddings input
    long_context: bool = False   # eligible for the long_500k cell
    # FoG integration: number of layer groves for confidence-gated exit
    fog_groups: int = 4

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_attn_layer(self, i: int) -> bool:
        if not self.ssm:
            return True
        if self.attn_layer_period == 0:
            return False           # pure SSM
        return i % self.attn_layer_period == self.attn_layer_offset

    def is_moe_layer(self, i: int) -> bool:
        if not self.moe or i < self.moe_first_k_dense:
            return False
        return (i - self.moe_first_k_dense) % self.moe_period == 0

    def scaled(self, **overrides) -> "ArchConfig":
        """Reduced config of the same family (smoke tests)."""
        return dataclasses.replace(self, **overrides)


def param_count(cfg: ArchConfig) -> tuple[int, int]:
    """(total, active-per-token) parameter counts — analytic, for 6ND."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    total = emb
    active = emb
    for i in range(cfg.n_layers):
        if cfg.ssm and not cfg.is_attn_layer(i):
            di, H, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
            # in_proj: d -> 2*di + 2*G*N + H (z, x, B, C, dt), G=1
            layer = d * (2 * di + 2 * N + H) + cfg.ssm_conv * (di + 2 * N) \
                + 2 * H + di + di * d
        elif cfg.mla:
            r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
            dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
            H = cfg.n_heads
            layer = d * r_q + r_q * H * (dn + dr)          # q path
            layer += d * (r_kv + dr)                        # kv compress + k_rope
            layer += r_kv * H * (dn + dv)                   # kv expand
            layer += H * dv * d                             # o_proj
        else:
            H, K = cfg.n_heads, cfg.n_kv_heads
            layer = d * H * hd + 2 * d * K * hd + H * hd * d
        total += layer
        active_layer = layer
        # FFN / MoE
        n_mats = 3 if cfg.gated_ffn else 2
        if cfg.is_moe_layer(i):
            eff = cfg.moe_d_ff or cfg.d_ff
            ffn_one = 3 * d * eff
            total += cfg.n_experts * ffn_one + cfg.n_shared_experts * ffn_one \
                + d * cfg.n_experts
            active_layer += (cfg.experts_per_token + cfg.n_shared_experts) * ffn_one \
                + d * cfg.n_experts
        else:
            ffn = n_mats * d * cfg.d_ff
            total += ffn
            active_layer += ffn
        active += active_layer
    return total, active
