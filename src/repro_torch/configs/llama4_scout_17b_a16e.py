"""llama4-scout-17b-a16e — 16-expert top-1 MoE with shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] 48L d_model=5120 40H (kv=8)
moe_d_ff=8192 vocab=202048, 16 experts top-1 + llama4 shared expert
(early-fusion multimodality is out of backbone scope).
"""
from ..models.moe import MoEConfig
from ..models.transformer import LMConfig

ARCH_ID = "llama4-scout-17b-a16e"
FAMILY = "moe"


def config(**overrides) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        moe_d_ff=8192,
        shared_expert_ff=8192,
        ffn_kind="moe",
        moe=MoEConfig(num_experts=16, top_k=1, capacity_factor=1.25,
                      group_tokens=512),
        vocab_size=202048,
        rope_theta=5e5,
        tie_embeddings=False,
        scan_layers=True,
    )
    base.update(overrides)
    return LMConfig(**base)


def reduced_config() -> LMConfig:
    return config(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=128, moe_d_ff=128, shared_expert_ff=128,
                  vocab_size=512,
                  moe=MoEConfig(num_experts=4, top_k=1, group_tokens=32,
                                capacity_factor=8.0),
                  scan_layers=False)
