"""qwen3-moe-30b-a3b — 128-expert top-8 MoE.

[hf:Qwen/Qwen3-30B-A3B; hf] 48L d_model=2048 32H (kv=4) moe_d_ff=768
vocab=151936, 128 experts top-8, qk_norm, head_dim=128, RoPE 1e6.
"""
from ..models.moe import MoEConfig
from ..models.transformer import LMConfig

ARCH_ID = "qwen3-moe-30b-a3b"
FAMILY = "moe"


def config(**overrides) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,
        moe_d_ff=768,
        ffn_kind="moe",
        moe=MoEConfig(num_experts=128, top_k=8, capacity_factor=1.25,
                      group_tokens=512),
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
        tie_embeddings=False,
        scan_layers=True,
    )
    base.update(overrides)
    return LMConfig(**base)


def reduced_config() -> LMConfig:
    # The reference also sets max_position=4096, which only learned
    # positions read (this config has RoPE).
    return config(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=96, moe_d_ff=96, vocab_size=512,
                  moe=MoEConfig(num_experts=8, top_k=2, group_tokens=32,
                                capacity_factor=8.0),
                  scan_layers=False)
