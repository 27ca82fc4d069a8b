"""qwen2.5-32b — dense GQA with QKV bias.

[hf:Qwen/Qwen2.5-0.5B; hf] 64L d_model=5120 40H (kv=8) d_ff=27648
vocab=152064, head_dim=128, RoPE 1e6, untied embeddings.
"""
from ..models.transformer import LMConfig

ARCH_ID = "qwen2.5-32b"
FAMILY = "dense"


def config(**overrides) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=27648,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1e6,
        tie_embeddings=False,
        scan_layers=True,
    )
    base.update(overrides)
    return LMConfig(**base)


def reduced_config() -> LMConfig:
    return config(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=160, vocab_size=512, scan_layers=False)
