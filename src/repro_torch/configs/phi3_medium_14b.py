"""phi3-medium-14b — dense GQA, RoPE + SwiGLU + RMSNorm.

[arXiv:2404.14219; unverified] 40L d_model=5120 40H (kv=10) d_ff=17920
vocab=100352, head_dim=128, RoPE 1e4.
"""
from ..models.transformer import LMConfig

ARCH_ID = "phi3-medium-14b"
FAMILY = "dense"


def config(**overrides) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=10,
        head_dim=128,
        d_ff=17920,
        vocab_size=100352,
        rope_theta=1e4,
        tie_embeddings=False,
        scan_layers=True,
    )
    base.update(overrides)
    return LMConfig(**base)


def reduced_config() -> LMConfig:
    return config(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=160, vocab_size=512, scan_layers=False)
