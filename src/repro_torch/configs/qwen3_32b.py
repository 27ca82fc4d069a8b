"""qwen3-32b — dense GQA with qk_norm.

[hf:Qwen/Qwen3-8B; hf] 64L d_model=5120 64H (kv=8) d_ff=25600 vocab=151936,
head_dim=128 (q width 8192 != d_model — per-head projections handle it),
qk-RMSNorm, RoPE 1e6, untied.
"""
from ..models.transformer import LMConfig

ARCH_ID = "qwen3-32b"
FAMILY = "dense"


def config(**overrides) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        num_layers=64,
        d_model=5120,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=25600,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
        tie_embeddings=False,
        scan_layers=True,
    )
    base.update(overrides)
    return LMConfig(**base)


def reduced_config() -> LMConfig:
    return config(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=160, vocab_size=512, scan_layers=False)
