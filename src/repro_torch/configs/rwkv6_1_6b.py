"""rwkv6-1.6b "Finch" — attention-free, data-dependent decay.

[arXiv:2404.05892] 24L d_model=2048 d_ff=7168 vocab=65536, head size 64
(32 WKV heads), token-shift ddlerp + decay LoRA, squared-ReLU channel mix.
"""
from ..models.transformer import LMConfig

ARCH_ID = "rwkv6-1.6b"
FAMILY = "ssm"


def config(**overrides) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        num_layers=24,
        d_model=2048,
        num_heads=32,             # d_model / rwkv_head_dim
        num_kv_heads=32,
        head_dim=64,
        rwkv_head_dim=64,
        d_ff=7168,
        vocab_size=65536,
        block_pattern=("rwkv",),
        ffn_kind="rwkv_channel",
        norm="layernorm",
        pos_embedding="none",
        tie_embeddings=True,
        scan_layers=True,
    )
    base.update(overrides)
    return LMConfig(**base)


def reduced_config() -> LMConfig:
    return config(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                  head_dim=16, rwkv_head_dim=16, d_ff=128, vocab_size=512,
                  scan_layers=False, rwkv_chunk=8)
