"""qwen2-vl-72b — VLM backbone with M-RoPE (vision frontend stubbed).

[arXiv:2409.12191; hf] 80L d_model=8192 64H (kv=8) d_ff=29568 vocab=152064,
head_dim=128, QKV bias, M-RoPE sections (16, 24, 24); the first
``num_patch_tokens`` positions carry precomputed patch embeddings (the
dynamic-resolution ViT frontend is a stub).
"""
from ..models.transformer import LMConfig

ARCH_ID = "qwen2-vl-72b"
FAMILY = "vlm"


def config(**overrides) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        mrope_section=(16, 24, 24),
        rope_theta=1e6,
        num_patch_tokens=256,
        tie_embeddings=False,
        scan_layers=True,
    )
    base.update(overrides)
    return LMConfig(**base)


def reduced_config() -> LMConfig:
    return config(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=160, vocab_size=512, num_patch_tokens=4,
                  mrope_section=(2, 3, 3), scan_layers=False)
