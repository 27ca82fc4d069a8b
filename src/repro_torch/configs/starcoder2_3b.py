"""starcoder2-3b — dense GQA kv=2, LayerNorm + plain GeLU MLP with biases.

[arXiv:2402.19173; hf] 30L d_model=3072 24H (kv=2) d_ff=12288 vocab=49152,
head_dim=128, RoPE (theta 1e5), tied embeddings, biases everywhere.
"""
from ..models.transformer import LMConfig

ARCH_ID = "starcoder2-3b"
FAMILY = "dense"
# the dry run's cells (launch/dryrun.py): long_500k only where attention
# is not quadratic in the sequence
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def config(**overrides) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        head_dim=128,
        d_ff=12288,
        vocab_size=49152,
        ffn_kind="plain",
        act="gelu",
        norm="layernorm",
        qkv_bias=True,
        out_bias=True,
        mlp_bias=True,
        rope_theta=1e5,
        tie_embeddings=True,
        scan_layers=True,
    )
    base.update(overrides)
    return LMConfig(**base)


def reduced_config() -> LMConfig:
    return config(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=512, scan_layers=False)
