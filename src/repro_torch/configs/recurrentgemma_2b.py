"""recurrentgemma-2b — Griffin hybrid: RG-LRU + local attention, 1:2.

[arXiv:2402.19427; hf] 26L d_model=2560 10H (kv=1, MQA) d_ff=7680
vocab=256000, head_dim=256, pattern (rglru, rglru, local_attn), window 2048,
lru_width 2560, GeGLU MLP.
"""
from ..models.transformer import LMConfig

ARCH_ID = "recurrentgemma-2b"
FAMILY = "hybrid"
# the dry run's cells (launch/dryrun.py): long_500k only where attention
# is not quadratic in the sequence
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def config(**overrides) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        block_pattern=("rglru", "rglru", "local_attn"),
        window=2048,
        lru_width=2560,
        act="gelu_tanh",
        rope_theta=1e4,
        tie_embeddings=True,
        scan_layers=False,        # heterogeneous pattern: unrolled
    )
    base.update(overrides)
    return LMConfig(**base)


def reduced_config() -> LMConfig:
    return config(num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
                  head_dim=16, d_ff=128, lru_width=64, vocab_size=512,
                  window=8)
