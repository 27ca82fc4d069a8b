"""whisper-tiny — encoder-decoder audio backbone (conv frontend stubbed).

[arXiv:2212.04356; unverified] 4 encoder + 4 decoder layers, d_model=384,
6H (kv=6), d_ff=1536, vocab=51865.  MHA, LayerNorm, GeLU, learned decoder
positions, sinusoidal encoder positions; the encoder sees 1500 precomputed
frame embeddings (the conv1d x2 + GELU frontend is a stub).
"""
from ..models.encdec import EncDecConfig

ARCH_ID = "whisper-tiny"
FAMILY = "audio"
# the dry run's cells (launch/dryrun.py): long_500k only where attention
# is not quadratic in the sequence
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def config(**overrides) -> EncDecConfig:
    base = dict(
        name=ARCH_ID,
        encoder_layers=4,
        decoder_layers=4,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51865,
        num_frames=1500,
        act="gelu",
        norm="layernorm",
        max_position=1 << 16,
    )
    base.update(overrides)
    return EncDecConfig(**base)


def reduced_config() -> EncDecConfig:
    return config(encoder_layers=2, decoder_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
                  vocab_size=512, num_frames=16, max_position=4096,
                  dense_attn_threshold=4096)
