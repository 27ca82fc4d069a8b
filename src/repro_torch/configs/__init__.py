"""Architecture registry (port of ``repro.configs``).

``get_config(arch_id)`` -> the model config with its published numbers;
``get_reduced(arch_id)`` -> a CPU-test-sized config of the same family.
All ten ids are ported: whisper-tiny is the encoder-decoder
(``models/encdec.py``), the rest decoder-only (``models/transformer.py``),
qwen2-vl-72b with M-RoPE and its patch stub.
"""

from __future__ import annotations

import importlib

_MODULES = {"qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
            "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
            "qwen2.5-32b": "qwen2_5_32b",
            "qwen3-32b": "qwen3_32b",
            "starcoder2-3b": "starcoder2_3b",
            "phi3-medium-14b": "phi3_medium_14b",
            "recurrentgemma-2b": "recurrentgemma_2b",
            "rwkv6-1.6b": "rwkv6_1_6b",
            "whisper-tiny": "whisper_tiny",
            "qwen2-vl-72b": "qwen2_vl_72b"}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCH_IDS)}")
    return importlib.import_module(f"{__name__}.{_MODULES[arch_id]}")


def get_config(arch_id: str, **overrides):
    return _module(arch_id).config(**overrides)


def get_reduced(arch_id: str):
    return _module(arch_id).reduced_config()
