"""Architecture registry (port of ``repro.configs``).

``get_config(arch_id)`` -> the model config with its published numbers;
``get_reduced(arch_id)`` -> a CPU-test-sized config of the same family.
starcoder2-3b, recurrentgemma-2b and rwkv6-1.6b are ported; the other ids
raise.
"""

from __future__ import annotations

import importlib

_MODULES = {"starcoder2-3b": "starcoder2_3b",
            "recurrentgemma-2b": "recurrentgemma_2b",
            "rwkv6-1.6b": "rwkv6_1_6b"}
_NOT_PORTED = ("whisper-tiny", "qwen3-moe-30b-a3b", "llama4-scout-17b-a16e",
               "qwen2.5-32b", "qwen3-32b", "phi3-medium-14b", "qwen2-vl-72b")

ARCH_IDS = tuple(_MODULES) + _NOT_PORTED


def _module(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"config {arch_id!r} is not ported yet (ROADMAP queue 1 item 7)")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCH_IDS)}")
    return importlib.import_module(f"{__name__}.{_MODULES[arch_id]}")


def get_config(arch_id: str, **overrides):
    return _module(arch_id).config(**overrides)


def get_reduced(arch_id: str):
    return _module(arch_id).reduced_config()
