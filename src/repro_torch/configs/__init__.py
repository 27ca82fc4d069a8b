"""Architecture registry (port of ``repro.configs``).

``get_config(arch_id)`` -> the model config with its published numbers;
``get_reduced(arch_id)`` -> a CPU-test-sized config of the same family;
``arch_cells()`` -> every (arch x shape) cell of the dry run
(``launch/dryrun.py``) with its skip note.
All ten ids are ported: whisper-tiny is the encoder-decoder
(``models/encdec.py``), the rest decoder-only (``models/transformer.py``),
qwen2-vl-72b with M-RoPE and its patch stub.
"""

from __future__ import annotations

import importlib

from .common import SHAPES, ShapeSpec, batch_axes, batch_structs, cache_structs  # noqa: F401

_MODULES = {"whisper-tiny": "whisper_tiny",
            "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
            "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
            "qwen2.5-32b": "qwen2_5_32b",
            "qwen3-32b": "qwen3_32b",
            "starcoder2-3b": "starcoder2_3b",
            "phi3-medium-14b": "phi3_medium_14b",
            "recurrentgemma-2b": "recurrentgemma_2b",
            "qwen2-vl-72b": "qwen2_vl_72b",
            "rwkv6-1.6b": "rwkv6_1_6b"}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCH_IDS)}")
    return importlib.import_module(f"{__name__}.{_MODULES[arch_id]}")


def get_config(arch_id: str, **overrides):
    return _module(arch_id).config(**overrides)


def get_reduced(arch_id: str):
    return _module(arch_id).reduced_config()


def arch_shapes(arch_id: str) -> tuple[str, ...]:
    return _module(arch_id).SHAPES


def arch_family(arch_id: str) -> str:
    return _module(arch_id).FAMILY


def arch_cells() -> list:
    """All (arch, shape, runnable, note) cells of the dry run: 40."""
    cells = []
    for arch in ARCH_IDS:
        mod = _module(arch)
        for shape in SHAPES:
            if shape in mod.SHAPES:
                cells.append((arch, shape, True, ""))
            else:
                cells.append((arch, shape, False,
                              "long_500k skipped: full quadratic attention "
                              "(see DESIGN.md §Arch-applicability)"))
    return cells
