"""CUDA flash attention — causal GQA attention with online softmax.

:func:`flash_attention` replaces ``src/repro/kernels/flash_attention.py::
flash_attention``: q (B, H, Sq, D), k/v (B, KH, Skv, D) in fp32 or bf16,
kv head ``h // (H // KH)``, the causal mask end-aligned (query i sits at
position ``i + Skv - Sq``), an optional sliding ``window``, fp32 softmax
statistics and accumulator, output in q's dtype.  The kernel
(``csrc/flash_attention.cu``) takes each tensor's strides, so a (B, S, H, D)
tensor transposed to (B, H, S, D) is read in place; only the innermost dim
must be contiguous.  Bound by operations on the H100; this first kernel
runs them on the fp32 cores.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Launches in this process (read and reset by chip_smoke.py).
launches = 0

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != 4:
        raise ValueError(f"{name} must be (B, heads, S, D), got "
                         f"{tuple(t.shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last dim")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """(B, H, Sq, D) attention output in q's dtype and layout."""
    global launches
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be fp32 or bf16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t, name, q.dtype)
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, kh, skv, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be ({b}, KH, Skv, {d}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if h % kh:
        raise ValueError(f"q heads {h} must be a multiple of kv heads {kh}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    if skv < 1:
        raise ValueError("attention over an empty key sequence")
    if causal and sq > skv:
        raise ValueError(f"causal attention with Sq={sq} > Skv={skv} leaves "
                         "queries with no key")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    dev = _build.same_device(q, k, v)
    scale = float(scale) if scale is not None else 1.0 / float(d) ** 0.5
    out = torch.empty_like(q)
    strides = (ctypes.c_int64 * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = _build.library().brk_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, h, kh, sq, skv, d, int(causal), window or 0, scale,
        _DTYPES[q.dtype], dev.index, _build.stream_of(dev))
    _build.check(err, "flash_attention")
    launches += 1
    return out
