"""CUDA flash attention — causal GQA attention with online softmax.

:func:`flash_attention` replaces ``src/repro/kernels/flash_attention.py::
flash_attention``: q (B, H, Sq, D), k/v (B, KH, Skv, D) in fp32 or bf16,
kv head ``h // (H // KH)``, the causal mask end-aligned (query i sits at
position ``i + Skv - Sq``), an optional sliding ``window``, fp32 softmax
statistics and accumulator, output in q's dtype.  Bound by operations on
the H100.  The kernel follows ``q.dtype``:

- bf16 (the model's compute type): ``csrc/flash_attention_wgmma.cu`` on
  the tensor cores, ``wgmma`` products fed by TMA loads of the strided
  (D, S, H, B) view, P as two bf16 halves so the output keeps the fp32
  kernel's error; 128-row q blocks of two warpgroups, 64-row blocks of
  one at D = 256 (recurrentgemma-2b's heads).  TMA needs 16-byte-aligned base pointers and strides
  that are multiples of 8 elements; the wrapper refuses other tensors.
- fp32: ``csrc/flash_attention.cu`` on the fp32 cores (a tensor-core
  product of fp32 operands would need TF32).

Both take each tensor's strides, so a (B, S, H, D) tensor transposed to
(B, H, S, D) is read in place; the innermost dim must be contiguous.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Launches in this process, of either kernel and of each (read and reset by
# chip_smoke.py).
launches = 0
launches_simt = 0
launches_wgmma = 0

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
# TMA's alignment of base pointers and strides, in bytes.
_TMA_ALIGN = 16


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


def tma_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """The (batch, head, seq) element strides a TMA map of ``t`` (B, heads,
    S, D) bf16 is given.  A dim of size 1 is never stepped, so its stride
    is replaced by the tensor's whole extent, which TMA accepts; every
    other stride, and the base pointer, must be 16-byte aligned."""
    elem = t.element_size()
    per = _TMA_ALIGN // elem
    span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride(),
                                               strict=True))
    extent = -(-span // per) * per
    out = []
    for dim in range(3):
        if t.shape[dim] == 1:
            out.append(extent)
        elif t.stride(dim) * elem % _TMA_ALIGN:
            raise ValueError(
                f"bf16 flash attention reads through TMA: stride "
                f"{t.stride(dim)} of dim {dim} is not a multiple of "
                f"{_TMA_ALIGN // elem} elements")
        else:
            out.append(t.stride(dim))
    if t.data_ptr() % _TMA_ALIGN:
        raise ValueError("bf16 flash attention reads through TMA: the base "
                         f"pointer must be {_TMA_ALIGN}-byte aligned")
    return tuple(out)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """(B, H, Sq, D) attention output in q's dtype and layout."""
    global launches, launches_simt, launches_wgmma
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
    bf16 = q.dtype == torch.bfloat16
    operand_strides = ([s for t in (q, k, v) for s in tma_strides(t)]
                       if bf16 else
                       [s for t in (q, k, v) for s in t.stride()[:3]])
    out = torch.empty_like(q)
    strides = (ctypes.c_int64 * 12)(*operand_strides, *out.stride()[:3])
    lib = _build.library()
    entry = lib.brk_flash_attention_bf16 if bf16 else lib.brk_flash_attention
    err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                strides, b, h, kh, sq, skv, d, int(causal), window or 0,
                scale, dev.index, _build.stream_of(dev))
    _build.check(err, "flash_attention")
    launches += 1
    if bf16:
        launches_wgmma += 1
    else:
        launches_simt += 1
    return out
