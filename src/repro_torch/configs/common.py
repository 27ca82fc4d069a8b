"""The shape grid shared by every LM config, and the batch's shapes and
logical axes (port of ``repro.configs.common``).

The four input shapes (seq_len x global_batch):

    train_4k     4,096 x 256    training       -> train step
    prefill_32k  32,768 x 32    inference      -> prefill
    decode_32k   32,768 x 128   inference      -> decode step (1 new token)
    long_500k    524,288 x 1    long-context   -> decode step

:func:`batch_structs` gives a shape's model inputs as tensors on the
``meta`` device (shapes and dtypes; nothing is allocated) and
:func:`batch_axes` their logical axes, which ``dist/sharding.py``
resolves.  Extras (audio frames, vision patches) come from the bundle's
``extra_inputs``; each is (B, n, d_model), on the axes ("batch", None,
"embed") the reference declares for both.  :func:`cache_structs` gives
a shape's caches as ``meta`` tensors, their axes are the bundle's
``cache_axes()``.
"""

from __future__ import annotations

import dataclasses

import torch

EXTRA_AXES = ("batch", None, "embed")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def positions_struct(cfg, b: int, s: int) -> torch.Tensor:
    if getattr(cfg, "mrope_section", None):
        return _struct((b, s, 3), torch.int32)
    return _struct((b, s), torch.int32)


def batch_structs(bundle, shape: ShapeSpec) -> dict:
    """Model inputs for one shape as ``meta`` tensors.

    train:   {tokens, labels, positions, *extras}
    prefill: {tokens, positions, lengths, *extras}
    decode:  {tokens (B,1), positions (B,1[,3]), lengths}
    """
    cfg = bundle.cfg
    b = shape.global_batch
    if shape.kind == "train":
        s = shape.seq_len
        out = {"tokens": _struct((b, s), torch.int32),
               "labels": _struct((b, s), torch.int32),
               "positions": positions_struct(cfg, b, s)}
    elif shape.kind == "prefill":
        s = shape.seq_len
        out = {"tokens": _struct((b, s), torch.int32),
               "positions": positions_struct(cfg, b, s),
               "lengths": _struct((b,), torch.int32)}
    else:
        out = {"tokens": _struct((b, 1), torch.int32),
               "positions": positions_struct(cfg, b, 1),
               "lengths": _struct((b,), torch.int32)}
    if shape.kind != "decode":
        for name, (shape_fn, dtype) in bundle.extra_inputs.items():
            out[name] = _struct(shape_fn(b, shape.seq_len), dtype)
    return out


def batch_axes(bundle, shape: ShapeSpec) -> dict:
    """Logical axes of each batch input (resolved by dist/sharding.py)."""
    mrope = bool(getattr(bundle.cfg, "mrope_section", None))
    pos = ("batch", "seq", None) if mrope else ("batch", "seq")
    if shape.kind == "train":
        out = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
               "positions": pos}
    elif shape.kind == "prefill":
        out = {"tokens": ("batch", "seq"), "positions": pos,
               "lengths": ("batch",)}
    else:
        pos1 = ("batch", None, None) if mrope else ("batch", None)
        out = {"tokens": ("batch", None), "positions": pos1,
               "lengths": ("batch",)}
    if shape.kind != "decode":
        for name in bundle.extra_inputs:
            out[name] = EXTRA_AXES
    return out


def cache_structs(bundle, shape: ShapeSpec):
    """The caches of a prefill or decode of ``shape`` as ``meta`` tensors
    (the bundle's ``init_cache`` on the ``meta`` device: nothing is
    allocated)."""
    return bundle.init_cache(shape.global_batch, shape.seq_len,
                             device="meta")
