"""int8 gradient compression with error feedback (port of
``repro.dist.compression``).

Data-parallel all-reduces move fp32 gradients; an int8 wire format (a
code per element and one fp32 scale per tensor per rank) cuts the bytes
4x.  Plain quantization biases the update, so every rank keeps a
**residual**: step t's quantization error is added back into step t+1's
gradient (error feedback), so the *accumulated* applied update tracks the
true mean.

Each function is a per-rank function over one mesh dim (the data-parallel
``axis`` of ``mesh``, its process group ``mesh.get_group(axis)``), with
this rank's tensors, the counterpart of the reference's ``shard_map``
body.  The int8 code and scale are what a wire would carry; as in the
reference, the dequantized fp32 values enter the all-reduce (the same
arithmetic as summing scaled int8 codes with per-rank scales).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from ..train.optimizer import tree_leaves, tree_map

Tensor = torch.Tensor


class EFState(NamedTuple):
    """Per-rank error-feedback residuals, one leaf per gradient leaf."""

    residual: Any


def init_ef_state(grads: Any) -> EFState:
    """Zero residuals shaped like this rank's gradient tree."""
    return EFState(residual=tree_map(torch.zeros_like, grads))


# The reference's compiled program (XLA) turns max|x| / 127 into a multiply
# by the fp32 reciprocal of 127, and contracts x - code * scale into one
# FMA; the port computes both as it does, so codes, scales and residuals
# are the reference's bits.
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def _quantize_int8(x: Tensor) -> tuple[Tensor, Tensor]:
    """Symmetric per-tensor int8: (code, scale) with x ~= code * scale;
    the scale max|x| / 127 (times the fp32 reciprocal, as XLA computes
    it) floored at 1e-30, the code rounded half to even and clipped to
    +-127."""
    scale = torch.amax(torch.abs(x)) * _INV_127
    scale = torch.clamp(scale, min=1e-30)           # all-zero tensor guard
    code = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return code, scale


def _residual(x: Tensor, code: Tensor, scale: Tensor) -> Tensor:
    """x - code * scale rounded once, as the reference's FMA gives it: in
    fp64 the difference is exact (a nonzero code means |x| >= scale / 2,
    so every bit of it lies within 53 of the top one), and one rounding
    to fp32 follows."""
    return (x.to(torch.float64) - code.to(torch.float64)
            * scale.to(torch.float64)).to(torch.float32)


def compressed_psum_mean(g: Tensor, mesh, axis: str,
                         residual: Tensor) -> tuple[Tensor, Tensor]:
    """Mean of ``g`` over ``axis`` through an int8 wire, with error
    feedback.  Returns ``(mean_estimate, new_residual)``: the estimate is
    the same on every rank of ``axis`` (an all-reduce of the dequantized
    values divided by the axis size); the residual is this rank's
    quantization error, fed back on the next call."""
    group = mesh.get_group(axis)
    x = g + residual
    code, scale = _quantize_int8(x)
    deq = code.to(torch.float32) * scale
    new_residual = _residual(x, code, scale)
    total = deq.clone()
    dist.all_reduce(total, group=group)
    return total / dist.get_world_size(group), new_residual


def compressed_grad_allreduce(grads: Any, mesh, axis: str,
                              ef: EFState) -> tuple[Any, EFState]:
    """:func:`compressed_psum_mean` over every leaf of a gradient tree
    (dicts, lists and tuples of tensors), in the tree's order."""
    means, residuals = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(ef.residual),
                    strict=True):
        m, nr = compressed_psum_mean(g, mesh, axis, r)
        means.append(m)
        residuals.append(nr)
    m_it, r_it = iter(means), iter(residuals)
    return (tree_map(lambda _: next(m_it), grads),
            EFState(residual=tree_map(lambda _: next(r_it), grads)))
