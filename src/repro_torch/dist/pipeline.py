"""Pipeline parallelism: a GPipe microbatch schedule over a mesh dim
(port of ``repro.dist.pipeline``).

Stage ``s`` runs on rank ``s`` of ``axis``; microbatches flow down the
ring with one send and receive per step.  With ``p`` stages and
``n_micro`` microbatches the schedule runs ``n_micro + p - 1`` steps:
stage 0 takes microbatch ``t`` at step ``t``, stage ``s`` works on it at
step ``s + t``, and the last stage gives it out at step ``p - 1 + t``
(the (p - 1)-step fill and drain bubble).  Every rank runs the same
program each step: bubble slots compute on zeros and are discarded.  A
per-rank function over the dim's process group, the counterpart of the
reference's ``shard_map`` body.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..train.optimizer import tree_map
from .collective_matmul import _ring, _shift

Tensor = torch.Tensor


def pipeline_apply(stage_fn: Callable, mesh, axis: str, stage_params,
                   microbatches: Tensor) -> Tensor:
    """Apply ``p`` stages to ``n_micro`` microbatches on a pipeline.

    Args:
      stage_fn: ``(w, x) -> y`` with ``y.shape == x.shape`` (stages chain).
      stage_params: this rank's slice of the ``(p, ...)`` stacked stage
        parameters (a tensor or tree whose leaves have a leading axis of
        1: stage ``s``'s parameters on rank ``s`` of ``axis``).
      microbatches: ``(n_micro, ...)`` inputs, the same on every rank.
    Returns the ``(n_micro, ...)`` outputs of the final stage on every
    rank: the last stage's outputs all-reduced with zeros from the rest,
    so they equal the last stage's."""
    group, idx, p, peer = _ring(mesh, axis)
    w = tree_map(lambda a: a[0], stage_params)          # this rank's stage
    n_micro = microbatches.shape[0]
    recv = torch.zeros_like(microbatches[0])
    ys = torch.zeros_like(microbatches)
    for t in range(n_micro + p - 1):
        if idx == 0:
            feed = (microbatches[t] if t < n_micro
                    else torch.zeros_like(microbatches[0]))
        else:
            feed = recv
        out = stage_fn(w, feed)
        done = t - (p - 1)                              # microbatch leaving
        if done >= 0 and idx == p - 1:
            ys[done] = out
        if p > 1:                                       # stage s -> s + 1
            recv, reqs = _shift(out.contiguous(), peer((idx + 1) % p),
                                peer((idx - 1) % p), group)
            for r in reqs:
                r.wait()
    # only the last stage holds real outputs; the sum replicates them
    if idx != p - 1:
        ys.zero_()
    dist.all_reduce(ys, group=group)
    return ys
