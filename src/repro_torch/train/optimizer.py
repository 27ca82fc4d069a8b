"""AdamW with global-norm clipping and a warmup-cosine schedule (port of
``repro.train.optimizer``).

Parameters and moments are trees of dicts and lists of tensors; the state
mirrors the parameters.  Every expression keeps the reference's fp32 order
of operations; :func:`apply_updates` writes the parameters, the moments and
the gradients (clipped) in place, with the same bits the reference's
out-of-place expressions give.

Under a mesh the leaves are DTensors: a moment takes its parameter's
placements, and a gradient must have them too (the train step anchors
it).  The global norm sums each leaf over all its shards (a sharded sum is
``Partial``; its full value is taken), and AdamW updates each rank's local
shards in place with that norm's clip.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: Tensor     # () int32
    mu: Any          # first moments (a tree like the parameters)
    nu: Any          # second moments


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in its order (a
    dict's in insertion order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` on every leaf, the structure kept (a NamedTuple by its
    type); ``rest``'s trees, where given, add their leaves at the same
    places as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = (tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree))
        return (type(tree)(*out) if hasattr(tree, "_fields")
                else type(tree)(out))
    return fn(tree, *rest)


@torch.no_grad()
def init_state(params) -> AdamWState:
    """Zero moments in fp32 beside each parameter (a DTensor's in its
    placements), step 0 (a plain tensor, the same on every rank)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)

    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _local(t: Tensor) -> Tensor:
    """A DTensor's shard on this rank; a plain tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def schedule(cfg: OptimizerConfig, step: Tensor) -> Tensor:
    """Linear warmup then cosine decay to min_lr_ratio * peak, in fp32."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decayed = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.peak_lr * torch.where(s < cfg.warmup_steps, warm, decayed)


def global_norm(tree) -> Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares (a
    DTensor's over all its shards; a plain tensor back)."""
    sums = []
    for x in tree_leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        sums.append(s.full_tensor() if isinstance(s, DTensor) else s)
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient IN PLACE by min(1, max_norm / norm); returns
    (grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in tree_leaves(grads):
        _local(g).mul_(scale)
    return grads, norm


def _decay_mask(params):
    """Weight decay on matrices only (norm scales, biases: none)."""
    return tree_map(lambda p: float(p.ndim >= 2), params)


@torch.no_grad()
def apply_updates(params, grads, state: AdamWState, cfg: OptimizerConfig):
    """One AdamW step, IN PLACE: the parameters, ``state``'s moments and
    the (clipped) gradients are overwritten.  Returns (params, state with
    the step advanced, stats {lr, grad_norm, param_norm})."""
    grads, grad_norm = clip_by_global_norm(grads, cfg.grad_clip_norm)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    for p, g, m, v, wd_on in zip(tree_leaves(params), tree_leaves(grads),
                                 tree_leaves(state.mu), tree_leaves(state.nu),
                                 tree_leaves(_decay_mask(params)),
                                 strict=True):
        if isinstance(p, DTensor) and not (
                g.placements == p.placements == m.placements
                == v.placements):
            raise ValueError(f"placements differ: parameter {p.placements},"
                             f" gradient {g.placements}, moments "
                             f"{m.placements} {v.placements}")
        p, g, m, v = _local(p), _local(g), _local(m), _local(v)
        gf = g.to(torch.float32)
        m.mul_(b1).add_((1 - b1) * gf)                 # b1*m + (1-b1)*g
        v.mul_(b2).add_((1 - b2) * gf * gf)            # b2*v + (1-b2)*g*g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        delta = delta + cfg.weight_decay * wd_on * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    stats = {"lr": lr, "grad_norm": grad_norm,
             "param_norm": global_norm(params)}
    return params, AdamWState(step, state.mu, state.nu), stats
