"""The train step: microbatched, remat'd, updated in place, on one
device or sharded over a ``DeviceMesh`` (port of
``repro.train.train_loop``).

``make_train_step(bundle, cfg)`` returns ``step(state, batch) -> (state,
metrics)``.  A microbatch's loss runs through the model's training forward
(``bundle.forward_autograd``: attention through the reference's
differentiable dispatch, never kernel #10, which has no backward pass) and
the chunked loss, then ``backward``; the gradients of the microbatches add
up in each parameter's fp32 ``.grad`` in microbatch order and are divided
by their count, and the metrics are averaged, as the reference's Python
loop does.  AdamW then writes the parameters and the moments in place.

``make_train_step(bundle, cfg, mesh=, shape=, rules=)`` is the sharded
step.  :func:`state_shardings` resolves every parameter and moment to
DTensor placements from its logical axes (``bundle.param_axes``,
``dist/sharding.py``; the reference's ``NamedSharding``s) and
:func:`init_train_state` with ``mesh=`` places them there.  The step
places the batch by :func:`batch_shardings`, runs the forward and the loss
under ``activation_rules`` (each ``constrain`` anchor a
``redistribute``, DTensor's propagation between them, plain tensors such
as masks taken as replicated), slices each microbatch's rows of the
global batch as the reference does, redistributes each gradient from
``Partial`` to its parameter's placements after the backward (a
reduce-scatter under fsdp: the reference's ``with_sharding_constraint``
on the gradients) and gives the metrics back as plain tensors, the same
on every rank.  At one rank on a (1, 1) mesh it gives the mesh-less
step's bits.  Donation has no counterpart (the update is in place).
:func:`lower_train_step` is the dry run's step (launch/lowering.py): the
state of :func:`state_structs` and the batch as ``meta`` shards, run once
through the sharded step under a cost count.

Every config the reference trains trains here: the dense, MoE, recurrent
and VLM decoders and the encoder-decoder.  :func:`train_batch` gives a
step's batch as the reference's launcher builds it (M-RoPE positions,
zero stub inputs), placed on a mesh where one is given.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, NamedTuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..configs.common import ShapeSpec, batch_axes, batch_structs
from ..data.pipeline import (TokenStreamConfig, batch_placements, local_rows,
                             token_batch)
from ..device import resolve_device
from ..dist import sharding as shd
from ..models import encdec, transformer
from ..models.encdec import EncDecConfig
from ..models.registry import zero_extras
from ..models.transformer import LMConfig
from . import losses
from . import optimizer as opt_mod
from .optimizer import AdamWState, OptimizerConfig, tree_leaves, tree_map

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    loss_chunk: int = 512
    z_weight: float = 1e-4
    opt: OptimizerConfig = OptimizerConfig()


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def check_trainable(cfg) -> None:
    """``TypeError`` for a config type ``build_model`` does not build;
    ``ValueError`` for an option the training forward does not port
    (``transformer.check_trainable``)."""
    if isinstance(cfg, LMConfig):
        transformer.check_trainable(cfg)
    elif not isinstance(cfg, EncDecConfig):
        raise TypeError(f"unknown config type {type(cfg)}")


def _trainable(params):
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def state_shardings(bundle, mesh: DeviceMesh, rules=None) -> TrainState:
    """The ``dist.sharding.Sharding`` of every parameter and moment, from
    the parameters' logical axes; the step count is a plain tensor on
    every rank (None)."""
    p_sh = shd.tree_shardings_for_structs(
        bundle.param_axes(), bundle.param_structs(), mesh, rules)
    return TrainState(params=p_sh,
                      opt=AdamWState(step=None, mu=p_sh, nu=p_sh))


def state_structs(bundle) -> TrainState:
    """The train state as ``meta`` tensors: fp32 parameters, fp32 AdamW
    moments, the int32 step (the reference's ``_state_structs``)."""
    def f32(t):
        return tree_map(lambda s: torch.empty(s.shape, dtype=torch.float32,
                                              device="meta"), t)

    p = bundle.param_structs()
    return TrainState(params=p, opt=AdamWState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        mu=f32(p), nu=f32(p)))


def lower_train_step(bundle, mesh: DeviceMesh, cfg: TrainConfig,
                     shape: ShapeSpec, batch: dict, rules=None, *,
                     count=None):
    """The dry run's train step: :func:`state_structs` placed by
    :func:`state_shardings` and ``batch`` (``meta`` structs) by
    :func:`batch_shardings` as ``meta`` shards, the parameters asking for
    their gradients; ``count`` (a ``launch.cost_analysis.CostCount``),
    where given, takes them as arguments and is entered around one call
    of ``make_train_step(..., mesh=)``.  Returns (state, metrics)."""
    state = state_structs(bundle)
    state = shd.place_structs(state, state_shardings(bundle, mesh, rules))
    _trainable(state.params)
    placed = shd.place_structs(batch, batch_shardings(bundle, shape, mesh,
                                                      rules))
    step = make_train_step(bundle, cfg, mesh=mesh, shape=shape, rules=rules)
    if count is None:
        return step(state, placed)
    count.add_arguments((state, placed))
    with count:
        return step(state, placed)


def batch_shardings(bundle, shape: ShapeSpec, mesh: DeviceMesh,
                    rules=None) -> dict:
    """The ``Sharding`` of each input of a batch of ``shape``."""
    return shd.tree_shardings_for_structs(
        batch_axes(bundle, shape), batch_structs(bundle, shape), mesh, rules)


def init_train_state(bundle, seed: int = 0, *, mesh: DeviceMesh | None = None,
                     rules=None) -> TrainState:
    """Parameters from ``bundle.init(seed)`` on the bundle's device, each
    asking for its gradient, and zero fp32 moments.  With ``mesh`` every
    rank draws the same parameters and keeps its shards of them: each
    parameter and moment a DTensor in its :func:`state_shardings`
    placements."""
    check_trainable(bundle.cfg)
    params = _trainable(bundle.init(seed))
    state = TrainState(params=params, opt=opt_mod.init_state(params))
    if mesh is None:
        return state
    return shard_train_state(state, state_shardings(bundle, mesh, rules))


def train_state_from_numpy(cfg, tree, device="cuda") -> TrainState:
    """The reference's ``TrainState`` (params, then ``AdamWState(step, mu,
    nu)``) with numpy leaves, as the port's on ``device``.  The parameter
    trees go through ``transformer.params_from_numpy`` (a stacked
    ``scan_layers`` tree included, MoE expert stacks as they are) or
    ``encdec.params_from_numpy``; every leaf is its own tensor, so each
    parameter can hold its gradient."""
    check_trainable(cfg)
    dev = resolve_device(device)
    params_np, (step, mu, nu) = tree
    module = encdec if isinstance(cfg, EncDecConfig) else transformer

    def own(t: Tensor) -> Tensor:
        return t.clone() if t._base is not None else t

    def convert(t):
        return tree_map(own, module.params_from_numpy(cfg, t, dev))

    params = _trainable(convert(params_np))
    opt = AdamWState(step=torch.tensor(int(step), dtype=torch.int32,
                                       device=dev),
                     mu=convert(mu), nu=convert(nu))
    return TrainState(params=params, opt=opt)


def shard_train_state(state: TrainState, shardings: TrainState
                      ) -> TrainState:
    """A whole-tensor ``state`` (the same on every rank) on the mesh of
    ``shardings`` (:func:`state_shardings`): each rank keeps its shards,
    the parameters asking for their gradients; a leaf whose sharding is
    None stays as it is."""
    with torch.no_grad():
        placed = tree_map(
            lambda t, sh: t if sh is None else shd.distribute(t.detach(), sh),
            state, shardings)
    _trainable(placed.params)
    return placed


def train_state_to(state: TrainState, device) -> TrainState:
    """A copy of ``state`` on ``device``, the parameters asking for their
    gradients (the same values on another device, e.g. to hold a step on
    the card against the same step on the CPU)."""
    dev = resolve_device(device)
    moved = tree_map(lambda t: t.detach().to(dev, copy=True), state)
    _trainable(moved.params)
    return moved


def train_batch(bundle, stream: TokenStreamConfig, step: int,
                mesh: DeviceMesh | None = None, rules=None) -> dict:
    """Batch ``step`` of the token stream on the bundle's device, as the
    reference's launcher feeds it: (B, S, 3) positions for an M-RoPE
    config and the bundle's extra inputs (frames, patch embeddings) as
    zeros.  With ``mesh`` each rank makes only its rows, and every input
    is a DTensor with its batch dim placed by ``rules``
    (``token_batch``)."""
    batch = token_batch(stream, step, device=bundle.device,
                        mrope=bool(getattr(bundle.cfg, "mrope_section",
                                           None)), mesh=mesh, rules=rules)
    if mesh is None:
        batch.update(zero_extras(bundle, stream.global_batch,
                                 stream.seq_len))
        return batch
    sh = batch_placements(stream.global_batch, mesh, rules)
    rows = len(local_rows(stream.global_batch, mesh, sh))
    for name, t in zero_extras(bundle, rows, stream.seq_len).items():
        batch[name] = DTensor.from_local(t, mesh, sh)
    return batch


def _split_micro(batch: dict, n: int, i: int) -> dict:
    """Microbatch ``i`` of ``n``: consecutive rows of every input."""
    def sl(x):
        mb = x.shape[0] // n
        return x[i * mb:(i + 1) * mb]
    return {k: sl(v) for k, v in batch.items()}


def make_loss_fn(bundle, cfg: TrainConfig):
    """(params, batch) -> (loss, metrics {nll, z_loss, accuracy,
    aux_loss}), differentiable in the parameters."""
    def loss_fn(params, batch):
        hidden, aux = bundle.forward_autograd(params, batch)
        table = params.get("unembed", params["embed"])  # tied: no unembed
        loss, metrics = losses.chunked_cross_entropy(
            hidden, batch["labels"], table, chunk=cfg.loss_chunk,
            z_weight=cfg.z_weight)
        metrics["aux_loss"] = torch.as_tensor(aux, dtype=torch.float32,
                                              device=hidden.device)
        return loss + aux, metrics
    return loss_fn


def _place(x, sharding: shd.Sharding):
    """``x`` as a DTensor in ``sharding``: a DTensor redistributed, a plain
    tensor (the same global tensor on every rank) split locally."""
    if isinstance(x, DTensor):
        if tuple(x.placements) == sharding.placements:
            return x
        return x.redistribute(sharding.mesh, sharding.placements)
    return shd.distribute(x, sharding)


def _full(x):
    """A DTensor's global value as a plain tensor; a plain tensor itself."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_train_step(bundle, cfg: TrainConfig, *,
                    mesh: DeviceMesh | None = None,
                    shape: ShapeSpec | None = None, rules=None):
    """The (state, batch) -> (state, metrics) step.  ``batch`` holds
    tokens, labels and positions with a leading batch axis that the
    microbatch count divides.  The state's tensors are updated in place
    and returned; metrics are 0-dim tensors on the device (loss, nll,
    z_loss, accuracy, aux_loss, lr, grad_norm, param_norm).

    With ``mesh`` (and the batch's ``shape``) the sharded step of the
    module docstring: the state as :func:`init_train_state` places it,
    the batch DTensors or plain tensors (the same global batch on every
    rank), the metrics plain tensors, the same on every rank."""
    check_trainable(bundle.cfg)
    loss_fn = make_loss_fn(bundle, cfg)
    n_micro = cfg.microbatches
    if mesh is not None:
        if shape is None:
            raise ValueError("a sharded step needs the batch's shape")
        batch_sh = batch_shardings(bundle, shape, mesh, rules)
        micro_sh = batch_shardings(bundle, dataclasses.replace(
            shape, global_batch=shape.global_batch // max(n_micro, 1)),
            mesh, rules)

    def context():
        if mesh is None:
            return contextlib.nullcontext()
        ctx = contextlib.ExitStack()
        ctx.enter_context(shd.activation_rules(mesh, rules))
        ctx.enter_context(implicit_replication())
        return ctx

    def micro_loss(params, batch):
        loss, metrics = loss_fn(params, batch)
        loss.backward()          # adds into each .grad, in order
        return (_full(loss.detach()),
                {k: _full(v.detach()) for k, v in metrics.items()})

    def step(state: TrainState, batch: dict):
        rows = batch["tokens"].shape[0]
        if n_micro < 1 or rows % n_micro:
            raise ValueError(f"{n_micro} microbatches do not divide a batch "
                             f"of {rows} rows")
        params = state.params
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        with context():
            if mesh is not None:
                batch = {k: _place(v, batch_sh[k]) for k, v in batch.items()}
            if n_micro == 1:
                loss, metrics = micro_loss(params, batch)
            else:
                loss = 0.0
                metrics = None
                for i in range(n_micro):
                    mb = _split_micro(batch, n_micro, i)
                    if mesh is not None:
                        mb = {k: _place(v, micro_sh[k])
                              for k, v in mb.items()}
                    li, m = micro_loss(params, mb)
                    loss = loss + li / n_micro
                    metrics = m if metrics is None else {
                        k: metrics[k] + m[k] for k in metrics}
                metrics = {k: v / n_micro for k, v in metrics.items()}
        with torch.no_grad():
            for p in leaves:
                if mesh is not None:
                    # Partial -> the parameter's placements
                    p.grad = p.grad.redistribute(mesh, p.placements)
                if n_micro > 1:
                    p.grad.div_(n_micro)
        grads = tree_map(lambda p: p.grad, params)
        params, new_opt, stats = opt_mod.apply_updates(params, grads,
                                                       state.opt, cfg.opt)
        for p in leaves:
            p.grad = None
        metrics = dict(metrics, loss=loss, **stats)
        return TrainState(params, new_opt), metrics

    return step
