"""The train step on one device: microbatched, remat'd, updated in place
(port of ``repro.train.train_loop``).

``make_train_step(bundle, cfg)`` returns ``step(state, batch) -> (state,
metrics)``.  A microbatch's loss runs through the model's training forward
(``bundle.forward_autograd``: attention through the reference's
differentiable dispatch, never kernel #10, which has no backward pass) and
the chunked loss, then ``backward``; the gradients of the microbatches add
up in each parameter's fp32 ``.grad`` in microbatch order and are divided
by their count, and the metrics are averaged, as the reference's Python
loop does.  AdamW then writes the parameters and the moments in place.

One device holds the whole state, so the reference's mesh, shardings and
donation have no counterpart; ``lower_train_step`` waits for the launch
tooling (ROADMAP item 5).  Every config the reference trains trains
here: the dense, MoE, recurrent and VLM decoders and the
encoder-decoder.  :func:`train_batch` gives a step's batch as the
reference's launcher builds it (M-RoPE positions, zero stub inputs).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..data.pipeline import TokenStreamConfig, token_batch
from ..device import resolve_device
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


def init_train_state(bundle, seed: int = 0) -> TrainState:
    """Parameters from ``bundle.init(seed)`` on the bundle's device, each
    asking for its gradient, and zero fp32 moments."""
    check_trainable(bundle.cfg)
    params = _trainable(bundle.init(seed))
    return TrainState(params=params, opt=opt_mod.init_state(params))


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


def train_state_to(state: TrainState, device) -> TrainState:
    """A copy of ``state`` on ``device``, the parameters asking for their
    gradients (the same values on another device, e.g. to hold a step on
    the card against the same step on the CPU)."""
    dev = resolve_device(device)
    moved = tree_map(lambda t: t.detach().to(dev, copy=True), state)
    _trainable(moved.params)
    return moved


def train_batch(bundle, stream: TokenStreamConfig, step: int) -> dict:
    """Batch ``step`` of the token stream on the bundle's device, as the
    reference's launcher feeds it: (B, S, 3) positions for an M-RoPE
    config and the bundle's extra inputs (frames, patch embeddings) as
    zeros."""
    batch = token_batch(stream, step, device=bundle.device,
                        mrope=bool(getattr(bundle.cfg, "mrope_section",
                                           None)))
    batch.update(zero_extras(bundle, stream.global_batch, stream.seq_len))
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


def make_train_step(bundle, cfg: TrainConfig):
    """The (state, batch) -> (state, metrics) step.  ``batch`` holds
    tokens, labels and positions with a leading batch axis that the
    microbatch count divides.  The state's tensors are updated in place
    and returned; metrics are 0-dim tensors on the device (loss, nll,
    z_loss, accuracy, aux_loss, lr, grad_norm, param_norm)."""
    check_trainable(bundle.cfg)
    loss_fn = make_loss_fn(bundle, cfg)
    n_micro = cfg.microbatches

    def step(state: TrainState, batch: dict):
        rows = batch["tokens"].shape[0]
        if n_micro < 1 or rows % n_micro:
            raise ValueError(f"{n_micro} microbatches do not divide a batch "
                             f"of {rows} rows")
        params = state.params
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        if n_micro == 1:
            loss, metrics = loss_fn(params, batch)
            loss.backward()
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            loss = 0.0
            metrics = None
            for i in range(n_micro):
                li, m = loss_fn(params, _split_micro(batch, n_micro, i))
                li.backward()          # adds into each .grad, in order
                m = {k: v.detach() for k, v in m.items()}
                loss = loss + li.detach() / n_micro
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in metrics}
            with torch.no_grad():
                for p in leaves:
                    p.grad.div_(n_micro)
            metrics = {k: v / n_micro for k, v in metrics.items()}
        grads = tree_map(lambda p: p.grad, params)
        params, new_opt, stats = opt_mod.apply_updates(params, grads,
                                                       state.opt, cfg.opt)
        for p in leaves:
            p.grad = None
        metrics = dict(metrics, loss=loss, **stats)
        return TrainState(params, new_opt), metrics

    return step
