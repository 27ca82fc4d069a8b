"""Uniform model interface (port of ``repro.models.registry``).

    bundle.init(seed)                              -> params
    bundle.forward_train(params, batch)            -> (hidden, aux_loss)
    bundle.logits(params, hidden)                  -> fp32 logits
    bundle.init_cache(batch_size, s_max)           -> caches
    bundle.prefill(params, batch, caches, lens)    -> (hidden, caches)
    bundle.decode_step(params, tok, pos, caches, lens)
                                                   -> (logits, hidden, caches)

``batch`` is a dict with tokens (B, S) and positions (B, S).  A bundle
holds the device its parameters and caches live on.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..device import resolve_device
from . import transformer
from .transformer import LMConfig


class ModelBundle(NamedTuple):
    cfg: Any
    device: torch.device
    init: Callable
    forward_train: Callable
    logits: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    count_params: int


def _lm_bundle(cfg: LMConfig, dev: torch.device) -> ModelBundle:
    transformer.check_supported(cfg)

    def forward_train(params, batch):
        return transformer.forward_train(cfg, params, batch["tokens"],
                                         batch["positions"])

    def prefill(params, batch, caches, lengths):
        return transformer.prefill(cfg, params, batch["tokens"],
                                   batch["positions"], caches, lengths)

    return ModelBundle(
        cfg=cfg,
        device=dev,
        init=lambda seed=0: transformer.init_params(cfg, seed, dev),
        forward_train=forward_train,
        logits=lambda params, h: transformer.logits_fn(cfg, params, h),
        init_cache=lambda b, s: transformer.init_cache(cfg, b, s, dev),
        prefill=prefill,
        decode_step=lambda params, tok, pos, caches, lens:
            transformer.decode_step(cfg, params, tok, pos, caches, lens),
        count_params=transformer.count_params(cfg),
    )


def build_model(cfg, device="cuda") -> ModelBundle:
    """The bundle of a decoder-only config, on ``device`` (the card unless
    the caller asks for the CPU)."""
    dev = resolve_device(device)
    if isinstance(cfg, LMConfig):
        return _lm_bundle(cfg, dev)
    if type(cfg).__name__ == "EncDecConfig":
        raise NotImplementedError(
            "encoder-decoder models are not ported yet (ROADMAP queue 1 "
            "item 12)")
    raise TypeError(f"unknown config type {type(cfg)}")
