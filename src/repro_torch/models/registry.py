"""Uniform model interface over the decoder-only and the encoder-decoder
stacks (port of ``repro.models.registry``).

    bundle.init(seed)                              -> params
    bundle.forward_train(params, batch)            -> (hidden, aux_loss)
    bundle.forward_autograd(params, batch)         -> (hidden, aux_loss),
                      differentiable, for training
    bundle.logits(params, hidden)                  -> fp32 logits
    bundle.init_cache(batch_size, s_max)           -> caches (per layer:
                      {"mixer": KVCache or state dict, "ffn": state dict
                      or None}; enc-dec {"self": KVCache, "cross": KVCache})
    bundle.prefill(params, batch, caches, lens)    -> (hidden, caches)
    bundle.decode_step(params, tok, pos, caches, lens)
                                                   -> (logits, hidden, caches)
    bundle.param_axes()                            -> each parameter's
                      logical axes (dist/sharding.py), in the init tree
    bundle.param_structs()                         -> each parameter as an
                      fp32 ``meta`` tensor, in the init tree

``batch`` is a dict with tokens (B, S) and positions (B, S), or (B, S, 3)
under M-RoPE, plus the modality stubs' extras the bundle declares in
``extra_inputs`` (name -> (shape function of (B, S), dtype)): ``frames``
(B, num_frames, d_model) for the encoder-decoder, ``patch_embeds`` (B,
num_patch_tokens, d_model) for a VLM.  ``model_inputs`` builds such a
batch as the engine and the datastore feed it.  A bundle holds the device
its parameters and caches live on.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..device import resolve_device
from . import encdec, transformer
from .encdec import EncDecConfig
from .transformer import LMConfig


class ModelBundle(NamedTuple):
    cfg: Any
    device: torch.device
    init: Callable
    param_axes: Callable
    param_structs: Callable
    forward_train: Callable
    forward_autograd: Callable
    logits: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    count_params: int
    extra_inputs: dict  # name -> (shape_fn(B, S) -> shape, dtype)


def _lm_bundle(cfg: LMConfig, dev: torch.device) -> ModelBundle:
    transformer.check_supported(cfg)
    extras = {}
    if cfg.num_patch_tokens:
        extras["patch_embeds"] = (
            lambda b, s: (b, cfg.num_patch_tokens, cfg.d_model),
            torch.float32)

    def forward_train(params, batch):
        return transformer.forward_train(cfg, params, batch["tokens"],
                                         batch["positions"],
                                         batch.get("patch_embeds"))

    def forward_autograd(params, batch):
        return transformer.forward_autograd(cfg, params, batch["tokens"],
                                            batch["positions"],
                                            batch.get("patch_embeds"))

    def prefill(params, batch, caches, lengths):
        return transformer.prefill(cfg, params, batch["tokens"],
                                   batch["positions"], caches, lengths,
                                   batch.get("patch_embeds"))

    return ModelBundle(
        cfg=cfg,
        device=dev,
        init=lambda seed=0: transformer.init_params(cfg, seed, dev),
        param_axes=lambda: transformer.param_axes(cfg),
        param_structs=lambda: transformer.param_structs(cfg),
        forward_train=forward_train,
        forward_autograd=forward_autograd,
        logits=lambda params, h: transformer.logits_fn(cfg, params, h),
        init_cache=lambda b, s: transformer.init_cache(cfg, b, s, dev),
        prefill=prefill,
        decode_step=lambda params, tok, pos, caches, lens:
            transformer.decode_step(cfg, params, tok, pos, caches, lens),
        count_params=transformer.count_params(cfg),
        extra_inputs=extras,
    )


def _encdec_bundle(cfg: EncDecConfig, dev: torch.device) -> ModelBundle:
    extras = {"frames": (lambda b, s: (b, cfg.num_frames, cfg.d_model),
                         torch.float32)}

    def forward_train(params, batch):
        return encdec.forward_train(cfg, params, batch["tokens"],
                                    batch["positions"], batch["frames"])

    def forward_autograd(params, batch):
        return encdec.forward_autograd(cfg, params, batch["tokens"],
                                       batch["positions"], batch["frames"])

    def prefill(params, batch, caches, lengths):
        return encdec.prefill(cfg, params, batch["tokens"],
                              batch["positions"], caches, lengths,
                              batch["frames"])

    return ModelBundle(
        cfg=cfg,
        device=dev,
        init=lambda seed=0: encdec.init_params(cfg, seed, dev),
        param_axes=lambda: encdec.param_axes(cfg),
        param_structs=lambda: encdec.param_structs(cfg),
        forward_train=forward_train,
        forward_autograd=forward_autograd,
        logits=lambda params, h: encdec.logits_fn(cfg, params, h),
        init_cache=lambda b, s: encdec.init_cache(cfg, b, s, dev),
        prefill=prefill,
        decode_step=lambda params, tok, pos, caches, lens:
            encdec.decode_step(cfg, params, tok, pos, caches, lens),
        count_params=encdec.count_params(cfg),
        extra_inputs=extras,
    )


def build_model(cfg, device="cuda") -> ModelBundle:
    """The bundle of a decoder-only or an encoder-decoder config, on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    if isinstance(cfg, EncDecConfig):
        return _encdec_bundle(cfg, dev)
    if isinstance(cfg, LMConfig):
        return _lm_bundle(cfg, dev)
    raise TypeError(f"unknown config type {type(cfg)}")


def model_positions(cfg, positions: torch.Tensor) -> torch.Tensor:
    """(B, S) positions as the model takes them: repeated into three equal
    components (B, S, 3) for an M-RoPE config, as the reference's engine
    and datastore give them."""
    if getattr(cfg, "mrope_section", None):
        return positions[..., None].expand(*positions.shape, 3)
    return positions


def zero_extras(bundle: ModelBundle, b: int, s: int) -> dict:
    """Each of the bundle's extra inputs for a (B, S) batch as zeros on its
    device: the modality stubs' inputs, as the reference's engine,
    datastore and training launcher feed them."""
    return {name: torch.zeros(shape_fn(b, s), dtype=dtype,
                              device=bundle.device)
            for name, (shape_fn, dtype) in bundle.extra_inputs.items()}


def model_inputs(bundle: ModelBundle, tokens: torch.Tensor,
                 positions: torch.Tensor) -> dict:
    """The batch dict of (B, S) ``tokens`` and ``positions``: the positions
    through ``model_positions`` and the bundle's extra inputs as zeros
    (:func:`zero_extras`)."""
    return {"tokens": tokens,
            "positions": model_positions(bundle.cfg, positions),
            **zero_extras(bundle, *tokens.shape)}
