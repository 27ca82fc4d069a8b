"""Encoder-decoder transformer: the Whisper backbone with its audio frontend
stubbed (port of ``repro.models.encdec``).

The encoder takes precomputed frame embeddings (B, F, d_model) in place of
the conv1d frontend, adds a fixed sinusoid and runs non-causal
self-attention layers; the decoder adds learned positions to its token
embeddings and runs causal self-attention, cross attention over the
encoder's output, and a plain GeLU MLP.  LayerNorm throughout, MHA (kv
heads = heads), no RoPE.

Self-attention in the encoder and in the decoder's prefill goes through
``attention.sdpa`` (kernel #10; looked up on the module at every call);
the decoder's decode step attends its cache with the plain
``decode_attend``, and cross attention is the plain ``sdpa_dense``, as
the reference computes it outside any kernel.  Each decoder layer's cache
is {"self": KVCache (B, s_max, KH, D), "cross": KVCache (B, F, KH, D)}:
the prefill writes both in place, the cross cache from the encoder's
output, and a decode step reads the cross cache as it stands.  Weights
are fp32, cast to ``compute_dtype`` at every use (models/transformer.py).

``forward_autograd`` is the training forward: the same layers building
the autograd graph, each encoder and decoder block under a reentrant
checkpoint (the reference ``jax.checkpoint``s each block; its configs
all remat), self-attention through ``attention.sdpa_train`` (the
reference's dispatch at ``dense_attn_threshold``; never #10, which has
no backward pass), cross attention through the plain ``sdpa_dense``, no
cache.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..device import resolve_device
from ..dist.sharding import constrain
from . import attention as attn_mod
from .attention import KVCache
from .layers import (Spec, apply_mlp, apply_norm, axes_tree, embed_lookup,
                     embed_spec, init_mlp, init_norm, init_normal, init_spec,
                     mlp_spec, norm_spec, padded_vocab, sinusoidal_positions,
                     spec_size, struct_tree, unembed_logits)
from .transformer import _to_tensors, remat_call

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    encoder_layers: int
    decoder_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    num_frames: int = 1500            # encoder sequence length (stub output)
    act: str = "gelu"
    norm: str = "layernorm"
    max_position: int = 1 << 16       # rows of the decoder's position table
    compute_dtype: Any = torch.bfloat16
    # training: the reference's attention dispatch (dense logits up to
    # this length squared)
    dense_attn_threshold: int = 2048

    @property
    def num_layers(self) -> int:
        return self.encoder_layers + self.decoder_layers


def _attn_spec(cfg: EncDecConfig) -> dict:
    return attn_mod.attention_spec(cfg.d_model, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.head_dim,
                                   qkv_bias=True, out_bias=True)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_params(cfg: EncDecConfig, seed: int = 0, device="cuda") -> dict:
    """Random fp32 parameters from a ``torch.Generator`` seeded with
    ``seed`` on ``device``, by the reference's specs: normal x
    1/sqrt(fan_in), the embedding table x 1, the decoder's position table
    x 0.02; norm scales 1, biases 0; ordinary tensors (not inference
    tensors), so a training state can ask for their gradients.  The bits
    are not ``jax.random``'s."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model

    def mlp():
        return init_mlp(d, cfg.d_ff, False, True, gen)

    def enc_layer():
        return {"norm1": init_norm(d, cfg.norm, dev),
                "attn": init_spec(_attn_spec(cfg), gen),
                "norm2": init_norm(d, cfg.norm, dev), "mlp": mlp()}

    def dec_layer():
        return {"norm1": init_norm(d, cfg.norm, dev),
                "self_attn": init_spec(_attn_spec(cfg), gen),
                "norm_x": init_norm(d, cfg.norm, dev),
                "cross_attn": init_spec(_attn_spec(cfg), gen),
                "norm2": init_norm(d, cfg.norm, dev), "mlp": mlp()}

    return {
        "embed": init_normal((padded_vocab(cfg.vocab_size), d), gen,
                             scale=1.0),
        "dec_pos": init_normal((cfg.max_position, d), gen, scale=0.02),
        "encoder": [enc_layer() for _ in range(cfg.encoder_layers)],
        "enc_final_norm": init_norm(d, cfg.norm, dev),
        "decoder": [dec_layer() for _ in range(cfg.decoder_layers)],
        "dec_final_norm": init_norm(d, cfg.norm, dev),
    }


def param_specs(cfg: EncDecConfig) -> dict:
    """The tree :func:`init_params` draws, as ``layers.Spec`` leaves (the
    reference's specs)."""
    d = cfg.d_model

    def mlp():
        return mlp_spec(d, cfg.d_ff, False, True)

    def enc_layer():
        return {"norm1": norm_spec(d, cfg.norm), "attn": _attn_spec(cfg),
                "norm2": norm_spec(d, cfg.norm), "mlp": mlp()}

    def dec_layer():
        return {"norm1": norm_spec(d, cfg.norm),
                "self_attn": _attn_spec(cfg),
                "norm_x": norm_spec(d, cfg.norm),
                "cross_attn": _attn_spec(cfg),
                "norm2": norm_spec(d, cfg.norm), "mlp": mlp()}

    return {
        "embed": embed_spec(cfg.vocab_size, d),
        "dec_pos": Spec((cfg.max_position, d), (None, "fsdp"), scale=0.02),
        "encoder": [enc_layer() for _ in range(cfg.encoder_layers)],
        "enc_final_norm": norm_spec(d, cfg.norm),
        "decoder": [dec_layer() for _ in range(cfg.decoder_layers)],
        "dec_final_norm": norm_spec(d, cfg.norm),
    }


def param_axes(cfg: EncDecConfig) -> dict:
    """Each parameter's logical axes, in :func:`init_params`'s tree."""
    return axes_tree(param_specs(cfg))


def param_structs(cfg: EncDecConfig) -> dict:
    """Each parameter as an fp32 ``meta`` tensor, in :func:`init_params`'s
    tree."""
    return struct_tree(param_specs(cfg))


def params_from_numpy(cfg: EncDecConfig, tree: dict, device="cuda") -> dict:
    """The reference's parameters (its pytree with numpy leaves) as the
    port's dicts on ``device``."""
    out = _to_tensors(tree, resolve_device(device))
    for part, n in (("encoder", cfg.encoder_layers),
                    ("decoder", cfg.decoder_layers)):
        if len(out[part]) != n:
            raise ValueError(f"{len(out[part])} {part} layers given for a "
                             f"config of {n}")
    return out


def count_params(cfg: EncDecConfig) -> int:
    """Parameters of :func:`init_params`'s tree."""
    return spec_size(param_specs(cfg))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _self_attention(cfg: EncDecConfig, p: dict, x: Tensor, causal: bool,
                    cache: KVCache | None = None, lengths=None,
                    decode: bool = False, autograd: bool = False):
    """Returns (y, cache).  ``decode``: one token against the cache (plain
    ``decode_attend``); ``autograd`` (training): the differentiable
    ``sdpa_train`` at ``cfg.dense_attn_threshold``, no cache; else
    ``sdpa`` over x, and the cache, where given, written at
    ``lengths``."""
    q, k, v = attn_mod.qkv_project(p, x, positions=None, rope_theta=1e4,
                                   use_rope=False)
    if decode:
        cache = attn_mod.cache_update(cache, k, v, lengths)
        out = attn_mod.decode_attend(q, cache, lengths + 1)
    elif autograd:
        out = attn_mod.sdpa_train(q, k, v, causal=causal,
                                  dense_threshold=cfg.dense_attn_threshold)
    else:
        out = attn_mod.sdpa(q, k, v, causal=causal)
        if cache is not None:
            cache = attn_mod.cache_update(cache, k, v, lengths)
    return attn_mod.out_project(p, out), cache


def _cross_attention(p: dict, x: Tensor, enc_out: Tensor | None = None,
                     cache: KVCache | None = None):
    """Cross attention, its keys and values from ``enc_out`` (written into
    ``cache`` in place where one is given) or, without ``enc_out``, from
    the cache as it stands.  Returns (y, cache)."""
    dt = x.dtype
    q = attn_mod._project(x, p["wq"]) + p["bq"].to(dt)
    if enc_out is not None:
        k = attn_mod._project(enc_out, p["wk"]) + p["bk"].to(dt)
        v = attn_mod._project(enc_out, p["wv"]) + p["bv"].to(dt)
        if cache is not None:
            cache.k.copy_(k)
            cache.v.copy_(v)
    else:
        k, v = cache.k.to(dt), cache.v.to(dt)
    out = attn_mod.sdpa_dense(q, k, v, causal=False)
    return attn_mod.out_project(p, out), cache


def _decoder_layer(cfg: EncDecConfig, lp: dict, x: Tensor, enc_out,
                   self_cache, cross_cache, lengths, decode: bool = False,
                   autograd: bool = False):
    h, self_cache = _self_attention(cfg, lp["self_attn"],
                                    apply_norm(lp["norm1"], x, cfg.norm),
                                    causal=True, cache=self_cache,
                                    lengths=lengths, decode=decode,
                                    autograd=autograd)
    x = x + h
    h, cross_cache = _cross_attention(lp["cross_attn"],
                                      apply_norm(lp["norm_x"], x, cfg.norm),
                                      enc_out=enc_out, cache=cross_cache)
    x = x + h
    x = x + apply_mlp(lp["mlp"], apply_norm(lp["norm2"], x, cfg.norm),
                      cfg.act)
    return x, self_cache, cross_cache


def _encoder_block(cfg: EncDecConfig, lp: dict, x: Tensor,
                   autograd: bool = False) -> Tensor:
    h, _ = _self_attention(cfg, lp["attn"],
                           apply_norm(lp["norm1"], x, cfg.norm),
                           causal=False, autograd=autograd)
    x = x + h
    return x + apply_mlp(lp["mlp"], apply_norm(lp["norm2"], x, cfg.norm),
                         cfg.act)


def _encode(cfg: EncDecConfig, params: dict, frames: Tensor,
            autograd: bool = False) -> Tensor:
    dt = cfg.compute_dtype
    frames = torch.as_tensor(frames, device=params["embed"].device)
    x = frames.to(dt) + sinusoidal_positions(
        frames.shape[1], cfg.d_model, frames.device).to(dt)[None]
    x = constrain(x, ("batch", "seq", "embed"))
    if autograd:
        # a reentrant checkpoint sends gradients back only where one of its
        # tensor inputs asks for them: the first block's input must
        x.requires_grad_(True)
    for lp in params["encoder"]:
        x = remat_call(autograd, _encoder_block, cfg, lp, x, autograd)
        x = constrain(x, ("batch", "seq", "embed"))
    return apply_norm(params["enc_final_norm"], x, cfg.norm)


@torch.inference_mode()
def encode(cfg: EncDecConfig, params: dict, frames: Tensor) -> Tensor:
    """frames (B, F, d_model), the stubbed frontend's output -> (B, F, D):
    frames and the sinusoid each cast to ``compute_dtype`` and added, then
    the non-causal layers and the final norm."""
    return _encode(cfg, params, frames)


def _embed(cfg: EncDecConfig, params: dict, tokens, positions) -> Tensor:
    """Token embeddings plus the learned positions (component 0 of (B, S,
    3) positions), in ``compute_dtype``, on the parameters' device."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    pos = torch.as_tensor(positions, device=dev)
    if pos.ndim == 3:
        pos = pos[..., 0]
    dt = cfg.compute_dtype
    return (embed_lookup(params["embed"], tokens, dt)
            + params["dec_pos"][pos.long()].to(dt))


# ---------------------------------------------------------------------------
# Full passes
# ---------------------------------------------------------------------------

@torch.inference_mode()
def forward_train(cfg: EncDecConfig, params: dict, tokens: Tensor,
                  positions: Tensor, frames: Tensor):
    """The teacher-forced decoder over the encoded frames -> (hidden (B, S,
    D), 0.0).  Forward only."""
    enc_out = encode(cfg, params, frames)
    x = _embed(cfg, params, tokens, positions)
    for lp in params["decoder"]:
        x, _, _ = _decoder_layer(cfg, lp, x, enc_out, None, None, None)
    return apply_norm(params["dec_final_norm"], x, cfg.norm), 0.0


def _train_decoder_block(cfg: EncDecConfig, lp: dict, x: Tensor,
                         enc_out: Tensor) -> Tensor:
    return _decoder_layer(cfg, lp, x, enc_out, None, None, None,
                          autograd=True)[0]


def forward_autograd(cfg: EncDecConfig, params: dict, tokens: Tensor,
                     positions: Tensor, frames: Tensor):
    """The training forward: the encoder over ``frames`` and the
    teacher-forced decoder -> (hidden (B, S, D), 0.0), building the
    autograd graph (the module docstring has its dispatch and remat)."""
    enc_out = _encode(cfg, params, frames, autograd=True)
    x = constrain(_embed(cfg, params, tokens, positions),
                  ("batch", "seq", "embed"))
    for lp in params["decoder"]:
        x = remat_call(True, _train_decoder_block, cfg, lp, x, enc_out)
        x = constrain(x, ("batch", "seq", "embed"))
    return apply_norm(params["dec_final_norm"], x, cfg.norm), 0.0


@torch.inference_mode()
def logits_fn(cfg: EncDecConfig, params: dict, hidden: Tensor) -> Tensor:
    """fp32 logits over the real vocab, through the (tied) embedding."""
    return unembed_logits(hidden, params["embed"])[..., : cfg.vocab_size]


@torch.inference_mode()
def init_cache(cfg: EncDecConfig, batch: int, s_max: int, device="cuda"):
    """Per decoder layer {"self": KVCache (batch, s_max), "cross": KVCache
    (batch, num_frames)}, zeros in ``compute_dtype``."""
    dev = resolve_device(device)
    dt = cfg.compute_dtype
    return [{"self": KVCache.zeros(batch, s_max, cfg.num_kv_heads,
                                   cfg.head_dim, dt, dev),
             "cross": KVCache.zeros(batch, cfg.num_frames, cfg.num_kv_heads,
                                    cfg.head_dim, dt, dev)}
            for _ in range(cfg.decoder_layers)]


@torch.inference_mode()
def prefill(cfg: EncDecConfig, params: dict, tokens: Tensor,
            positions: Tensor, caches, lengths: Tensor, frames: Tensor):
    """Encode, then the teacher-forced decoder, writing each layer's self
    cache at ``lengths`` (B,) and its cross cache from the encoder's output
    (both in place).  Returns (hidden (B, S, D), caches)."""
    enc_out = encode(cfg, params, frames)
    x = _embed(cfg, params, tokens, positions)
    lengths = torch.as_tensor(lengths, device=x.device)
    new_caches = []
    for lp, cache in zip(params["decoder"], caches, strict=True):
        x, new_self, new_cross = _decoder_layer(
            cfg, lp, x, enc_out, cache["self"], cache["cross"], lengths)
        new_caches.append({"self": new_self, "cross": new_cross})
    return apply_norm(params["dec_final_norm"], x, cfg.norm), new_caches


@torch.inference_mode()
def decode_step(cfg: EncDecConfig, params: dict, token: Tensor,
                positions: Tensor, caches, lengths: Tensor):
    """One decode step.  token (B, 1); lengths (B,) = self-cache fill
    before the step.  Returns (logits (B, V) fp32, hidden (B, D), caches)."""
    x = _embed(cfg, params, token, positions)
    lengths = torch.as_tensor(lengths, device=x.device)
    new_caches = []
    for lp, cache in zip(params["decoder"], caches, strict=True):
        x, new_self, new_cross = _decoder_layer(
            cfg, lp, x, None, cache["self"], cache["cross"], lengths,
            decode=True)
        new_caches.append({"self": new_self, "cross": new_cross})
    hidden = apply_norm(params["dec_final_norm"], x, cfg.norm)[:, 0]
    return logits_fn(cfg, params, hidden), hidden, new_caches
