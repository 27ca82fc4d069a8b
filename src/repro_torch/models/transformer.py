"""Decoder-only LM, dense attention stacks (port of
``repro.models.transformer``).

A layer is

    x = x + mixer(norm1(x))     mixer in {attn, local_attn}
    x = x + ffn(norm2(x))       ffn   in {plain MLP, gated MLP}

with the per-layer kind taken from ``cfg.block_pattern`` cycled over depth.
MoE, RG-LRU and RWKV blocks are not ported yet (ROADMAP queue 1 item 12)
and raise ``NotImplementedError``.

* ``forward_train`` — the teacher-forced forward (no loss, no gradient).
* ``prefill`` — the same forward, writing the KV caches; returns every
  position's hidden state (the engine samples at each slot's last prompt
  position).
* ``decode_step`` — one token against the caches.

Layers run in a Python loop (a ``scan_layers`` config included); each
layer's parameters are a dict, and the caches a list of per-layer dicts
whose tensors every call updates in place.  Weights are kept as given
(fp32 from :func:`init_params`) and cast to ``compute_dtype`` at every use,
as the reference casts them: the same values a held bf16 copy would give,
at the cost of the cast's traffic and no second copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from . import attention as attn_mod
from .attention import KVCache
from .layers import (apply_mlp, apply_norm, embed_lookup, init_mlp,
                     init_norm, init_normal, padded_vocab, unembed_logits)

Tensor = torch.Tensor

_NOT_PORTED = "not ported yet (ROADMAP queue 1 item 12)"


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # layer pattern, cycled over depth
    block_pattern: tuple[str, ...] = ("attn",)
    ffn_kind: str = "gated"              # gated | plain
    act: str = "silu"
    norm: str = "rmsnorm"
    # attention details
    qkv_bias: bool = False
    out_bias: bool = False
    mlp_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    window: int | None = None            # sliding window for local_attn
    # embeddings / head
    tie_embeddings: bool = True
    pos_embedding: str = "rope"          # rope | none
    # execution: the reference stacks a homogeneous scan_layers config's
    # parameters (L, ...); the port loops over layers either way and
    # imports the stacked layout (params_from_numpy).
    scan_layers: bool = False
    compute_dtype: Any = torch.bfloat16

    def layer_kinds(self) -> tuple[str, ...]:
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))


def check_supported(cfg: LMConfig) -> None:
    """Raise for the block kinds and options the port does not run."""
    for kind in set(cfg.layer_kinds()):
        if kind not in ("attn", "local_attn"):
            raise NotImplementedError(f"block kind {kind!r} is {_NOT_PORTED}")
    if cfg.ffn_kind not in ("plain", "gated"):
        raise NotImplementedError(
            f"ffn_kind {cfg.ffn_kind!r} is {_NOT_PORTED}")
    if cfg.pos_embedding not in ("rope", "none"):
        raise NotImplementedError(
            f"pos_embedding {cfg.pos_embedding!r} is {_NOT_PORTED}")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _init_layer(cfg: LMConfig, generator: torch.Generator) -> dict:
    dev = generator.device
    spec = attn_mod.attention_spec(
        cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
        qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, out_bias=cfg.out_bias)
    return {"norm1": init_norm(cfg.d_model, cfg.norm, dev),
            "mixer": attn_mod.init_attention(spec, generator),
            "norm2": init_norm(cfg.d_model, cfg.norm, dev),
            "ffn": init_mlp(cfg.d_model, cfg.d_ff, cfg.ffn_kind == "gated",
                            cfg.mlp_bias, generator)}


@torch.inference_mode()
def init_params(cfg: LMConfig, seed: int = 0, device="cuda") -> dict:
    """Random fp32 parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``: normal x 1/sqrt(fan_in) with fan_in the first
    dim of each per-layer shape (the reference ``Spec``'s rule; the
    embedding table at scale 1), norm scales 1, biases 0.  The bits are not
    ``jax.random``'s."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    vp = padded_vocab(cfg.vocab_size)
    params = {"embed": init_normal((vp, cfg.d_model), gen, scale=1.0),
              "final_norm": init_norm(cfg.d_model, cfg.norm, dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = init_normal((vp, cfg.d_model), gen, scale=1.0)
    params["layers"] = [_init_layer(cfg, gen) for _ in range(cfg.num_layers)]
    return params


def _to_tensors(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_tensors(v, dev) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def params_from_numpy(cfg: LMConfig, tree: dict, device="cuda") -> dict:
    """The reference's parameters (its pytree with numpy leaves) as the
    port's dicts on ``device``.  ``tree["layers"]`` is a list of per-layer
    dicts, or, for a ``scan_layers`` homogeneous stack, one dict of (L, ...)
    arrays: each stacked array moves to the device once and every layer
    reads a view of it, not a copy."""
    check_supported(cfg)
    dev = resolve_device(device)
    out = _to_tensors(tree, dev)
    layers = out["layers"]
    if isinstance(layers, dict):
        layers = [_unstack(layers, i) for i in range(cfg.num_layers)]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{len(layers)} layers given for a "
                         f"{cfg.num_layers}-layer config")
    out["layers"] = layers
    return out


def count_params(cfg: LMConfig) -> int:
    """Parameters of :func:`init_params`'s tree."""
    d, f = cfg.d_model, cfg.d_ff
    spec = attn_mod.attention_spec(
        d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
        qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, out_bias=cfg.out_bias)
    norm = d * (1 if cfg.norm == "rmsnorm" else 2)
    mlp = d * f * (3 if cfg.ffn_kind == "gated" else 2)
    if cfg.mlp_bias:
        mlp += f + d
    layer = (2 * norm + mlp
             + sum(int(np.prod(shape)) for shape, _ in spec.values()))
    tables = padded_vocab(cfg.vocab_size) * d * (
        1 if cfg.tie_embeddings else 2)
    return tables + norm + cfg.num_layers * layer


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _apply_mixer(cfg: LMConfig, kind: str, p: dict, x: Tensor, *,
                 positions: Tensor, cache, lengths):
    """Returns (y, cache).  cache None: training (no cache)."""
    window = cfg.window if kind == "local_attn" else None
    q, k, v = attn_mod.qkv_project(
        p, x, positions=positions, rope_theta=cfg.rope_theta,
        use_rope=cfg.pos_embedding == "rope")
    if cache is None:                                       # training
        out = attn_mod.sdpa(q, k, v, causal=True, window=window)
    elif x.shape[1] == 1:                                   # decode step
        cache = _cache_write(cache, k, v, lengths, window)
        if window is not None and cache.k.shape[1] <= window:
            # ring buffer: every filled slot lies inside the window, in
            # permuted order, so the positional window mask must not apply.
            filled = torch.clamp(lengths + 1, max=cache.k.shape[1])
            out = attn_mod.decode_attend(q, cache, filled, window=None)
        else:
            out = attn_mod.decode_attend(q, cache, lengths + 1,
                                         window=window)
    else:                                                   # prefill
        out = attn_mod.sdpa(q, k, v, causal=True, window=window)
        cache = _cache_write(cache, k, v, lengths, window)
    return attn_mod.out_project(p, out), cache


def _cache_write(cache: KVCache, k: Tensor, v: Tensor, lengths: Tensor,
                 window: int | None) -> KVCache:
    """Write new KV in place; a local-attention cache of at most ``window``
    slots is a ring buffer."""
    s_max = cache.k.shape[1]
    s_new = k.shape[1]
    if window is not None and s_max <= window:
        # ring buffer: only the trailing min(s_new, W) steps can survive
        keep = min(s_new, s_max)
        k, v = k[:, -keep:], v[:, -keep:]
        start = lengths.to(k.device, torch.long) + (s_new - keep)
        tgt = (start[:, None]
               + torch.arange(keep, device=k.device)[None, :]) % s_max
        return attn_mod.write_rows(cache, k, v, tgt)
    return attn_mod.cache_update(cache, k, v, lengths)


def _apply_layer(cfg: LMConfig, kind: str, p: dict, x: Tensor, *,
                 positions, cache, lengths):
    """cache: {"mixer": KVCache, "ffn": None} or None."""
    h, new_mx = _apply_mixer(cfg, kind, p["mixer"],
                             apply_norm(p["norm1"], x, cfg.norm),
                             positions=positions,
                             cache=None if cache is None else cache["mixer"],
                             lengths=lengths)
    x = x + h
    x = x + apply_mlp(p["ffn"], apply_norm(p["norm2"], x, cfg.norm),
                      cfg.act)
    return x, None if cache is None else {"mixer": new_mx, "ffn": None}


def embed_inputs(cfg: LMConfig, params: dict, tokens: Tensor) -> Tensor:
    """Token embeddings in ``compute_dtype`` (RoPE enters in attention)."""
    return embed_lookup(params["embed"], tokens, cfg.compute_dtype)


def _positions(positions, like: Tensor) -> Tensor:
    return torch.as_tensor(positions, device=like.device)


# ---------------------------------------------------------------------------
# Full forward passes
# ---------------------------------------------------------------------------

@torch.inference_mode()
def forward_train(cfg: LMConfig, params: dict, tokens: Tensor,
                  positions: Tensor):
    """(B, S) tokens -> (hidden (B, S, D), aux_loss 0.0).  Forward only."""
    check_supported(cfg)
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    positions = _positions(positions, tokens)
    x = embed_inputs(cfg, params, tokens)
    for kind, lp in zip(cfg.layer_kinds(), params["layers"], strict=True):
        x, _ = _apply_layer(cfg, kind, lp, x, positions=positions,
                            cache=None, lengths=None)
    return apply_norm(params["final_norm"], x, cfg.norm), 0.0


@torch.inference_mode()
def logits_fn(cfg: LMConfig, params: dict, hidden: Tensor) -> Tensor:
    """fp32 logits over the real vocab (the padding rows stripped)."""
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed_logits(hidden, table)[..., : cfg.vocab_size]


@torch.inference_mode()
def init_cache(cfg: LMConfig, batch: int, s_max: int, device="cuda"):
    """Per-layer KV caches in ``compute_dtype``: (batch, s_max) slots, or
    min(s_max, window) for a local-attention layer (a ring buffer)."""
    check_supported(cfg)
    dev = resolve_device(device)
    caches = []
    for kind in cfg.layer_kinds():
        size = min(s_max, cfg.window) if kind == "local_attn" else s_max
        caches.append({"mixer": KVCache.zeros(
            batch, size, cfg.num_kv_heads, cfg.head_dim, cfg.compute_dtype,
            dev), "ffn": None})
    return caches


@torch.inference_mode()
def prefill(cfg: LMConfig, params: dict, tokens: Tensor, positions: Tensor,
            caches, lengths: Tensor):
    """Teacher-forced forward that also writes the caches (in place).

    Returns (hidden (B, S, D), caches).  ``lengths``: (B,) valid cache
    entries BEFORE this call (0 for a fresh prefill).
    """
    check_supported(cfg)
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    positions = _positions(positions, tokens)
    lengths = torch.as_tensor(lengths, device=tokens.device)
    x = embed_inputs(cfg, params, tokens)
    new_caches = []
    for kind, lp, cache in zip(cfg.layer_kinds(), params["layers"], caches,
                               strict=True):
        x, nc = _apply_layer(cfg, kind, lp, x, positions=positions,
                             cache=cache, lengths=lengths)
        new_caches.append(nc)
    return apply_norm(params["final_norm"], x, cfg.norm), new_caches


@torch.inference_mode()
def decode_step(cfg: LMConfig, params: dict, token: Tensor,
                positions: Tensor, caches, lengths: Tensor):
    """One decode step.  token (B, 1); lengths (B,) = cache fill before the
    step.  Returns (logits (B, V) fp32, hidden (B, D), caches); the hidden
    state feeds the kNN-LM datastore lookup (serve/knnlm.py)."""
    hidden, new_caches = prefill(cfg, params, token, positions, caches,
                                 lengths)
    hidden = hidden[:, 0]
    return logits_fn(cfg, params, hidden), hidden, new_caches
