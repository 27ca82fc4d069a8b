"""Decoder-only LM: dense, MoE, hybrid (RG-LRU) and RWKV stacks (port of
``repro.models.transformer``).

A layer is

    x = x + mixer(norm1(x))     mixer in {attn, local_attn, rglru, rwkv}
    x = x + ffn(norm2(x))       ffn   in {plain MLP, gated MLP, MoE,
                                          rwkv_channel}

with the per-layer kind taken from ``cfg.block_pattern`` cycled over depth.
Positions enter as RoPE (M-RoPE with ``mrope_section``: (B, S, 3)
positions), as a learned table added to the embeddings, or not at all.  A
VLM config (``num_patch_tokens`` > 0) takes ``patch_embeds`` (B, P, D) in
place of the first P tokens' embeddings in ``forward_train`` and
``prefill``: the stub of its vision frontend, as in the reference.

* ``forward_train`` — the teacher-forced forward (no loss, no gradient;
  attention through kernel #10); returns the MoE layers' summed aux loss
  beside the hidden states.  The datastore build and the forward timings
  call it.
* ``forward_autograd`` — the training forward: the same layers, building
  the autograd graph, attention through ``attention.sdpa_train`` (the
  reference's differentiable dispatch; #10 has no backward pass), each
  layer under ``torch.utils.checkpoint`` when ``cfg.remat`` is on (the
  reference's default remat policy "nothing"); returns the MoE layers'
  summed aux loss, which keeps its gradient.  Every layer kind, FFN and
  position embedding trains, a VLM's patch stub included.
* ``prefill`` — the same forward, writing the caches; returns every
  position's hidden state (the engine samples at each slot's last prompt
  position).
* ``decode_step`` — one token against the caches.

Layers run in a Python loop (a ``scan_layers`` config included); each
layer's parameters are a dict, and the caches a list of per-layer dicts
{"mixer": ..., "ffn": ...}: a ``KVCache`` that every call updates in
place, or a recurrent state dict ({"h", "conv"} for RG-LRU, {"shift",
"wkv"} for RWKV's time mix, {"shift"} for its channel mix) that every
call replaces.  Weights are kept as given
(fp32 from :func:`init_params`) and cast to ``compute_dtype`` at every use,
as the reference casts them: the same values a held bf16 copy would give,
at the cost of the cast's traffic and no second copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..dist.sharding import constrain
from . import attention as attn_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import rwkv as rwkv_mod
from .attention import KVCache
from .layers import (Spec, apply_mlp, apply_norm, axes_tree, embed_lookup,
                     embed_spec, init_mlp, init_norm, init_normal, init_spec,
                     mlp_spec, norm_spec, padded_vocab, spec_size,
                     struct_tree, unembed_logits)

Tensor = torch.Tensor

_MIXERS = ("attn", "local_attn", "rglru", "rwkv")
_FFNS = ("plain", "gated", "moe", "rwkv_channel")
_POSITIONS = ("rope", "learned", "none")


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
    ffn_kind: str = "gated"              # gated | plain | moe | rwkv_channel
    act: str = "silu"
    norm: str = "rmsnorm"
    # attention details
    qkv_bias: bool = False
    out_bias: bool = False
    mlp_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    mrope_section: tuple[int, ...] | None = None
    window: int | None = None            # sliding window for local_attn
    # MoE
    moe: moe_mod.MoEConfig | None = None
    moe_d_ff: int = 0
    shared_expert_ff: int = 0
    # recurrent widths
    lru_width: int = 0
    conv_width: int = 4
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 128
    # embeddings / head
    tie_embeddings: bool = True
    pos_embedding: str = "rope"          # rope | learned | none
    max_position: int = 1 << 20          # rows of the learned table
    # multimodal stub
    num_patch_tokens: int = 0            # vlm: first P positions are patches
    # execution: the reference stacks a homogeneous scan_layers config's
    # parameters (L, ...); the port loops over layers either way and
    # imports the stacked layout (params_from_numpy).
    scan_layers: bool = False
    # training: per-layer remat (the reference's policy "nothing" is the
    # one ported) and the reference's attention dispatch sizes
    remat: bool = True
    remat_policy: str = "nothing"
    compute_dtype: Any = torch.bfloat16
    q_chunk: int = 512
    kv_chunk: int = 1024
    dense_attn_threshold: int = 2048

    def layer_kinds(self) -> tuple[str, ...]:
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))


def check_supported(cfg: LMConfig) -> None:
    """Raise ``ValueError`` for a block kind or option that does not
    exist (the reference raises on them too)."""
    for kind in set(cfg.layer_kinds()):
        if kind not in _MIXERS:
            raise ValueError(f"unknown block kind {kind!r}")
    if cfg.ffn_kind not in _FFNS:
        raise ValueError(f"unknown ffn_kind {cfg.ffn_kind!r}")
    if cfg.ffn_kind == "moe" and cfg.moe is None:
        raise ValueError("ffn_kind='moe' needs an MoEConfig (cfg.moe)")
    if cfg.pos_embedding not in _POSITIONS:
        raise ValueError(f"unknown pos_embedding {cfg.pos_embedding!r}")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _mixer_spec(cfg: LMConfig, kind: str) -> dict:
    """The mixer's parameters, name -> (shape, init[, scale])."""
    if kind == "rglru":
        return rglru_mod.rglru_spec(cfg.d_model, cfg.lru_width,
                                    cfg.conv_width)
    if kind == "rwkv":
        return rwkv_mod.rwkv_time_spec(cfg.d_model, cfg.rwkv_head_dim)
    return attn_mod.attention_spec(
        cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
        qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, out_bias=cfg.out_bias)


def _ffn_spec(cfg: LMConfig) -> dict:
    if cfg.ffn_kind == "moe":
        spec = moe_mod.moe_spec(cfg.d_model, cfg.moe_d_ff,
                                cfg.moe.num_experts)
        if cfg.shared_expert_ff:
            spec["shared"] = mlp_spec(cfg.d_model, cfg.shared_expert_ff,
                                      True, False)
        return spec
    if cfg.ffn_kind == "rwkv_channel":
        return rwkv_mod.rwkv_channel_spec(cfg.d_model, cfg.d_ff)
    return mlp_spec(cfg.d_model, cfg.d_ff, cfg.ffn_kind == "gated",
                    cfg.mlp_bias)


def param_specs(cfg: LMConfig) -> dict:
    """The tree :func:`init_params` draws, as ``layers.Spec`` leaves: per
    layer, with no ``layers`` axis (a ``scan_layers`` config too)."""
    check_supported(cfg)
    spec: dict = {"embed": embed_spec(cfg.vocab_size, cfg.d_model),
                  "final_norm": norm_spec(cfg.d_model, cfg.norm)}
    if not cfg.tie_embeddings:
        spec["unembed"] = embed_spec(cfg.vocab_size, cfg.d_model)
    if cfg.pos_embedding == "learned":
        spec["pos_embed"] = Spec((cfg.max_position, cfg.d_model),
                                 (None, "fsdp"), scale=0.02)
    spec["layers"] = [{"norm1": norm_spec(cfg.d_model, cfg.norm),
                       "mixer": _mixer_spec(cfg, kind),
                       "norm2": norm_spec(cfg.d_model, cfg.norm),
                       "ffn": _ffn_spec(cfg)}
                      for kind in cfg.layer_kinds()]
    return spec


def param_axes(cfg: LMConfig) -> dict:
    """Each parameter's logical axes, in :func:`init_params`'s tree."""
    return axes_tree(param_specs(cfg))


def param_structs(cfg: LMConfig) -> dict:
    """Each parameter as an fp32 ``meta`` tensor, in :func:`init_params`'s
    tree (nothing is allocated)."""
    return struct_tree(param_specs(cfg))


def _init_layer(cfg: LMConfig, kind: str, generator: torch.Generator
                ) -> dict:
    dev = generator.device
    mixer = init_spec(_mixer_spec(cfg, kind), generator)
    if cfg.ffn_kind == "rwkv_channel":
        ffn = init_spec(rwkv_mod.rwkv_channel_spec(cfg.d_model, cfg.d_ff),
                        generator)
    elif cfg.ffn_kind == "moe":
        ffn = init_spec(moe_mod.moe_spec(cfg.d_model, cfg.moe_d_ff,
                                         cfg.moe.num_experts), generator)
        if cfg.shared_expert_ff:
            ffn["shared"] = init_mlp(cfg.d_model, cfg.shared_expert_ff,
                                     True, False, generator)
    else:
        ffn = init_mlp(cfg.d_model, cfg.d_ff, cfg.ffn_kind == "gated",
                       cfg.mlp_bias, generator)
    return {"norm1": init_norm(cfg.d_model, cfg.norm, dev), "mixer": mixer,
            "norm2": init_norm(cfg.d_model, cfg.norm, dev), "ffn": ffn}


@torch.no_grad()
def init_params(cfg: LMConfig, seed: int = 0, device="cuda") -> dict:
    """Random fp32 parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``, as ordinary tensors (not inference tensors, so
    a training state can ask for their gradients): normal x
    1/sqrt(fan_in) with fan_in the first
    dim of each per-layer shape (the reference ``Spec``'s rule; an expert
    stack's fan-in is each expert's own first dim), or x the
    spec's own scale where it gives one (the embedding table 1, RG-LRU's
    conv 0.3, RWKV's LoRAs 0.01, the learned position table 0.02); norm
    scales 1, biases 0.  The bits are not ``jax.random``'s."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    vp = padded_vocab(cfg.vocab_size)
    params = {"embed": init_normal((vp, cfg.d_model), gen, scale=1.0),
              "final_norm": init_norm(cfg.d_model, cfg.norm, dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = init_normal((vp, cfg.d_model), gen, scale=1.0)
    if cfg.pos_embedding == "learned":
        params["pos_embed"] = init_normal((cfg.max_position, cfg.d_model),
                                          gen, scale=0.02)
    params["layers"] = [_init_layer(cfg, kind, gen)
                        for kind in cfg.layer_kinds()]
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
    return spec_size(param_specs(cfg))


def active_params(cfg: LMConfig) -> int:
    """Parameters touched per token (MoE: the top-k experts only)."""
    total = count_params(cfg)
    if cfg.ffn_kind != "moe":
        return total
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    return total - cfg.num_layers * (e - k) * cfg.d_model * cfg.moe_d_ff * 3


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _apply_mixer(cfg: LMConfig, kind: str, p: dict, x: Tensor, *,
                 positions: Tensor, cache, lengths, autograd: bool = False):
    """Returns (y, cache).  cache None: the teacher-forced forward (no
    cache), attending through #10, or with ``autograd`` through the
    reference's differentiable dispatch."""
    if kind == "rglru":
        return rglru_mod.apply_rglru_block(p, x, cache)
    if kind == "rwkv":
        return rwkv_mod.apply_rwkv_time(p, x, cfg.rwkv_head_dim, cache,
                                        chunk=cfg.rwkv_chunk)
    window = cfg.window if kind == "local_attn" else None
    q, k, v = attn_mod.qkv_project(
        p, x, positions=positions, rope_theta=cfg.rope_theta,
        mrope_section=cfg.mrope_section,
        use_rope=cfg.pos_embedding == "rope")
    if cache is None and autograd:                          # training
        out = attn_mod.sdpa_train(
            q, k, v, causal=True, window=window,
            dense_threshold=cfg.dense_attn_threshold, q_chunk=cfg.q_chunk,
            kv_chunk=cfg.kv_chunk)
    elif cache is None:                                     # forward
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
                 positions, cache, lengths, autograd: bool = False):
    """Returns (x, aux loss, cache).  cache: {"mixer": KVCache or state
    dict, "ffn": state dict or None} or None."""
    h, new_mx = _apply_mixer(cfg, kind, p["mixer"],
                             apply_norm(p["norm1"], x, cfg.norm),
                             positions=positions,
                             cache=None if cache is None else cache["mixer"],
                             lengths=lengths, autograd=autograd)
    x = x + h
    new_ffn, aux = None, 0.0
    hn = apply_norm(p["norm2"], x, cfg.norm)
    if cfg.ffn_kind == "rwkv_channel":
        h, new_ffn = rwkv_mod.apply_rwkv_channel(
            p["ffn"], hn, None if cache is None else cache["ffn"])
    elif cfg.ffn_kind == "moe":
        h, aux = moe_mod.apply_moe(p["ffn"], hn, cfg.moe, act=cfg.act,
                                   shared_mlp=p["ffn"].get("shared"))
    else:
        h = apply_mlp(p["ffn"], hn, cfg.act)
    x = x + h
    return x, aux, (None if cache is None
                    else {"mixer": new_mx, "ffn": new_ffn})


def embed_inputs(cfg: LMConfig, params: dict, tokens: Tensor,
                 positions: Tensor, patch_embeds: Tensor | None = None,
                 autograd: bool = False) -> Tensor:
    """Token embeddings in ``compute_dtype``; a VLM's first P positions
    take ``patch_embeds`` (B, P, D) instead (the reference's stub: written
    in place, or with ``autograd`` joined out of place, the same values);
    a learned position table's rows added (component 0 of (B, S, 3)
    positions).  RoPE enters in attention.  A sequence shorter than the
    patches raises ``ValueError``, where the reference's write of the
    patches fails."""
    dt = cfg.compute_dtype
    x = embed_lookup(params["embed"], tokens, dt)
    if cfg.num_patch_tokens and patch_embeds is not None:
        p = patch_embeds.shape[1]
        if p > tokens.shape[1]:
            raise ValueError(f"{p} patch embeddings for a sequence of "
                             f"{tokens.shape[1]} tokens")
        pe = torch.as_tensor(patch_embeds, device=x.device).to(dt)
        if autograd:
            x = torch.cat([pe, x[:, p:]], dim=1)
        else:
            x[:, :p] = pe
    if cfg.pos_embedding == "learned":
        pos = positions if positions.ndim == 2 else positions[..., 0]
        x = x + params["pos_embed"][pos.long()].to(dt)
    return x


def _positions(positions, like: Tensor) -> Tensor:
    return torch.as_tensor(positions, device=like.device)


# ---------------------------------------------------------------------------
# Full forward passes
# ---------------------------------------------------------------------------

@torch.inference_mode()
def forward_train(cfg: LMConfig, params: dict, tokens: Tensor,
                  positions: Tensor, patch_embeds: Tensor | None = None):
    """(B, S) tokens -> (hidden (B, S, D), aux loss: the MoE layers' sum,
    0.0 without MoE).  Forward only."""
    check_supported(cfg)
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    positions = _positions(positions, tokens)
    x = embed_inputs(cfg, params, tokens, positions, patch_embeds)
    aux = 0.0
    for kind, lp in zip(cfg.layer_kinds(), params["layers"], strict=True):
        x, a, _ = _apply_layer(cfg, kind, lp, x, positions=positions,
                               cache=None, lengths=None)
        aux = aux + a
    return apply_norm(params["final_norm"], x, cfg.norm), aux


def check_trainable(cfg: LMConfig) -> None:
    """Raise ``ValueError`` unless ``forward_autograd`` trains ``cfg``:
    every config :func:`check_supported` accepts, with the remat policy
    "nothing" (the reference configs' policy; "dots" and "dots_no_batch"
    are not ported)."""
    check_supported(cfg)
    if cfg.remat_policy != "nothing":
        raise ValueError(
            f"remat_policy {cfg.remat_policy!r} is not ported (only "
            "\"nothing\", the reference configs' policy)")


def remat_call(enabled: bool, fn, *args):
    """``fn(*args)``, under a reentrant ``torch.utils.checkpoint`` when
    ``enabled``: the forward builds no graph (the tiles and chunks inside
    run plain) and the backward makes ``fn``'s graph again, so only the
    inputs are kept (the reference's remat policy "nothing").  ``fn``
    draws no random numbers.  Call ``backward()`` on a loss through it (a
    reentrant checkpoint refuses ``torch.autograd.grad``)."""
    if not enabled:
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=True,
                      preserve_rng_state=False)


def _train_layer(cfg: LMConfig, kind: str, p: dict, x: Tensor,
                 positions: Tensor):
    x, aux, _ = _apply_layer(cfg, kind, p, x, positions=positions,
                             cache=None, lengths=None, autograd=True)
    return x, aux


def forward_autograd(cfg: LMConfig, params: dict, tokens: Tensor,
                     positions: Tensor, patch_embeds: Tensor | None = None):
    """The training forward: (B, S) tokens -> (hidden (B, S, D), aux loss:
    the MoE layers' sum, 0.0 without MoE), building the autograd graph.
    Attention runs through ``attention.sdpa_train``, never #10; with
    ``cfg.remat`` each layer runs under :func:`remat_call`, so the
    backward pass keeps only each layer's input and makes the rest again
    (the aux loss leaves the checkpoint beside the hidden state, with its
    gradient).  Raises ``ValueError`` for a remat policy that is not
    ported (:func:`check_trainable`)."""
    check_trainable(cfg)
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    positions = _positions(positions, tokens)
    x = embed_inputs(cfg, params, tokens, positions, patch_embeds,
                     autograd=True)
    x = constrain(x, ("batch", "seq", "embed"))
    aux = 0.0
    for kind, lp in zip(cfg.layer_kinds(), params["layers"], strict=True):
        x, a = remat_call(cfg.remat, _train_layer, cfg, kind, lp, x,
                          positions)
        x = constrain(x, ("batch", "seq", "embed"))
        aux = aux + a
    return apply_norm(params["final_norm"], x, cfg.norm), aux


@torch.inference_mode()
def logits_fn(cfg: LMConfig, params: dict, hidden: Tensor) -> Tensor:
    """fp32 logits over the real vocab (the padding rows stripped)."""
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed_logits(hidden, table)[..., : cfg.vocab_size]


def _one_layer_cache(cfg: LMConfig, kind: str, batch: int, s_max: int,
                     dev: torch.device) -> dict:
    dt = cfg.compute_dtype
    if kind == "rwkv":
        st = rwkv_mod.rwkv_state_zeros(batch, cfg.d_model, cfg.rwkv_head_dim,
                                       dt, dev)
        return {"mixer": st["time"], "ffn": st["channel"]}
    if kind == "rglru":
        mx = rglru_mod.rglru_state_zeros(batch, cfg.lru_width,
                                         cfg.conv_width, dt, dev)
    else:
        size = min(s_max, cfg.window) if kind == "local_attn" else s_max
        mx = KVCache.zeros(batch, size, cfg.num_kv_heads, cfg.head_dim, dt,
                           dev)
    ffn = ({"shift": torch.zeros((batch, cfg.d_model), dtype=dt,
                                 device=dev)}
           if cfg.ffn_kind == "rwkv_channel" else None)
    return {"mixer": mx, "ffn": ffn}


@torch.inference_mode()
def init_cache(cfg: LMConfig, batch: int, s_max: int, device="cuda"):
    """Per-layer caches in ``compute_dtype``: KV caches of (batch, s_max)
    slots, or min(s_max, window) for a local-attention layer (a ring
    buffer); zero recurrent states (RG-LRU's ``h`` and RWKV's ``wkv`` in
    fp32)."""
    check_supported(cfg)
    dev = resolve_device(device)
    return [_one_layer_cache(cfg, kind, batch, s_max, dev)
            for kind in cfg.layer_kinds()]


@torch.inference_mode()
def prefill(cfg: LMConfig, params: dict, tokens: Tensor, positions: Tensor,
            caches, lengths: Tensor, patch_embeds: Tensor | None = None):
    """Teacher-forced forward that also writes the caches (in place).

    Returns (hidden (B, S, D), caches).  ``lengths``: (B,) valid cache
    entries BEFORE this call (0 for a fresh prefill).
    """
    check_supported(cfg)
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    positions = _positions(positions, tokens)
    lengths = torch.as_tensor(lengths, device=tokens.device)
    x = embed_inputs(cfg, params, tokens, positions, patch_embeds)
    new_caches = []
    for kind, lp, cache in zip(cfg.layer_kinds(), params["layers"], caches,
                               strict=True):
        x, _, nc = _apply_layer(cfg, kind, lp, x, positions=positions,
                                cache=cache, lengths=lengths)
        new_caches.append(nc)
    return apply_norm(params["final_norm"], x, cfg.norm), new_caches


@torch.inference_mode()
def decode_step(cfg: LMConfig, params: dict, token: Tensor,
                positions: Tensor, caches, lengths: Tensor):
    """One decode step.  token (B, 1); positions (B, 1), or (B, 1, 3) under
    M-RoPE; lengths (B,) = cache fill before the step.  Returns (logits
    (B, V) fp32, hidden (B, D), caches); the hidden state feeds the kNN-LM
    datastore lookup (serve/knnlm.py)."""
    hidden, new_caches = prefill(cfg, params, token, positions, caches,
                                 lengths)
    hidden = hidden[:, 0]
    return logits_fn(cfg, params, hidden), hidden, new_caches
