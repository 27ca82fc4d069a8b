"""GQA attention: projections, SDPA through kernel #10, KV-cache decode
(port of ``repro.models.attention``).

Layout: activations (B, S, H, D).  ``sdpa`` hands q, k and v to
``kernels.ops.flash_attention`` as (B, H, S, D) views of that layout: on the
card the flash-attention kernel reads them through their strides, so no
transposed copy is made; on the CPU the plain version runs.  The reference
dispatches between a dense and a chunked jnp version instead (its docstring
names the Pallas kernel, its code never calls it); the kernel takes every
shape, so the port has one path.  ``decode_attend`` stays plain torch, as
in the reference: one query a slot against the cache, with each slot's own
valid length, which the kernel has no operand for; so does
``sdpa_dense``, the encoder-decoder's cross attention, which the reference
computes with its own ``sdpa_dense``.  The reference's
sharding constraints are dropped: the port runs on one device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops as kernel_ops
from .layers import apply_rope, rms_norm

Tensor = torch.Tensor

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def attention_spec(d: int, heads: int, kv_heads: int, head_dim: int,
                   qkv_bias: bool = False, qk_norm: bool = False,
                   out_bias: bool = False) -> dict:
    """Parameter name -> (shape, init) with init "normal", "zeros" or
    "ones"; the reference's shapes."""
    spec = {
        "wq": ((d, heads, head_dim), "normal"),
        "wk": ((d, kv_heads, head_dim), "normal"),
        "wv": ((d, kv_heads, head_dim), "normal"),
        "wo": ((heads, head_dim, d), "normal"),
    }
    if qkv_bias:
        spec["bq"] = ((heads, head_dim), "zeros")
        spec["bk"] = ((kv_heads, head_dim), "zeros")
        spec["bv"] = ((kv_heads, head_dim), "zeros")
    if out_bias:
        spec["bo"] = ((d,), "zeros")
    if qk_norm:
        spec["q_norm"] = ((head_dim,), "ones")
        spec["k_norm"] = ((head_dim,), "ones")
    return spec


def _project(x: Tensor, w: Tensor) -> Tensor:
    """(B,S,D) x (D,H,K) -> (B,S,H,K) as one matmul in x's dtype."""
    b, s, d = x.shape
    return (x @ w.to(x.dtype).reshape(d, -1)).reshape(b, s, *w.shape[1:])


def qkv_project(p: dict, x: Tensor, *, positions: Tensor, rope_theta: float,
                mrope_section=None, use_rope: bool = True):
    """x (B,S,D) -> q (B,S,H,hd), k/v (B,S,KH,hd), with bias/qk-norm/rope
    (M-RoPE where ``mrope_section`` is given)."""
    dt = x.dtype
    q, k, v = _project(x, p["wq"]), _project(x, p["wk"]), _project(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if "q_norm" in p:  # per-head RMS norm (Qwen3)
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if use_rope:
        q = apply_rope(q, positions, rope_theta, mrope_section)
        k = apply_rope(k, positions, rope_theta, mrope_section)
    return q, k, v


def out_project(p: dict, attn: Tensor) -> Tensor:
    b, s, h, hd = attn.shape
    out = attn.reshape(b, s, h * hd) @ p["wo"].to(attn.dtype).reshape(
        h * hd, -1)
    if "bo" in p:
        out = out + p["bo"].to(attn.dtype)
    return out


# ---------------------------------------------------------------------------
# SDPA (prefill and teacher forcing): kernel #10
# ---------------------------------------------------------------------------

def sdpa(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
         window: int | None = None) -> Tensor:
    """q (B,Sq,H,D), k/v (B,Skv,KH,D) -> (B,Sq,H,D), queries end-aligned to
    the keys (Sq == Skv in prefill and training)."""
    out = kernel_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal=causal,
                                     window=window)
    return out.transpose(1, 2)


def sdpa_dense(q: Tensor, k: Tensor, v: Tensor, *,
               causal: bool = False) -> Tensor:
    """The reference's full-logits attention, kept plain where the
    reference computes it outside any kernel (the encoder-decoder's cross
    attention).  q (B,Sq,H,D), k/v (B,Skv,KH,D) -> (B,Sq,H,D): fp32 logits,
    a softmax, the probabilities cast to q's dtype for the product with v;
    a causal mask aligns query i with key i."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * (d ** -0.5)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        logits = torch.where(qi >= ki, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(q.dtype))
    return out.reshape(b, sq, h, d)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: Tensor  # (B, S_max, KH, D)
    v: Tensor  # (B, S_max, KH, D)

    @staticmethod
    def zeros(b: int, s_max: int, kh: int, d: int, dtype=torch.bfloat16,
              device="cuda") -> "KVCache":
        dev = resolve_device(device)
        return KVCache(k=torch.zeros((b, s_max, kh, d), dtype=dtype,
                                     device=dev),
                       v=torch.zeros((b, s_max, kh, d), dtype=dtype,
                                     device=dev))


def write_rows(cache: KVCache, k_new: Tensor, v_new: Tensor,
               tgt: Tensor) -> KVCache:
    """Write step j of row b at cache position ``tgt[b, j]``, IN PLACE, and
    return the same cache.  Targets must lie inside the cache (the
    reference's one-hot write would drop one past its end; the engine
    retires a slot before that)."""
    rows = torch.arange(tgt.shape[0], device=tgt.device)[:, None]
    cache.k[rows, tgt] = k_new.to(cache.k.dtype)
    cache.v[rows, tgt] = v_new.to(cache.v.dtype)
    return cache


def cache_update(cache: KVCache, k_new: Tensor, v_new: Tensor,
                 lengths: Tensor) -> KVCache:
    """Write S_new steps at per-sequence offsets ``lengths`` (B,).  An
    indexed write in place, where the reference rebuilds the cache with a
    one-hot matmul; the stored values are the same."""
    s_new = k_new.shape[1]
    tgt = (lengths.to(k_new.device, torch.long)[:, None]
           + torch.arange(s_new, device=k_new.device)[None, :])
    return write_rows(cache, k_new, v_new, tgt)


def decode_attend(q: Tensor, cache: KVCache, lengths: Tensor, *,
                  window: int | None = None) -> Tensor:
    """One-token attention over the cache.  q (B,1,H,D); lengths (B,) is the
    number of valid cache entries INCLUDING the new token already written.
    Logits and softmax in fp32, probabilities cast to q's dtype for the
    product with v, as in the reference."""
    b, _, h, d = q.shape
    kh = cache.k.shape[2]
    qg = q.reshape(b, 1, kh, h // kh, d)
    logits = torch.einsum(
        "bqhgd,bkhd->bhgqk", qg.to(torch.float32),
        cache.k.to(q.dtype).to(torch.float32)) * (d ** -0.5)
    ki = torch.arange(cache.k.shape[1], device=q.device)[None, :]
    lengths = lengths.to(q.device)[:, None]
    mask = ki < lengths
    if window is not None:
        mask &= ki >= (lengths - window)
    logits = torch.where(mask[:, None, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, cache.v.to(q.dtype))
    return out.reshape(b, 1, h, d)
