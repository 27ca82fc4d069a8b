"""GQA attention: projections, SDPA through kernel #10, the reference's
differentiable SDPA for training, KV-cache decode (port of
``repro.models.attention``).

Layout: activations (B, S, H, D).  ``sdpa`` hands q, k and v to
``kernels.ops.flash_attention`` as (B, H, S, D) views of that layout: on the
card the flash-attention kernel reads them through their strides, so no
transposed copy is made; on the CPU the plain version runs.  It builds no
graph: #10 has no backward pass (nor has the reference's Pallas kernel),
and the kernel's dispatcher raises when q, k or v asks for a gradient.

Training computes attention where the reference computes it, in plain
differentiable tensor operations: ``sdpa_train`` is the reference's
``sdpa`` dispatch, ``sdpa_dense`` (full logits) for short sequences and
``sdpa_chunked`` (online softmax over q/kv tiles, fully masked tiles
skipped, each tile under ``torch.utils.checkpoint``) otherwise.  The
reference's own dispatch never reaches its Pallas kernel either.
``decode_attend`` stays plain torch, as in the reference: one query a slot
against the cache, with each slot's own valid length, which the kernel has
no operand for; so does ``sdpa_dense`` as the encoder-decoder's cross
attention.  The reference's sharding constraints on q, k and v are
``dist.sharding.constrain`` anchors in ``qkv_project``: identities
outside an ``activation_rules`` context, so the one-device path is
unchanged.

Under a mesh (the sharded serving steps: DTensor q, k, v and caches),
#10, ``decode_attend`` and the cache writes run on each rank's local
tensors (:func:`_local_heads`): q keeps its batch and head shards and is
gathered along any other dim; a rank's local query head h reads its
*global* kv head, (h + the rank's head offset) // (H / KH): where k's heads
are split as q's the local kv heads are those, else k is gathered whole
over its head dim and each rank takes the kv heads its query heads read
(a slice where they are whole groups or lie in one, else one kv head a
query head).  The local GQA ratio never decides it.  A cache write puts
the new rows into the rank's local cache, in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..dist.sharding import constrain, row_matmul, span
from ..kernels import ops as kernel_ops
from .layers import Spec, apply_rope, rms_norm

Tensor = torch.Tensor

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def attention_spec(d: int, heads: int, kv_heads: int, head_dim: int,
                   qkv_bias: bool = False, qk_norm: bool = False,
                   out_bias: bool = False) -> dict:
    """Parameter name -> ``Spec``: the reference's shapes and axes."""
    spec = {
        "wq": Spec((d, heads, head_dim), ("fsdp", "heads", "head_dim")),
        "wk": Spec((d, kv_heads, head_dim), ("fsdp", "kv_heads", "head_dim")),
        "wv": Spec((d, kv_heads, head_dim), ("fsdp", "kv_heads", "head_dim")),
        "wo": Spec((heads, head_dim, d), ("heads", "head_dim", "fsdp")),
    }
    if qkv_bias:
        spec["bq"] = Spec((heads, head_dim), ("heads", "head_dim"), "zeros")
        spec["bk"] = Spec((kv_heads, head_dim), ("kv_heads", "head_dim"),
                          "zeros")
        spec["bv"] = Spec((kv_heads, head_dim), ("kv_heads", "head_dim"),
                          "zeros")
    if out_bias:
        spec["bo"] = Spec((d,), ("embed",), "zeros")
    if qk_norm:
        spec["q_norm"] = Spec((head_dim,), ("head_dim",), "ones")
        spec["k_norm"] = Spec((head_dim,), ("head_dim",), "ones")
    return spec


def _project(x: Tensor, w: Tensor) -> Tensor:
    """(B,S,D) x (D,H,K) -> (B,S,H,K) as one matmul in x's dtype.  Under a
    mesh the weight keeps only its head shards (:func:`_heads_only`), so
    the product's H*K columns are split where the rules split H, and
    (H, K) can follow, in both directions."""
    b, s, d = x.shape
    w = _heads_only(w, 1)
    return row_matmul(x, w.to(x.dtype).reshape(d, -1)).reshape(
        b, s, *w.shape[1:])


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
    q = constrain(q, ("batch", "seq", "heads", "head_dim"))
    k = constrain(k, ("batch", "seq", "kv_heads", "head_dim"))
    v = constrain(v, ("batch", "seq", "kv_heads", "head_dim"))
    return q, k, v


def out_project(p: dict, attn: Tensor) -> Tensor:
    """(B,S,H,K) -> (B,S,D); under a mesh the weight keeps only its head
    shards, as in :func:`_project`."""
    b, s, h, hd = attn.shape
    out = row_matmul(attn.reshape(b, s, h * hd),
                     _heads_only(p["wo"], 0).to(attn.dtype).reshape(
                         h * hd, -1))
    if "bo" in p:
        out = out + p["bo"].to(attn.dtype)
    return out


def _heads_only(w: Tensor, dim: int) -> Tensor:
    """A projection weight with its shards of its head dim ``dim`` kept
    and gathered whole over every other mesh dim (FSDP's gather; its
    gradient leaves as a reduce-scatter into the shards).  The rules
    split heads only over mesh dims that divide them (``model``), so each
    rank projects the heads it attends with and no other.  A plain tensor
    as it is."""
    return _keep(w, (dim,)) if isinstance(w, DTensor) else w


# ---------------------------------------------------------------------------
# SDPA: kernel #10 (prefill, teacher forcing) and the reference's
# differentiable dispatch (training)
# ---------------------------------------------------------------------------

def _keep(t: DTensor, dims: tuple) -> DTensor:
    """``t`` with its shards of ``dims`` kept and every other dim gathered
    whole (``Replicate()`` on the mesh dims that split it)."""
    want = tuple(p if isinstance(p, Shard) and p.dim in dims
                 else Replicate() for p in t.placements)
    if want == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, want)


def _local_heads(q: DTensor, k: DTensor, v: DTensor):
    """Each rank's operands of a GQA attention under a mesh (module
    docstring).  q (B,Sq,H,D), k/v (B,Skv,KH,D) DTensors -> (q, k, v
    local, q's placements after the gather).
    Differentiable: where each rank takes a part of k's heads, their
    gradients leave as ``Partial`` over the mesh dims that split q's."""
    h, kh = q.shape[2], k.shape[2]
    group = h // kh
    mesh = q.device_mesh
    q = _keep(q, (0, 2))
    heads = [p == Shard(2) for p in q.placements]
    batch = tuple(p if p == Shard(0) else Replicate() for p in q.placements)
    # k's heads split as q's (on the same mesh dims and no other): the
    # local GQA ratio is the global one
    same = all(hq == (pk == Shard(2))
               for hq, pk in zip(heads, k.placements, strict=True))
    want = tuple(q.placements) if same else batch
    grads = want if same else tuple(Partial() if hq else p
                                    for hq, p in zip(heads, batch))
    kl, vl = (
        (t if tuple(t.placements) == want else t.redistribute(mesh, want)
         ).to_local(grad_placements=grads) for t in (k, v))
    if not same:
        hs = span(q, 2)
        lo, n = hs.start, hs.stop - hs.start
        if n % group == 0:                  # whole groups
            kv = slice(lo // group, lo // group + n // group)
        elif group % n == 0:                # inside one group
            kv = slice(lo // group, lo // group + 1)
        else:                               # one kv head a query head
            kv = torch.arange(lo, lo + n, device=kl.device) // group
        kl, vl = kl[:, :, kv], vl[:, :, kv]
    return q.to_local(), kl, vl, q.placements


def _on_local_heads(fn, q: DTensor, k: DTensor, v: DTensor, **kw):
    """``fn(q, k, v, **kw)`` on each rank's local heads, a DTensor back in
    q's (gathered) placements."""
    ql, kl, vl, placements = _local_heads(q, k, v)
    return DTensor.from_local(fn(ql, kl, vl, **kw), q.device_mesh,
                              placements, run_check=False)


def sdpa(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
         window: int | None = None) -> Tensor:
    """q (B,Sq,H,D), k/v (B,Skv,KH,D) -> (B,Sq,H,D), queries end-aligned to
    the keys (Sq == Skv in prefill and training).  DTensors: on each
    rank's heads (:func:`_local_heads`), a DTensor back."""
    if isinstance(q, DTensor):
        return _on_local_heads(sdpa, q, k, v, causal=causal, window=window)
    out = kernel_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal=causal,
                                     window=window)
    return out.transpose(1, 2)


def _grouped(q: Tensor, kv_heads: int) -> Tensor:
    """(B,S,H,D) -> (B,S,KH,G,D)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, kv_heads, h // kv_heads, d)


def _mask(qpos: Tensor, kpos: Tensor, causal: bool,
          window: int | None) -> Tensor | None:
    """(Sq, Skv) bool mask of the keys each query sees at absolute
    positions, or None when every key is seen."""
    if not causal and window is None:
        return None
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    return mask


def sdpa_dense(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
               window: int | None = None, q_offset: int = 0) -> Tensor:
    """The reference's full-logits attention (plain and differentiable).
    q (B,Sq,H,D), k/v (B,Skv,KH,D) -> (B,Sq,H,D): fp32 logits, a softmax,
    the probabilities cast to q's dtype for the product with v.  Query i
    sits at absolute position ``i + q_offset``, key j at j; the causal
    mask keeps keys at or before the query, the window the last
    ``window`` of them.  DTensors: on each rank's heads
    (:func:`_local_heads`)."""
    if isinstance(q, DTensor):
        return _on_local_heads(sdpa_dense, q, k, v, causal=causal,
                               window=window, q_offset=q_offset)
    b, sq, h, d = q.shape
    kh = k.shape[2]
    qg = _grouped(q, kh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * (d ** -0.5)
    mask = _mask(torch.arange(sq, device=q.device) + q_offset,
                 torch.arange(k.shape[1], device=q.device), causal, window)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(q.dtype))
    return out.reshape(b, sq, h, d)


def _flash_tile(qg, kj, vj, acc, m, den, qpos, kpos, causal, window, scale):
    """Online-softmax update for one (q_chunk, kv_chunk) tile.

    qg (B,Cq,KH,G,D); kj/vj (B,Ck,KH,D); acc (B,Cq,KH,G,D) fp32; m/den
    (B,Cq,KH,G) fp32; qpos (Cq,), kpos (Ck,) absolute positions.  The
    products accumulate in fp32, P cast to q's dtype before P.V."""
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg.to(torch.float32),
                     kj.to(torch.float32)) * scale
    mask = _mask(qpos, kpos, causal, window)
    if mask is not None:
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    den_new = den * corr + torch.sum(p, dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bqhgk,bkhd->bqhgd", p.to(qg.dtype).to(torch.float32),
        vj.to(torch.float32))
    return acc_new, m_new, den_new


def sdpa_chunked(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                 window: int | None = None, q_offset: int = 0,
                 q_chunk: int = 512, kv_chunk: int = 1024) -> Tensor:
    """The reference's flash-semantics attention in plain differentiable
    operations; the largest buffer is one tile's (B, q_chunk, H, kv_chunk)
    fp32 logits.  Tiles outside the causal or window reach are skipped
    (known from the positions alone); where a graph is built, each tile's
    body runs under ``torch.utils.checkpoint``, so the backward pass makes
    its probabilities again instead of keeping them."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    nq = -(-sq // q_chunk)
    nk = -(-skv // kv_chunk)
    qg = _grouped(q, kh)
    scale = d ** -0.5
    kpos = [torch.arange(j * kv_chunk, min((j + 1) * kv_chunk, skv),
                         device=q.device) for j in range(nk)]
    outs = []
    for i in range(nq):
        q0, q1 = i * q_chunk, min((i + 1) * q_chunk, sq)
        qi = qg[:, q0:q1]
        cq = q1 - q0
        qpos = torch.arange(q0, q1, device=q.device) + q_offset
        acc = torch.zeros((b, cq, kh, h // kh, d), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, cq, kh, h // kh), NEG_INF, dtype=torch.float32,
                       device=q.device)
        den = torch.zeros((b, cq, kh, h // kh), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            k0, k1 = j * kv_chunk, min((j + 1) * kv_chunk, skv)
            lo_q, hi_q = q0 + q_offset, q1 - 1 + q_offset
            if causal and k0 > hi_q:
                continue
            if window is not None and (k1 - 1) < lo_q - window + 1:
                continue
            # a tile whose every key is within reach of every query needs
            # no mask (the same bits as a mask of all True)
            tile_causal = causal and k1 - 1 > lo_q
            tile_window = (window if window is not None
                           and hi_q - k0 >= window else None)
            args = (qi, k[:, k0:k1], v[:, k0:k1], acc, m, den, qpos,
                    kpos[j], tile_causal, tile_window, scale)
            if torch.is_grad_enabled():
                # reentrant: the tile's forward builds no graph and its
                # backward makes it again, at a third of the non-reentrant
                # form's host time a tile; it draws no random numbers
                acc, m, den = checkpoint(_flash_tile, *args,
                                         use_reentrant=True,
                                         preserve_rng_state=False)
            else:               # no graph to spare (a remat'd layer's pass)
                acc, m, den = _flash_tile(*args)
        out = acc / torch.clamp(den, min=1e-30)[..., None]
        outs.append(out.reshape(b, cq, h, d).to(q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def sdpa_train(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
               window: int | None = None, q_offset: int = 0,
               dense_threshold: int = 2048, q_chunk: int = 512,
               kv_chunk: int = 1024) -> Tensor:
    """The reference's ``sdpa`` dispatch, differentiable: ``sdpa_dense``
    where Sq * Skv <= dense_threshold^2, else ``sdpa_chunked`` with chunks
    of at least S/8 (the reference's rule, which bounds its unrolled tile
    count).  DTensors: on each rank's heads (:func:`_local_heads`)."""
    if isinstance(q, DTensor):
        return _on_local_heads(sdpa_train, q, k, v, causal=causal,
                               window=window, q_offset=q_offset,
                               dense_threshold=dense_threshold,
                               q_chunk=q_chunk, kv_chunk=kv_chunk)
    if q.shape[1] * k.shape[1] <= dense_threshold * dense_threshold:
        return sdpa_dense(q, k, v, causal=causal, window=window,
                          q_offset=q_offset)
    q_chunk = max(q_chunk, -(-q.shape[1] // 8))
    kv_chunk = max(kv_chunk, -(-k.shape[1] // 8))
    return sdpa_chunked(q, k, v, causal=causal, window=window,
                        q_offset=q_offset, q_chunk=q_chunk,
                        kv_chunk=kv_chunk)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: Tensor  # (B, S_max, KH, D)
    v: Tensor  # (B, S_max, KH, D)

    @staticmethod
    def zeros(b: int, s_max: int, kh: int, d: int, dtype=torch.bfloat16,
              device="cuda") -> "KVCache":
        dev = resolve_device(device, meta=True)
        return KVCache(k=torch.zeros((b, s_max, kh, d), dtype=dtype,
                                     device=dev),
                       v=torch.zeros((b, s_max, kh, d), dtype=dtype,
                                     device=dev))

    @staticmethod
    def axes() -> "KVCache":
        """The logical axes of k and v (``kv_seq`` is in no rules table:
        the cache's sequence stays whole on every rank)."""
        ax = ("batch", "kv_seq", "kv_heads", "head_dim")
        return KVCache(k=ax, v=ax)


def write_rows(cache: KVCache, k_new: Tensor, v_new: Tensor,
               tgt: Tensor) -> KVCache:
    """Write step j of row b at cache position ``tgt[b, j]``, IN PLACE, and
    return the same cache.  Targets must lie inside the cache (the
    reference's one-hot write would drop one past its end; the engine
    retires a slot before that).  A DTensor cache: the new rows placed as
    the cache is, each rank writing its local rows."""
    if isinstance(cache.k, DTensor):
        mesh, want = cache.k.device_mesh, tuple(cache.k.placements)
        if tuple(k_new.placements) != want:
            k_new = k_new.redistribute(mesh, want)
        if tuple(v_new.placements) != want:
            v_new = v_new.redistribute(mesh, want)
        write_rows(KVCache(cache.k.to_local(), cache.v.to_local()),
                   k_new.to_local(), v_new.to_local(),
                   tgt[span(cache.k, 0)])
        return cache
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
    product with v, as in the reference.  DTensors: on each rank's rows
    and heads (:func:`_local_heads`), a DTensor back."""
    if isinstance(q, DTensor):
        rows = span(q, 0)
        return _on_local_heads(
            lambda ql, kl, vl: decode_attend(ql, KVCache(kl, vl),
                                             lengths[rows], window=window),
            q, cache.k, cache.v)
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
