"""Norms, embeddings, RoPE and MLPs (port of ``repro.models.layers``).

Parameters are plain dicts of tensors.  Every layer computes in its input's
dtype and keeps the reference's places of fp32 arithmetic: the norms
reduce in fp32 and cast back, the logits come out in fp32.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

def init_normal(shape: tuple, generator: torch.Generator,
                scale: float | None = None) -> Tensor:
    """N(0, 1) x ``scale`` on the generator's device; ``scale`` defaults to
    1/sqrt(shape[0]), the reference ``Spec``'s fan-in rule."""
    if scale is None:
        scale = 1.0 / max(shape[0] if shape else 1, 1) ** 0.5
    return torch.randn(shape, generator=generator,
                       device=generator.device) * scale


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """RMSNorm in fp32 (returns x.dtype)."""
    xf = x.to(torch.float32)
    nrm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (nrm * scale.to(torch.float32)).to(x.dtype)


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor,
               eps: float = 1e-5) -> Tensor:
    """LayerNorm in fp32 (returns x.dtype)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    nrm = (xf - mu) * torch.rsqrt(var + eps)
    return (nrm * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def init_norm(d: int, kind: str, device) -> dict:
    p = {"scale": torch.ones((d,), device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros((d,), device=device)
    return p


def apply_norm(p: dict, x: Tensor, kind: str) -> Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def padded_vocab(vocab: int, multiple: int = 128) -> int:
    """Vocab tables are padded to a multiple of 128 rows; the pad logits
    are stripped at the sampling boundary (``transformer.logits_fn``)."""
    return -(-vocab // multiple) * multiple


def embed_lookup(table: Tensor, tokens: Tensor, compute_dtype) -> Tensor:
    """Rows of the table for (B, S) tokens, in ``compute_dtype``.  The
    reference multiplies a one-hot matrix by the table cast to that dtype,
    which selects the same values this gather does."""
    return table[tokens.long()].to(compute_dtype)


def unembed_logits(x: Tensor, table: Tensor) -> Tensor:
    """(..., d) @ (V, d)^T -> (..., V) fp32 logits: the table is cast to
    x's dtype, then both operands are widened so the product accumulates
    and stays in fp32 (the reference's ``preferred_element_type``)."""
    return x.to(torch.float32) @ table.to(x.dtype).to(torch.float32).T


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> Tensor:
    """(head_dim//2,) inverse frequencies."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: Tensor, positions: Tensor, theta: float = 1e4) -> Tensor:
    """Rotary embedding, half-split (not interleaved).  x (B, S, H, D),
    positions (B, S) int.  sin and cos are cast to x's dtype before they
    multiply, as in the reference."""
    half = x.shape[-1] // 2
    inv = rope_frequencies(x.shape[-1], theta, x.device)          # (half,)
    angle = positions.to(torch.float32)[..., None] * inv           # (B,S,half)
    sin = torch.sin(angle)[:, :, None, :].to(x.dtype)
    cos = torch.cos(angle)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Dense MLPs
# ---------------------------------------------------------------------------

def init_mlp(d: int, f: int, gated: bool, bias: bool,
             generator: torch.Generator) -> dict:
    p = {"w_in": init_normal((d, f), generator),
         "w_out": init_normal((f, d), generator)}
    if gated:
        p["w_gate"] = init_normal((d, f), generator)
    if bias:
        p["b_in"] = torch.zeros((f,), device=generator.device)
        p["b_out"] = torch.zeros((d,), device=generator.device)
    return p


def _act(name: str) -> Callable[[Tensor], Tensor]:
    # The reference's "gelu" is jax.nn.gelu, whose default is the tanh
    # approximation.
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
            "relu_sq": lambda x: torch.square(F.relu(x))}[name]


def apply_mlp(p: dict, x: Tensor, act: str) -> Tensor:
    """Gated (SwiGLU/GeGLU) or plain 2-layer MLP; matmuls in x.dtype."""
    dt = x.dtype
    h = x @ p["w_in"].to(dt)
    if "b_in" in p:
        h = h + p["b_in"].to(dt)
    h = _act(act)(h)
    if "w_gate" in p:
        h = h * (x @ p["w_gate"].to(dt))
    out = h @ p["w_out"].to(dt)
    if "b_out" in p:
        out = out + p["b_out"].to(dt)
    return out
