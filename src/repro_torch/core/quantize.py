"""Int8 storage tier: per-row quantizers and their error bounds (port of
``repro.core.quantize``).

The int8 index's point set IS the dequantized rows ``x_hat``; search over
the tier returns the exact kNN of ``x_hat``.  Three per-row affine
quantizers (``value = code * scale + zp``, codes in [-128, 127]):

* data rows (d,) — round to nearest, decoded rows clamped into the family
  domain (:func:`dequantize_rows` defines the stored points);
* filter stats ``alpha`` / ``sqrt_gamma`` (M,) — round to nearest; the
  Alg.-4 bounds are inflated by :func:`ub_slack` at query time;
* corner stats ``alpha_min_pt`` / ``sqrt_gamma_max_pt`` (M,) — DIRECTED
  rounding (alpha_min floors, sqrt_gamma_max ceils), so the decoded corner
  is conservative and the Theorem-3 prune needs no slack.

A constant row stores ``scale = 0`` (codes zero, ``zp`` exact); the
search-inert fill reuses it.  Codes, scales and zero-points are bit-equal
to the reference's on the CPU and on the card: every fp32 operation below
is one IEEE operation rounded on its own (no fused multiply-add), and the
Python constants are rounded to fp32 once, explicitly, as JAX's weak types
do.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

# Families whose generator domain is the open positive axis; decoded rows
# are clamped to >= DOMAIN_EPS there.
POSITIVE_FAMILIES = frozenset({"itakura_saito", "burg", "shannon"})
DOMAIN_EPS = 1e-6

# Half-step rounding bound with a small safety margin (docs/quantization.md).
UB_SLACK = 0.5 * (1.0 + 1e-3)

# Affine range: 255 levels over [min, max] of a row.
_LEVELS = 254.0
# Directed rounding keeps the row extremes strictly inside the code range.
_DIRECTED_PAD = 1.0 + 1e-6


def _f32(value: float, like: Tensor) -> Tensor:
    """A Python constant rounded to fp32 once, on ``like``'s device."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _row_affine(v: Tensor, pad: float = 1.0) -> tuple[Tensor, Tensor]:
    """Per-row (scale, zero_point) covering [min, max] of the last axis;
    constant rows get ``scale = 0``."""
    lo = torch.amin(v, dim=-1)
    hi = torch.amax(v, dim=-1)
    zp = 0.5 * (hi + lo)
    scale = (hi - lo) * _f32(pad / _LEVELS, v)
    return scale, zp


def _encode(v: Tensor, scale: Tensor, zp: Tensor, rounding: str) -> Tensor:
    div = torch.where(scale > 0, scale, _f32(1.0, scale))
    t = (v - zp[..., None]) / div[..., None]
    if rounding == "nearest":
        t = torch.round(t)                       # half to even, as jnp.round
    elif rounding == "floor":
        t = torch.floor(t)
    elif rounding == "ceil":
        t = torch.ceil(t)
    else:
        raise ValueError(f"unknown rounding {rounding!r}")
    return torch.clamp(t, -128, 127).to(torch.int8)


def quantize_rows(x: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Affine int8 per (d,) row: (codes (n, d) int8, scale (n,), zp (n,))."""
    x = torch.as_tensor(x, dtype=torch.float32)
    scale, zp = _row_affine(x)
    return _encode(x, scale, zp, "nearest"), scale, zp


def clamp_domain(x: Tensor, family_name: str) -> Tensor:
    """Domain projection shared by dequantize_rows and the refine kernels."""
    if family_name in POSITIVE_FAMILIES:
        return torch.maximum(x, _f32(DOMAIN_EPS, x))
    return x


def dequantize_stats(codes: Tensor, scale: Tensor, zp: Tensor) -> Tensor:
    """Per-row affine decode ``code * scale + zp``, each operation rounded
    on its own."""
    return codes.to(torch.float32) * scale[..., None] + zp[..., None]


def dequantize_rows(codes: Tensor, scale: Tensor, zp: Tensor,
                    family) -> Tensor:
    """``x_hat``, the int8 tier's point set: the affine decode, then the
    domain clamp.  This expression defines the stored points; the refine
    kernel reproduces it bit for bit.  ``family`` is a family or its
    canonical name."""
    name = family if isinstance(family, str) else family.name
    return clamp_domain(dequantize_stats(codes, scale, zp), name)


def quantize_stats(v: Tensor, rounding: str = "nearest",
                   ) -> tuple[Tensor, Tensor, Tensor]:
    """Affine int8 per (M,) stat row: (codes int8, scale (n,), zp (n,)).

    ``nearest``: ``|dequant - v| <= scale / 2``; ``floor`` / ``ceil``: the
    decoded value is <= / >= the true value.
    """
    v = torch.as_tensor(v, dtype=torch.float32)
    pad = 1.0 if rounding == "nearest" else _DIRECTED_PAD
    scale, zp = _row_affine(v, pad=pad)
    return _encode(v, scale, zp, rounding), scale, zp


def decoded_corner_tables(forest) -> tuple[Tensor, Tensor]:
    """Full (n, M) fp32 corner tables of an index (decoded in the int8
    tier, where they are conservative by their directed rounding)."""
    amin, gmax = forest.alpha_min_pt, forest.sqrt_gamma_max_pt
    if forest.storage == "int8":
        amin = dequantize_stats(amin, forest.amin_scale, forest.amin_zp)
        gmax = dequantize_stats(gmax, forest.gmax_scale, forest.gmax_zp)
    return amin, gmax


def ub_slack(alpha_scale: Tensor, sg_scale: Tensor,
             sqrt_delta: Tensor) -> Tensor:
    """Alg.-4 bound inflation from filter-stat scales: the (..., M)
    componentwise slack ``UB_SLACK * (alpha_scale + sg_scale * sqrt_delta)``
    from the per-query maxima of the scales over the filter's top-k rows."""
    return _f32(UB_SLACK, sqrt_delta) * (alpha_scale[..., None]
                                         + sg_scale[..., None] * sqrt_delta)


def encode_corner_tables(alpha_min_pt: Tensor,
                         sqrt_gamma_max_pt: Tensor) -> dict:
    """Directed-rounded int8 corner fields: alpha_min FLOORS and
    sqrt_gamma_max CEILS.  Returns the BallForest field dict."""
    am_q, am_s, am_z = quantize_stats(alpha_min_pt, "floor")
    gm_q, gm_s, gm_z = quantize_stats(sqrt_gamma_max_pt, "ceil")
    return {"alpha_min_pt": am_q, "amin_scale": am_s, "amin_zp": am_z,
            "sqrt_gamma_max_pt": gm_q, "gmax_scale": gm_s, "gmax_zp": gm_z}


def encode_stat_tables(alpha: Tensor, sqrt_gamma: Tensor,
                       alpha_min_pt: Tensor,
                       sqrt_gamma_max_pt: Tensor) -> dict:
    """Int8 field dict for all four (n, M) stat tables: filter stats round
    to nearest, corners through :func:`encode_corner_tables`."""
    a_q, a_s, a_z = quantize_stats(alpha, "nearest")
    g_q, g_s, g_z = quantize_stats(sqrt_gamma, "nearest")
    return {"alpha": a_q, "alpha_scale": a_s, "alpha_zp": a_z,
            "sqrt_gamma": g_q, "sg_scale": g_s, "sg_zp": g_z,
            **encode_corner_tables(alpha_min_pt, sqrt_gamma_max_pt)}
