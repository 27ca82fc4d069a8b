"""Bregman distance families (port of ``repro.core.bregman``).

Every family is separable, ``f(x) = sum_j phi(x_j)``, so the distance over
the full space is the sum of the distances over disjoint subspaces — the
property dimensionality partitioning rests on.  Each family exposes the
elementwise generator ``phi``, its derivative ``phi_prime`` and the
inverse of the derivative, as torch functions on tensors, with a domain
sampler (drawing from an explicit ``torch.Generator``) and a domain
projection.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BregmanFamily:
    """A separable Bregman generator ``f(x) = sum_j phi(x_j)``."""

    name: str
    phi: Callable[[Tensor], Tensor]            # elementwise generator
    phi_prime: Callable[[Tensor], Tensor]      # elementwise derivative
    phi_prime_inv: Callable[[Tensor], Tensor]  # inverse of phi_prime
    domain_low: float                          # open lower bound of the domain
    domain_high: float

    def f(self, x: Tensor) -> Tensor:
        """``f(x)``: sum of the elementwise generator over the trailing axis."""
        return torch.sum(self.phi(x), dim=-1)

    def grad_f(self, x: Tensor) -> Tensor:
        return self.phi_prime(x)

    def distance(self, x: Tensor, y: Tensor) -> Tensor:
        """``D_f(x, y)`` over the trailing axis (broadcasts on leading axes)."""
        term = self.phi(x) - self.phi(y) - self.phi_prime(y) * (x - y)
        return torch.sum(term, dim=-1)

    def distance_masked(self, x: Tensor, y: Tensor, mask: Tensor) -> Tensor:
        """``D_f`` restricted to dims where ``mask`` is 1 (padded subspaces)."""
        term = self.phi(x) - self.phi(y) - self.phi_prime(y) * (x - y)
        return torch.sum(term * mask, dim=-1)

    def pairwise_distance(self, xs: Tensor, y: Tensor) -> Tensor:
        """``D_f(xs[i], y)`` for a stack of points ``xs`` of shape (n, d)."""
        return self.distance(xs, y[None, :])

    # -- domain helpers ------------------------------------------------------
    def project(self, x: Tensor) -> Tensor:
        """Clip into the (numerically safe interior of the) domain."""
        lo = self.domain_low + 1e-6 if math.isfinite(self.domain_low) \
            else None
        hi = self.domain_high - 1e-6 if math.isfinite(self.domain_high) \
            else None
        if lo is None and hi is None:
            return x
        return torch.clamp(x, lo, hi)

    def sample(self, generator: torch.Generator, shape,
               scale: float = 1.0) -> Tensor:
        """Draw valid fp32 data for this family from ``generator`` (on the
        generator's device): standard normals times ``scale``, made
        strictly positive for the positive-domain families and clipped to
        [-4, 4] for the exponential one (so exp(x) stays in range)."""
        raw = torch.randn(tuple(shape), generator=generator,
                          device=generator.device) * scale
        if self.name in ("itakura_saito", "burg", "shannon"):
            return torch.abs(raw) + 0.05
        if self.name == "exponential":
            return torch.clamp(raw, -4.0, 4.0)
        return raw


def validate_rows(family, rows, *, mode: str = "raise", what: str = "row"):
    """Per-row domain gate: finite entries inside the family's OPEN domain.

    ``rows`` is (d,) or (q, d), a tensor or an array; the check runs in
    numpy on the host and returns a (q,) bool ``ok`` mask.  ``mode="raise"``
    raises a ``ValueError`` naming the first offending row.
    """
    fam = get_family(family) if isinstance(family, str) else family
    if mode not in ("raise", "mask"):
        raise ValueError(f"mode must be 'raise' or 'mask', got {mode!r}")
    if isinstance(rows, torch.Tensor):
        rows = rows.detach().cpu().numpy()
    arr = np.asarray(rows)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim != 2:
        raise ValueError(f"expected (d,) or (q, d) {what}s, got {arr.shape}")
    ok = np.isfinite(arr).all(axis=1)
    lo, hi = fam.domain_low, fam.domain_high
    with np.errstate(invalid="ignore"):
        if np.isfinite(lo):
            ok &= (arr > lo).all(axis=1)
        if np.isfinite(hi):
            ok &= (arr < hi).all(axis=1)
    if mode == "raise" and not ok.all():
        bad = int(np.argmax(~ok))
        lo_s = f"{lo:g}" if np.isfinite(lo) else "-inf"
        hi_s = f"{hi:g}" if np.isfinite(hi) else "inf"
        raise ValueError(
            f"{what} {bad} is invalid for Bregman family {fam.name!r}: "
            f"entries must be finite and inside the open domain "
            f"({lo_s}, {hi_s}); got {what} values "
            f"min={np.nanmin(arr[bad]):g} max={np.nanmax(arr[bad]):g} "
            f"finite={bool(np.isfinite(arr[bad]).all())}")
    return ok


def _squared_euclidean() -> BregmanFamily:
    return BregmanFamily(
        name="squared_euclidean",
        phi=lambda x: 0.5 * x * x,
        phi_prime=lambda x: x,
        phi_prime_inv=lambda t: t,
        domain_low=-math.inf,
        domain_high=math.inf,
    )


def _itakura_saito() -> BregmanFamily:
    # f(x) = -sum log x_i  ->  D_f(x,y) = sum(x/y - log(x/y) - 1)
    return BregmanFamily(
        name="itakura_saito",
        phi=lambda x: -torch.log(x),
        phi_prime=lambda x: -1.0 / x,
        phi_prime_inv=lambda t: -1.0 / t,
        domain_low=0.0,
        domain_high=math.inf,
    )


def _exponential() -> BregmanFamily:
    # f(x) = sum exp(x_i)  ->  D_f(x,y) = sum(e^x - (x - y + 1) e^y)
    return BregmanFamily(
        name="exponential",
        phi=torch.exp,
        phi_prime=torch.exp,
        phi_prime_inv=torch.log,
        domain_low=-math.inf,
        domain_high=math.inf,
    )


def _burg() -> BregmanFamily:
    # Burg entropy f(x) = -sum log x_i + x_i  (strictly convex on x>0)
    return BregmanFamily(
        name="burg",
        phi=lambda x: x - torch.log(x),
        phi_prime=lambda x: 1.0 - 1.0 / x,
        phi_prime_inv=lambda t: 1.0 / (1.0 - t),
        domain_low=0.0,
        domain_high=math.inf,
    )


def _shannon() -> BregmanFamily:
    # Shannon entropy f(x) = sum x log x  (generalized I-divergence)
    return BregmanFamily(
        name="shannon",
        phi=lambda x: x * torch.log(x),
        phi_prime=lambda x: torch.log(x) + 1.0,
        phi_prime_inv=lambda t: torch.exp(t - 1.0),
        domain_low=0.0,
        domain_high=math.inf,
    )


def mahalanobis(q_diag) -> BregmanFamily:
    """Squared Mahalanobis distance with a diagonal PSD matrix ``Q``.

    ``f(x) = 0.5 x^T Q x`` with diagonal ``Q`` stays separable; a full ``Q``
    would couple dimensions and break the partition bound.  ``q_diag`` is
    held in fp32 and follows the operand to its device.  The family is
    not in the registry (as in the reference), so no index is built by
    its name and the refine kernels have no generator for it: use it with
    the family-level operations (``distance``, ``pairwise_distance``).
    """
    q = torch.as_tensor(np.asarray(q_diag, dtype=np.float32))

    def on(x: Tensor) -> Tensor:
        return q.to(x.device)

    return BregmanFamily(
        name="mahalanobis",
        phi=lambda x: 0.5 * on(x) * x * x,
        phi_prime=lambda x: on(x) * x,
        phi_prime_inv=lambda t: t / on(t),
        domain_low=-math.inf,
        domain_high=math.inf,
    )


_REGISTRY = {
    "squared_euclidean": _squared_euclidean,
    "itakura_saito": _itakura_saito,
    "exponential": _exponential,
    "burg": _burg,
    "shannon": _shannon,
}

# Paper dataset-measure shorthand.
ALIASES = {"ed": "exponential", "isd": "itakura_saito", "se": "squared_euclidean"}


def get_family(name: str) -> BregmanFamily:
    key = ALIASES.get(name.lower(), name.lower())
    if key not in _REGISTRY:
        raise KeyError(f"unknown Bregman family {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[key]()


def family_names():
    return sorted(_REGISTRY)
