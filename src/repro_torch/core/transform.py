"""Dimensionality partition layout + P/Q transforms (paper Alg. 2 & 3).

Port of ``repro.core.transform``.  A :class:`Partition` deals the ``d``
original dimensions into ``M`` subspaces of width ``w = ceil(d/M)``; padded
slots carry ``mask = 0`` and contribute nothing to any transform.

* data tuple  ``P(x) = (alpha_x, gamma_x)`` per subspace, with
  ``alpha_x = sum_j f(x_ij)`` and ``gamma_x = sum_j x_ij^2``;
* query triple ``Q(y) = (alpha_y, beta_yy, delta_y)`` per subspace, with
  ``alpha_y = -sum_j f(y_ij)``, ``beta_yy = sum_j y_ij f'(y_ij)`` and
  ``delta_y = sum_j f'(y_ij)^2``.

``sqrt(gamma)`` and ``sqrt(delta)`` are stored so the filter's Cauchy term
is a plain inner product over subspaces.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bregman import BregmanFamily

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class Partition:
    """Static partition layout: which original dim sits in which subspace slot.

    Hash and equality go by content, so two partitions dealt the same way
    compare equal.
    """

    d: int
    num_subspaces: int                 # M
    width: int                         # w = ceil(d / M)
    idx: np.ndarray                    # (M, w) int32 indices into the original dims
    mask: np.ndarray                   # (M, w) float32, 0 for padded slots

    def __eq__(self, other):
        return (
            isinstance(other, Partition)
            and self.d == other.d
            and self.num_subspaces == other.num_subspaces
            and np.array_equal(self.idx, other.idx)
            and np.array_equal(self.mask, other.mask)
        )

    def __hash__(self):
        return hash((self.d, self.num_subspaces, self.width,
                     self.idx.tobytes(), self.mask.tobytes()))

    @property
    def m(self) -> int:
        return self.num_subspaces

    def gather(self, x: Tensor) -> Tensor:
        """(…, d) -> (…, M, w) subspace view (padded slots refer to dim 0)."""
        return x[..., torch.as_tensor(self.idx, dtype=torch.long,
                                      device=x.device)]

    def subspace_mask(self, device=None) -> Tensor:
        return torch.as_tensor(self.mask, device=device)


def make_partition(d: int, m: int, order: np.ndarray | None = None) -> Partition:
    """Partition ``d`` dims into ``m`` subspaces, dealt contiguously from
    ``order`` (``range(d)`` when None; the PCCP order otherwise): subspace
    ``i`` takes ``order[i*w:(i+1)*w]``."""
    if m < 1 or m > d:
        raise ValueError(f"need 1 <= M <= d, got M={m}, d={d}")
    if order is None:
        order = np.arange(d)
    order = np.asarray(order, dtype=np.int32)
    if order.shape != (d,) or len(np.unique(order)) != d:
        raise ValueError("order must be a permutation of range(d)")
    w = -(-d // m)  # ceil
    idx = np.zeros((m, w), dtype=np.int32)
    mask = np.zeros((m, w), dtype=np.float32)
    for i in range(m):
        chunk = order[i * w:(i + 1) * w]
        idx[i, : len(chunk)] = chunk
        mask[i, : len(chunk)] = 1.0
    return Partition(d=d, num_subspaces=m, width=w, idx=idx, mask=mask)


def p_transform_views(xs: Tensor, mask: Tensor, family: BregmanFamily) -> dict:
    """Alg. 2 on a pre-gathered (..., M, w) subspace view."""
    alpha = torch.sum(family.phi(xs) * mask, dim=-1)
    gamma = torch.sum(xs * xs * mask, dim=-1)
    return {"alpha": alpha, "gamma": gamma, "sqrt_gamma": torch.sqrt(gamma)}


def p_transform(x: Tensor, part: Partition, family: BregmanFamily) -> dict:
    """Alg. 2: (..., d) points -> alpha, gamma, sqrt_gamma, each (..., M)."""
    return p_transform_views(part.gather(x), part.subspace_mask(x.device),
                             family)


def q_transform_views(ys: Tensor, mask: Tensor, family: BregmanFamily) -> dict:
    """Alg. 3 on a pre-gathered (..., M, w) subspace view: the per-subspace
    fields of :func:`q_transform`."""
    g = family.phi_prime(ys)
    alpha = -torch.sum(family.phi(ys) * mask, dim=-1)
    beta_yy = torch.sum(ys * g * mask, dim=-1)
    delta = torch.sum(g * g * mask, dim=-1)
    return {
        "alpha": alpha,
        "beta_yy": beta_yy,
        "delta": delta,
        "qconst": alpha + beta_yy,
        "sqrt_delta": torch.sqrt(delta),
    }


def q_transform(y: Tensor, part: Partition, family: BregmanFamily) -> dict:
    """Alg. 3: per-subspace triples (..., M) plus ``grad`` (..., d), f'(y)
    in original dim order, and ``f_y`` (...), f(y) over all dims."""
    q = q_transform_views(part.gather(y), part.subspace_mask(y.device), family)
    q["grad"] = family.phi_prime(y)
    q["f_y"] = family.f(y)
    return q
