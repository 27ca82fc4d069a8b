"""Cauchy upper/lower bounds (Theorems 1-2), port of ``repro.core.bounds``.

Per subspace ``i``:

  UB_i(x, y) = alpha_x + alpha_y + beta_yy + sqrt(gamma_x * delta_y)
  LB_i(x, y) = alpha_x + alpha_y + beta_yy - sqrt(gamma_x * delta_y)

Summing over subspaces bounds the full distance.  Because
``sqrt(gamma_x*delta_y) = sqrt(gamma_x)*sqrt(delta_y)``, the (n, q) total-UB
matrix is one (n, M) x (M, q) product plus a rank-1 bias.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def ub_components(p: dict, q: dict) -> Tensor:
    """Per-subspace upper bounds UB_i. Shapes broadcast: p (..., M), q (..., M)."""
    return p["alpha"] + q["qconst"] + p["sqrt_gamma"] * q["sqrt_delta"]


def lb_components(p: dict, q: dict) -> Tensor:
    """Per-subspace lower bounds LB_i (other Cauchy side)."""
    return p["alpha"] + q["qconst"] - p["sqrt_gamma"] * q["sqrt_delta"]


def ub_matrix(p: dict, q: dict) -> Tensor:
    """Total upper bounds for all (point, query) pairs: p fields (n, M),
    q fields (qn, M) -> (n, qn)."""
    bias_p = torch.sum(p["alpha"], dim=-1)
    bias_q = torch.sum(q["qconst"], dim=-1)
    cauchy = p["sqrt_gamma"] @ q["sqrt_delta"].T
    return bias_p[:, None] + bias_q[None, :] + cauchy


def fixed_order_sum(x: Tensor) -> Tensor:
    """Sum over the last axis by pairwise halving (an odd tail element is
    carried to the next level): the order of the adds depends on that
    axis's length alone.  A CUDA reduction's order follows its launch
    configuration, which follows the number of rows, so ``torch.sum``
    can round a query's sums differently in a batch of another size."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        head = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([head, x[..., 2 * h:]], dim=-1) if x.shape[-1] % 2 \
            else head
    return x[..., 0]


def _row_sum(x: Tensor) -> Tensor:
    """On the card :func:`fixed_order_sum`; on the CPU ``torch.sum``, whose
    order follows no batch size there and keeps the reference's parity
    tolerance (a large ``c_y`` cancels in ``D_f``, so a reordered sum
    moves a distance by its ulps)."""
    return fixed_order_sum(x) if x.is_cuda else torch.sum(x, dim=-1)


def query_refine_constants(y: Tensor, family) -> dict:
    """``grad = f'(y)`` and ``c_y = sum_j (y_j grad_j) - f(y)``: with them
    ``D_f(x, y) = sum_j phi(x_j) - x . grad + c_y``.  The sums do not
    depend on the batch (:func:`_row_sum`), so a query's ``c_y``, and with
    it its refined distances, has the same bits in a batch of any size."""
    grad = family.phi_prime(y)
    c_y = _row_sum(y * grad) - _row_sum(family.phi(y))
    return {"grad": grad, "c_y": c_y}
