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


def query_refine_constants(y: Tensor, family) -> dict:
    """``grad = f'(y)`` and ``c_y = sum_j (y_j grad_j) - f(y)``: with them
    ``D_f(x, y) = sum_j phi(x_j) - x . grad + c_y``."""
    grad = family.phi_prime(y)
    c_y = torch.sum(y * grad, dim=-1) - family.f(y)
    return {"grad": grad, "c_y": c_y}
