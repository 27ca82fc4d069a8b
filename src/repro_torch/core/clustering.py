"""Bregman k-means for the ball-forest index (port of ``repro.core.clustering``).

Assignment minimizes ``D_f(x, c)`` (data in the first slot); the optimal
center for that orientation is the arithmetic mean of the cluster, so Lloyd
iterations are exact.  Pairwise distances use the product form

    D_f(x, c) = sum_j f(x_j)  -  x . f'(c)  +  [c . f'(c) - f(c)]

one (n, w) x (w, C) product per iteration.  The assignment step runs over
row chunks, so the (n, C) distance matrix never exists whole: at n = 10^6
and C = 8192 it would take 32 GB.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

# Elements of one (rows, C) distance chunk of the assignment step.
ASSIGN_CHUNK_ELEMS = 1 << 28


def pairwise_bregman(x: Tensor, centers: Tensor, mask: Tensor, family) -> Tensor:
    """D_f(x_i, c_j) for all pairs, masked dims excluded. (n, C)."""
    mask = mask[None, :]
    fx = torch.sum(family.phi(x) * mask, dim=-1)                     # (n,)
    g = family.phi_prime(centers) * mask                             # (C, w)
    cconst = torch.sum(centers * g - family.phi(centers) * mask, dim=-1)  # (C,)
    cross = x @ g.T                                                  # (n, C)
    return fx[:, None] - cross + cconst[None, :]


def _assign(points: Tensor, centers: Tensor, mask: Tensor, family) -> Tensor:
    """argmin_c D_f(x, c) per row, over row chunks. (n,) int64."""
    n = points.shape[0]
    rows = max(1, ASSIGN_CHUNK_ELEMS // max(centers.shape[0], 1))
    return torch.cat([
        torch.argmin(pairwise_bregman(points[s:s + rows], centers, mask,
                                      family), dim=-1)
        for s in range(0, n, rows)])


def _cluster_sums(points: Tensor, assign: Tensor, c: int) -> Tensor:
    """Per-cluster row sums, (c, w).  ``index_add_`` adds the rows in
    order on the CPU but with atomics in no fixed order on the card, where
    the centres, and so the whole build, would then differ from run to
    run; ``index_put_(accumulate=True)`` sorts the indices there and adds
    each cluster's rows in a fixed order."""
    out = torch.zeros((c, points.shape[1]), dtype=points.dtype,
                      device=points.device)
    if points.is_cuda:
        return out.index_put_((assign,), points, accumulate=True)
    return out.index_add_(0, assign, points)


def kmeans(
    points: Tensor,
    mask: Tensor,
    *,
    family,
    num_clusters: int,
    iters: int = 12,
    generator: torch.Generator | None = None,
    init_idx: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Lloyd iterations; returns (centers (C, w), assignment (n,) int64).

    The initial centers are the rows ``init_idx`` when given, else
    ``num_clusters`` distinct rows drawn with ``generator``.  Empty clusters
    keep their previous center.
    """
    n, w = points.shape
    c = num_clusters
    if init_idx is None:
        init_idx = torch.randperm(n, generator=generator)[:c]
    centers = points[torch.as_tensor(init_idx, device=points.device)]
    ones = torch.ones((n,), dtype=points.dtype, device=points.device)
    for _ in range(iters):
        assign = _assign(points, centers, mask, family)
        sums = _cluster_sums(points, assign, c)
        # Counts are whole numbers, exact in any order of addition.
        cnts = torch.zeros((c,), dtype=points.dtype,
                           device=points.device).index_add_(0, assign, ones)
        means = sums / torch.clamp(cnts, min=1.0)[:, None]
        centers = torch.where((cnts > 0)[:, None], means, centers)
    return centers, _assign(points, centers, mask, family)


def cluster_stats(values: Tensor, assign: Tensor, num_clusters: int) -> dict:
    """Per-cluster min/max/count of a per-point scalar (for pruning bounds).

    Empty clusters get the impossible interval (min = finfo.max, max = 0),
    so the pruning test never admits them.
    """
    big = torch.finfo(values.dtype).max
    assign = assign.long()
    vmin = torch.full((num_clusters,), big, dtype=values.dtype,
                      device=values.device).scatter_reduce(
        0, assign, values, reduce="amin", include_self=False)
    vmax = torch.zeros((num_clusters,), dtype=values.dtype,
                       device=values.device).scatter_reduce(
        0, assign, values, reduce="amax", include_self=False)
    cnt = torch.zeros((num_clusters,), dtype=values.dtype,
                      device=values.device).index_add_(
        0, assign, torch.ones_like(values))
    return {"min": vmin, "max": vmax, "count": cnt}
