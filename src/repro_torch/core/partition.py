"""Partition-count optimization (Theorem 4) and PCCP (paper §5).

Port of ``repro.core.partition``.  Everything here is offline
precomputation on the host: numpy, with the transforms run as CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bregman import BregmanFamily
from .transform import Partition, make_partition, p_transform, q_transform
from . import bounds


# ---------------------------------------------------------------------------
# Theorem 4 — optimized number of partitions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CostModel:
    """Fitted parameters of the paper's online cost model.

    UB(M) = A * alpha**M   (exponential bound decay; paper §5.1)
    lambda = beta * UB     (pruning fraction proportional to the bound)
    """

    a: float
    alpha: float
    beta: float
    n: int
    d: int

    def candidates(self, m: int) -> float:
        """Expected candidate-set size at M partitions: beta*A*alpha^M*n."""
        return self.beta * self.a * (self.alpha ** m) * self.n

    def online_cost(self, m: int, k: int = 1) -> float:
        """T(M) = d + M n + n log k + beta A alpha^M n (d + log k)."""
        logk = np.log(max(k, 2))
        cand = self.candidates(m)
        return self.d + m * self.n + self.n * logk + cand * (self.d + logk)

    def build_cost(self, m: int, kmeans_iters: int = 12) -> float:
        """Offline rebuild cost: ``iters`` (n, w) x (w, C) products per
        subspace with C ~ n/32."""
        c = float(np.clip(self.n // 32, 8, 8192))
        return kmeans_iters * self.n * (self.d / max(m, 1)) * c * m

    def m_star(self, k: int = 1) -> int:
        """Theorem 4: M* = log_alpha( 2n / (-mu ln(alpha) (d + log k)) ),
        mu = beta*A*n, evaluated at floor and ceil and clamped to [1, d]."""
        mu = self.beta * self.a * self.n
        logk = np.log(max(k, 2)) if k > 1 else 0.0
        inner = 2.0 * self.n / (-mu * np.log(self.alpha) * (self.d + logk))
        if inner <= 0:
            return max(1, min(self.d, int(np.sqrt(self.d))))
        m_frac = np.log(inner) / np.log(self.alpha)
        lo = int(np.floor(m_frac))
        hi = lo + 1
        best, best_cost = 1, np.inf
        for m in (lo, hi):
            m = int(np.clip(m, 1, self.d))
            c = self.online_cost(m, k)
            if c < best_cost:
                best, best_cost = m, c
        return best


def fit_cost_model(
    data: np.ndarray,
    family: BregmanFamily,
    num_samples: int = 50,
    m_probe: tuple[int, int] = (2, 8),
    seed: int = 0,
) -> CostModel:
    """Fit A, alpha, beta from sampled point pairs (paper §5.1).

    * A, alpha: fit UB = A*alpha^M through the mean UB at two probe values
      of M over sampled (point, query) pairs.
    * beta: mean fraction of points whose exact distance falls inside a
      sample's UB, divided by that UB (lambda = beta * UB).
    """
    data = np.asarray(data, dtype=np.float32)
    n, d = data.shape
    rng = np.random.default_rng(seed)
    num_samples = min(num_samples, n // 2) or 1
    xi = rng.choice(n, size=num_samples, replace=False)
    yi = rng.choice(n, size=num_samples, replace=False)

    m1, m2 = m_probe
    m1 = int(np.clip(m1, 1, d))
    m2 = int(np.clip(m2, m1 + 1, d)) if d > m1 else m1 + 1

    def mean_ub(m: int) -> float:
        part = make_partition(d, m)
        p = p_transform(torch.from_numpy(data[xi]), part, family)
        q = q_transform(torch.from_numpy(data[yi]), part, family)
        comp = bounds.ub_components(
            {k_: v.numpy() for k_, v in p.items()},
            {k_: v.numpy() for k_, v in q.items() if v.ndim == 2},
        )
        return float(np.mean(np.sum(comp, axis=-1)))

    ub1, ub2 = mean_ub(m1), mean_ub(m2)
    ub1 = max(ub1, 1e-9)
    ub2 = max(min(ub2, ub1 * (1 - 1e-6)), 1e-9)  # enforce decay for the fit
    alpha = float((ub2 / ub1) ** (1.0 / (m2 - m1)))
    alpha = float(np.clip(alpha, 1e-4, 1.0 - 1e-4))
    a = float(ub1 / (alpha ** m1))

    # beta: pruning fraction per unit bound, measured on a data subsample.
    sub = torch.from_numpy(data[rng.choice(n, size=min(n, 2048), replace=False)])
    lam = []
    for i in range(min(8, num_samples)):
        y = torch.from_numpy(data[yi[i]])
        ub = a * alpha ** m1  # representative bound magnitude
        dist = family.distance(sub, y[None, :]).numpy()
        lam.append(np.mean(dist <= ub) / max(ub, 1e-9))
    beta = float(np.clip(np.mean(lam), 1e-8, 1e3))
    return CostModel(a=a, alpha=alpha, beta=beta, n=n, d=d)


# ---------------------------------------------------------------------------
# Merge-vs-rebuild decision for a mutable index
# ---------------------------------------------------------------------------

# Queries a compaction is amortized over before its cost "counts".
COMPACT_AMORTIZE_QUERIES = 2048


def decide_compaction(
    model: CostModel,
    m: int,
    *,
    stale_fraction: float,
    amortize_queries: int = COMPACT_AMORTIZE_QUERIES,
    k: int = 1,
) -> str:
    """``"merge"`` or ``"rebuild"`` for a segmented forest (Theorem-4 model).

    A merge inflates the expected candidate set by roughly the stale
    fraction; a rebuild pays :meth:`CostModel.build_cost` once, amortized
    over ``amortize_queries``.  Pick whichever per-query cost is lower.
    """
    base = model.online_cost(m, k)
    cost_merge = base + stale_fraction * model.candidates(m) * (
        model.d + np.log(max(k, 2)))
    cost_rebuild = base + model.build_cost(m) / max(amortize_queries, 1)
    return "rebuild" if cost_rebuild < cost_merge else "merge"


# ---------------------------------------------------------------------------
# PCCP — Pearson Correlation Coefficient-based Partition (paper §5.2)
# ---------------------------------------------------------------------------

def correlation_matrix(data: np.ndarray) -> np.ndarray:
    """|Pearson correlation| between all dimension pairs (d, d)."""
    x = np.asarray(data, dtype=np.float64)
    x = x - x.mean(axis=0, keepdims=True)
    std = np.sqrt((x * x).mean(axis=0))
    std = np.where(std < 1e-12, 1.0, std)
    corr = (x.T @ x) / (x.shape[0] * std[:, None] * std[None, :])
    np.fill_diagonal(corr, 0.0)
    return np.abs(corr)


def pccp_order(corr: np.ndarray, m: int, seed: int = 0) -> np.ndarray:
    """PCCP dim order: greedy correlation groups, then deal across partitions.

    Groups of (up to) ``M`` dims grow greedily with the dim most correlated
    to any dim already in the group (first dim random); partition ``j``
    takes the j-th member of every group, so each partition samples every
    correlation cluster.  Returns the order for :func:`make_partition`.
    """
    d = corr.shape[0]
    rng = np.random.default_rng(seed)
    unassigned = set(range(d))
    groups: list[list[int]] = []
    while unassigned:
        first = int(rng.choice(sorted(unassigned)))
        group = [first]
        unassigned.discard(first)
        while len(group) < m and unassigned:
            cand = np.fromiter(unassigned, dtype=np.int64)
            sub = corr[np.ix_(group, cand)]       # (|group|, |cand|)
            best = cand[int(np.argmax(sub.max(axis=0)))]
            group.append(int(best))
            unassigned.discard(int(best))
        groups.append(group)
    partitions: list[list[int]] = [[] for _ in range(m)]
    for g in groups:
        for j, dim in enumerate(g):
            partitions[j % m].append(dim)
    order: list[int] = []
    for pdim in partitions:
        order.extend(pdim)
    return np.asarray(order, dtype=np.int32)


def build_pccp_partition(
    data: np.ndarray, m: int, seed: int = 0, corr: np.ndarray | None = None
) -> Partition:
    """Full PCCP pipeline: correlations -> order -> Partition layout (the
    dealt order is cut into equal ``w``-sized chunks)."""
    if corr is None:
        corr = correlation_matrix(data)
    order = pccp_order(corr, m, seed)
    return make_partition(corr.shape[0], m, order=order)
