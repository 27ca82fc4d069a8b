"""The paper's CPU baselines (Table 1 / §9.1.1), port of
``repro.core.baselines``.

* ``BBTree``  — Cayton's Bregman-ball tree ("BBT"): hierarchical 2-means,
  best-first kNN with ball lower bounds.  Two bounds: the exact geodesic
  bisection of Cayton '08 (``bound='geodesic'``) and the tuple-space
  Cauchy bound (``bound='tuple'``).
* ``VAFile``  — Zhang et al.'s VA-file ("VAF"): per-dim scalar
  quantization, two-phase scan (approximation bounds, then exact
  refinement).
* ``linear_scan`` — the floor.

These run in numpy on the host, by design: they are the paper-fidelity
comparison points, not the accelerated path (reference baselines.py:11-12),
so unlike the port's other entry points they take no device.  Each search
returns (ids, dists, stats) where stats carries the I/O-cost proxy (bytes
of data touched) and candidate counts.

The data are held in float64 as in the reference, but every generator
value (``phi``, ``phi'``, its inverse, ``D_f``) is computed in float32
through the port's torch families, as the reference's run through jnp
with 64-bit values off: the 2-means splits and the VA cell tables follow
those float32 values.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from .bregman import get_family

F32 = 4  # bytes per float


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def _phi(fam, x):
    return fam.phi(_f32(x)).numpy()


def _phi_prime(fam, x):
    return fam.phi_prime(_f32(x)).numpy()


def _phi_prime_inv(fam, x):
    return fam.phi_prime_inv(_f32(x)).numpy()


def _distance(fam, xs, y):
    y = _f32(y)
    return fam.distance(_f32(xs), y[None] if y.ndim == 1 else y).numpy()


def linear_scan(data: np.ndarray, y: np.ndarray, k: int, family) -> tuple:
    fam = get_family(family) if isinstance(family, str) else family
    dist = _distance(fam, data, y)
    idx = np.argpartition(dist, min(k, len(dist) - 1))[:k]
    order = np.argsort(dist[idx])
    stats = {"bytes_moved": data.size * F32, "candidates": len(data),
             "distance_evals": len(data)}
    return idx[order], dist[idx][order], stats


# ---------------------------------------------------------------------------
# BB-tree (Cayton 2008; range search per Cayton 2009)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Node:
    center: np.ndarray
    radius: float
    alpha_min: float          # min over members of sum phi(x)
    sqrt_gamma_max: float     # max over members of ||x||
    points: np.ndarray | None = None   # leaf: member ids
    left: "._Node | None" = None
    right: "._Node | None" = None

    @property
    def is_leaf(self):
        return self.points is not None


class BBTree:
    """Memory-resident Bregman ball tree with best-first exact kNN."""

    def __init__(self, data, family, leaf_size: int = 32, seed: int = 0,
                 bound: str = "geodesic"):
        self.data = np.asarray(data, dtype=np.float64)
        self.family = get_family(family) if isinstance(family, str) else family
        self.leaf_size = leaf_size
        self.bound = bound
        self._rng = np.random.default_rng(seed)
        self._phi_sums = _phi(self.family, self.data).sum(-1)
        self._norms = np.sqrt((self.data ** 2).sum(-1))
        self.root = self._build(np.arange(len(self.data)))
        self.nodes_built = self._count(self.root)

    # -- construction ------------------------------------------------------
    def _make_node(self, ids):
        pts = self.data[ids]
        center = pts.mean(0)
        radius = float(_distance(self.family, pts, center).max())
        return _Node(center=center, radius=radius,
                     alpha_min=float(self._phi_sums[ids].min()),
                     sqrt_gamma_max=float(self._norms[ids].max()))

    def _build(self, ids):
        node = self._make_node(ids)
        if len(ids) <= self.leaf_size:
            node.points = ids
            return node
        # 2-means split (Bregman assignment, mean update)
        pts = self.data[ids]
        ci = self._rng.choice(len(ids), 2, replace=False)
        centers = pts[ci].copy()
        for _ in range(8):
            d0 = _distance(self.family, pts, centers[0])
            d1 = _distance(self.family, pts, centers[1])
            lab = (d1 < d0)
            if lab.all() or (~lab).all():
                break
            centers[0] = pts[~lab].mean(0)
            centers[1] = pts[lab].mean(0)
        if lab.all() or (~lab).all():      # degenerate: split by median norm
            lab = self._norms[ids] > np.median(self._norms[ids])
            if lab.all() or (~lab).all():
                node.points = ids
                return node
        node.left = self._build(ids[~lab])
        node.right = self._build(ids[lab])
        return node

    def _count(self, node):
        if node is None:
            return 0
        return 1 + self._count(node.left) + self._count(node.right)

    # -- bounds --------------------------------------------------------------
    def _lb_tuple(self, node, qstruct):
        qconst, sqrt_delta = qstruct["qconst"], qstruct["sqrt_delta"]
        return node.alpha_min + qconst - node.sqrt_gamma_max * sqrt_delta

    def _lb_geodesic(self, node, y, iters: int = 24):
        """Cayton's bisection on the dual geodesic between q and the center."""
        fam = self.family
        gy = _phi_prime(fam, y)
        gc = _phi_prime(fam, node.center)
        if float(_distance(fam, node.center[None], y)[0]) <= node.radius:
            return 0.0
        lo, hi = 0.0, 1.0   # theta: 0 -> query side, 1 -> center
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            x = _phi_prime_inv(fam, mid * gc + (1 - mid) * gy)
            inside = float(_distance(fam, x[None], node.center)[0]) <= node.radius
            if inside:
                hi = mid
            else:
                lo = mid
        x = _phi_prime_inv(fam, hi * gc + (1 - hi) * gy)
        return max(0.0, float(_distance(fam, x[None], y)[0]))

    def _lb(self, node, y, qstruct):
        if self.bound == "tuple":
            return self._lb_tuple(node, qstruct)
        return self._lb_geodesic(node, y)

    def _qstruct(self, y):
        g = _phi_prime(self.family, y)
        return {
            "qconst": float(-_phi(self.family, y).sum() + (y * g).sum()),
            "sqrt_delta": float(np.sqrt((g * g).sum())),
        }

    # -- queries -------------------------------------------------------------
    def knn(self, y, k):
        y = np.asarray(y, dtype=np.float64)
        qs = self._qstruct(y)
        heap = [(self._lb(self.root, y, qs), 0, self.root)]
        best: list = []          # max-heap of (-dist, id)
        tick = 1
        stats = {"bytes_moved": 0, "candidates": 0, "distance_evals": 0,
                 "nodes_visited": 0}
        while heap:
            lb, _, node = heapq.heappop(heap)
            if len(best) == k and lb > -best[0][0]:
                continue
            stats["nodes_visited"] += 1
            if node.is_leaf:
                d = _distance(self.family, self.data[node.points], y)
                stats["distance_evals"] += len(node.points)
                stats["candidates"] += len(node.points)
                stats["bytes_moved"] += len(node.points) * self.data.shape[1] * F32
                for di, pid in zip(d, node.points, strict=True):
                    if len(best) < k:
                        heapq.heappush(best, (-di, pid))
                    elif di < -best[0][0]:
                        heapq.heapreplace(best, (-di, pid))
            else:
                for child in (node.left, node.right):
                    clb = self._lb(child, y, qs)
                    if len(best) < k or clb <= -best[0][0]:
                        heapq.heappush(heap, (clb, tick, child))
                        tick += 1
        out = sorted([(-nd, pid) for nd, pid in best])
        ids = np.array([pid for _, pid in out])
        dists = np.array([d for d, _ in out])
        return ids, dists, stats

    def range_query(self, y, r):
        """Cayton '09-style range search; returns ids with D_f(x, y) <= r."""
        y = np.asarray(y, dtype=np.float64)
        qs = self._qstruct(y)
        out, stack = [], [self.root]
        stats = {"bytes_moved": 0, "candidates": 0, "nodes_visited": 0}
        while stack:
            node = stack.pop()
            if self._lb(node, y, qs) > r:
                continue
            stats["nodes_visited"] += 1
            if node.is_leaf:
                d = _distance(self.family, self.data[node.points], y)
                stats["candidates"] += len(node.points)
                stats["bytes_moved"] += len(node.points) * self.data.shape[1] * F32
                out.extend(node.points[d <= r].tolist())
            else:
                stack.extend([node.left, node.right])
        return np.asarray(sorted(out), dtype=np.int64), stats


# ---------------------------------------------------------------------------
# VA-file (Zhang et al. 2009 — extended-space scalar quantization)
# ---------------------------------------------------------------------------

class VAFile:
    """Per-dimension quantile grid; two-phase exact kNN scan."""

    def __init__(self, data, family, bits: int = 4):
        self.data = np.asarray(data, dtype=np.float64)
        self.family = get_family(family) if isinstance(family, str) else family
        self.bits = bits
        n, d = self.data.shape
        cells = 1 << bits
        qs = np.linspace(0, 1, cells + 1)
        # (d, cells+1) boundaries via per-dim quantiles
        self.bounds = np.quantile(self.data, qs, axis=0).T
        self.bounds[:, 0] -= 1e-9
        self.bounds[:, -1] += 1e-9
        self.cells = np.empty((n, d), dtype=np.int16)
        for j in range(d):
            self.cells[:, j] = np.clip(
                np.searchsorted(self.bounds[j], self.data[:, j], side="right") - 1,
                0, cells - 1)
        self.approx_bytes = n * d * bits / 8.0

    def _cell_tables(self, y):
        """Per-(dim, cell) min/max of the per-dim distance term (convex in x)."""
        fam = self.family
        lo, hi = self.bounds[:, :-1], self.bounds[:, 1:]       # (d, cells)
        yj = y[:, None]
        gy = _phi_prime(fam, yj)
        phiy = _phi(fam, yj)

        def term(x):
            return _phi(fam, x) - phiy - gy * (x - yj)

        t_lo, t_hi = term(lo), term(hi)
        # min of a convex fn on [lo, hi]: at clamp(y); max: at an endpoint
        inside = (yj >= lo) & (yj <= hi)
        tmin = np.where(inside, 0.0, np.minimum(t_lo, t_hi))
        tmax = np.maximum(t_lo, t_hi)
        return tmin, tmax

    def knn(self, y, k):
        y = np.asarray(y, dtype=np.float64)
        n, d = self.data.shape
        tmin, tmax = self._cell_tables(y)                      # (d, cells)
        cols = np.arange(d)
        lb = tmin[cols, self.cells].sum(-1)                    # (n,)
        ub = tmax[cols, self.cells].sum(-1)
        tau = np.partition(ub, min(k - 1, n - 1))[min(k - 1, n - 1)]
        cand = np.flatnonzero(lb <= tau)
        dist = _distance(self.family, self.data[cand], y)
        idx = np.argpartition(dist, min(k - 1, len(cand) - 1))[:k]
        order = np.argsort(dist[idx])
        stats = {
            "bytes_moved": self.approx_bytes + cand.size * d * F32,
            "candidates": int(cand.size),
            "distance_evals": int(cand.size),
        }
        return cand[idx[order]], dist[idx[order]], stats
