"""Recall calibration: the §8 approximate knob as a measured recall (port of
``repro.core.calibrate``).

The approximate search (paper §8, ``core/search.py``) shrinks the Alg.-4
filter bounds by a factor derived from the empirical beta_xy CDF at a
guarantee level ``p_guarantee``.  Prop. 1 ties ``p`` to the probability
that any single pruned point was a true neighbour, not to recall@k, which
is what callers care about and which depends on the data, the family, k
and the index layout.  This module makes the mapping empirical:

* :func:`fit_calibration` sweeps a ``p`` grid over a held-out query sample
  (jittered live rows: in distribution, and inside every family's domain),
  measures recall@k against the exact oracle (``_brute_force_live``) and
  makes the curve monotone (recall is non-decreasing in ``p`` in
  expectation; the running maximum removes sampling noise).  The sweep
  runs the batched approximate search (``knn_batch(approx_p=p)``) on the
  index's device.
* :class:`RecallCalibration` stores the fitted curve as host numpy on
  ``BallForest.calibration``, a host-only field that is never moved to a
  device and survives every ``dataclasses.replace`` of the forest.
* :func:`resolve_p_guarantee` inverts the curve conservatively: the
  smallest grid ``p`` whose measured recall meets the target, with that
  measured recall as the ``expected_recall`` estimate.  An uncalibrated
  index falls back to ``p = target`` with a one-time warning.

Lifecycle: fitted at ``build_index(calibrate=True)`` time, or attached
later by :func:`ensure_calibration`.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)

# Default guarantee grid: dense near the top where the recall curve is
# steepest (and where targets live), sparse below.
DEFAULT_P_GRID = (0.0, 0.2, 0.4, 0.6, 0.7, 0.8, 0.9, 0.95, 0.99, 1.0)
DEFAULT_NUM_QUERIES = 64
DEFAULT_JITTER = 0.05

_warned_uncalibrated = False


@dataclasses.dataclass(frozen=True)
class RecallCalibration:
    """A fitted ``p_guarantee`` -> measured recall@k curve (host-side).

    ``p_grid`` is ascending and ends at 1.0 (the no-shrink point);
    ``recall_grid`` is the monotone measured recall@``k`` at each grid
    point.  ``num_queries`` / ``seed`` / ``jitter`` record the fit so it
    can be repeated with the same settings.
    """

    p_grid: np.ndarray          # (G,) ascending guarantee levels
    recall_grid: np.ndarray     # (G,) measured recall@k, non-decreasing
    k: int
    num_queries: int
    seed: int
    jitter: float = DEFAULT_JITTER

    def __post_init__(self):
        # Accept tuples and lists (hand-built curves) but store arrays.
        object.__setattr__(self, "p_grid",
                           np.asarray(self.p_grid, np.float64))
        object.__setattr__(self, "recall_grid",
                           np.asarray(self.recall_grid, np.float64))

    def expected_recall(self, p: float) -> float:
        """Measured recall estimate at guarantee level ``p`` (interpolated)."""
        return float(np.interp(float(p), self.p_grid, self.recall_grid))

    def resolve(self, target_recall: float) -> tuple[float, float]:
        """Smallest grid ``p`` whose measured recall meets the target.

        Returns ``(p_guarantee, expected_recall)``.  An achievable target
        gets the cheapest grid point that met it during the fit (never an
        interpolated p, whose recall was not measured); a target above
        everything the fit achieved gets ``p = 1.0`` (the unshrunk §8
        search) and the lower measured estimate.
        """
        t = float(target_recall)
        if not 0.0 <= t <= 1.0:
            raise ValueError(f"target_recall must be in [0, 1], got {t}")
        idx = int(np.searchsorted(self.recall_grid, t, side="left"))
        if idx >= self.p_grid.shape[0]:
            return float(self.p_grid[-1]), float(self.recall_grid[-1])
        return float(self.p_grid[idx]), float(self.recall_grid[idx])


def as_calibration(curve) -> RecallCalibration | None:
    """A fitted curve from any object with the fields of
    :class:`RecallCalibration` (one saved, or fitted by the reference
    package), as host numpy; None stays None."""
    if curve is None:
        return None
    return RecallCalibration(
        p_grid=np.array(curve.p_grid, np.float64),
        recall_grid=np.array(curve.recall_grid, np.float64),
        k=int(curve.k), num_queries=int(curve.num_queries),
        seed=int(curve.seed), jitter=float(curve.jitter))


def _recall_at_k(ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Mean fraction of oracle ids recovered, set-wise per query row."""
    hits = 0
    for row, truth in zip(ids, true_ids, strict=True):
        hits += len(set(row.tolist()) & set(truth.tolist()))
    return hits / true_ids.size


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def held_out_queries(index, num_queries: int, seed: int,
                     jitter: float = DEFAULT_JITTER) -> np.ndarray:
    """An in-distribution held-out query sample: jittered live rows.

    Multiplicative log-normal jitter keeps every positive-domain family
    (Itakura-Saito, Burg, Shannon) inside its open domain and perturbs
    each coordinate by about ``jitter`` relative.  The rows come to the
    host and numpy's ``default_rng(seed)`` draws the sample, so the
    queries do not depend on the index's device.  A mutable index is
    sampled through its ``view()``.
    """
    from .search import _as_forest
    forest = _as_forest(index)
    rows = _host(forest.rows_view())
    live = np.flatnonzero(_host(forest.point_ids) >= 0)
    if live.size == 0:
        raise ValueError("cannot sample held-out queries: no live rows")
    rng = np.random.default_rng(seed)
    pick = rng.choice(live, size=num_queries, replace=live.size < num_queries)
    qs = rows[pick] * np.exp(
        jitter * rng.standard_normal((num_queries, rows.shape[1])))
    return np.asarray(qs, np.float32)


def fit_calibration(index, *, k: int = 10,
                    num_queries: int = DEFAULT_NUM_QUERIES,
                    p_grid=None, seed: int = 0,
                    jitter: float = DEFAULT_JITTER) -> RecallCalibration:
    """Measure recall@``k`` over a ``p_guarantee`` grid for this index, on
    the index's device.

    The oracle is the live-row linear scan (int8 rows decoded), so the
    measured recall is over exactly the point set the approximate search
    searches.  A mutable index is measured through its ``view()``.
    """
    from .search import _as_forest, _brute_force_live, knn_batch
    index = _as_forest(index, k)
    grid = np.asarray(DEFAULT_P_GRID if p_grid is None else p_grid,
                      np.float64)
    if grid.ndim != 1 or grid.size < 2 or np.any(np.diff(grid) <= 0):
        raise ValueError("p_grid must be a strictly ascending 1-D grid")
    if grid[-1] != 1.0:
        raise ValueError("p_grid must end at 1.0 (the no-shrink point)")
    live = int(np.sum(_host(index.point_ids) >= 0))
    num_queries = max(1, min(int(num_queries), max(live, 1)))
    qs = torch.from_numpy(held_out_queries(index, num_queries, seed,
                                           jitter)).to(index.device)
    true_ids, _ = _brute_force_live(index, qs, k)
    true_ids = _host(true_ids)
    rec = np.empty(grid.shape[0], np.float64)
    for i, p in enumerate(grid):
        res = knn_batch(index, qs, k, approx_p=float(p), validate=False,
                        device=index.device)
        rec[i] = _recall_at_k(_host(res.ids), true_ids)
    # Isotonic projection: recall is non-decreasing in p in expectation;
    # the running max removes finite-sample wiggles while never promising
    # more than some grid point actually measured.
    rec = np.maximum.accumulate(rec)
    return RecallCalibration(p_grid=grid, recall_grid=rec, k=k,
                             num_queries=num_queries, seed=seed,
                             jitter=float(jitter))


def validate_target_recall(target_recall) -> None:
    """Range-gate a raw ``target_recall`` knob (None = knob unused), for
    entry points that accept it but resolve it later."""
    if target_recall is None:
        return
    t = float(target_recall)
    if not 0.0 <= t <= 1.0:    # False for NaN too
        raise ValueError(f"target_recall must be in [0, 1], got {t}")


def resolve_p_guarantee(index, target_recall: float):
    """Invert an index's calibration curve: target recall -> (p, expected).

    Returns ``(p_guarantee, expected_recall)``.  ``expected_recall`` is the
    fit's measured recall at the chosen grid point, or ``None`` when the
    index carries no calibration; then ``p = target_recall``, announced
    once per process.
    """
    cal = getattr(index, "calibration", None)
    if cal is None:
        global _warned_uncalibrated
        if not _warned_uncalibrated:
            _warned_uncalibrated = True
            logger.warning(
                "target_recall=%s requested on an uncalibrated index; "
                "falling back to p_guarantee=target_recall. Build with "
                "build_index(calibrate=True) for a measured recall "
                "contract.", target_recall)
        t = float(target_recall)
        if not 0.0 <= t <= 1.0:
            raise ValueError(f"target_recall must be in [0, 1], got {t}")
        return t, None
    return cal.resolve(target_recall)


def ensure_calibration(index, *, k: int = 10,
                       num_queries: int = DEFAULT_NUM_QUERIES,
                       p_grid=None, seed: int = 0,
                       jitter: float = DEFAULT_JITTER):
    """Attach a fitted curve to an index that lacks one; returns the index.

    A BallForest comes back as a ``dataclasses.replace`` copy; a mutable
    index (one with a sealed ``main`` segment) is updated in place, its
    main segment carrying the curve, and its cached snapshot dropped so
    the next ``view()`` carries the curve too.
    """
    if getattr(index, "calibration", None) is not None:
        return index
    cal = fit_calibration(index, k=k, num_queries=num_queries,
                          p_grid=p_grid, seed=seed, jitter=jitter)
    if hasattr(index, "main"):
        index.main = dataclasses.replace(index.main, calibration=cal)
        index._view = None
        return index
    return dataclasses.replace(index, calibration=cal)
