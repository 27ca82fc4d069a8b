"""The mutable index: streaming insert / delete without a rebuild (port of
``repro.core.segments``).

A :class:`SegmentedForest` is one sealed main segment, a
:class:`~repro_torch.core.index.BallForest` from ``build_index``, plus one
append segment per :meth:`SegmentedForest.insert`:

* The main segment's partition, k-means centres, gamma-bucket edges and
  beta samples are frozen; every later mutation reuses them.
* An append segment shares them.  Its points are P-transformed with the
  sealed partition, assigned to the nearest existing centre per subspace
  (``clustering._assign``, over row chunks), bucketed with the sealed
  gamma edges, and given singleton corners (``alpha_min_pt = alpha``,
  ``sqrt_gamma_max_pt = sqrt_gamma``): the point's own lower bound, so the
  Theorem-3 test stays exact for it.
* :meth:`SegmentedForest.delete` overwrites a point's rows with the inert
  fill (``index.tombstone_rows``): every phase of every search skips it.
* :meth:`SegmentedForest.compact` re-seals everything into one main
  segment, by a merge (drop the dead rows, restore the shared layout with
  a stable sort on the card, refit the corner tables; no k-means) or a
  rebuild (``build_index`` over the live rows, original ids kept), as
  ``partition.decide_compaction`` rules over the fitted Theorem-4 cost
  model.

The point tables stay on the index's device through every mutation and
compaction; only the per-segment live masks and id lists are host numpy
bookkeeping.  Searches see one plain forest, :meth:`SegmentedForest.view`
(``index.concat_points``), and every entry point of core/search.py takes
either type.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import quantize as qz
from .bregman import BregmanFamily, validate_rows
from .clustering import _assign, cluster_stats
from .index import (BallForest, build_index, concat_points, point_fields,
                    refresh_envelopes, tombstone_rows)
from .partition import CostModel, decide_compaction, fit_cost_model
from .transform import p_transform_views

Tensor = torch.Tensor

# Stale fraction (appended + deleted over live) above which insert and
# delete compact on their own.
DEFAULT_COMPACT_THRESHOLD = 0.5


def _append_segment(main: BallForest, points, first_id: int) -> BallForest:
    """Seal ``points`` into a searchable segment of ``main``'s index.

    Only the per-point P-tuples, the nearest-centre assignment and the
    singleton corners are computed.  In the int8 tier the points are
    quantized first (fresh per-row affines) and the transforms run over
    the decoded rows; the corner codes round directionally from the true
    stats.
    """
    part, fam, dev = main.partition, main.family, main.device
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    if pts.ndim != 2 or pts.shape[1] != main.d:
        raise ValueError(f"expected (a, {main.d}) points, got "
                         f"{tuple(pts.shape)}")
    pts = pts.contiguous()
    if main.storage == "int8":
        codes, d_scale, d_zp = qz.quantize_rows(pts)
        pts = qz.dequantize_rows(codes, d_scale, d_zp, fam)
    sub = part.gather(pts)                          # (a, M, w)
    mask = part.subspace_mask(dev)
    p = p_transform_views(sub, mask, fam)
    alpha, sqrt_gamma = p["alpha"], p["sqrt_gamma"]

    # Nearest existing centre per subspace, then the sealed gamma-bucket
    # edges: build_index's effective segment id for the new points.
    a = pts.shape[0]
    nb = main.num_clusters // main.centers.shape[1]
    assign_eff = []
    for i in range(part.num_subspaces):
        ball = (_assign(sub[:, i, :].contiguous(), main.centers[i], mask[i],
                        fam) if a else
                torch.zeros(0, dtype=torch.long, device=dev))
        bucket = torch.searchsorted(main.gamma_edges[i].contiguous(),
                                    sqrt_gamma[:, i].contiguous(),
                                    side="left")
        assign_eff.append(ball * nb + bucket)
    assign_eff = torch.stack(assign_eff, dim=1).to(torch.int32)   # (a, M)

    ids = torch.arange(first_id, first_id + a, dtype=torch.int32, device=dev)
    if main.storage == "int8":
        seg = dataclasses.replace(
            main, data=codes, data_scale=d_scale, data_zp=d_zp,
            point_ids=ids, assign=assign_eff,
            **qz.encode_stat_tables(alpha, sqrt_gamma, alpha, sqrt_gamma))
    else:
        seg = dataclasses.replace(
            main, data=pts, point_ids=ids, alpha=alpha,
            sqrt_gamma=sqrt_gamma, assign=assign_eff, alpha_min_pt=alpha,
            sqrt_gamma_max_pt=sqrt_gamma)
    # The segment's own envelopes, so it is searchable alone too.
    return refresh_envelopes(seg)


@dataclasses.dataclass
class SegmentedForest:
    """A mutable index: a sealed main segment and append segments.

    ``live`` and ``ids_host`` (one numpy array per segment, main first)
    are host bookkeeping; the searchable tables stay on the device, so
    :meth:`view` is one concatenation there.
    """

    main: BallForest
    segments: list[BallForest]
    live: list[np.ndarray]          # bool mask per segment (0 = main)
    ids_host: list[np.ndarray]      # point ids per segment (-1 = dead)
    next_id: int
    cost_model: CostModel | None = None
    compact_threshold: float = DEFAULT_COMPACT_THRESHOLD
    _view: BallForest | None = dataclasses.field(default=None, init=False,
                                                 repr=False)

    @classmethod
    def from_forest(cls, forest: BallForest, *,
                    cost_model: CostModel | None = None,
                    compact_threshold: float = DEFAULT_COMPACT_THRESHOLD,
                    ) -> "SegmentedForest":
        ids = forest.point_ids.cpu().numpy()
        return cls(main=forest, segments=[], live=[ids >= 0],
                   ids_host=[ids.copy()],
                   next_id=int(ids.max(initial=-1)) + 1,
                   cost_model=cost_model,
                   compact_threshold=compact_threshold)

    # -- snapshot and counts ------------------------------------------------

    def view(self) -> BallForest:
        """One searchable forest over every segment (cached)."""
        if self._view is None:
            self._view = concat_points([self.main] + self.segments)
        return self._view

    @property
    def family(self) -> BregmanFamily:
        return self.main.family

    @property
    def family_name(self) -> str:
        return self.main.family_name

    @property
    def partition(self):
        return self.main.partition

    @property
    def num_clusters(self) -> int:
        return self.main.num_clusters

    @property
    def storage(self) -> str:
        return self.main.storage

    @property
    def device(self) -> torch.device:
        return self.main.device

    @property
    def calibration(self):
        """The main segment's fitted recall curve, if any: inserts and
        deletes leave it in place, :meth:`compact` refits it."""
        return self.main.calibration

    @property
    def n(self) -> int:
        """Rows of :meth:`view`, tombstones included."""
        return self.main.n + sum(s.n for s in self.segments)

    @property
    def d(self) -> int:
        return self.main.d

    @property
    def m(self) -> int:
        return self.main.m

    @property
    def live_n(self) -> int:
        return int(sum(int(mask.sum()) for mask in self.live))

    @property
    def appended_live(self) -> int:
        return int(sum(int(mask.sum()) for mask in self.live[1:]))

    @property
    def deleted_n(self) -> int:
        return self.n - self.live_n

    @property
    def append_fraction(self) -> float:
        return self.appended_live / max(self.live_n, 1)

    @property
    def stale_fraction(self) -> float:
        """Appended and deleted rows over live ones: the compaction
        pressure."""
        return (self.appended_live + self.deleted_n) / max(self.live_n, 1)

    def live_ids(self) -> np.ndarray:
        """Original ids of the live points, in layout order."""
        return np.concatenate(
            [ids[mask] for ids, mask in zip(self.ids_host, self.live,
                                            strict=True)])

    def append_row_range(self) -> tuple[int, int]:
        """``[start, stop)`` rows of :meth:`view` held by the append
        segments (the tail): the rows a tiered store pins."""
        return self.main.n, self.n

    # -- mutations ----------------------------------------------------------

    def insert(self, points, *, auto_compact: bool = True,
               validate: bool = False) -> np.ndarray:
        """Append ``points`` (a, d) as a new segment; returns their ids.

        One nearest-centre pass against the sealed centres.
        ``validate=True`` checks the family's domain first and raises,
        naming the row, before anything is sealed.
        """
        if validate:
            validate_rows(self.family, points, what="insert row")
        seg = _append_segment(self.main, points, self.next_id)
        ids = np.arange(self.next_id, self.next_id + seg.n, dtype=np.int32)
        self.segments.append(seg)
        self.live.append(np.ones(seg.n, dtype=bool))
        self.ids_host.append(ids.copy())
        self.next_id += seg.n
        self._view = None
        if auto_compact and self.stale_fraction > self.compact_threshold:
            self.compact()
        return ids

    def delete(self, ids, *, auto_compact: bool = True) -> int:
        """Tombstone the given original ids; returns how many were live.
        Unknown and already deleted ids are ignored."""
        ids = np.unique(np.asarray(ids, np.int64))
        removed = 0
        for b, block in enumerate([self.main] + self.segments):
            dead = np.isin(self.ids_host[b], ids) & self.live[b]
            if not dead.any():
                continue
            removed += int(dead.sum())
            self.live[b] = self.live[b] & ~dead
            self.ids_host[b][dead] = -1
            patched = tombstone_rows(block, torch.from_numpy(dead))
            if b == 0:
                self.main = patched
            else:
                self.segments[b - 1] = patched
        if removed:
            self._view = None
            if auto_compact and self.stale_fraction > self.compact_threshold:
                self.compact()
        return removed

    def find_invalid(self) -> np.ndarray:
        """Original ids of live rows outside the family's domain (NaN, inf
        or an open-domain violation), checked over ``rows_view()``, the
        rows the refine reads."""
        bad: list[np.ndarray] = []
        for b, ids, mask in zip([self.main] + self.segments, self.ids_host,
                                self.live, strict=True):
            if not mask.any():
                continue
            ok = validate_rows(self.family, b.rows_view(), mode="mask")
            bad_rows = mask & ~ok
            if bad_rows.any():
                bad.append(ids[bad_rows])
        if not bad:
            return np.empty((0,), np.int32)
        return np.concatenate(bad).astype(np.int32)

    def quarantine(self) -> np.ndarray:
        """Tombstone every live row :meth:`find_invalid` names, without an
        automatic compaction; returns their ids."""
        bad = self.find_invalid()
        if bad.size:
            self.delete(bad, auto_compact=False)
        return bad

    # -- compaction ---------------------------------------------------------

    def fitted_cost_model(self) -> CostModel:
        """The Theorem-4 model for merge against rebuild, fitted on a host
        copy of the live rows (cached until the next compaction)."""
        if self.cost_model is None:
            self.cost_model = fit_cost_model(
                self._live_rows().cpu().numpy(), self.family)
        return self.cost_model

    def decide(self) -> str:
        """``"merge"`` or ``"rebuild"`` by the cost model's rule."""
        return decide_compaction(self.fitted_cost_model(), self.m,
                                 stale_fraction=self.stale_fraction)

    def compact(self, mode: str | None = None, *, seed: int = 0) -> str:
        """Re-seal every segment into the main one and drop the tombstones.

        ``mode`` forces ``"merge"`` or ``"rebuild"``; None asks
        :meth:`decide`.  Original ids are kept either way.  A fitted recall
        curve is refit over the compacted index with its stored
        parameters, or dropped when fewer than its k rows stay live.
        """
        prev_cal = self.main.calibration
        if self.live_n == 0:
            # Nothing to model or cluster: the merge drops the dead rows.
            mode = "merge"
        elif mode is None:
            mode = self.decide()
        if mode not in ("merge", "rebuild"):
            raise ValueError(f"unknown compaction mode {mode!r}")
        self.main = self._rebuild(seed) if mode == "rebuild" else self._merge()
        self.segments = []
        ids = self.main.point_ids.cpu().numpy()
        if prev_cal is not None:
            from . import calibrate as _calibrate
            cal = None
            if self.main.n and int((ids >= 0).sum()) >= prev_cal.k:
                cal = _calibrate.fit_calibration(
                    self.main, k=prev_cal.k,
                    num_queries=prev_cal.num_queries,
                    p_grid=prev_cal.p_grid, seed=prev_cal.seed,
                    jitter=prev_cal.jitter)
            self.main = dataclasses.replace(self.main, calibration=cal)
        self.live = [ids >= 0]
        self.ids_host = [ids.copy()]
        self._view = None
        # The live set moved: refit the model at the next decision.
        self.cost_model = None
        return mode

    def _live_index(self) -> list[Tensor]:
        """Per segment, the device row indices of its live rows."""
        return [torch.from_numpy(np.flatnonzero(mask)).to(self.device)
                for mask in self.live]

    def _live_arrays(self, fields) -> dict:
        """The live rows of the given point-major fields, in layout order,
        gathered on the device."""
        blocks = [self.main] + self.segments
        rows = self._live_index()
        return {f: torch.cat([getattr(b, f)[r] for b, r in zip(
                    blocks, rows, strict=True)])
                for f in fields}

    def _live_rows(self) -> Tensor:
        """The live fp32 rows (decoded in the int8 tier), layout order, on
        the device."""
        if self.storage == "f32":
            return self._live_arrays(("data",))["data"]
        a = self._live_arrays(("data", "data_scale", "data_zp"))
        return qz.dequantize_rows(a["data"], a["data_scale"], a["data_zp"],
                                  self.family_name)

    def _rebuild(self, seed: int) -> BallForest:
        """``build_index`` over the live rows, on the index's device, the
        original ids kept.  In the int8 tier the decoded rows are
        quantized again, so a point may move by one step a coordinate; a
        merge keeps the codes."""
        ids = self._live_arrays(("point_ids",))["point_ids"]
        data = self._live_rows()
        num_centers = self.main.centers.shape[1]
        nb = max(self.main.num_clusters // num_centers, 1)
        forest = build_index(
            data, self.family_name, m=self.m,
            num_clusters=min(num_centers, data.shape[0]), gamma_buckets=nb,
            quantize=self.storage == "int8", seed=seed, device=self.device)
        # build_index's ids are positions in ``data``: map them back.
        return dataclasses.replace(forest,
                                   point_ids=ids[forest.point_ids.long()])

    def _merge(self) -> BallForest:
        """Keep the sealed centres and buckets, drop the dead rows, restore
        the shared layout and refit the corner tables.

        In the int8 tier the codes and their decode move as opaque rows
        (the stored points stay bit-equal); the corners are refit from a
        conservative decode of the stat codes (alpha half a step lower,
        sqrt_gamma half a step higher) and rounded directionally again.
        """
        fields = point_fields(self.main)
        arrays = self._live_arrays(fields)
        # The stable order of the reference's host argsort, on the device.
        order = torch.sort(arrays["assign"][:, 0], stable=True).indices
        arrays = {f: a[order] for f, a in arrays.items()}

        if self.storage == "int8":
            slack = torch.tensor(qz.UB_SLACK, dtype=torch.float32,
                                 device=self.device)
            alpha = qz.dequantize_stats(
                arrays["alpha"], arrays["alpha_scale"], arrays["alpha_zp"])
            sqrt_gamma = qz.dequantize_stats(
                arrays["sqrt_gamma"], arrays["sg_scale"], arrays["sg_zp"])
            alpha_lo = alpha - slack * arrays["alpha_scale"][:, None]
            sg_hi = sqrt_gamma + slack * arrays["sg_scale"][:, None]
        else:
            alpha = alpha_lo = arrays["alpha"]
            sqrt_gamma = sg_hi = arrays["sqrt_gamma"]
        assign = arrays["assign"]

        c_eff = self.num_clusters
        stats_a = [cluster_stats(alpha_lo[:, i], assign[:, i], c_eff)
                   for i in range(self.m)]
        amin = torch.stack([s["min"] for s in stats_a])
        counts = torch.stack([s["count"] for s in stats_a])
        gmax = torch.stack([cluster_stats(sg_hi[:, i], assign[:, i],
                                          c_eff)["max"]
                            for i in range(self.m)])
        assign_t = assign.long().T
        amin_pt = torch.gather(amin, 1, assign_t).T.contiguous()
        gmax_pt = torch.gather(gmax, 1, assign_t).T.contiguous()
        if self.storage == "int8":
            corners = qz.encode_corner_tables(amin_pt, gmax_pt)
            merged = dataclasses.replace(
                self.main,
                **{f: arrays[f] for f in fields if f not in corners},
                alpha_min=amin, sqrt_gamma_max=gmax, counts=counts,
                **corners)
        else:
            merged = dataclasses.replace(
                self.main, data=arrays["data"],
                point_ids=arrays["point_ids"], alpha=alpha,
                sqrt_gamma=sqrt_gamma, assign=assign, alpha_min=amin,
                sqrt_gamma_max=gmax, counts=counts, alpha_min_pt=amin_pt,
                sqrt_gamma_max_pt=gmax_pt)
        # The dead rows are gone and the layout re-sorted: refit the
        # envelopes exactly.
        return refresh_envelopes(merged)


def build_segmented_index(data, family, **build_kwargs) -> SegmentedForest:
    """``build_index`` (its keywords, ``device`` included) wrapped as the
    mutable index; ``compact_threshold`` sets the automatic compaction."""
    threshold = build_kwargs.pop("compact_threshold",
                                 DEFAULT_COMPACT_THRESHOLD)
    forest = build_index(data, family, **build_kwargs)
    return SegmentedForest.from_forest(forest, compact_threshold=threshold)
