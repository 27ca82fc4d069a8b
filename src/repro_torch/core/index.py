"""BallForest — the flat Bregman-ball forest (port of ``repro.core.index``).

One flat Bregman-ball table per subspace, all indexing the SAME physical
point order: points are sorted by the first subspace's cluster id, so
candidate gathers from different subspaces touch overlapping rows.

Pruning uses the tuple-space cluster lower bound

    LB_cluster(i) = alpha_min[c,i] + qconst[i] - sqrt_gamma_max[c,i]*sqrt_delta[i]
                  <= min_{x in c} D_f(x_i., y_i.)

so "LB_cluster > qb_i" prunes cluster c in subspace i without evaluating a
member distance.  Two storage tiers share the one dataclass: ``"f32"`` and
``"int8"`` (codes plus per-row decode fields, core/quantize.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from . import quantize as qz
from .bregman import BregmanFamily, get_family
from .clustering import cluster_stats, kmeans
from .partition import build_pccp_partition, fit_cost_model
from .transform import Partition, make_partition, p_transform

Tensor = torch.Tensor


@dataclasses.dataclass
class BallForest:
    """Search index: its tables on one device.

    In the ``"int8"`` tier ``data``, ``alpha``, ``sqrt_gamma``,
    ``alpha_min_pt`` and ``sqrt_gamma_max_pt`` hold int8 codes and the
    ``*_scale`` / ``*_zp`` fields their per-row affine decode; the point
    set is the decoded rows (:meth:`rows_view`).  The envelopes are fp32
    in both tiers, reduced over the decoded corners in int8.
    """

    family_name: str
    partition: Partition
    num_clusters: int
    data: Tensor              # (n, d)  points in shared layout order
    point_ids: Tensor         # (n,)    int32 original ids (layout -> original)
    alpha: Tensor             # (n, M)  P-tuple alpha
    sqrt_gamma: Tensor        # (n, M)  P-tuple sqrt(gamma)
    assign: Tensor            # (n, M)  int32 bucketed cluster id per subspace
    alpha_min: Tensor         # (M, C)  per-cluster min alpha
    sqrt_gamma_max: Tensor    # (M, C)  per-cluster max sqrt(gamma)
    counts: Tensor            # (M, C)
    centers: Tensor           # (M, C0, w) k-means centers
    beta_samples: Tensor      # (S,) sorted empirical beta_xy sample
    alpha_min_pt: Tensor      # (n, M)  own-cluster corner alpha_min per point
    sqrt_gamma_max_pt: Tensor  # (n, M) own-cluster corner sqrt_gamma_max per point
    gamma_edges: Tensor       # (M, nb-1) gamma-bucket quantile edges
    storage: str = "f32"
    # Corner envelopes over ENV_BLOCK_ROWS-row groups of the layout: row e
    # holds the tightest alpha_min / loosest sqrt_gamma_max of its rows.
    env_alpha_min: Tensor | None = None        # (nE, M)
    env_sqrt_gamma_max: Tensor | None = None   # (nE, M)
    data_scale: Tensor | None = None
    data_zp: Tensor | None = None
    alpha_scale: Tensor | None = None
    alpha_zp: Tensor | None = None
    sg_scale: Tensor | None = None
    sg_zp: Tensor | None = None
    amin_scale: Tensor | None = None
    amin_zp: Tensor | None = None
    gmax_scale: Tensor | None = None
    gmax_zp: Tensor | None = None
    # Host-only recall calibration (core/calibrate.py RecallCalibration):
    # numpy, never moved to a device nor counted in its bytes; it rides
    # along through every dataclasses.replace of the forest.
    calibration: object | None = None

    @property
    def family(self) -> BregmanFamily:
        return get_family(self.family_name)

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def d(self) -> int:
        return self.data.shape[1]

    @property
    def m(self) -> int:
        return self.partition.num_subspaces

    @property
    def device(self) -> torch.device:
        # point_ids is a hot table: a tiered store's hot forest keeps it on
        # the device while its cold tables are shape-only meta tensors.
        return self.point_ids.device

    def rows_view(self) -> Tensor:
        """(n, d) fp32 point rows — the point set this index searches.  In
        the int8 tier this decodes the whole table: for oracles and the
        brute-force escape, never the per-query path."""
        if self.storage == "f32":
            return self.data
        return qz.dequantize_rows(self.data, self.data_scale, self.data_zp,
                                  self.family_name)


# Row-group size of the corner envelopes.
ENV_BLOCK_ROWS = 256

# Point-major (n, ...) fields, and the small per-cluster / sample tables.
POINT_FIELDS = ("data", "point_ids", "alpha", "sqrt_gamma", "assign",
                "alpha_min_pt", "sqrt_gamma_max_pt")
ENV_FIELDS = ("env_alpha_min", "env_sqrt_gamma_max")
QUANT_FIELDS = ("data_scale", "data_zp", "alpha_scale", "alpha_zp",
                "sg_scale", "sg_zp", "amin_scale", "amin_zp",
                "gmax_scale", "gmax_zp")
REPLICATED_FIELDS = ("alpha_min", "sqrt_gamma_max", "counts", "centers",
                     "beta_samples", "gamma_edges") + ENV_FIELDS

# Residency tiers (core/tiered.py).  The COLD point-major fields are the
# ones only the post-filter stages read: the (n, d) rows the refine kernel
# reads and the (n, M) per-point corners the Theorem-3 prune reads, the
# tables the envelope gate can veto a block of before any fetch.  The rest
# is HOT: the filter streams alpha / sqrt_gamma for every row, point_ids
# resolves the final top-k, and the replicated and envelope tables are
# small.
COLD_POINT_FIELDS = ("data", "alpha_min_pt", "sqrt_gamma_max_pt")
COLD_QUANT_FIELDS = ("data_scale", "data_zp", "amin_scale", "amin_zp",
                     "gmax_scale", "gmax_zp")


def cold_point_fields(index_or_storage) -> tuple:
    """Field names of the host-RAM cold tier of an index or storage tier."""
    storage = getattr(index_or_storage, "storage", index_or_storage)
    if storage == "int8":
        return COLD_POINT_FIELDS + COLD_QUANT_FIELDS
    return COLD_POINT_FIELDS


# Corner sentinel for padded rows: an alpha_min_pt of +PAD_CORNER makes the
# tuple-space lower bound exceed any finite search bound; the same value in
# alpha keeps the row out of every filter top-k.
PAD_CORNER = 1e30

# The search-inert row: never admitted, never in a top-k, id -1, data rows
# of ones (inside every family's domain).
INERT_FILL = {"data": 1.0, "point_ids": -1, "alpha": PAD_CORNER,
              "sqrt_gamma": 0.0, "assign": 0, "alpha_min_pt": PAD_CORNER,
              "sqrt_gamma_max_pt": 0.0}

# The int8 inert row: all codes zero, the sentinels in the decode fields
# (zero scales add no bound slack; data_zp 1.0 decodes to the ones-row).
INERT_FILL_INT8 = {
    "data": 0, "point_ids": -1, "alpha": 0, "sqrt_gamma": 0, "assign": 0,
    "alpha_min_pt": 0, "sqrt_gamma_max_pt": 0,
    "data_scale": 0.0, "data_zp": 1.0,
    "alpha_scale": 0.0, "alpha_zp": PAD_CORNER,
    "sg_scale": 0.0, "sg_zp": 0.0,
    "amin_scale": 0.0, "amin_zp": PAD_CORNER,
    "gmax_scale": 0.0, "gmax_zp": 0.0,
}


def point_fields(index_or_storage) -> tuple:
    """The point-major field names of an index or storage tier."""
    storage = getattr(index_or_storage, "storage", index_or_storage)
    return POINT_FIELDS + QUANT_FIELDS if storage == "int8" else POINT_FIELDS


def inert_fill(index_or_storage) -> dict:
    """Per-field inert fill values of an index or storage tier."""
    storage = getattr(index_or_storage, "storage", index_or_storage)
    return INERT_FILL_INT8 if storage == "int8" else INERT_FILL


def corner_envelopes(amin_pt: Tensor, gmax_pt: Tensor) -> tuple[Tensor, Tensor]:
    """Block envelopes of (n, M) corner tables -> ((nE, M), (nE, M)).

    Row e is the componentwise min/max over layout rows
    ``[e*ENV_BLOCK_ROWS, (e+1)*ENV_BLOCK_ROWS)``; a short tail group is
    completed with the inert corner, which moves neither reduction.
    """
    n, m = amin_pt.shape
    ne = max(-(-n // ENV_BLOCK_ROWS), 1)
    pad = ne * ENV_BLOCK_ROWS - n
    a = torch.nn.functional.pad(amin_pt, (0, 0, 0, pad), value=PAD_CORNER)
    g = torch.nn.functional.pad(gmax_pt, (0, 0, 0, pad), value=0.0)
    return (a.reshape(ne, ENV_BLOCK_ROWS, m).amin(dim=1),
            g.reshape(ne, ENV_BLOCK_ROWS, m).amax(dim=1))


def refresh_envelopes(forest: BallForest) -> BallForest:
    """Recompute the block-envelope tables from the per-point corners; in
    the int8 tier over the DECODED corners, so an envelope dominates what
    the per-point test decodes for each of its rows."""
    ea, eg = corner_envelopes(*qz.decoded_corner_tables(forest))
    return dataclasses.replace(forest, env_alpha_min=ea, env_sqrt_gamma_max=eg)


def pad_points(forest: BallForest, multiple: int) -> BallForest:
    """Pad the point-major arrays with inert rows so ``n % multiple == 0``;
    the envelope tables grow by inert rows where the padding needs them."""
    pad = (-forest.n) % multiple
    if pad == 0:
        return forest
    fill = inert_fill(forest)

    def pad_rows(a, rows, v):
        return torch.cat([a, torch.full((rows,) + tuple(a.shape[1:]), v,
                                        dtype=a.dtype, device=a.device)])

    out = dataclasses.replace(forest, **{
        f: pad_rows(getattr(forest, f), pad, fill[f])
        for f in point_fields(forest)})
    # The appended rows are inert, so the existing envelope rows stay valid.
    grow = max(-(-out.n // ENV_BLOCK_ROWS), 1) - forest.env_alpha_min.shape[0]
    if grow > 0:
        out = dataclasses.replace(
            out,
            env_alpha_min=pad_rows(forest.env_alpha_min, grow, PAD_CORNER),
            env_sqrt_gamma_max=pad_rows(forest.env_sqrt_gamma_max, grow, 0.0))
    return out


def tombstone_rows(forest: BallForest, dead) -> BallForest:
    """Overwrite the rows where ``dead`` (n,) is True with the inert fill.

    How the mutable index (core/segments.py) deletes: the row stays in
    place, but its filter stats keep it out of every top-k and its corners
    fail every Theorem-3 admission.  The envelopes are left as they are:
    removing a row only tightens a block's true envelope, so the stored
    one stays a valid, looser dominator.  Compaction refits them.
    """
    dead = torch.as_tensor(dead, dtype=torch.bool).to(forest.device)
    fill = inert_fill(forest)

    def patch(a, v):
        d = dead.reshape((-1,) + (1,) * (a.ndim - 1))
        return torch.where(d, torch.tensor(v, dtype=a.dtype,
                                           device=a.device), a)

    return dataclasses.replace(forest, **{
        f: patch(getattr(forest, f), fill[f]) for f in point_fields(forest)})


def concat_points(forests) -> BallForest:
    """Concatenate the point-major tables of segments of one sealed index
    (one family, partition, cluster count and storage tier; the first
    segment's replicated tables are kept) into one searchable forest,
    with its envelopes refit over the concatenated corners."""
    forests = list(forests)
    head = forests[0]
    for f in forests[1:]:
        if (f.family_name != head.family_name
                or f.partition != head.partition
                or f.num_clusters != head.num_clusters
                or f.storage != head.storage):
            raise ValueError("concat_points needs segments of one index")
    if len(forests) == 1:
        return head
    out = dataclasses.replace(head, **{
        f: torch.cat([getattr(seg, f) for seg in forests])
        for f in point_fields(head)})
    return refresh_envelopes(out)


def slice_points(forest: BallForest, start: int, size: int) -> BallForest:
    """The ``[start, start + size)`` rows of a forest as a forest of their
    own: the point-major tables sliced, the replicated tables shared, the
    envelopes refit over the slice."""
    out = dataclasses.replace(forest, **{
        f: getattr(forest, f)[start:start + size]
        for f in point_fields(forest)})
    return refresh_envelopes(out)


def quantize_point_tables(forest: BallForest, data_codes: Tensor,
                          data_scale: Tensor, data_zp: Tensor) -> BallForest:
    """Swap a built fp32 forest's point-major tables for the int8 tier.

    The codes must decode exactly to ``forest.data`` (the forest was built
    over the decoded rows).  Filter stats round to nearest, corners
    directionally; the envelopes are refit over the decoded corners.
    """
    if forest.storage != "f32":
        raise ValueError("quantize_point_tables wants an f32 forest")
    out = dataclasses.replace(
        forest, storage="int8",
        data=data_codes, data_scale=data_scale, data_zp=data_zp,
        **qz.encode_stat_tables(forest.alpha, forest.sqrt_gamma,
                                forest.alpha_min_pt,
                                forest.sqrt_gamma_max_pt))
    return refresh_envelopes(out)


def default_num_clusters(n: int) -> int:
    return int(np.clip(n // 32, 8, 8192))


def _quantile_linear(x: Tensor, probs: Tensor) -> Tensor:
    """Linear-interpolation quantiles of a 1-D tensor, in the reference's
    arithmetic: ``low * (1 - w) + high * w`` at position ``probs * (n-1)``
    (``torch.quantile`` interpolates as ``low + w * (high - low)``, which
    rounds differently and would move rows across bucket edges)."""
    s = torch.sort(x).values
    pos = probs * (x.shape[0] - 1)
    low = torch.floor(pos)
    w = pos - low
    lo = low.long().clamp(0, x.shape[0] - 1)
    hi = torch.ceil(pos).long().clamp(0, x.shape[0] - 1)
    return s[lo] * (1.0 - w) + s[hi] * w


def build_tables(
    data: Tensor,
    family: BregmanFamily,
    partition: Partition,
    assign: Tensor,
    centers: Tensor,
    *,
    num_clusters: int,
    gamma_buckets: int = 4,
    beta_sample_size: int = 4096,
    seed: int = 0,
) -> BallForest:
    """The forest's tables from a partition and per-subspace clusterings.

    ``data`` (n, d) fp32 on the target device; ``assign`` (n, M) base
    cluster ids in ORIGINAL row order; ``centers`` (M, C, w).  Points are
    laid out by the first subspace's cluster id (stable), each ball is
    split into ``gamma_buckets`` gamma-quantile buckets whose corners give
    a tighter lower bound, and the per-point corners and block envelopes
    are gathered once here so query-time pruning is elementwise.
    """
    fam = family
    dev = data.device
    n = data.shape[0]
    m = partition.num_subspaces

    # Shared layout: order points by the reference subspace's cluster id.
    order = torch.argsort(assign[:, 0], stable=True)
    data_l = data[order]
    assign_l = assign[order].long()
    point_ids = order.to(torch.int32)

    p = p_transform(data_l, partition, fam)
    alpha, sqrt_gamma = p["alpha"], p["sqrt_gamma"]

    # gamma-bucketed corners: effective segment id = ball * nb + bucket.
    nb = max(int(gamma_buckets), 1)
    probs = torch.linspace(0.0, 1.0, nb + 1, device=dev)[1:-1]
    assign_eff, edges = [], []
    for i in range(m):
        sg_i = sqrt_gamma[:, i].contiguous()
        qs = _quantile_linear(sg_i, probs)
        bucket = torch.searchsorted(qs, sg_i, side="left")
        assign_eff.append(assign_l[:, i] * nb + bucket)
        edges.append(qs)
    assign_eff = torch.stack(assign_eff, dim=1)          # (n, M)
    gamma_edges = torch.stack(edges)                     # (M, nb-1)
    c_eff = num_clusters * nb

    stats_a = [cluster_stats(alpha[:, i], assign_eff[:, i], c_eff)
               for i in range(m)]
    amin = torch.stack([s["min"] for s in stats_a])      # (M, C*nb)
    counts = torch.stack([s["count"] for s in stats_a])
    gmax = torch.stack([cluster_stats(sqrt_gamma[:, i], assign_eff[:, i],
                                      c_eff)["max"] for i in range(m)])

    # Per-point view of the bucketed corners.
    amin_pt = torch.gather(amin, 1, assign_eff.T).T.contiguous()   # (n, M)
    gmax_pt = torch.gather(gmax, 1, assign_eff.T).T.contiguous()

    # Empirical beta_xy sample (cross term over random (data, query) pairs),
    # its row pairs drawn with the reference's numpy stream.
    rng = np.random.default_rng(seed)
    s = min(beta_sample_size, n * n)
    xi = torch.from_numpy(rng.integers(0, n, size=s)).to(dev)
    yi = torch.from_numpy(rng.integers(0, n, size=s)).to(dev)
    betas = -torch.sum(data[xi] * fam.phi_prime(data[yi]), dim=-1)
    beta_samples = torch.sort(betas).values

    forest = BallForest(
        family_name=fam.name,
        partition=partition,
        num_clusters=c_eff,
        data=data_l,
        point_ids=point_ids,
        alpha=alpha,
        sqrt_gamma=sqrt_gamma,
        assign=assign_eff.to(torch.int32),
        alpha_min=amin,
        sqrt_gamma_max=gmax,
        counts=counts,
        centers=centers,
        beta_samples=beta_samples,
        alpha_min_pt=amin_pt,
        sqrt_gamma_max_pt=gmax_pt,
        gamma_edges=gamma_edges,
    )
    return refresh_envelopes(forest)


def build_index(
    data,
    family: str | BregmanFamily,
    *,
    m: int | None = None,
    pccp: bool = True,
    num_clusters: int | None = None,
    kmeans_iters: int = 12,
    beta_sample_size: int = 4096,
    gamma_buckets: int = 4,
    quantize: bool = False,
    calibrate: bool = False,
    calibrate_k: int = 10,
    calibration_queries: int = 64,
    seed: int = 0,
    device="cuda",
) -> BallForest:
    """Offline precomputation (paper Alg. 5): partition -> k-means -> forest.

    ``m=None`` fits the Theorem-4 cost model and uses M*.  ``pccp`` deals
    the dims by correlation (§5.2).  Per subspace, Bregman k-means starts
    from ``num_clusters`` distinct rows drawn with a ``torch.Generator``
    seeded by ``seed``.  The index lives on ``device``.

    ``quantize=True`` builds the int8 tier in the reference's order: the
    data are snapped to per-row int8 first (on ``device``), the index is
    built over the decoded rows, the stat tables are re-encoded, and the
    envelopes are reduced over the decoded corners last.  Search over it
    is exact over :meth:`BallForest.rows_view`.

    ``calibrate=True`` also fits the recall-calibration curve
    (core/calibrate.py) over the finished index: measured recall@
    ``calibrate_k`` over a ``p_guarantee`` grid on
    ``calibration_queries`` held-out jittered rows, stored host-side on
    :attr:`BallForest.calibration` so ``target_recall`` can be inverted.
    """
    dev = resolve_device(device)
    fam = get_family(family) if isinstance(family, str) else family
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    data_np = np.ascontiguousarray(data, dtype=np.float32)
    n, d = data_np.shape
    x = torch.from_numpy(data_np).to(dev)
    if quantize:
        codes, scale, zp = qz.quantize_rows(x)
        x = qz.dequantize_rows(codes, scale, zp, fam)
        data_np = x.cpu().numpy()

    if m is None:
        m = fit_cost_model(data_np, fam, seed=seed).m_star()
    m = int(np.clip(m, 1, d))
    if pccp and m < d:
        part = build_pccp_partition(data_np, m, seed=seed)
    else:
        part = make_partition(d, m)

    c = int(min(num_clusters or default_num_clusters(n), n))
    sub_views = part.gather(x)                          # (n, M, w)
    mask = part.subspace_mask(dev)                      # (M, w)
    gen = torch.Generator().manual_seed(seed)
    centers_list, assign_list = [], []
    for i in range(m):
        cen, asg = kmeans(sub_views[:, i, :].contiguous(), mask[i],
                          family=fam, num_clusters=c, iters=kmeans_iters,
                          generator=gen)
        centers_list.append(cen)
        assign_list.append(asg)
    del sub_views
    forest = build_tables(
        x, fam, part, torch.stack(assign_list, dim=1),
        torch.stack(centers_list), num_clusters=c,
        gamma_buckets=gamma_buckets, beta_sample_size=beta_sample_size,
        seed=seed)
    if quantize:
        order = forest.point_ids.long()
        forest = quantize_point_tables(forest, codes[order], scale[order],
                                       zp[order])
    if calibrate:
        # Fit over the finished index (calibrate drives the search, which
        # imports this module).
        from . import calibrate as _calibrate
        forest = dataclasses.replace(
            forest,
            calibration=_calibrate.fit_calibration(
                forest, k=min(calibrate_k, n),
                num_queries=calibration_queries, seed=seed))
    return forest


# ---------------------------------------------------------------------------
# numpy interchange (a forest built by the reference package, or saved)
# ---------------------------------------------------------------------------

def interchange_fields(storage: str) -> tuple:
    """The fields :func:`forest_to_numpy` carries for a storage tier."""
    return point_fields(storage) + REPLICATED_FIELDS


def forest_to_numpy(forest: BallForest) -> dict:
    """The forest's tables as host numpy arrays, keyed by field name (the
    decode fields too in the int8 tier; ``forest.storage`` names it)."""
    return {f: getattr(forest, f).detach().cpu().numpy()
            for f in interchange_fields(forest.storage)}


def forest_from_numpy(arrays: dict, *, family_name: str,
                      partition_idx, partition_mask, d: int,
                      num_clusters: int, storage: str = "f32",
                      calibration=None, device="cuda") -> BallForest:
    """A forest from numpy tables (:func:`interchange_fields` of
    ``storage``) and its partition layout; dtypes are kept, so
    export(import(x)) is bit-equal.  ``calibration``, a fitted recall
    curve with the fields of ``calibrate.RecallCalibration`` (one the
    reference package fitted, say), is attached as host numpy."""
    from .calibrate import as_calibration
    dev = resolve_device(device)
    if storage not in ("f32", "int8"):
        raise ValueError(f"storage must be 'f32' or 'int8', got {storage!r}")
    fields = interchange_fields(storage)
    missing = [f for f in fields if f not in arrays]
    if missing:
        raise KeyError(f"forest_from_numpy: missing fields {missing}")
    want = np.int8 if storage == "int8" else np.float32
    if np.asarray(arrays["data"]).dtype != want:
        raise ValueError(f"a {storage} forest stores data as {want.__name__}, "
                         f"got {np.asarray(arrays['data']).dtype}")
    idx = np.asarray(partition_idx, dtype=np.int32)
    part = Partition(d=int(d), num_subspaces=idx.shape[0],
                     width=idx.shape[1], idx=idx,
                     mask=np.asarray(partition_mask, dtype=np.float32))
    return BallForest(
        family_name=get_family(family_name).name, partition=part,
        num_clusters=int(num_clusters), storage=storage,
        calibration=as_calibration(calibration),
        **{f: torch.from_numpy(np.array(arrays[f], copy=True)).to(dev)
           for f in fields})
