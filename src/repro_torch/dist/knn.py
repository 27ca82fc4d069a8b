"""Sharded BrePartition search on ``torch.distributed`` (port of
``repro.dist.knn``).

The partition-filter-refinement framework decomposes over disjoint point
blocks: subspace UB totals, the Theorem-3 corner test and the exact
refinement distances are all per point.  So a ``BallForest`` split
point-major across a ``data`` mesh dim runs the whole fused pipeline of
``core/search.py`` locally on each shard, and only two small collectives
cross ranks per query block:

1. **Bound exchange** — each shard's k smallest UB totals, with their
   P-tuples (and in the int8 tier the rows' stat scales), are
   all-gathered and merged, so every shard prunes against the GLOBAL
   Alg.-4 bound ``qb``, not a loose local one.
2. **Top-k merge** — each shard refines its own candidates exactly, and
   the per-shard (q, k) results are all-gathered and merged.

Exactness survives sharding for the same reason: each shard's local top-k
is exact over its points whenever its union fits its budget, and the
merge of exact local top-ks is the exact global top-k.  ``exact`` is the
AND over shards; the host wrapper retries with a budget fitted to the
largest shard's union, topping out at the shard's row count, where the
union always fits.

The reference runs one SPMD program under ``shard_map``; the port is
multi-controller: every rank runs the same Python on its own device, and
the collectives run on the mesh dim's process group, so kernels and
collectives share one device.  The per-shard phases are the search's own
helpers (``_batch_filter_topk``, ``_stream_prune_compact``,
``_refine_batch``), so each shard launches the kernels the resident
search does: #1, #3 and #7 in fp32, #2, #4 and #8 in int8.  The envelope
tables stay GLOBAL and replicated; each shard reads them from its first
row, ``rank * local_n``.  Both merges send ties to the lower gathered
position (shard-major, so the lower global row), as the single-host
stable sorts do; at world size 1 the result equals ``knn_search_batch``
bit for bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core import bounds
from ..core import quantize as qz
from ..core import search as bp
from ..core.calibrate import resolve_p_guarantee
from ..core.index import (REPLICATED_FIELDS, BallForest, pad_points,
                          point_fields, refresh_envelopes)
from ..core.transform import Partition, q_transform_views
from ..device import resolve_device, synchronize
from .sharding import axis_size

Tensor = torch.Tensor


class LaunchTimeout(TimeoutError):
    """A distributed launch blocked past its ``launch_timeout_s``.

    Raised AFTER the launch completes (a launch in flight is not
    preempted), so the timeout is cooperative: it bounds how long a slow
    shard can silently inflate tail latency before the caller learns
    about it.  serve/retrieval.py counts it as a circuit-breaker failure
    and degrades the tenant.  The completed result rides on the
    exception (:attr:`result`, :attr:`elapsed_s`), so a caller that still
    meets its deadline may use it.
    """

    def __init__(self, msg: str, result=None, elapsed_s: float = 0.0):
        super().__init__(msg)
        self.result = result
        self.elapsed_s = elapsed_s


class QueryView(NamedTuple):
    """A query block plus its pre-gathered per-subspace view."""

    y: Tensor       # (q, d) original dim order
    sub: Tensor     # (q, M, w) subspace view (partition.gather(y))


def query_subview(partition: Partition, ys, device="cuda") -> QueryView:
    """Pre-gather a (q, d) query block's subspace view on ``device``."""
    dev = resolve_device(device)
    ys = torch.as_tensor(ys, dtype=torch.float32, device=dev).contiguous()
    if ys.ndim != 2:
        raise ValueError(f"expected (q, d) queries, got {tuple(ys.shape)}")
    return QueryView(y=ys, sub=partition.gather(ys))


@dataclasses.dataclass(frozen=True)
class ShardedForest:
    """This rank's shard of a BallForest laid out point-major across one
    mesh dim.

    ``forest`` holds rows ``[shard * local_n, (shard + 1) * local_n)`` of
    the padded index and its replicated tables (the GLOBAL envelopes
    among them); ``global_n`` is the real (pre-padding) point count and
    ``live_n`` the count of live points (None unless the shard came from
    a mutable SegmentedForest).
    """

    forest: BallForest
    mesh: DeviceMesh
    axis: str
    global_n: int
    shard: int
    num_shards: int
    live_n: int | None = None

    @property
    def local_n(self) -> int:
        return self.forest.n

    @property
    def row_offset(self) -> int:
        """This shard's first row in the padded global layout."""
        return self.shard * self.local_n

    @property
    def global_live_n(self) -> int:
        return self.global_n if self.live_n is None else self.live_n


def _shard_device(dev: torch.device, forest) -> torch.device:
    """A bare ``cuda`` is the card the index lies on, else the current
    one."""
    if dev.type == "cuda" and dev.index is None:
        if forest.device.type == "cuda":
            return forest.device
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def shard_index(forest, mesh: DeviceMesh, axis: str = "data",
                device="cuda") -> ShardedForest:
    """Split an index point-major across ``mesh[axis]`` and keep this
    rank's shard on its device.

    ``forest`` is a BallForest or a mutable SegmentedForest
    (core/segments.py), snapshotted through ``view()``, so each shard
    carries its share of the append segments and tombstones.  Points are
    padded to a multiple of the axis size with search-inert rows
    (``pad_points``); this rank keeps its ``local_n`` rows of every
    point-major table and the replicated tables.  At world size 1 the
    shard's tables are the forest's own tensors, not copies; above it the
    slice is copied, so the whole table can be freed.  ``device`` must be
    the mesh's device type; a bare ``"cuda"`` is the card the index lies
    on (the current card when the index is on the host).

    A mutating index does not reshard by itself: shard it again after an
    insert or delete (the snapshot is immutable).
    """
    dev = resolve_device(device)
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r}, the shard "
                         f"was asked for {dev.type!r}")
    world = axis_size(mesh, axis)
    shard = int(mesh.get_local_rank(axis))
    live_n = getattr(forest, "live_n", None)
    view = getattr(forest, "view", None)
    if callable(view):
        forest = view()
    dev = _shard_device(dev, forest)
    if forest.env_alpha_min is None:
        # A hand-assembled forest without envelope tables: derive them so
        # every shard reads the same replicated global tables.
        forest = refresh_envelopes(forest)
    padded = pad_points(forest, world)
    local_n = padded.n // world
    whole = world == 1

    def keep(t):
        part = t if whole else t[shard * local_n:(shard + 1) * local_n]
        return part.to(dev, copy=not whole)

    local = dataclasses.replace(
        padded,
        **{f: keep(getattr(padded, f)) for f in point_fields(padded)},
        **{f: getattr(padded, f).to(dev) for f in REPLICATED_FIELDS
           if getattr(padded, f) is not None})
    return ShardedForest(forest=local, mesh=mesh, axis=axis,
                         global_n=forest.n, shard=shard, num_shards=world,
                         live_n=live_n)


def _gather(t: Tensor, group) -> Tensor:
    """All-gather ``t`` (q, c, ...) over ``group`` into (q, world * c,
    ...), shard-major along dim 1."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=1)


def _reduce(t: Tensor, op, group) -> Tensor:
    dist.all_reduce(t, op=op, group=group)
    return t


def _agree(value: float, group, dev: torch.device) -> float:
    """The largest of every rank's ``value``, so that each rank takes the
    same exit from the retry ladder: a rank's clock and its ``stop_retry``
    are its own, and a rank that left the ladder alone would leave the
    others waiting in the next launch's collectives."""
    if dist.get_world_size(group) == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=dev)
    return float(_reduce(t, dist.ReduceOp.MAX, group))


def _query_struct(forest: BallForest, qv: QueryView) -> dict:
    """The filter's and the refine's per-query fields from the
    pre-gathered view (``search.query_struct`` over ``qv.y``)."""
    fam = forest.family
    qs = q_transform_views(qv.sub, forest.partition.subspace_mask(
        qv.sub.device), fam)
    qs.update(bounds.query_refine_constants(qv.y, fam))
    return qs


def _global_bounds(local: BallForest, group, qs: dict, k: int,
                   block_rows: int, p_guarantee) -> Tensor:
    """The shard's filter, then the GLOBAL Alg.-4 bounds ``qb`` (q, M)
    through the k-way exchange: the bits of the single-host
    ``search._filter_bounds`` over the whole index."""
    q = qs["qconst"].shape[0]
    vals, idx = bp._batch_filter_topk(local, qs, k, block_rows)
    tup = bp._tuple_rows(local, idx)                    # decoded in int8
    vals_g = _gather(vals, group)                       # (q, W*k)
    a_g = _gather(tup["alpha"], group)                  # (q, W*k, M)
    g_g = _gather(tup["sqrt_gamma"], group)
    sel = torch.sort(vals_g, dim=1, stable=True).indices[:, :k]
    rows = torch.arange(q, device=sel.device)
    kth = {"alpha": a_g[rows, sel[:, -1]],
           "sqrt_gamma": g_g[rows, sel[:, -1]]}         # (q, M)
    qb = bounds.ub_components(kth, qs)
    if local.storage == "int8":
        # The rows' stat scales ride with their tuples: the global bound
        # carries the slack of whichever shard's rows set the k-th UB.
        sa_g = _gather(local.alpha_scale[idx], group)
        sg_g = _gather(local.sg_scale[idx], group)
        qb = qb + qz.ub_slack(torch.amax(torch.gather(sa_g, 1, sel), -1),
                              torch.amax(torch.gather(sg_g, 1, sel), -1),
                              qs["sqrt_delta"])
    if p_guarantee is not None:                         # §8 shrink
        qb = bp._shrink_bounds(local.beta_samples, kth["sqrt_gamma"],
                               qs["sqrt_delta"], qb, p_guarantee)
    return qb


def _shard_search(sharded: ShardedForest, group, qv: QueryView, k: int,
                  budget: int, block_rows: int, p_guarantee):
    """One launch on this rank: the shard's filter and the bound exchange,
    its prune, compaction and refine, and the merge.  Returns ``(ids,
    dists, exact, num_candidates, need)``, the same on every rank."""
    local = sharded.forest
    qs = _query_struct(local, qv)
    qb = _global_bounds(local, group, qs, k, block_rows, p_guarantee)
    # ---- local streaming prune + compact + refine
    sel_c, valid, ncand, _, _, _ = bp._stream_prune_compact(
        local, qs, qb, budget, block_rows, row_offset=sharded.row_offset)
    ids, dists = bp._refine_batch(local, qs, sel_c, valid, k)
    # ---- k-way merge (the ids are global already) and the reductions
    ids_g, d_g = _gather(ids, group), _gather(dists, group)
    dv, pos = torch.sort(d_g, dim=1, stable=True)
    overflowed = _reduce((ncand > budget).to(torch.int32), dist.ReduceOp.SUM,
                         group)
    total = _reduce(ncand.clone(), dist.ReduceOp.SUM, group)
    need = _reduce(ncand.clone(), dist.ReduceOp.MAX, group)
    return (torch.gather(ids_g, 1, pos[:, :k]), dv[:, :k], overflowed == 0,
            total, need)


def distributed_knn(sharded: ShardedForest, queries, *, family: str, k: int,
                    budget: int | None,
                    approx_p: float | None = None,
                    target_recall: float | None = None,
                    block_rows: int | None = None,
                    max_doublings: int = bp.MAX_BUDGET_DOUBLINGS,
                    launch_timeout_s: float | None = None,
                    launch_hook=None, stop_retry=None,
                    clock=time.monotonic,
                    device="cuda") -> bp.SearchResult:
    """Batched kNN over a sharded index — the distributed ``knn_batch``.

    Every rank of the mesh dim calls it with the same queries and knobs.
    ``queries`` is a (q, d) block or a prebuilt :class:`QueryView`;
    ``budget`` is the PER-SHARD refine budget (resolved against the
    shard's rows); ``block_rows`` tunes the per-shard streaming scans as
    in the single-host search.  Returns ``(ids, dists, exact,
    num_candidates)`` with ``num_candidates`` the global Theorem-3 union
    size per query.  On overflow the whole block retries with the budget
    fitted to the largest shard's union; the ladder ends at the shard's
    row count, where the union always fits, so ``exact`` is truthful.

    Every retry is its own launch, ended by a sync of the shard's device
    before ``clock()`` is read.  ``launch_hook(elapsed_s)`` observes each
    launch's time (the service's cost model); ``launch_timeout_s`` raises
    :class:`LaunchTimeout`, carrying the completed result, when a launch
    took longer; ``stop_retry`` (no-arg -> bool) is consulted before each
    ADDITIONAL launch and ends the ladder with the budget-capped result.
    ``target_recall`` (not with ``approx_p``) inverts the index's fitted
    recall curve on the host before the launch.

    Every exit from the ladder is the same on every rank: the launch's
    time is the largest over the ranks (the hook and the timeout read
    it), and the ladder stops when any rank's ``stop_retry`` says so.
    """
    forest = sharded.forest
    dev = bp._on_index_device(forest, device)
    group = sharded.mesh.get_group(sharded.axis)
    if target_recall is not None:
        if approx_p is not None:
            raise ValueError("pass at most one of approx_p / target_recall")
        approx_p, _ = resolve_p_guarantee(forest, target_recall)
    bp.validate_p_guarantee(approx_p)
    p = None if approx_p is None else float(approx_p)
    if family != forest.family_name:
        raise ValueError(
            f"family {family!r} does not match index {forest.family_name!r}")
    if k > sharded.global_live_n:
        raise ValueError(
            f"k={k} exceeds live index size n={sharded.global_live_n}")
    qv = (queries if isinstance(queries, QueryView)
          else query_subview(forest.partition, queries, device=dev))
    local_n = sharded.local_n
    block_rows = bp.resolve_block_rows(block_rows, sharded.global_live_n,
                                       q=qv.y.shape[0],
                                       storage=forest.storage, device=dev)
    b = bp.resolve_budget(budget, local_n, k)
    for attempt in range(max_doublings + 1):
        t0 = clock()
        ids, dists, exact, ncand, need = _shard_search(
            sharded, group, qv, k, b, block_rows, p)
        synchronize(dev)
        # The launch's time is its slowest rank's.
        elapsed = _agree(clock() - t0, group, dev)
        if launch_hook is not None:
            launch_hook(elapsed)
        res = bp.SearchResult(ids=ids, dists=dists, exact=exact,
                              num_candidates=ncand)
        if launch_timeout_s is not None and elapsed > launch_timeout_s:
            raise LaunchTimeout(
                f"distributed_knn launch (budget={b}, attempt={attempt}) "
                f"blocked {elapsed:.3f}s > launch_timeout_s="
                f"{launch_timeout_s:.3f}s", result=res, elapsed_s=elapsed)
        if bool(exact.all()) or b >= local_n or attempt == max_doublings:
            break
        if stop_retry is not None and _agree(float(stop_retry()), group,
                                             dev):
            break
        b = bp.fitted_budget_for_n(local_n, k, int(need.max()))
    return res
