"""Out-of-core tiered point store (port of ``repro.core.tiered``).

A :class:`~repro_torch.core.index.BallForest` is split into two residency
tiers:

* **Hot (on the device)** — what the filter and the envelope gate read:
  the (n, M) filter stats ``alpha`` / ``sqrt_gamma`` (int8 codes and their
  decode in the int8 tier), the block envelopes, ``point_ids`` and the
  small replicated tables.
* **Cold (host RAM)** — the (n, d) point rows and the (n, M) per-point
  corners, with their decode columns in the int8 tier
  (:func:`~repro_torch.core.index.cold_point_fields`), held as pinned host
  tensors cut into ``block_rows`` blocks.  In the hot forest these fields
  are shape-only ``meta`` tensors, so nothing can read them there.

A search is the resident pipeline re-cut at the host/device boundary:

1. **Stage A** — query transform, streaming filter top-k, Alg.-4 bounds
   ``qb`` (with the int8 slack and the optional §8 shrink), then the
   resident path's own envelope gate (``search._envelope_gate``): the
   host reads once which blocks some query admits.  Hot tables only.
2. **Stage B** — the admitted blocks are resolved in index order, and
   each one's corner tables are copied into its rows of a window buffer
   on the device; a full window (or the last) takes one launch of the
   prune-only kernel (#5, or #6 in int8) over its rows and one pooled
   rank fill (:func:`_prune_pool`).  A window holds as many blocks as keep
   its corner bytes and its mask within :data:`WINDOW_BYTES`
   (:func:`_window_blocks`); the window is transient device memory of the
   search, outside ``resident_bytes`` (``cache_info()["window_bytes"]``
   gives the last one's size).  While block i is resolved, the next
   ``prefetch_depth`` admitted blocks are in flight: a worker thread
   copies each block's tables to the device on the store's own CUDA
   stream (``non_blocking`` from pinned memory) and records an event; the
   compute stream waits on that event before it reads the block, and each
   block tensor is marked as used by the compute stream
   (``record_stream``), so an LRU eviction never frees memory a queued
   copy or kernel still reads.  Fetched blocks land in a device-side LRU
   cache budgeted by ``resident_bytes``; the calls into it, and so
   ``stats``, are those of a loop that prunes one block at a time.
3. **Stage C** — the admitted blocks' rows are concatenated into one
   refine pool; the candidates' global rows are remapped into it, and the
   refine kernel (#7, or #8 in int8) and the stable top-k run as in the
   resident ``search._refine_batch``.

When every admitted block is already cached (the warm path), Stages B and
C run once over the pooled rows: one prune launch over all of them.  A
pooled rank fill, a window's or the warm pool's, gives the per-block
fills' ``(sel, count)`` bit for bit.  Results are bit-equal to the
resident ``knn_search_batch`` / ``knn_search_batch_approx`` on the same
index.  When the cold tables fit ``resident_bytes`` (or it is ``None``)
the store keeps the whole forest on the device and delegates to the
resident search.

On the CPU the same code runs with host copies, and nothing is pinned.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeoutError

import numpy as np
import torch

from ..kernels import ref as kernel_ref
from . import search as _search
from .calibrate import resolve_p_guarantee
from .index import BallForest, cold_point_fields, inert_fill
from .search import (CORNER_FIELDS, POS_BIG, REFINE_FIELDS, SearchResult,
                     resolve_block_rows, resolve_budget,
                     resolve_env_block_rows, validate_p_guarantee,
                     validate_queries)

Tensor = torch.Tensor

# Blocks in flight beyond the one being pruned: one copy overlaps one
# prune, one more is held against fetch jitter.
DEFAULT_PREFETCH_DEPTH = 2
MAX_PREFETCH_DEPTH = 64

# Cap of one Stage B window: its pooled corner bytes plus its (rows, q)
# int32 mask, 2^27 bytes as the resident search's group cap.  Transient
# device memory beside the block cache, not counted in ``resident_bytes``.
WINDOW_BYTES = 1 << 27


class FetchTimeout(RuntimeError):
    """A host->device block fetch exceeded the store's ``fetch_timeout_s``.

    Raised out of :meth:`TieredPointStore.search` so a wedged copy
    surfaces as an ordinary failure instead of blocking the search.  The
    stalled fetch keeps running in the background; a retry that arrives
    after it lands uses its result.
    """


def resolve_resident_bytes(resident_bytes):
    """THE ``resident_bytes`` knob resolver: ``None`` (no budget: every
    table stays on the device) or a positive int byte count bounding the
    device-side block cache."""
    if resident_bytes is None:
        return None
    if isinstance(resident_bytes, bool) or not isinstance(
            resident_bytes, (int, np.integer)):
        raise ValueError(
            f"resident_bytes must be an int byte count or None, "
            f"got {resident_bytes!r}")
    rb = int(resident_bytes)
    if rb < 1:
        raise ValueError(
            f"resident_bytes must be a positive byte count, got {rb}")
    return rb


def resolve_prefetch_depth(prefetch_depth):
    """THE ``prefetch_depth`` knob resolver: ``None`` picks
    :data:`DEFAULT_PREFETCH_DEPTH`; otherwise an int in [1,
    :data:`MAX_PREFETCH_DEPTH`] (0 would serialize every copy behind its
    prune)."""
    if prefetch_depth is None:
        return DEFAULT_PREFETCH_DEPTH
    if isinstance(prefetch_depth, bool) or not isinstance(
            prefetch_depth, (int, np.integer)):
        raise ValueError(
            f"prefetch_depth must be an int or None, got {prefetch_depth!r}")
    depth = int(prefetch_depth)
    if not 1 <= depth <= MAX_PREFETCH_DEPTH:
        raise ValueError(
            f"prefetch_depth={depth} must be within "
            f"[1, {MAX_PREFETCH_DEPTH}]")
    return depth


def _nbytes(t: Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# The three stages
# ---------------------------------------------------------------------------

def _stage_a(hot: BallForest, ys: Tensor, k: int, block_rows: int,
             env_block_rows: int, p_guarantee) -> tuple:
    """Filter, bounds and envelope gate over the HOT tables only; returns
    ``(qs, qb, env_admit (nb, q) bool)``."""
    qs = _search.query_struct(ys, hot.partition, hot.family)
    qb = _search._filter_bounds(hot, qs, k, block_rows, p_guarantee)
    bn, nb = _search._block_layout(hot.n, block_rows)
    env_admit = _search._envelope_gate(hot, qs, qb, bn, nb, env_block_rows)
    return qs, qb, env_admit


def _window_blocks(row_bytes: int, bn: int, q: int) -> int:
    """Blocks one Stage B window pools: their corner rows (``row_bytes``
    a row) and their (rows, q) int32 mask within :data:`WINDOW_BYTES`."""
    return max(1, WINDOW_BYTES // (bn * (row_bytes + 4 * q)))


def _prune_pool(sel: Tensor, count: Tensor, corners: tuple, gidx: Tensor,
                qs: dict, qb: Tensor, budget: int, n: int,
                storage: str) -> tuple[Tensor, Tensor]:
    """Pooled admitted blocks in ONE prune launch over their rows: the
    warm path's whole admitted set, or one Stage B window.

    ``corners`` are the blocks' corner tables concatenated in ascending
    block order; ``gidx`` maps each pooled row to its global row (pad rows
    carry a row >= n and are masked).  The admit kernel is elementwise per
    row and the pool keeps ascending global order, above every row routed
    before it, so one rank search over the pool's running admit count
    routes the same rows into the same slots as the per-block fills:
    ``(sel, count)`` bit for bit.
    """
    admit = _search._prune_block(storage, corners, qs, qb)
    admit = admit * (gidx < n).to(admit.dtype)[:, None]
    pn = admit.shape[0]
    csum = torch.cumsum(admit, dim=0, dtype=torch.long)         # (pn, q)
    tot = csum[-1]                                              # (q,)
    t_ranks = min(pn, budget)
    q = csum.shape[1]
    ranks = torch.arange(1, t_ranks + 1, device=csum.device,
                         dtype=csum.dtype).expand(q, -1).contiguous()
    rows_for_rank = torch.searchsorted(csum.T.contiguous(), ranks,
                                       side="left")             # (q, T)
    rows_for_rank = torch.clamp(rows_for_rank, max=pn - 1)
    r0 = (torch.arange(budget, device=csum.device)[None, :]
          - count[:, None])                                     # rank - 1
    fill = (r0 >= 0) & (r0 < tot[:, None])
    rows_at_slot = torch.gather(rows_for_rank, 1,
                                torch.clamp(r0, 0, t_ranks - 1))
    sel = torch.where(fill, gidx[rows_at_slot], sel)
    return sel, count + tot


def _refine_tiles(tables: tuple, pos_of: Tensor, sel: Tensor,
                  count: Tensor, qs: dict, point_ids: Tensor, k: int,
                  family_name: str, bn: int, budget: int):
    """The refine over the pooled blocks' rows.  ``pos_of`` maps a global
    block to its place in the pool, so the global candidate rows ``sel``
    remap there.  Every valid candidate lies in an admitted block; invalid
    slots map anywhere in range and are masked to +BIG as the resident
    refine masks them.  ``sel`` stays global, so the ids are the resident
    path's."""
    valid = _search._slot_validity(count, budget)
    lsel = pos_of[sel // bn] * bn + sel % bn                    # (q, budget)
    return _search._refine_topk(tables, lsel, sel, valid, qs, point_ids, k,
                                family_name)


class TieredPointStore:
    """Two-tier residency wrapper around a BallForest snapshot.

    Build with :meth:`from_index`.  Every public search entry point of
    ``core.search`` routes a store to :meth:`search` through the
    ``is_tiered_store`` marker.  Not safe for concurrent searches; the
    fetch workers are the only internal concurrency.
    """

    is_tiered_store = True

    def __init__(self, snapshot: BallForest, *, resident_bytes=None,
                 prefetch_depth=None, block_rows=None,
                 pinned_row_range: tuple[int, int] | None = None,
                 transfer=None, fetch_timeout_s: float | None = None):
        self.resident_bytes = resolve_resident_bytes(resident_bytes)
        self.prefetch_depth = resolve_prefetch_depth(prefetch_depth)
        n = snapshot.n
        self.block_rows = resolve_block_rows(block_rows, n,
                                             storage=snapshot.storage,
                                             device=snapshot.device)
        self.fetch_timeout_s = fetch_timeout_s
        self.device = snapshot.device
        self._transfer = self._copy_to_device if transfer is None \
            else transfer
        self._lock = threading.Lock()
        self._live_n = int((snapshot.point_ids >= 0).sum())
        self.stats = self._zero_stats()
        cold = cold_point_fields(snapshot)
        self.cold_bytes = sum(_nbytes(getattr(snapshot, f)) for f in cold)
        self._bn, self._nb = _search._block_layout(n, self.block_rows)
        self._cache: OrderedDict[int, dict] = OrderedDict()
        self._cache_bytes = 0
        self._futures: dict = {}
        self._pinned: frozenset[int] = frozenset()
        # Single-entry pooled-rows cache of the warm path: (admitted-set
        # key, pooled corners, global row of each pooled row, pooled
        # refine tables, block -> pool slot).  One more device copy of the
        # admitted set, reported as pool_bytes.
        self._pool_cache: tuple | None = None
        # Bytes of the last Stage B window buffer (transient, freed when
        # the search returns; outside resident_bytes).
        self._window_bytes = 0
        self._executor: ThreadPoolExecutor | None = None
        self._copy_stream = None

        if self.resident_bytes is None or \
                self.cold_bytes <= self.resident_bytes:
            # Resident fast path: keep the whole forest and delegate.
            self._resident: BallForest | None = snapshot
            self._hot = snapshot
            self._blocks = None
            return

        self._resident = None
        self._hot = dataclasses.replace(snapshot, **{
            f: torch.empty(getattr(snapshot, f).shape,
                           dtype=getattr(snapshot, f).dtype, device="meta")
            for f in cold})
        # Host blocks, the tail padded with the inert row (never admitted,
        # a domain-safe data row).
        fills = inert_fill(snapshot)
        bn, nb = self._bn, self._nb
        pad = nb * bn - n
        self._blocks = {}
        for f in cold:
            host = getattr(snapshot, f).detach().cpu()
            if pad:
                host = torch.cat([host, torch.full(
                    (pad,) + tuple(host.shape[1:]), fills[f],
                    dtype=host.dtype)])
            host = host.reshape((nb, bn) + tuple(host.shape[1:]))
            self._blocks[f] = (host.pin_memory()
                               if self.device.type == "cuda" else host)
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(device=self.device)
        self._executor = ThreadPoolExecutor(
            max_workers=self.prefetch_depth,
            thread_name_prefix="tiered-fetch")
        # Append-segment rows stay resident: their blocks are fetched here
        # and never evicted.
        if pinned_row_range is not None:
            lo, hi = pinned_row_range
            if hi > lo:
                self._pinned = frozenset(range(lo // bn, -(-hi // bn)))
        for bid in sorted(self._pinned):
            self._insert_cache(bid, self._fetch_block(bid))

    @staticmethod
    def _zero_stats() -> dict:
        return {"queries": 0, "searches": 0, "fetches": 0,
                "host_bytes_fetched": 0, "cache_hits": 0, "cache_misses": 0,
                "blocks_admitted": 0, "blocks_total": 0}

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_index(cls, index, *, resident_bytes=None, prefetch_depth=None,
                   block_rows=None, transfer=None,
                   fetch_timeout_s: float | None = None
                   ) -> "TieredPointStore":
        """Tier a forest, or a mutable index through its ``view()``; the
        mutable index's ``append_row_range()`` rows are pinned in the
        block cache.  The snapshot is frozen: re-wrap after mutating."""
        resident_bytes = resolve_resident_bytes(resident_bytes)
        prefetch_depth = resolve_prefetch_depth(prefetch_depth)
        snapshot = index
        pinned = None
        view = getattr(index, "view", None)
        if callable(view):
            snapshot = view()
            rng = getattr(index, "append_row_range", None)
            if callable(rng):
                pinned = rng()
        block_rows = resolve_block_rows(block_rows, snapshot.n,
                                        storage=snapshot.storage,
                                        device=snapshot.device)
        return cls(snapshot, resident_bytes=resident_bytes,
                   prefetch_depth=prefetch_depth, block_rows=block_rows,
                   pinned_row_range=pinned, transfer=transfer,
                   fetch_timeout_s=fetch_timeout_s)

    # -- index-protocol surface --------------------------------------------

    @property
    def n(self) -> int:
        return self._hot.n

    @property
    def d(self) -> int:
        return self._hot.d

    @property
    def m(self) -> int:
        return self._hot.m

    @property
    def family(self):
        return self._hot.family

    @property
    def family_name(self) -> str:
        return self._hot.family_name

    @property
    def storage(self) -> str:
        return self._hot.storage

    @property
    def calibration(self):
        """The hot forest's fitted recall curve (host-only), or None."""
        return self._hot.calibration

    @property
    def live_n(self) -> int:
        return self._live_n

    @property
    def is_resident(self) -> bool:
        """True when the resident fast path is active (no tiering)."""
        return self._resident is not None

    @property
    def num_blocks(self) -> int:
        return self._nb

    def as_resident_forest(self) -> BallForest:
        """The whole forest on the device (one O(n) copy, not cached: for
        ``knn_batch``'s brute-force escape and diagnostics)."""
        if self._resident is not None:
            return self._resident
        n = self.n
        return dataclasses.replace(self._hot, **{
            f: blocks.reshape((-1,) + tuple(blocks.shape[2:]))[:n]
            .to(self.device)
            for f, blocks in self._blocks.items()})

    def reset_stats(self) -> None:
        self.stats = self._zero_stats()

    def cache_info(self) -> dict:
        """Block-cache occupancy."""
        pool_bytes = 0
        if self._pool_cache is not None:
            _, corners, _, tables, _ = self._pool_cache
            pool_bytes = sum(_nbytes(t) for t in corners + tables)
        return {"blocks_cached": len(self._cache),
                "bytes_cached": self._cache_bytes,
                "pool_bytes": pool_bytes,
                "window_bytes": self._window_bytes,
                "pinned_blocks": len(self._pinned),
                "num_blocks": self._nb,
                "resident_bytes": self.resident_bytes,
                "cold_bytes": self.cold_bytes,
                "resident_fast_path": self.is_resident}

    def close(self) -> None:
        """Shut the fetch workers down (idempotent)."""
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = None

    # -- cache and fetch machinery -----------------------------------------

    def _copy_to_device(self, tiles: dict) -> dict:
        """The default transfer: one copy of each host tile (asynchronous
        from pinned memory on the card)."""
        return {f: t.to(self.device, non_blocking=True, copy=True)
                for f, t in tiles.items()}

    def _fetch_block(self, bid: int) -> dict:
        """Copy one cold block host -> device; runs on a fetch worker.

        On the card the copies are issued on the store's copy stream and
        an event marks their end; the worker waits for it, so a fetch
        counts as done (and ``fetch_timeout_s`` bounds the wait for it)
        only once its bytes are on the device.  One bundle carries the
        block's prune and refine tables alike.
        """
        tiles = {f: blocks[bid] for f, blocks in self._blocks.items()}
        host_nbytes = sum(_nbytes(t) for t in tiles.values())
        done = None
        if self._copy_stream is not None:
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._copy_stream):
                dev = self._transfer(tiles)
                done = torch.cuda.Event()
                done.record(self._copy_stream)
            done.synchronize()
        else:
            dev = self._transfer(tiles)
        return {"tiles": dev, "done": done, "host_nbytes": host_nbytes,
                "nbytes": sum(_nbytes(t) for t in dev.values())}

    def _use(self, bundle: dict) -> dict:
        """Order the compute stream after the bundle's copies and mark its
        tensors as used there, so freeing them on eviction waits for the
        kernels queued on it."""
        if bundle["done"] is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(bundle["done"])
            for t in bundle["tiles"].values():
                t.record_stream(stream)
        return bundle

    def _insert_cache(self, bid: int, bundle: dict) -> None:
        self._cache[bid] = bundle
        self._cache.move_to_end(bid)
        self._cache_bytes += bundle["nbytes"]
        if self.resident_bytes is None:
            return
        # Evict LRU-first until under budget; the block just inserted and
        # the pinned blocks stay, so the cache may exceed a budget smaller
        # than one bundle.
        for victim in list(self._cache):
            if self._cache_bytes <= self.resident_bytes:
                break
            if victim == bid or victim in self._pinned:
                continue
            self._cache_bytes -= self._cache.pop(victim)["nbytes"]

    def _ensure_inflight(self, bid: int) -> None:
        with self._lock:
            if bid in self._cache or bid in self._futures:
                return
            self._futures[bid] = self._executor.submit(self._fetch_block, bid)

    def _block(self, bid: int) -> dict:
        """Resolve one block: a cache hit, or a wait on its fetch."""
        with self._lock:
            cached = self._cache.get(bid)
            if cached is not None:
                self.stats["cache_hits"] += 1
                self._cache.move_to_end(bid)
                return self._use(cached)
            fut = self._futures.get(bid)
            if fut is None:
                fut = self._executor.submit(self._fetch_block, bid)
                self._futures[bid] = fut
        try:
            bundle = fut.result(timeout=self.fetch_timeout_s)
        except _FutureTimeoutError:
            raise FetchTimeout(
                f"host->device fetch of block {bid} exceeded "
                f"fetch_timeout_s={self.fetch_timeout_s}s; the transfer "
                f"keeps running, and a retry may use it") from None
        with self._lock:
            self._futures.pop(bid, None)
            if bid not in self._cache:
                self.stats["cache_misses"] += 1
                self.stats["fetches"] += 1
                self.stats["host_bytes_fetched"] += bundle["host_nbytes"]
                self._insert_cache(bid, bundle)
        return self._use(bundle)

    def warm_cache(self) -> dict:
        """Fill the block cache in index order up to ``resident_bytes``
        (pinned blocks are already in).  Not counted in ``stats``."""
        if self._resident is not None:
            return {"blocks_cached": 0, "bytes_cached": 0,
                    "resident_fast_path": True}
        for bid in range(self._nb):
            if bid in self._cache:
                continue
            bundle = self._fetch_block(bid)
            if (self._cache_bytes + bundle["nbytes"] > self.resident_bytes
                    and bid not in self._pinned):
                break
            self._insert_cache(bid, bundle)
        return {"blocks_cached": len(self._cache),
                "bytes_cached": self._cache_bytes,
                "resident_fast_path": False}

    def _fields(self, bundle: dict, names: tuple) -> tuple:
        return tuple(bundle["tiles"][f] for f in names)

    def _pooled(self, key: tuple) -> tuple:
        """Pooled corners, global rows, refine tables and block -> slot map
        of one admitted set, every block of which is cached; memoized for
        the last set."""
        cached = self._pool_cache
        if cached is not None and cached[0] == key:
            self.stats["cache_hits"] += len(key)
            return cached[1:]
        bn, dev = self._bn, self.device
        bundles = [self._block(b) for b in key]
        corners = tuple(torch.cat(parts) for parts in zip(*(
            self._fields(b, CORNER_FIELDS[self.storage]) for b in bundles),
            strict=True))
        tables = tuple(torch.cat(parts) for parts in zip(*(
            self._fields(b, REFINE_FIELDS[self.storage]) for b in bundles),
            strict=True))
        gidx = kernel_ref.block_rows(torch.tensor(key, device=dev), bn)
        pos_of = torch.zeros(self._nb, dtype=torch.long, device=dev)
        pos_of[list(key)] = torch.arange(len(key), device=dev)
        self._pool_cache = (key, corners, gidx, tables, pos_of)
        return corners, gidx, tables, pos_of

    # -- search -------------------------------------------------------------

    def search(self, ys, k: int, budget: int | None = None, *,
               p_guarantee=None, target_recall: float | None = None,
               block_rows: int | None = None,
               env_block_rows: int | None = None, validate: bool = True,
               device="cuda") -> SearchResult:
        """Batched kNN over the store: bit-equal to the resident
        ``knn_search_batch``, or to ``knn_search_batch_approx`` when one
        of ``p_guarantee`` / ``target_recall`` is given, on the same index
        (``target_recall`` resolves through the hot forest's recall
        curve).

        ``block_rows`` was fixed at construction (the host blocks are cut
        at it): another explicit value raises.  ``env_block_rows`` only
        coarsens the gate; results do not move, the admitted set may.
        """
        if p_guarantee is not None and target_recall is not None:
            raise ValueError(
                "pass at most one of p_guarantee / target_recall")
        if target_recall is not None:
            p_guarantee, _ = resolve_p_guarantee(self, target_recall)
        validate_p_guarantee(p_guarantee)
        dev = _search._on_index_device(self, device)
        budget = resolve_budget(budget, self.n, k)
        if block_rows is not None:
            br = resolve_block_rows(block_rows, self.n, storage=self.storage,
                                    device=self.device)
            if br != self.block_rows:
                raise ValueError(
                    f"block_rows={br} conflicts with the store's pinned "
                    f"block size {self.block_rows} (host blocks are cut at "
                    f"construction; rebuild the store to change it)")
        eb = resolve_env_block_rows(env_block_rows)
        ys = _search._queries(ys, dev)
        if ys.ndim != 2:
            raise ValueError(f"expected (q, d) queries, got {tuple(ys.shape)}")
        if validate:
            validate_queries(self.family, ys)
        if self._resident is not None:
            if p_guarantee is None:
                return _search.knn_search_batch(
                    self._resident, ys, k, budget, self.block_rows,
                    validate=False, env_block_rows=eb, device=dev)
            return _search.knn_search_batch_approx(
                self._resident, ys, k, budget, p_guarantee, self.block_rows,
                validate=False, device=dev)
        return self._search_tiered(ys, k, budget, p_guarantee, eb)

    def _stage_b(self, admitted: list, sel: Tensor, count: Tensor, qs: dict,
                 qb: Tensor, budget: int) -> tuple[Tensor, Tensor]:
        """The admitted blocks in windows: each block resolved as a loop
        that pruned it alone would (prefetch ``prefetch_depth`` blocks
        ahead, then ``_block``), its corner tables copied into its rows of
        the window on the compute stream, one prune launch and one pooled
        fill a full window.  The window buffer (up to :data:`WINDOW_BYTES`
        with its mask) lives for this call only, outside
        ``resident_bytes``."""
        n, bn, dev = self.n, self._bn, self.device
        names = CORNER_FIELDS[self.storage]
        depth = self.prefetch_depth
        ids = torch.tensor(admitted, device=dev)
        window, wb = (), 1
        for j, bid in enumerate(admitted):
            for ahead in admitted[j:j + 1 + depth]:
                self._ensure_inflight(ahead)
            corners = self._fields(self._block(bid), names)
            if not window:
                row_bytes = sum(_nbytes(t) for t in corners) // bn
                wb = min(_window_blocks(row_bytes, bn, qb.shape[0]),
                         len(admitted))
                window = tuple(torch.empty((wb * bn,) + t.shape[1:],
                                           dtype=t.dtype, device=dev)
                               for t in corners)
                self._window_bytes = sum(_nbytes(b) for b in window)
            w = j % wb
            for buf, t in zip(window, corners, strict=True):
                buf[w * bn:(w + 1) * bn].copy_(t)
            if w == wb - 1 or j == len(admitted) - 1:
                rows = (w + 1) * bn
                sel, count = _prune_pool(
                    sel, count, tuple(buf[:rows] for buf in window),
                    kernel_ref.block_rows(ids[j - w:j + 1], bn), qs, qb,
                    budget, n, self.storage)
        return sel, count

    def _search_tiered(self, ys: Tensor, k: int, budget: int, p_guarantee,
                       env_block_rows: int) -> SearchResult:
        q = ys.shape[0]
        n, bn, nb = self.n, self._bn, self._nb
        dev = self.device
        storage = self.storage
        qs, qb, env_admit = _stage_a(self._hot, ys, k, self.block_rows,
                                     env_block_rows, p_guarantee)
        # A block runs (for all queries) iff some query admits it; the host
        # decides here, so a rejected block is never fetched.
        admitted = torch.nonzero(env_admit.any(dim=1)).flatten().tolist()
        self.stats["blocks_admitted"] += len(admitted)
        self.stats["blocks_total"] += nb
        self.stats["queries"] += int(q)
        self.stats["searches"] += 1

        sel = torch.full((q, budget), n - 1, dtype=torch.long, device=dev)
        count = torch.zeros((q,), dtype=torch.long, device=dev)
        if not admitted:
            # Every slot is invalid: the resident refine masks them all to
            # +BIG, and its stable sort keeps the first k slots.
            ids = self._hot.point_ids[sel[:, :k]]
            dists = torch.full((q, k), POS_BIG, dtype=torch.float32,
                               device=dev)
            return SearchResult(ids=ids, dists=dists, exact=count <= budget,
                                num_candidates=count)

        with self._lock:
            all_cached = all(b in self._cache for b in admitted)
        if all_cached:
            # Warm path: one prune launch over the pooled admitted rows.
            corners, gidx, tables, pos_of = self._pooled(tuple(admitted))
            sel, count = _prune_pool(sel, count, corners, gidx, qs, qb,
                                     budget, n, storage)
        else:
            sel, count = self._stage_b(admitted, sel, count, qs, qb, budget)
            # Stage C pool: every valid candidate lies in an admitted
            # block, so the pool is the admitted set; blocks evicted during
            # Stage B are fetched again.
            for b in admitted:
                self._ensure_inflight(b)
            bundles = [self._block(b) for b in admitted]
            tables = tuple(torch.cat(parts) for parts in zip(*(
                self._fields(b, REFINE_FIELDS[storage]) for b in bundles),
                strict=True))
            del bundles
            pos_of = torch.zeros(nb, dtype=torch.long, device=dev)
            pos_of[admitted] = torch.arange(len(admitted), device=dev)
        ids, dists = _refine_tiles(tables, pos_of, sel, count, qs,
                                   self._hot.point_ids, k, self.family_name,
                                   bn, budget)
        return SearchResult(ids=ids, dists=dists, exact=count <= budget,
                            num_candidates=count)
