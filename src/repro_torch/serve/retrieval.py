"""Fault-tolerant multi-tenant retrieval front end over BrePartition search
(port of ``repro.serve.retrieval``).

This is the layer between clients and ``knn_search_batch`` that the
engine-room code deliberately does not provide: deadlines, admission control, graceful degradation, and failure
containment.  Robustness is the CONTRACT here, not a best effort:

* **Request lifecycle.**  ``submit(tenant, queries, k, deadline_s,
  target_recall)`` admits into a BOUNDED queue; a full queue rejects with
  ``retry_after`` (explicit backpressure — the service never buffers
  unboundedly).  ``k`` is validated against the tenant's LIVE point count
  and query rows against the Bregman family's domain
  (``core.search.validate_queries``) at admission, so malformed requests
  fail fast with a named row instead of deep in a kernel.
  ``step()`` drains the queue by CROSS-REQUEST MICROBATCHING: requests
  sharing (tenant, k, target_recall) concatenate into one
  ``knn_search_batch`` launch whose query count is padded to a configured
  bucket size.  Eager torch compiles nothing, but the buckets are kept as
  the reference's: the CPU's plain refine rounds by the batch's shape, so
  the same padded batches keep the CPU service equal to the reference's;
  on the card a pad row changes no row's bits.

* **Degradation ladder** (paper §8 + Abdullah et al., arXiv 1108.0835 —
  trade accuracy for time instead of timing out):

      exact  ->  approx (§8 CDF shrink)  ->  partial (budget-capped)  ->  shed

  The ladder is COST-DRIVEN: a per-tenant launch-cost model (peak-tracking
  EWMA of observed launch seconds) prices each tier, and the microbatch
  enters at the highest tier whose price fits the remaining deadline.
  Exact-tier budget retries reuse ``fitted_budget`` but are capped by the
  remaining deadline instead of doubling forever; when time runs out the
  last capped result is returned as-is.  Every response carries a
  ``quality`` label (``exact | approx | partial | shed``) derived from
  what ACTUALLY happened — the per-row ``exact`` flags and the pipeline
  that ran — never from what was planned, so degradation is observable
  and truthful (tests compare exact-labeled responses bit-for-bit against
  a fault-free oracle).

* **Failure containment.**  Launches run behind a per-tenant CIRCUIT
  BREAKER (closed -> open after ``breaker_threshold`` consecutive
  failures -> half-open probe after ``breaker_cooldown_s`` -> closed on
  success); an open breaker sheds with ``retry_after`` instead of queuing
  doomed work.  Launch failures back off with seeded jittered exponential
  delays (``faults.jittered_backoff``), re-entering the ladder at
  whatever tier the post-backoff remaining deadline affords.  A launch
  that blocks past ``launch_timeout_s`` counts as a breaker failure even
  though its (completed) result is still used — slow launches open the
  breaker before they melt the queue.  Every launch is ended by a sync of
  the tenant's device before its time is read, so the cost model, the
  timeout and the ladder see device time, not the time to enqueue.
  Distributed tenants (``mesh=``) wire ``dist.knn.distributed_knn``'s
  per-launch timeout and hook for the same behavior per internal retry.
  The service coordinates nothing across ranks: its tiers, breaker and
  admission follow each rank's own clock, so its sharded tenants are
  safe only on a mesh of one rank.

* **Consistency under mutation.**  Each microbatch searches a SNAPSHOT
  (``view()``) taken before its first launch, so background
  insert/delete/compact on the mutable index never races an in-flight
  search — results are bit-identical to searching the snapshot.
  Poisoned INDEX rows (NaN / domain violations) found at registration are
  quarantined (tombstoned) and the tenant is marked degraded — contained,
  not crashed; poisoned QUERY rows are shed individually
  (``row_quality``), never dragging down their batchmates.

* **Determinism.**  The service reads time only through an injectable
  clock and takes an optional ``faults.FaultPlan``, so chaos scenarios
  (latency spikes, launch exceptions, poisoned queries,
  compaction-during-search, shard stalls) are seeded and replayable —
  see serve/faults.py and tests/test_torch_retrieval.py.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque

import numpy as np
import torch

from ..core import calibrate as breg_cal
from ..core import search as bp
from ..core import tiered as tiered_store
from ..core.bregman import valid_rows_mask, validate_rows
from ..core.segments import SegmentedForest
from ..device import synchronize
from ..dist import knn as dist_knn
from ..dist.knn import LaunchTimeout
from ..launch import autotune

from .faults import FaultPlan, SystemClock, jittered_backoff

QUALITY_EXACT = "exact"
QUALITY_APPROX = "approx"
QUALITY_PARTIAL = "partial"
QUALITY_SHED = "shed"
_QORDER = {QUALITY_EXACT: 0, QUALITY_APPROX: 1, QUALITY_PARTIAL: 2,
           QUALITY_SHED: 3}
_LADDER = (QUALITY_EXACT, QUALITY_APPROX, QUALITY_PARTIAL)


def resolve_deadline_s(deadline_s, default_s: float) -> float:
    """THE per-request deadline resolver (brelint knob-contract).

    ``None`` picks the service default; an explicit deadline must be a
    finite positive number of seconds — zero/negative/NaN deadlines would
    make every request deadline-shed before its first launch, a config
    error worth rejecting at submission.
    """
    if deadline_s is None:
        return float(default_s)
    d = float(deadline_s)
    if not math.isfinite(d) or d <= 0.0:
        raise ValueError(
            f"deadline_s must be a finite positive number, got {deadline_s!r}")
    return d


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Tuning knobs (the reference's defaults)."""

    queue_depth: int = 64           # bounded admission queue (backpressure)
    max_batch: int = 32             # query rows per microbatch launch
    buckets: tuple = (1, 2, 4, 8, 16, 32)   # padded q shapes (program reuse)
    default_deadline_s: float = 1.0
    launch_timeout_s: float | None = 5.0    # breaker-failure threshold
    default_p_guarantee: float = 0.9        # approx tier's §8 p
    breaker_threshold: int = 3      # consecutive failures -> open
    breaker_cooldown_s: float = 2.0  # open -> half-open probe delay
    max_retries: int = 2            # failed-launch retries per microbatch
    backoff_base_s: float = 0.05
    backoff_max_s: float = 1.0
    # Cost floors, as multiples of the estimated launch cost: a tier is
    # only entered when the remaining deadline exceeds its floor.  Exact
    # needs headroom for a possible budget retry; partial runs one
    # minimal-budget launch.
    exact_margin: float = 2.0
    approx_margin: float = 1.0
    partial_margin: float = 0.5
    # A microbatch runs on its TIGHTEST member's deadline, so coupling a
    # fresh request to a nearly-expired one would degrade (or shed) the
    # fresh one.  A request only joins a batch while the batch's
    # max/min remaining-deadline ratio stays within this factor;
    # incompatible requests wait for the next tick's batch instead.
    deadline_spread: float = 2.0
    validate_index: bool = True     # quarantine poisoned rows at register
    record_snapshots: bool = False  # keep per-batch snapshot in meta (tests)


class CircuitBreaker:
    """closed -> open (threshold consecutive failures) -> half-open -> ...

    ``allow(now)`` answers "may a launch go out right now" and is
    SIDE-EFFECT-FREE: an open breaker says no until ``cooldown_s`` has
    passed, then answers yes.  The open -> half_open transition happens in
    ``begin_probe``, called only when a launch is ACTUALLY attempted — a
    caller that asks permission and then sheds anyway (deadline ran out
    between the check and the launch) leaves the breaker open with its
    cooldown clock intact instead of wedging it in a probe-in-flight
    state that nothing will ever resolve.  Half-open admits exactly one
    probe; the probe's outcome closes or re-opens.  Success in any state
    resets to closed.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 2.0):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.state = "closed"
        self.failures = 0
        self.opened_at = -math.inf
        self.opens = 0              # telemetry: times the breaker tripped

    def allow(self, now: float) -> bool:
        if self.state == "closed":
            return True
        if self.state == "open":
            return now - self.opened_at >= self.cooldown_s
        return False                # half-open probe in flight

    def begin_probe(self) -> None:
        """A launch is going out while open: mark it as the probe."""
        if self.state == "open":
            self.state = "half_open"

    def record_success(self) -> None:
        self.state = "closed"
        self.failures = 0

    def record_failure(self, now: float) -> None:
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.threshold:
            self.state = "open"
            self.opened_at = now
            self.failures = 0
            self.opens += 1

    def retry_after(self, now: float) -> float:
        if self.state == "open":
            return max(0.0, self.opened_at + self.cooldown_s - now)
        if self.state == "half_open":
            return self.cooldown_s  # probe in flight; retry after it lands
        return 0.0


class LaunchCostModel:
    """Peak-tracking launch-cost estimate in seconds.

    ``max(latest, 0.7 * est + 0.3 * latest)``: jumps to a spike
    immediately (deadline decisions must react to the FIRST slow launch,
    not the EWMA-smoothed fifth) and decays as healthy launches return.
    Starts optimistic (0.0): the first launch is always attempted and
    teaches the model; a too-early deadline is then missed by at most
    that one launch, which is the service's documented guarantee.
    """

    def __init__(self, decay: float = 0.7):
        self.decay = decay
        self._est: float | None = None

    def observe(self, dt: float) -> None:
        dt = float(dt)
        if self._est is None:
            self._est = dt
        else:
            self._est = max(dt, self.decay * self._est
                            + (1.0 - self.decay) * dt)

    def estimate(self) -> float:
        return 0.0 if self._est is None else self._est


@dataclasses.dataclass
class Tenant:
    """Per-tenant registry entry: index + isolation state."""

    name: str
    index: object                   # BallForest | SegmentedForest
    family: object
    family_name: str
    breaker: CircuitBreaker
    cost: LaunchCostModel
    p_guarantee: float
    degraded: bool = False          # poisoned rows were quarantined
    quarantined: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty((0,), np.int32))
    # Streaming-scan block size, resolved from the autotuner table ONCE at
    # registration (launch/autotune.py); None = resolve_block_rows's
    # default.
    block_rows: int | None = None
    # Out-of-core residency (core/tiered.py): a TieredPointStore snapshot
    # frozen at registration, used as the launch snapshot in place of
    # _as_forest(index).  None = fully device-resident.
    tiered: object = None
    # A point-major shard over a mesh (dist/knn.py), frozen at
    # registration; its launches run distributed_knn.  None = one device.
    sharded: object = None

    @property
    def live_n(self) -> int:
        return int(getattr(self.index, "live_n", self.index.n))

    @property
    def device(self) -> torch.device:
        """Where the tenant's searches run: its shard's device, else its
        index's."""
        if self.sharded is not None:
            return self.sharded.forest.device
        return self.index.device


@dataclasses.dataclass
class RetrievalResponse:
    """What a ticket resolves to.  ``quality`` is the headline label.

    ``quality`` describes the retrieval tier of the NON-flagged rows
    (worst row wins: exact < approx < partial < shed); rows the admission
    gate flagged as poisoned are listed in ``flagged_rows`` and carry
    ``row_quality == "shed"`` with ids -1 / dists inf — a poisoned row
    never degrades its batchmates, only itself.  ``retry_after`` is set
    on backpressure sheds (full queue, open breaker).
    """

    uid: int
    tenant: str
    quality: str
    ids: np.ndarray                 # (q, k) int32, -1 for shed rows
    dists: np.ndarray               # (q, k) float32, inf for shed rows
    row_quality: list
    flagged_rows: list
    shed_reason: str | None = None
    retry_after: float | None = None
    error: str | None = None
    tenant_degraded: bool = False
    latency_s: float = 0.0
    deadline_met: bool = True
    # Measured recall estimate for ``quality="approx"`` responses: the
    # calibration curve's value at the shrink level that actually ran
    # (core/calibrate.py).  None for exact responses (recall is 1.0 by
    # construction) and for approx responses of uncalibrated tenants
    # (nothing was measured — the honest answer is "unknown").
    expected_recall: float | None = None
    meta: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Ticket:
    uid: int
    done: bool = False
    response: RetrievalResponse | None = None


@dataclasses.dataclass
class _Request:
    uid: int
    tenant: str
    queries: np.ndarray             # (q, d) float32, poisoned rows replaced
    k: int
    deadline: float                 # absolute clock time
    target_recall: float | None
    submitted_at: float
    ok_rows: np.ndarray             # (q,) bool — admission gate verdict
    ticket: Ticket


class RetrievalService:
    """The multi-tenant front end.  Single-threaded and deterministic:
    ``submit`` enqueues, ``step`` forms and runs microbatches.  A real
    deployment calls ``step`` from its event loop; tests drive it
    directly with a virtual clock.  Each tenant's searches run on its
    index's device (the card, or the CPU for an index built there).
    """

    def __init__(self, config: ServiceConfig | None = None, *,
                 clock=None, faults: FaultPlan | None = None,
                 seed: int = 0):
        self.config = config or ServiceConfig()
        self.clock = clock or SystemClock()
        self.faults = faults
        self.tenants: dict[str, Tenant] = {}
        self.queue: deque[_Request] = deque()
        self._uid = 0
        self._rng = np.random.default_rng(seed)
        self.counters = {
            "submitted": 0, "rejected_queue_full": 0, "rejected_bad_k": 0,
            "completed": 0, "launches": 0, "launch_failures": 0,
            "launch_timeouts": 0, "escalations": 0, "breaker_sheds": 0,
            "deadline_sheds": 0, "poisoned_rows": 0,
            QUALITY_EXACT: 0, QUALITY_APPROX: 0, QUALITY_PARTIAL: 0,
            QUALITY_SHED: 0,
        }

    # -- tenants ------------------------------------------------------------

    def register_tenant(self, name: str, index, *, mesh=None, axis="data",
                        p_guarantee: float | None = None,
                        calibrate: bool = False,
                        calibrate_k: int = 10,
                        resident_bytes: int | None = None,
                        prefetch_depth: int | None = None) -> Tenant:
        """Admit an index into the registry, quarantining poisoned rows.

        With ``config.validate_index`` every live row is checked against
        the family domain (NaN / open-bound violations), on the index's
        device (no row is copied to the host).  Offenders are
        TOMBSTONED — an immutable BallForest is first wrapped into a
        :class:`SegmentedForest` so the quarantine is a mutation, not a
        rebuild — and the tenant is marked ``degraded`` with the
        quarantined ids kept for audit.  Searches then run exact over the
        clean live set; every response advertises ``tenant_degraded``.

        ``calibrate=True`` fits a recall-calibration curve at registration
        when the index does not already carry one (the preferred place is
        ``build_index(calibrate=True)`` — this is the catch-up path for
        indexes built before calibration existed).  The fit runs AFTER
        quarantine (measured over the clean live set) and BEFORE sharding
        (the sharded snapshot carries the curve).

        ``mesh`` (a ``DeviceMesh``, dist/sharding.py) shards the
        (validated) index point-major over its ``axis`` dim for
        ``distributed_knn`` launches, on the mesh's device type; the
        sharded snapshot is FROZEN at registration — re-register after
        mutating to reshard.  Only a mesh of one rank is safe: each
        rank's service would choose its tiers and launches by its own
        clock, and ranks that launch differently wait on each other's
        collectives (``distributed_knn`` itself keeps its ranks in step).

        ``resident_bytes`` tiers the tenant out-of-core (core/tiered.py):
        cold point blocks live in host RAM behind that device-cache
        budget and launches run against the TieredPointStore snapshot —
        frozen at registration.  ``prefetch_depth`` sets its double-buffer
        depth.  Mutually exclusive with ``mesh`` (a shard IS a residency
        decision).
        """
        bp.validate_p_guarantee(p_guarantee)
        resident_bytes = tiered_store.resolve_resident_bytes(resident_bytes)
        prefetch_depth = tiered_store.resolve_prefetch_depth(prefetch_depth)
        if mesh is not None and resident_bytes is not None:
            raise ValueError(
                "resident_bytes and mesh are mutually exclusive: a sharded "
                "tenant's residency is the shard layout")
        fam = index.family
        quarantined = np.empty((0,), np.int32)
        if self.config.validate_index:
            if not isinstance(index, SegmentedForest):
                ok = valid_rows_mask(fam, index.rows_view())
                live = index.point_ids >= 0
                if bool((live & ~ok).any()):
                    index = SegmentedForest.from_forest(index)
            if isinstance(index, SegmentedForest):
                quarantined = index.quarantine()
        if calibrate:
            index = breg_cal.ensure_calibration(index, k=calibrate_k)
        sharded = None
        if mesh is not None:
            sharded = dist_knn.shard_index(index, mesh, axis,
                                           device=mesh.device_type)
        # Pin the tuned block size now: the table lookup keys on the live
        # row count, the service's largest query bucket (the steady-state
        # heavy-traffic shape), the storage tier and the index's device.
        # A table miss pins None and the search layer resolves its own.
        live_n = int(getattr(index, "live_n", index.n))
        block_rows = autotune.lookup_block_rows(
            max(live_n, 1), max(self.config.buckets),
            storage=getattr(index, "storage", None), device=index.device)
        tiered = None
        if resident_bytes is not None:
            # Snapshot AFTER quarantine/calibration so the store serves
            # the same clean live set as a resident launch would; a
            # wedged fetch surfaces within one launch-timeout window.
            tiered = tiered_store.TieredPointStore.from_index(
                index, resident_bytes=resident_bytes,
                prefetch_depth=prefetch_depth, block_rows=block_rows,
                fetch_timeout_s=self.config.launch_timeout_s)
        tenant = Tenant(
            name=name, index=index, family=fam,
            family_name=index.family_name,
            breaker=CircuitBreaker(self.config.breaker_threshold,
                                   self.config.breaker_cooldown_s),
            cost=LaunchCostModel(),
            p_guarantee=(self.config.default_p_guarantee
                         if p_guarantee is None else float(p_guarantee)),
            degraded=quarantined.size > 0, quarantined=quarantined,
            block_rows=block_rows, tiered=tiered, sharded=sharded)
        self.tenants[name] = tenant
        return tenant

    def warm(self, tenant: str, shapes=None) -> dict:
        """Run the launches a tenant's traffic will hit once, off the books.

        A cold first launch pays one-time costs (the kernel library's
        load, the allocator's first blocks, lazy module state), which
        both blow the first requests' deadlines AND teach the launch
        cost model that every launch costs that much — the ladder then
        sheds healthy traffic.  Launches run DIRECTLY against the
        tenant's snapshot, so no counters, breaker state, or cost-model
        observations are touched.

        ``shapes`` is an iterable of ``(q, k)`` pairs mirroring expected
        traffic; each ``q`` is rounded up to its service bucket (the
        shape real microbatches launch at) and both ladder entry tiers —
        exact and §8 approx at the tenant's ``p_guarantee`` — run.
        Default: every configured bucket at k=10.

        For a tiered tenant (``resident_bytes``) this also pre-populates
        the device-side block cache up to the residency budget
        (``TieredPointStore.warm_cache``), so first queries pay no
        host->device transfer.
        """
        t = self.tenants[tenant]
        if shapes is None:
            shapes = [(b, 10) for b in self.config.buckets]
        snapshot = (t.tiered if t.tiered is not None
                    else bp._as_forest(t.index))
        dev = t.device
        # Ones-rows are inside every family's domain (the same reasoning
        # as the index's inert fill), so synthetic warmup queries are
        # domain-safe without sampling tenant data.
        programs = []
        for q, k in shapes:
            q, k = int(q), int(k)
            bucket = next((b for b in self.config.buckets if b >= q), q)
            if (bucket, k) in programs:
                continue
            programs.append((bucket, k))
            ys = torch.ones((bucket, snapshot.d), dtype=torch.float32,
                            device=dev)
            budget = bp.default_budget(snapshot, k)
            if t.sharded is not None:
                # Sharded tenants launch distributed_knn, so warm that.
                for ap in (None, np.float32(t.p_guarantee)):
                    dist_knn.distributed_knn(
                        t.sharded, ys, family=t.family_name, k=k,
                        budget=budget, block_rows=t.block_rows,
                        approx_p=ap, device=dev)
                continue
            bp.knn_search_batch(snapshot, ys, k, budget,
                                block_rows=t.block_rows, validate=False,
                                device=dev)
            bp.knn_search_batch_approx(
                snapshot, ys, k, budget, np.float32(t.p_guarantee),
                block_rows=t.block_rows, validate=False, device=dev)
            synchronize(dev)
        out = {"tenant": tenant, "programs": programs, "tiered": None}
        if t.tiered is not None:
            out["tiered"] = t.tiered.warm_cache()
        return out

    # -- admission ----------------------------------------------------------

    def submit(self, tenant: str, queries, k: int, *,
               deadline_s: float | None = None,
               target_recall: float | None = None) -> Ticket:
        """Admit one request; returns a :class:`Ticket`.

        Backpressure and validation failures resolve the ticket
        IMMEDIATELY (``quality == "shed"`` with ``shed_reason`` /
        ``retry_after``) rather than raising — rejection is part of the
        response contract, not an exception.  Unknown tenants and
        malformed knobs (``target_recall`` outside [0, 1], non-positive
        ``deadline_s``) are the programming errors that raise.
        """
        if tenant not in self.tenants:
            raise KeyError(f"unknown tenant {tenant!r}; "
                           f"registered: {sorted(self.tenants)}")
        breg_cal.validate_target_recall(target_recall)
        t = self.tenants[tenant]
        now = self.clock.now()
        if isinstance(queries, torch.Tensor):
            queries = queries.detach().cpu().numpy()
        qs = np.array(queries, np.float32, copy=True)
        if qs.ndim == 1:
            qs = qs[None, :]
        uid = self._uid
        self._uid += 1
        self.counters["submitted"] += 1
        ticket = Ticket(uid=uid)

        if k < 1 or k > t.live_n:
            # Up-front k validation: k > live_n would otherwise surface as
            # a ValueError deep inside the pipeline (or, worse, as padded
            # sentinel rows in the result).
            self.counters["rejected_bad_k"] += 1
            self._resolve_shed(
                ticket, uid, tenant, qs.shape[0], k, now, now,
                reason="bad_k",
                error=(f"k={k} is outside [1, live_n={t.live_n}] for "
                       f"tenant {tenant!r}"))
            return ticket

        if self.faults is not None:
            self.faults.on_submit(tenant, qs)   # may poison rows in place

        ok = validate_rows(t.family, qs, mode="mask")
        self.counters["poisoned_rows"] += int((~ok).sum())
        if len(self.queue) >= self.config.queue_depth:
            # Reject-with-retry-after: the queue is the ONLY buffer, and
            # it is bounded.  The hint prices the backlog with the cost
            # model so well-behaved clients spread their retries.
            self.counters["rejected_queue_full"] += 1
            est = max(self.tenants[tenant].cost.estimate(),
                      self.config.backoff_base_s)
            batches = math.ceil(len(self.queue) / self.config.max_batch)
            self._resolve_shed(
                ticket, uid, tenant, qs.shape[0], k, now, now,
                reason="queue_full", retry_after=est * batches)
            return ticket

        deadline = now + resolve_deadline_s(
            deadline_s, self.config.default_deadline_s)
        self.queue.append(_Request(
            uid=uid, tenant=tenant, queries=qs, k=int(k), deadline=deadline,
            target_recall=target_recall, submitted_at=now, ok_rows=ok,
            ticket=ticket))
        return ticket

    # -- the service loop ---------------------------------------------------

    def step(self) -> int:
        """One scheduling tick: shed expired work, launch microbatches.

        Returns the number of requests resolved this tick.
        """
        resolved = 0
        now = self.clock.now()
        # Expire queued requests whose deadline already passed — shedding
        # in O(1) beats launching work nobody is waiting for.
        still = deque()
        for req in self.queue:
            if req.deadline <= now:
                self.counters["deadline_sheds"] += 1
                self._resolve_shed(req.ticket, req.uid, req.tenant,
                                   req.queries.shape[0], req.k,
                                   req.submitted_at, now, reason="deadline",
                                   deadline=req.deadline)
                resolved += 1
            else:
                still.append(req)
        self.queue = still

        # Microbatch: FIFO within (tenant, k, target_recall) groups, up to
        # max_batch query rows per launch group.  The TENANT component is
        # load-bearing for correctness, not just isolation: target_recall
        # resolves to a per-tenant shrink factor through each index's own
        # calibration curve, so two tenants sharing a target must never
        # share a launch (tests/test_calibration.py pins this down).
        groups: dict[tuple, list[_Request]] = {}
        order: list[tuple] = []
        for req in self.queue:
            key = (req.tenant, req.k, req.target_recall)
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(req)
        spread = self.config.deadline_spread
        for key in order:
            reqs, rows = [], 0
            min_rem = max_rem = 0.0
            for req in groups[key]:
                rem = req.deadline - now    # > 0: expiry sweep ran above
                if reqs:
                    if rows + req.queries.shape[0] > self.config.max_batch:
                        break
                    # Deadline-compatibility guard: the batch runs on its
                    # tightest deadline, so don't couple requests whose
                    # remaining deadlines differ by more than the
                    # configured spread — the rest of the group waits for
                    # the next tick rather than degrading with this one.
                    if max(max_rem, rem) > spread * min(min_rem, rem):
                        break
                reqs.append(req)
                rows += req.queries.shape[0]
                min_rem = min(min_rem, rem) if len(reqs) > 1 else rem
                max_rem = max(max_rem, rem) if len(reqs) > 1 else rem
            for req in reqs:
                self.queue.remove(req)
            resolved += self._run_microbatch(self.tenants[key[0]], reqs,
                                             key[2])
        return resolved

    def run_until_drained(self, max_steps: int = 1000) -> None:
        """Drive ``step`` until the queue empties (bounded — never hangs)."""
        for _ in range(max_steps):
            if not self.queue:
                return
            self.step()
        raise RuntimeError(
            f"queue not drained after {max_steps} steps "
            f"({len(self.queue)} requests left) — scheduler stuck?")

    def search_sync(self, tenant: str, queries, k: int, *,
                    deadline_s: float | None = None,
                    target_recall: float | None = None) -> RetrievalResponse:
        """Blocking convenience path: submit + step until resolved.

        The route in-process hooks use (serve/knnlm.py): one caller, no
        event loop, but the same admission gate, ladder, and labels.
        """
        ticket = self.submit(tenant, queries, k, deadline_s=deadline_s,
                             target_recall=target_recall)
        steps = 0
        while not ticket.done:
            self.step()
            steps += 1
            if steps > 1000:
                raise RuntimeError("search_sync: ticket never resolved")
        return ticket.response

    def stats(self) -> dict:
        """Counter snapshot plus per-tenant breaker/degradation state."""
        out = dict(self.counters)
        out["queued"] = len(self.queue)
        out["tenants"] = {
            name: {"breaker": t.breaker.state,
                   "breaker_opens": t.breaker.opens,
                   "degraded": t.degraded,
                   "quarantined": int(t.quarantined.size),
                   "est_launch_s": t.cost.estimate(),
                   "live_n": t.live_n}
            for name, t in self.tenants.items()}
        return out

    # -- microbatch execution -----------------------------------------------

    def _run_microbatch(self, tenant: Tenant, reqs: list,
                        target_recall) -> int:
        """Run one microbatch; returns how many requests were RESOLVED
        (a deadline shed requeues batchmates whose own deadlines still
        have slack, so the count can be less than ``len(reqs)``)."""
        cfg = self.config
        now = self.clock.now()
        deadline = min(r.deadline for r in reqs)

        # Assemble the query block: poisoned rows are replaced by the
        # first valid row in the batch (the launch math must stay finite)
        # and masked out of the results afterwards.
        blocks = [r.queries for r in reqs]
        ys = np.concatenate(blocks, axis=0)
        ok = np.concatenate([r.ok_rows for r in reqs])
        if not ok.any():
            for r in reqs:
                self._resolve_shed(r.ticket, r.uid, r.tenant,
                                   r.queries.shape[0], r.k, r.submitted_at,
                                   now, reason="poisoned",
                                   deadline=r.deadline)
            return len(reqs)
        filler = ys[int(np.argmax(ok))]
        ys[~ok] = filler
        q_total = ys.shape[0]
        bucket = next((b for b in cfg.buckets if b >= q_total), q_total)
        if bucket > q_total:
            ys = np.concatenate(
                [ys, np.broadcast_to(filler, (bucket - q_total,
                                              ys.shape[1]))])

        if not tenant.breaker.allow(now):
            self.counters["breaker_sheds"] += 1
            retry = tenant.breaker.retry_after(now)
            for r in reqs:
                self._resolve_shed(r.ticket, r.uid, r.tenant,
                                   r.queries.shape[0], r.k, r.submitted_at,
                                   now, reason="breaker_open",
                                   retry_after=retry, deadline=r.deadline)
            return len(reqs)

        # Snapshot BEFORE any launch: background insert/delete/compact on
        # the mutable index (including fault-injected compactions) cannot
        # perturb this microbatch's results.  A tiered tenant launches
        # against its (construction-time-frozen) TieredPointStore — same
        # results bit-for-bit, cold rows fetched on envelope admission.
        snapshot = (tenant.tiered if tenant.tiered is not None
                    else bp._as_forest(tenant.index))
        k = reqs[0].k
        # Resolve the §8 shrink level from THIS tenant's snapshot: a
        # client target_recall inverts the index's measured calibration
        # curve (core/calibrate.py; uncalibrated indexes fall back to
        # p = target, the historical behavior, with a one-time warning) —
        # target_recall and p_guarantee are different quantities and are
        # never conflated on a calibrated index.  Two tenants sharing a
        # target_recall may resolve to different p: the microbatch key in
        # step() is tenant-scoped, so each batch reaches here with one
        # tenant and one resolved shrink.
        cal = getattr(snapshot, "calibration", None)
        if target_recall is None:
            p = tenant.p_guarantee
            expected = None if cal is None else cal.expected_recall(p)
        else:
            p, expected = breg_cal.resolve_p_guarantee(snapshot,
                                                       target_recall)

        meta: dict = {"bucket": bucket, "attempts": 0, "tier_path": [],
                      "p_guarantee": p}
        # One upload of the padded block for every launch of the batch.
        ys = torch.as_tensor(ys, device=tenant.device)
        if expected is not None:
            meta["expected_recall"] = expected
        if cfg.record_snapshots:
            meta["snapshot"] = snapshot
        res, used_approx, error = None, False, None
        failures = 0
        while True:
            now = self.clock.now()
            tier = self._choose_tier(tenant, deadline - now, target_recall)
            if tier == QUALITY_SHED:
                break
            meta["tier_path"].append(tier)
            meta["attempts"] += 1
            try:
                res, used_approx, budget = self._run_tier(
                    tenant, snapshot, ys, k, tier, p, deadline)
                meta["budget"] = budget
                break
            except Exception as e:  # noqa: BLE001 — containment layer
                failures += 1
                self.counters["launch_failures"] += 1
                tenant.breaker.record_failure(self.clock.now())
                error = f"{type(e).__name__}: {e}"
                if failures > cfg.max_retries:
                    break
                if not tenant.breaker.allow(self.clock.now()):
                    break
                back = jittered_backoff(cfg.backoff_base_s, failures - 1,
                                        cfg.backoff_max_s, self._rng)
                self.clock.sleep(
                    min(back, max(0.0, deadline - self.clock.now())))

        finished = self.clock.now()
        if res is None:
            reason = "launch_failed" if error else "deadline"
            if not error:
                self.counters["deadline_sheds"] += 1
            retry = (tenant.breaker.retry_after(finished)
                     if tenant.breaker.state == "open" else None)
            resolved = 0
            requeue = []
            for r in reqs:
                if (reason == "deadline" and r.deadline > deadline
                        and r.deadline > finished):
                    # The BATCH deadline (its tightest member) ran out,
                    # not this request's: requeue it so it retries on its
                    # own, later, deadline instead of shedding healthy
                    # traffic.  The batch min strictly increases each
                    # round, so this terminates.
                    requeue.append(r)
                    continue
                self._resolve_shed(r.ticket, r.uid, r.tenant,
                                   r.queries.shape[0], r.k, r.submitted_at,
                                   finished, reason=reason, error=error,
                                   retry_after=retry, meta=dict(meta),
                                   deadline=r.deadline)
                resolved += 1
            for r in reversed(requeue):     # back to the head, FIFO order
                self.queue.appendleft(r)
            return resolved

        ids = res.ids[:q_total].cpu().numpy()
        dists = res.dists[:q_total].cpu().numpy()
        exact = res.exact[:q_total].cpu().numpy()
        row = 0
        for r in reqs:
            q = r.queries.shape[0]
            sl = slice(row, row + q)
            self._resolve(r, ids[sl].copy(), dists[sl].copy(), exact[sl],
                          ok[sl], used_approx, finished, dict(meta),
                          expected_recall=(expected if used_approx
                                           else None))
            row += q
        return len(reqs)

    def _choose_tier(self, tenant: Tenant, remaining: float,
                     target_recall) -> str:
        """Highest ladder tier whose cost floor fits the remaining time."""
        cfg = self.config
        est = tenant.cost.estimate()
        floors = {QUALITY_EXACT: cfg.exact_margin * est,
                  QUALITY_APPROX: cfg.approx_margin * est,
                  QUALITY_PARTIAL: cfg.partial_margin * est}
        start = 0
        if target_recall is not None and target_recall < 1.0:
            start = 1               # the client asked for the §8 trade
        if remaining <= 0:
            return QUALITY_SHED
        for tier in _LADDER[start:]:
            if remaining >= floors[tier]:
                return tier
        return QUALITY_SHED

    def _run_tier(self, tenant: Tenant, snapshot, ys, k: int, tier: str,
                  p: float, deadline: float):
        """Run one ladder tier to completion; returns (result, used_approx,
        budget).  Budget retries inside the exact/approx tiers reuse the
        ``fitted_budget`` machinery but stop when the NEXT launch would
        not fit the remaining deadline — the budget-capped partial path.
        """
        approx = tier == QUALITY_APPROX
        dev = tenant.device

        def stop_retry() -> bool:
            return (self.clock.now() + tenant.cost.estimate()) > deadline

        if tenant.sharded is not None:
            budget = bp.default_budget(snapshot, k)
            if tier == QUALITY_PARTIAL:
                budget = bp.fitted_budget(snapshot, k, 2 * k)
            res = self._launch(
                tenant, tier,
                lambda: dist_knn.distributed_knn(
                    tenant.sharded, ys,
                    family=tenant.family_name, k=k, budget=budget,
                    block_rows=tenant.block_rows,
                    approx_p=(p if approx else None),
                    stop_retry=stop_retry,
                    launch_hook=tenant.cost.observe,
                    launch_timeout_s=self.config.launch_timeout_s,
                    clock=self.clock.now, device=dev))
            return res, approx, budget

        if tier == QUALITY_PARTIAL:
            budget = bp.fitted_budget(snapshot, k, 2 * k)
            res = self._launch(
                tenant, tier,
                lambda: bp.knn_search_batch(snapshot, ys, k, budget,
                                            block_rows=tenant.block_rows,
                                            validate=False, device=dev))
            return res, False, budget

        budget = bp.default_budget(snapshot, k)
        while True:
            b = budget
            if approx:
                res = self._launch(
                    tenant, tier,
                    lambda: bp.knn_search_batch_approx(
                        snapshot, ys, k, b, np.float32(p),
                        block_rows=tenant.block_rows, validate=False,
                        device=dev))
            else:
                res = self._launch(
                    tenant, tier,
                    lambda: bp.knn_search_batch(snapshot, ys, k, b,
                                                block_rows=tenant.block_rows,
                                                validate=False, device=dev))
            if bool(res.exact.all()) or budget >= snapshot.n:
                return res, approx, budget
            if stop_retry():
                # Deadline-capped: keep the partial result instead of
                # doubling forever (the rows that fit are still exact).
                return res, approx, budget
            self.counters["escalations"] += 1
            budget = bp.fitted_budget(snapshot, k,
                                      int(res.num_candidates.max()))

    def _launch(self, tenant: Tenant, tier: str, thunk):
        """One guarded launch: faults, timing, cost model, breaker."""
        cfg = self.config
        attempt = self.counters["launches"]
        # A launch is really going out now: if the breaker was open (and
        # past cooldown — _run_microbatch checked allow()), this is the
        # half-open probe.  Any exception from here on reaches the
        # caller's record_failure, so the probe always resolves.
        tenant.breaker.begin_probe()
        # The timer starts BEFORE the fault hook: anything that stalls the
        # launch path synchronously (an injected compaction, a seized GIL)
        # is launch cost as far as deadlines and the cost model are
        # concerned — unattributed stalls would silently erode the
        # "deadline + one launch" guarantee.
        t0 = self.clock.now()
        extra = 0.0
        if self.faults is not None:
            extra = self.faults.before_launch(
                tenant.name, tier, attempt, tenant_obj=tenant, service=self)
        timed_out = False
        try:
            res = thunk()
            # Device time, not the time to enqueue: the cost model, the
            # timeout and the ladder read the clock after this.
            synchronize(tenant.device)
        except LaunchTimeout as e:
            # The launch COMPLETED but blocked past the timeout: use the
            # result, count the failure (slow launches must trip the
            # breaker before they wedge the queue).
            if e.result is None:
                raise
            res, timed_out = e.result, True
        if extra > 0:
            self.clock.sleep(extra)
        elapsed = self.clock.now() - t0
        tenant.cost.observe(elapsed)
        self.counters["launches"] += 1
        if self.faults is not None:
            self.faults.after_launch(tenant.name, tier, attempt,
                                     tenant_obj=tenant, service=self)
        if timed_out or (cfg.launch_timeout_s is not None
                         and elapsed > cfg.launch_timeout_s):
            self.counters["launch_timeouts"] += 1
            tenant.breaker.record_failure(self.clock.now())
        else:
            tenant.breaker.record_success()
        return res

    # -- response assembly --------------------------------------------------

    def _resolve(self, req: _Request, ids, dists, exact, ok, used_approx,
                 finished: float, meta: dict,
                 expected_recall: float | None = None) -> None:
        tenant = self.tenants[req.tenant]
        row_quality = []
        for i in range(ids.shape[0]):
            if not ok[i]:
                row_quality.append(QUALITY_SHED)
                ids[i, :] = -1
                dists[i, :] = np.inf
            elif bool(exact[i]):
                row_quality.append(QUALITY_APPROX if used_approx
                                   else QUALITY_EXACT)
            else:
                row_quality.append(QUALITY_PARTIAL)
        flagged = [i for i, o in enumerate(ok) if not o]
        valid = [q for i, q in enumerate(row_quality) if ok[i]]
        quality = (max(valid, key=_QORDER.__getitem__) if valid
                   else QUALITY_SHED)
        self.counters[quality] += 1
        self.counters["completed"] += 1
        req.ticket.response = RetrievalResponse(
            uid=req.uid, tenant=req.tenant, quality=quality, ids=ids,
            dists=dists, row_quality=row_quality, flagged_rows=flagged,
            tenant_degraded=tenant.degraded,
            latency_s=finished - req.submitted_at,
            deadline_met=finished <= req.deadline,
            expected_recall=expected_recall, meta=meta)
        req.ticket.done = True

    def _resolve_shed(self, ticket: Ticket, uid: int, tenant: str, q: int,
                      k: int, submitted: float, finished: float, *,
                      reason: str, retry_after: float | None = None,
                      error: str | None = None, meta: dict | None = None,
                      deadline: float | None = None) -> None:
        t = self.tenants.get(tenant)
        self.counters[QUALITY_SHED] += 1
        self.counters["completed"] += 1
        # Clamp the sentinel shape: ``k`` may be the UNVALIDATED value a
        # bad_k rejection is bouncing (k=1e9 must not allocate its own
        # rejection into an OOM); admitted requests have k <= live_n, so
        # their shape is unchanged.
        kk = max(1, min(int(k), t.live_n)) if t is not None else 1
        ticket.response = RetrievalResponse(
            uid=uid, tenant=tenant, quality=QUALITY_SHED,
            ids=np.full((q, kk), -1, np.int32),
            dists=np.full((q, kk), np.inf, np.float32),
            row_quality=[QUALITY_SHED] * q, flagged_rows=[],
            shed_reason=reason, retry_after=retry_after, error=error,
            tenant_degraded=bool(t.degraded) if t else False,
            latency_s=finished - submitted,
            deadline_met=(True if deadline is None
                          else bool(finished <= deadline)),
            meta=meta or {})
        ticket.done = True
