"""Deterministic, seedable fault injection for the retrieval service
(port of ``repro.serve.faults``).

A failing chaos run is only useful when it can be replayed: every fault
here is a pure function of (plan seed, event counter), never of wall
time or thread timing.  The service (serve/retrieval.py) threads a
:class:`FaultPlan` through three hook points --

* ``on_submit`` -- fires as a request enters admission, BEFORE the query
  domain gate, so injected poison exercises the real validation path;
* ``before_launch`` -- fires after the microbatch snapshot is taken and
  immediately before a search launches.  A fault may RAISE (injected
  launch failure) or return extra seconds of latency, which the service
  adds through its injectable clock (so a latency spike is visible to
  deadlines and the cost model without wall-clock sleeping);
* ``after_launch`` -- observation point for invariants.

Clocks live here too: the service never reads ``time`` directly, it reads
an injectable clock with ``now()``/``sleep(dt)``.  :class:`SystemClock`
is production; :class:`VirtualClock` makes tests fully deterministic
(latency exists only where a fault injects it); :class:`OffsetClock`
layers injected latency on top of real launch cost for chaos runs --
measured latencies then include both the real compute and the simulated
spikes, while the process never actually sleeps.

Every fault that fires appends a :class:`FaultEvent` to ``plan.events``,
so tests assert "the poison DID fire and only row r degraded" rather than
hoping.  A plan with a given seed fires the same events in the same order
as the reference's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from ..core.tiered import FetchTimeout


# ---------------------------------------------------------------------------
# Clocks
# ---------------------------------------------------------------------------

class SystemClock:
    """Wall time; ``sleep`` really sleeps (production backoff)."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)


class VirtualClock:
    """Fully simulated time — deterministic tests.

    Real launches take ZERO virtual time; only explicit ``sleep``/
    ``advance`` calls (backoff, injected latency) move the clock, so a
    test controls exactly how much of a request's deadline each fault
    consumes.
    """

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def now(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.advance(dt)

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"cannot rewind the clock (dt={dt})")
        self.t += dt


class OffsetClock:
    """Wall time plus an accumulated offset; ``sleep`` only adds offset.

    The chaos-bench clock: launch costs are real (``now`` advances with
    the actual compute), injected latency and backoff advance the offset
    instantly — observed latencies are realistic, CI wall time is not
    inflated by the injected spikes.
    """

    def __init__(self):
        self.offset = 0.0

    def now(self) -> float:
        return time.monotonic() + self.offset

    def sleep(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"cannot rewind the clock (dt={dt})")
        self.offset += dt


# ---------------------------------------------------------------------------
# Hook contexts + event log
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SubmitCtx:
    """Admission-time hook context; ``queries`` is mutated in place."""

    index: int                  # global submit counter
    tenant: str
    queries: np.ndarray         # (q, d) float32, poisonable


@dataclasses.dataclass
class LaunchCtx:
    """Launch-time hook context.

    ``tenant_obj`` is the service's live tenant record — its ``index`` is
    the MUTABLE index, not the snapshot the in-flight launch reads, which
    is exactly what compaction/ingestion races need.
    """

    index: int                  # global launch counter
    tenant: str
    tier: str                   # "exact" | "approx" | "partial"
    attempt: int                # retry ordinal within the microbatch
    tenant_obj: object = None
    service: object = None


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str                   # e.g. "latency", "error", "poison", "compact"
    where: str                  # "submit" | "launch"
    index: int                  # the counter value when it fired
    tenant: str
    detail: str = ""


class InjectedLaunchError(RuntimeError):
    """The default exception type for injected launch failures."""


# ---------------------------------------------------------------------------
# Faults
# ---------------------------------------------------------------------------

class Fault:
    """Base: no-op hooks.  Subclasses override what they inject.

    ``before_launch`` returns extra SECONDS of latency (0.0 for none) or
    raises to simulate a failed launch.  ``rng`` is the plan's seeded
    generator — faults must draw randomness ONLY from it.
    """

    def on_submit(self, ctx: SubmitCtx, rng, record) -> None:
        pass

    def before_launch(self, ctx: LaunchCtx, rng, record) -> float:
        return 0.0

    def after_launch(self, ctx: LaunchCtx, rng, record) -> None:
        pass


def _matches(sel, index: int) -> bool:
    """Launch/submit selector: None = every, int = one, iterable = set."""
    if sel is None:
        return True
    if isinstance(sel, int):
        return index == sel
    return index in sel


@dataclasses.dataclass
class LatencySpike(Fault):
    """Add ``extra_s`` (+ jittered ``jitter_s``) to matching launches."""

    extra_s: float
    jitter_s: float = 0.0
    at_launches: object = None      # None = every launch
    every: int = 1                  # ... or every n-th matching launch
    tenant: str | None = None

    def before_launch(self, ctx, rng, record) -> float:
        if self.tenant is not None and ctx.tenant != self.tenant:
            return 0.0
        if not _matches(self.at_launches, ctx.index):
            return 0.0
        if self.every > 1 and ctx.index % self.every:
            return 0.0
        extra = self.extra_s + self.jitter_s * float(rng.random())
        record(FaultEvent("latency", "launch", ctx.index, ctx.tenant,
                          f"+{extra:.3f}s tier={ctx.tier}"))
        return extra


@dataclasses.dataclass
class ShardStall(Fault):
    """A straggling shard: the whole launch blocks on it.

    Mechanically identical to a latency spike (a sharded launch is as slow
    as its slowest shard), but logged as a stall so chaos reports can
    distinguish "everything slow" from "one shard wedged".
    """

    stall_s: float
    at_launches: object = None
    shard: int = 0
    tenant: str | None = None

    def before_launch(self, ctx, rng, record) -> float:
        if self.tenant is not None and ctx.tenant != self.tenant:
            return 0.0
        if not _matches(self.at_launches, ctx.index):
            return 0.0
        record(FaultEvent("shard_stall", "launch", ctx.index, ctx.tenant,
                          f"shard={self.shard} +{self.stall_s:.3f}s"))
        return self.stall_s


@dataclasses.dataclass
class FetchStall(Fault):
    """A slow/wedged host->device cold-block fetch on a TIERED tenant.

    Applies only when the tenant record carries a TieredPointStore
    (``tenant_obj.tiered`` — core/tiered.py); fully-resident tenants have
    no fetch to stall, so the fault is a no-op there.  Two regimes,
    matching what a real stalled DMA does:

    * ``stall_s`` within the store's ``fetch_timeout_s``: the copy is
      merely slow — the launch completes and the stall rides the clock
      like a latency spike, so deadlines and the cost model see it.
    * ``stall_s`` beyond ``fetch_timeout_s``: the store would abandon the
      wait and raise ``FetchTimeout`` — this fault does exactly that
      (after charging the timeout window to the clock), so the service's
      containment (retry/backoff/breaker, then the degradation ladder)
      is exercised instead of a microbatch wedging on the copy.
    """

    stall_s: float
    at_launches: object = None
    tenant: str | None = None

    def before_launch(self, ctx, rng, record) -> float:
        if self.tenant is not None and ctx.tenant != self.tenant:
            return 0.0
        if not _matches(self.at_launches, ctx.index):
            return 0.0
        store = getattr(ctx.tenant_obj, "tiered", None)
        if store is None:
            return 0.0
        timeout = getattr(store, "fetch_timeout_s", None)
        if timeout is not None and self.stall_s > timeout:
            record(FaultEvent(
                "fetch_stall", "launch", ctx.index, ctx.tenant,
                f"+{self.stall_s:.3f}s > fetch_timeout_s={timeout:.3f}s "
                f"-> FetchTimeout"))
            if ctx.service is not None:
                # A real timed-out fetch still costs the full wait window.
                ctx.service.clock.sleep(timeout)
            raise FetchTimeout(
                f"injected: host->device fetch stalled {self.stall_s:.3f}s, "
                f"exceeding fetch_timeout_s={timeout:.3f}s "
                f"(launch {ctx.index}, tier {ctx.tier})")
        record(FaultEvent("fetch_stall", "launch", ctx.index, ctx.tenant,
                          f"+{self.stall_s:.3f}s tier={ctx.tier}"))
        return self.stall_s


@dataclasses.dataclass
class LaunchError(Fault):
    """Raise on matching launches (device loss, OOM, compile failure)."""

    at_launches: object = None
    tenant: str | None = None
    message: str = "injected launch failure"

    def before_launch(self, ctx, rng, record) -> float:
        if self.tenant is not None and ctx.tenant != self.tenant:
            return 0.0
        if not _matches(self.at_launches, ctx.index):
            return 0.0
        record(FaultEvent("error", "launch", ctx.index, ctx.tenant,
                          self.message))
        raise InjectedLaunchError(
            f"{self.message} (launch {ctx.index}, tier {ctx.tier})")


@dataclasses.dataclass
class PoisonQuery(Fault):
    """Corrupt one row of a matching submission's query block in place."""

    at_submits: object = 0
    row: int = 0
    value: float = float("nan")
    tenant: str | None = None

    def on_submit(self, ctx, rng, record) -> None:
        if self.tenant is not None and ctx.tenant != self.tenant:
            return
        if not _matches(self.at_submits, ctx.index):
            return
        r = min(self.row, ctx.queries.shape[0] - 1)
        ctx.queries[r, :] = self.value
        record(FaultEvent("poison", "submit", ctx.index, ctx.tenant,
                          f"row={r} value={self.value}"))


@dataclasses.dataclass
class CompactDuringSearch(Fault):
    """Compact (or mutate) the tenant's index between snapshot and launch.

    The service snapshots ``view()`` before launching, so a correct
    implementation returns bit-identical-to-snapshot results even though
    the index compacted underneath it mid-request; this fault makes that
    race happen on demand.  ``insert_rows > 0`` additionally appends that
    many copies of the index's first live row before compacting, so the
    compaction actually has segments to fold.
    """

    at_launches: object = 0
    tenant: str | None = None
    insert_rows: int = 0

    def before_launch(self, ctx, rng, record) -> float:
        if self.tenant is not None and ctx.tenant != self.tenant:
            return 0.0
        if not _matches(self.at_launches, ctx.index):
            return 0.0
        idx = getattr(ctx.tenant_obj, "index", None)
        if idx is None or not hasattr(idx, "compact"):
            return 0.0
        if self.insert_rows > 0:
            rows = idx.view().rows_view()[:1]       # on the index's device
            idx.insert(rows.repeat(self.insert_rows, 1), auto_compact=False)
        mode = idx.compact()
        record(FaultEvent("compact", "launch", ctx.index, ctx.tenant,
                          f"mode={mode} insert_rows={self.insert_rows}"))
        return 0.0


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

class FaultPlan:
    """A composable, seeded set of faults plus the counters they key on.

    One plan = one deterministic chaos scenario: the n-th submit and the
    n-th launch of a run always see the same injections for the same
    seed, regardless of wall time.  ``events`` records everything that
    fired, newest last.
    """

    def __init__(self, faults=(), seed: int = 0):
        self.faults = list(faults)
        self.rng = np.random.default_rng(seed)
        self.submits = 0
        self.launches = 0
        self.events: list[FaultEvent] = []

    def _record(self, event: FaultEvent) -> None:
        self.events.append(event)

    def on_submit(self, tenant: str, queries: np.ndarray) -> None:
        ctx = SubmitCtx(index=self.submits, tenant=tenant, queries=queries)
        self.submits += 1
        for f in self.faults:
            f.on_submit(ctx, self.rng, self._record)

    def before_launch(self, tenant: str, tier: str, attempt: int,
                      tenant_obj=None, service=None) -> float:
        """Total injected latency for this launch; may raise instead."""
        ctx = LaunchCtx(index=self.launches, tenant=tenant, tier=tier,
                        attempt=attempt, tenant_obj=tenant_obj,
                        service=service)
        self.launches += 1
        extra = 0.0
        for f in self.faults:
            extra += float(f.before_launch(ctx, self.rng, self._record))
        return extra

    def after_launch(self, tenant: str, tier: str, attempt: int,
                     tenant_obj=None, service=None) -> None:
        ctx = LaunchCtx(index=self.launches - 1, tenant=tenant, tier=tier,
                        attempt=attempt, tenant_obj=tenant_obj,
                        service=service)
        for f in self.faults:
            f.after_launch(ctx, self.rng, self._record)

    def fired(self, kind: str) -> list[FaultEvent]:
        return [e for e in self.events if e.kind == kind]


def jittered_backoff(base_s: float, attempt: int, max_s: float,
                     rng) -> float:
    """Exponential backoff with full jitter: U(0.5, 1) * base * 2^attempt.

    THE backoff rule for launch retries (service and clients): capped at
    ``max_s``, jitter drawn from the caller's seeded generator so replays
    are deterministic and concurrent tenants never thundering-herd onto
    the same retry tick.
    """
    span = min(base_s * (2 ** attempt), max_s)
    return span * (0.5 + 0.5 * float(rng.random()))


Clock = Callable  # documentation alias: anything with now()/sleep(dt)
