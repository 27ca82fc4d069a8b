"""Serving on torch (port of ``repro.serve``): the batched engine, the
kNN-LM hook over a BrePartition datastore, and the fault-tolerant
retrieval front end (deadlines, admission control, degradation ladder)
with its fault-injection harness."""

from .faults import (  # noqa: F401
    CompactDuringSearch,
    FaultEvent,
    FaultPlan,
    InjectedLaunchError,
    LatencySpike,
    LaunchError,
    OffsetClock,
    PoisonQuery,
    ShardStall,
    SystemClock,
    VirtualClock,
    jittered_backoff,
)
from .retrieval import (  # noqa: F401
    CircuitBreaker,
    LaunchCostModel,
    RetrievalResponse,
    RetrievalService,
    ServiceConfig,
    Tenant,
    Ticket,
)
