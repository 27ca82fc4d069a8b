"""The port's retrieval service and fault injection against the JAX
package's, on the CPU.

Each scenario of tests/test_retrieval_service.py (and the serving cases
of tests/test_calibration.py) runs through both services on a
VirtualClock with the same FaultPlan seed, over the reference's own
forest (N = 400, D = 16, shannon, m = 4) imported into torch, wrapped in
each package's SegmentedForest where the scenario mutates the index.
Equal: the quality and row_quality labels, ids, tier paths, shed
reasons, counters, breaker states and the fired fault events; dists agree
to rtol/atol 1e-5 (the tolerance of tests/test_kernels.py).  The
reference's own assertions are held on both sides.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from repro.core import calibrate as jcal
from repro.core import search as jbp
from repro.core.bregman import get_family as jget_family
from repro.core.bregman import validate_rows as jvalidate_rows
from repro.core.index import build_index as jbuild_index
from repro.core.segments import SegmentedForest as JSegmentedForest
from repro.dist.sharding import make_mesh as jmake_mesh
from repro.serve import faults as jfaults
from repro.serve import retrieval as jret

from repro_torch.core import calibrate as tcal
from repro_torch.core import search as tbp
from repro_torch.core.bregman import get_family as tget_family
from repro_torch.core.bregman import valid_rows_mask, validate_rows
from repro_torch.core.segments import SegmentedForest as TSegmentedForest
from repro_torch.dist import knn as tdk
from repro_torch.dist.sharding import make_mesh as tmake_mesh
from repro_torch.serve import faults as tfaults
from repro_torch.serve import retrieval as tret

from torch_parity import to_port

N, D, K, M = 400, 16, 5, 4
SPIKE = 0.3     # injected seconds per launch in the latency tests
TOL = dict(rtol=1e-5, atol=1e-5)

JAX = types.SimpleNamespace(
    name="jax", faults=jfaults, ret=jret, bp=jbp, cal=jcal,
    SF=JSegmentedForest, imported=lambda f: f, kw={})
PORT = types.SimpleNamespace(
    name="port", faults=tfaults, ret=tret, bp=tbp, cal=tcal,
    SF=TSegmentedForest, imported=to_port, kw={"device": "cpu"})


@functools.lru_cache(maxsize=None)
def _jforest(seed: int = 0, n: int = N):
    """The reference's index of tests/test_retrieval_service.py."""
    rng = np.random.default_rng(seed)
    data = rng.random((n, D)).astype(np.float32) + 0.1
    return jbuild_index(data, "shannon", m=M)


def make_index(side, seed=0, n=N, mutable=False):
    forest = side.imported(_jforest(seed, n))
    return side.SF.from_forest(forest) if mutable else forest


QUERIES = np.random.default_rng(7).random((4, D)).astype(np.float32) + 0.1


def oracle(side, index, queries, k=K):
    """Fault-free exact search over the index's current live rows."""
    snap = side.bp._as_forest(index)
    return side.bp.knn_search_batch(snap, queries, k, snap.n, **side.kw)


def host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_service(side, index, *, faults=None, register=True, **cfg):
    clock = side.faults.VirtualClock()
    svc = side.ret.RetrievalService(side.ret.ServiceConfig(**cfg),
                                    clock=clock, faults=faults)
    if register:
        svc.register_tenant("t", index)
    return svc, clock


def observe(resp) -> dict:
    """What a response says, dists apart."""
    meta = {k: v for k, v in resp.meta.items() if k != "snapshot"}
    return {"quality": resp.quality, "row_quality": list(resp.row_quality),
            "ids": np.asarray(resp.ids).tolist(),
            "flagged_rows": list(resp.flagged_rows),
            "shed_reason": resp.shed_reason,
            "retry_after": resp.retry_after, "error": resp.error,
            "tenant_degraded": resp.tenant_degraded,
            "latency_s": resp.latency_s, "deadline_met": resp.deadline_met,
            "expected_recall": resp.expected_recall,
            "meta": {k: (float(v) if k == "p_guarantee" else v)
                     for k, v in meta.items()}}


def both(scenario):
    """Run ``scenario(side)`` for both packages; it returns (responses,
    service, plan or None).  Labels, ids, counters, breakers and events
    must be equal, dists within tolerance.  Returns the port's triple."""
    out = {}
    for side in (JAX, PORT):
        out[side.name] = scenario(side)
    (jr, jsvc, jplan), (tr, tsvc, tplan) = out["jax"], out["port"]
    assert len(jr) == len(tr)
    for i, (a, b) in enumerate(zip(jr, tr, strict=True)):
        assert observe(b) == observe(a), i
        np.testing.assert_allclose(np.asarray(b.dists), np.asarray(a.dists),
                                   err_msg=f"response {i}", **TOL)
    assert tsvc.counters == jsvc.counters
    assert {n: t.breaker.state for n, t in tsvc.tenants.items()} == {
        n: t.breaker.state for n, t in jsvc.tenants.items()}
    if jplan is not None:
        assert [dataclasses.astuple(e) for e in tplan.events] == [
            dataclasses.astuple(e) for e in jplan.events]
        assert (tplan.submits, tplan.launches) == (jplan.submits,
                                                   jplan.launches)
    return out["port"]


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------

def test_deadline_honored_under_latency():
    def run(side):
        plan = side.faults.FaultPlan([side.faults.LatencySpike(SPIKE)],
                                     seed=1)
        svc, _ = make_service(side, make_index(side), faults=plan,
                              default_deadline_s=0.5)
        out = []
        for _ in range(6):
            r = svc.search_sync("t", QUERIES, K)
            assert r.latency_s <= 0.5 + SPIKE + 1e-6
            if r.quality != "shed":
                assert r.deadline_met or r.latency_s - 0.5 <= SPIKE + 1e-6
            out.append(r)
        assert svc.counters["launches"] == len(plan.fired("latency"))
        return out, svc, plan
    both(run)


def test_ladder_degrades_as_cost_rises():
    def run(side):
        plan = side.faults.FaultPlan([side.faults.LatencySpike(SPIKE)],
                                     seed=1)
        svc, _ = make_service(side, make_index(side), faults=plan)
        out = [svc.search_sync("t", QUERIES, K)]
        assert svc.tenants["t"].cost.estimate() >= SPIKE
        for dl, tier in ((2.5, "exact"), (1.5, "approx"), (0.8, "partial")):
            r = svc.search_sync("t", QUERIES, K, deadline_s=dl * SPIKE)
            assert r.meta["tier_path"][0] == tier
            out.append(r)
        before = svc.counters["launches"]
        r = svc.search_sync("t", QUERIES, K, deadline_s=0.3 * SPIKE)
        assert r.quality == "shed" and r.shed_reason == "deadline"
        assert svc.counters["launches"] == before
        return out + [r], svc, plan
    both(run)


def test_expired_requests_shed_without_launch():
    def run(side):
        svc, clock = make_service(side, make_index(side))
        ticket = svc.submit("t", QUERIES, K, deadline_s=0.1)
        clock.advance(0.2)
        svc.step()
        r = ticket.response
        assert ticket.done and r.quality == "shed"
        assert r.shed_reason == "deadline" and r.deadline_met is False
        assert svc.counters["launches"] == 0
        return [r], svc, None
    both(run)


def test_stale_batchmate_never_coupled_to_fresh_traffic():
    def run(side):
        index = make_index(side)
        svc, _ = make_service(side, index)
        svc.tenants["t"].cost.observe(SPIKE)
        stale = svc.submit("t", QUERIES, K, deadline_s=0.3 * SPIKE)
        fresh = svc.submit("t", QUERIES, K, deadline_s=10 * SPIKE)
        svc.run_until_drained()
        assert stale.response.shed_reason == "deadline"
        assert fresh.response.quality == "exact"
        np.testing.assert_array_equal(
            fresh.response.ids, host(oracle(side, index, QUERIES).ids))
        return [stale.response, fresh.response], svc, None
    both(run)


def test_deadline_shed_requeues_batchmates_with_slack():
    def run(side):
        svc, _ = make_service(side, make_index(side))
        svc.tenants["t"].cost.observe(SPIKE)
        tight = svc.submit("t", QUERIES, K, deadline_s=0.3 * SPIKE)
        slack = svc.submit("t", QUERIES, K, deadline_s=0.55 * SPIKE)
        svc.step()
        assert tight.done and tight.response.shed_reason == "deadline"
        assert not slack.done
        svc.run_until_drained()
        assert slack.response.quality in ("exact", "partial")
        assert svc.counters["launches"] >= 1
        return [tight.response, slack.response], svc, None
    both(run)


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------

def test_queue_full_returns_retry_after():
    def run(side):
        svc, _ = make_service(side, make_index(side), queue_depth=2)
        t1 = svc.submit("t", QUERIES, K)
        t2 = svc.submit("t", QUERIES, K)
        t3 = svc.submit("t", QUERIES, K)
        assert not t1.done and not t2.done
        assert t3.done and t3.response.quality == "shed"
        assert t3.response.shed_reason == "queue_full"
        assert t3.response.retry_after > 0
        assert svc.counters["rejected_queue_full"] == 1
        svc.run_until_drained()
        assert t1.done and t2.done
        return [t.response for t in (t1, t2, t3)], svc, None
    both(run)


def test_bad_k_rejected_up_front():
    def run(side):
        index = make_index(side)
        svc, _ = make_service(side, index)
        live = svc.tenants["t"].live_n
        out = []
        for k, cols in ((live + 1, live), (10**9, live), (0, 1)):
            r = svc.submit("t", QUERIES, k).response
            assert r.shed_reason == "bad_k" and r.quality == "shed"
            assert r.ids.shape == (QUERIES.shape[0], cols)
            out.append(r)
        assert "live_n" in out[0].error
        assert svc.counters["launches"] == 0
        return out, svc, None
    both(run)


def test_microbatching_coalesces_requests():
    def run(side):
        index = make_index(side)
        svc, _ = make_service(side, index)
        tickets = [svc.submit("t", QUERIES[i:i + 1], K) for i in range(3)]
        svc.step()
        assert all(t.done for t in tickets)
        assert svc.counters["launches"] <= 2
        ref = host(oracle(side, index, QUERIES[:3]).ids)
        for i, t in enumerate(tickets):
            assert t.response.quality == "exact"
            np.testing.assert_array_equal(t.response.ids[0], ref[i])
        return [t.response for t in tickets], svc, None
    both(run)


# ---------------------------------------------------------------------------
# Circuit breaker and retry
# ---------------------------------------------------------------------------

def test_breaker_opens_half_opens_closes():
    def run(side):
        index = make_index(side)
        plan = side.faults.FaultPlan(
            [side.faults.LaunchError(at_launches=(0, 1))], seed=3)
        svc, clock = make_service(side, index, faults=plan,
                                  breaker_threshold=2,
                                  breaker_cooldown_s=1.0)
        brk = svc.tenants["t"].breaker
        r1 = svc.search_sync("t", QUERIES, K)
        assert r1.quality == "shed" and r1.shed_reason == "launch_failed"
        assert "InjectedLaunchError" in r1.error
        assert brk.state == "open" and brk.opens == 1
        before = svc.counters["launches"]
        r2 = svc.search_sync("t", QUERIES, K)
        assert r2.shed_reason == "breaker_open"
        assert 0 < r2.retry_after <= 1.0
        assert svc.counters["launches"] == before
        clock.advance(1.1)
        r3 = svc.search_sync("t", QUERIES, K)
        assert r3.quality == "exact" and brk.state == "closed"
        np.testing.assert_array_equal(
            r3.ids, host(oracle(side, index, QUERIES).ids))
        return [r1, r2, r3], svc, plan
    both(run)


def test_breaker_allow_is_side_effect_free():
    """The breaker alone: both packages step through the same states."""
    trace = {}
    for side in (JAX, PORT):
        brk = side.ret.CircuitBreaker(threshold=1, cooldown_s=2.0)
        seen = []
        brk.record_failure(0.0)
        seen += [brk.state, brk.allow(1.0), brk.allow(2.5), brk.allow(2.5),
                 brk.state]
        brk.begin_probe()
        seen += [brk.state, brk.allow(2.5), brk.retry_after(2.5)]
        brk.record_failure(3.0)
        seen += [brk.state, brk.retry_after(3.5), brk.opens]
        trace[side.name] = seen
    assert trace["port"] == trace["jax"]
    assert trace["port"][:5] == ["open", False, True, True, "open"]
    assert trace["port"][5:7] == ["half_open", False]
    assert trace["port"][7] > 0 and trace["port"][8] == "open"


def test_breaker_probe_survives_deadline_shed():
    def run(side):
        plan = side.faults.FaultPlan(
            [side.faults.LaunchError(at_launches=(0, 1))], seed=9)
        svc, clock = make_service(side, make_index(side), faults=plan,
                                  breaker_threshold=2,
                                  breaker_cooldown_s=1.0)
        brk = svc.tenants["t"].breaker
        r1 = svc.search_sync("t", QUERIES, K)
        assert r1.shed_reason == "launch_failed" and brk.state == "open"
        clock.advance(1.1)
        svc.tenants["t"].cost.observe(1.0)
        r2 = svc.search_sync("t", QUERIES, K, deadline_s=0.01)
        assert r2.shed_reason == "deadline" and brk.state == "open"
        assert brk.retry_after(clock.now()) == 0
        r3 = svc.search_sync("t", QUERIES, K, deadline_s=10.0)
        assert r3.quality == "exact" and brk.state == "closed"
        return [r1, r2, r3], svc, plan
    both(run)


def test_transient_failure_retried_within_deadline():
    def run(side):
        plan = side.faults.FaultPlan(
            [side.faults.LaunchError(at_launches=0)], seed=4)
        svc, _ = make_service(side, make_index(side), faults=plan,
                              breaker_threshold=3)
        r = svc.search_sync("t", QUERIES, K)
        assert r.quality == "exact"
        assert svc.counters["launch_failures"] == 1
        assert r.latency_s > 0
        return [r], svc, plan
    both(run)


# ---------------------------------------------------------------------------
# Poison containment
# ---------------------------------------------------------------------------

def test_poisoned_query_degrades_only_its_row():
    def run(side):
        index = make_index(side)
        plan = side.faults.FaultPlan(
            [side.faults.PoisonQuery(at_submits=0, row=1)], seed=5)
        svc, _ = make_service(side, index, faults=plan)
        r = svc.search_sync("t", QUERIES, K)
        assert plan.fired("poison") and r.flagged_rows == [1]
        assert r.row_quality[1] == "shed"
        assert (r.ids[1] == -1).all() and np.isinf(r.dists[1]).all()
        ref = host(oracle(side, index, QUERIES).ids)
        for i in (0, 2, 3):
            assert r.row_quality[i] == "exact"
            np.testing.assert_array_equal(r.ids[i], ref[i])
        assert r.quality == "exact"
        return [r], svc, plan
    both(run)


def test_poisoned_index_rows_quarantined_at_register():
    def run(side):
        idx = make_index(side, seed=11, n=200, mutable=True)
        bad = np.full((2, D), 0.5, np.float32)
        bad[0, 3] = np.nan
        bad[1, 5] = -1.0                      # shannon domain is x > 0
        bad_ids = idx.insert(bad, auto_compact=False)
        svc, _ = make_service(side, idx)
        tenant = svc.tenants["t"]
        assert tenant.degraded
        assert sorted(tenant.quarantined) == sorted(bad_ids)
        q = np.random.default_rng(2).random((2, D)).astype(np.float32) + 0.1
        r = svc.search_sync("t", q, K)
        assert r.quality == "exact" and r.tenant_degraded
        assert not np.isin(r.ids, bad_ids).any()
        return [r], svc, None
    both(run)


def test_poisoned_rows_of_an_immutable_forest_wrap_it_at_register():
    """A plain forest with an invalid live row is wrapped into the mutable
    index and the row quarantined, as the reference does."""
    def run(side):
        forest = make_index(side, seed=5, n=200)
        if side is PORT:
            data = forest.data.clone()
            data[7, 2] = float("nan")
            forest = dataclasses.replace(forest, data=data)
        else:
            forest = dataclasses.replace(forest,
                                         data=forest.data.at[7, 2].set(
                                             np.nan))
        bad_id = int(host(forest.point_ids)[7])
        svc, _ = make_service(side, forest)
        tenant = svc.tenants["t"]
        assert isinstance(tenant.index, side.SF) and tenant.degraded
        assert tenant.quarantined.tolist() == [bad_id]
        r = svc.search_sync("t", QUERIES, K)
        assert r.quality == "exact" and bad_id not in r.ids
        return [r], svc, None
    both(run)


# ---------------------------------------------------------------------------
# Snapshot consistency under mutation
# ---------------------------------------------------------------------------

def test_compaction_during_search_is_snapshot_consistent():
    def run(side):
        idx = make_index(side, seed=13, n=200, mutable=True)
        n0 = idx.live_n
        plan = side.faults.FaultPlan(
            [side.faults.CompactDuringSearch(at_launches=0, insert_rows=8)],
            seed=6)
        svc, _ = make_service(side, idx, faults=plan, record_snapshots=True)
        r = svc.search_sync("t", QUERIES, K)
        assert plan.fired("compact")
        assert idx.live_n == n0 + 8
        snap = r.meta["snapshot"]
        assert snap.n == n0
        ref = side.bp.knn_search_batch(snap, QUERIES, K, r.meta["budget"],
                                       **side.kw)
        np.testing.assert_array_equal(r.ids, host(ref.ids))
        np.testing.assert_array_equal(r.dists, host(ref.dists))
        return [r], svc, plan
    both(run)


# ---------------------------------------------------------------------------
# Quality labels are truthful in all four tiers
# ---------------------------------------------------------------------------

def test_quality_exact_matches_oracle():
    def run(side):
        index = make_index(side)
        svc, _ = make_service(side, index)
        r = svc.search_sync("t", QUERIES, K)
        assert r.quality == "exact"
        np.testing.assert_array_equal(
            r.ids, host(oracle(side, index, QUERIES).ids))
        return [r], svc, None
    both(run)


def test_quality_approx_labels_approx_pipeline():
    def run(side):
        svc, _ = make_service(side, make_index(side))
        r = svc.search_sync("t", QUERIES, K, target_recall=0.9)
        assert r.meta["tier_path"][0] == "approx"
        assert r.quality == "approx"
        assert all(q in ("approx", "partial") for q in r.row_quality)
        return [r], svc, None
    both(run)


def test_quality_partial_when_deadline_caps_retries():
    def run(side):
        index = make_index(side)
        probe = side.bp.knn_batch(side.bp._as_forest(index), QUERIES, K,
                                  return_stats=True, **side.kw)[1]
        assert probe.escalations >= 1
        plan = side.faults.FaultPlan([side.faults.LatencySpike(SPIKE)],
                                     seed=8)
        svc, _ = make_service(side, index, faults=plan, exact_margin=1.0)
        svc.tenants["t"].cost.observe(SPIKE)
        r = svc.search_sync("t", QUERIES, K, deadline_s=1.2 * SPIKE)
        assert r.meta["tier_path"] == ["exact"]
        assert r.quality == "partial"
        assert any(q == "partial" for q in r.row_quality)
        ref = host(oracle(side, index, QUERIES).ids)
        for i, q in enumerate(r.row_quality):
            if q == "exact":
                np.testing.assert_array_equal(r.ids[i], ref[i])
        return [r], svc, plan
    both(run)


def test_quality_shed_is_explicit():
    def run(side):
        svc, _ = make_service(side, make_index(side))
        svc.tenants["t"].cost.observe(1.0)
        r = svc.search_sync("t", QUERIES, K, deadline_s=0.01)
        assert r.quality == "shed" and r.shed_reason == "deadline"
        assert (r.ids == -1).all() and np.isinf(r.dists).all()
        assert svc.counters["shed"] >= 1
        return [r], svc, None
    both(run)


def test_knn_batch_returns_structured_stats():
    """The retry telemetry the service's ladder mirrors: this data
    overflows the default budget once; ``stop_retry`` before the first
    retry keeps the capped result, on both packages alike."""
    got = {}
    for side in (JAX, PORT):
        snap = side.bp._as_forest(make_index(side))
        res, stats = side.bp.knn_batch(snap, QUERIES, K, return_stats=True,
                                       **side.kw)
        assert bool(np.asarray(host(res.exact)).all())
        assert stats.budget_final >= side.bp.default_budget(snap, K)
        res2, stats2 = side.bp.knn_batch(snap, QUERIES, K,
                                         stop_retry=lambda: True,
                                         return_stats=True, **side.kw)
        assert stats2.stopped_early and stats2.escalations == 0
        assert not bool(host(res2.exact).all())
        got[side.name] = (tuple(stats), tuple(stats2),
                          host(res.ids).tolist(), host(res2.exact).tolist())
    assert got["port"] == got["jax"]
    assert got["port"][0][0] >= 1             # escalations


# ---------------------------------------------------------------------------
# Query and row validation
# ---------------------------------------------------------------------------

def test_validate_queries_names_offending_row():
    index = make_index(PORT)
    for side, fam in ((JAX, jget_family("shannon")),
                      (PORT, tget_family("shannon"))):
        q = np.full((3, D), 0.5, np.float32)
        q[2, 4] = np.nan
        with pytest.raises(ValueError, match="row 2"):
            side.bp.validate_queries(fam, q)
        q[2, 4] = -0.5
        with pytest.raises(ValueError, match="row 2"):
            side.bp.validate_queries(fam, q)
        assert side.bp.validate_queries(fam, q, mode="mask").tolist() == [
            True, True, False]
    with pytest.raises(ValueError, match="row 2"):
        tbp.knn_search_batch(index, q, K, 64, device="cpu")


@pytest.mark.parametrize("family", ["squared_euclidean", "shannon", "burg",
                                    "itakura_saito", "exponential"])
def test_device_validation_mask_equals_validate_rows(family):
    """The registration mask computed where the rows lie equals
    ``validate_rows(mode="mask")`` (the port's and the reference's) on
    rows with NaN, +-inf, zeros, negatives and domain edges."""
    rng = np.random.default_rng(3)
    rows = (rng.random((64, 8)).astype(np.float32) + 0.1)
    specials = [np.nan, np.inf, -np.inf, 0.0, -1.0, -1e-30, 1e-30,
                np.float32(np.finfo(np.float32).max)]
    for i, v in enumerate(specials):
        rows[2 * i, i % 8] = v
    rows[40] = -rows[40]
    got = valid_rows_mask(family, torch.from_numpy(rows)).numpy()
    assert got.dtype == bool and got.shape == (64,)
    np.testing.assert_array_equal(got, validate_rows(family, rows,
                                                     mode="mask"))
    np.testing.assert_array_equal(got, jvalidate_rows(
        jget_family(family), rows, mode="mask"))
    assert 0 < got.sum() < 64 or family == "squared_euclidean"


def test_segments_insert_validation_and_quarantine():
    """The mutable index's find_invalid (now on the index's device) names
    the same ids as the reference's."""
    found = {}
    for side in (JAX, PORT):
        idx = make_index(side, seed=17, n=200, mutable=True)
        bad = np.full((1, D), 0.5, np.float32)
        bad[0, 0] = np.nan
        with pytest.raises(ValueError, match="insert row 0"):
            idx.insert(bad, validate=True)
        assert idx.find_invalid().size == 0
        (bid,) = idx.insert(bad, validate=False)
        found[side.name] = (idx.find_invalid().tolist(),
                            idx.quarantine().tolist(),
                            idx.find_invalid().size, int(bid))
        assert bid not in idx.live_ids()
    assert found["port"] == found["jax"]
    assert found["port"][0] == [found["port"][3]]


# ---------------------------------------------------------------------------
# Tiered tenants: warm() and FetchStall containment
# ---------------------------------------------------------------------------

def make_tiered_service(side, index, *, faults=None, **cfg):
    """A tenant whose cold point blocks live in host RAM (resident_bytes
    below the ~38 KB cold footprint at n = 400, d = 16)."""
    svc, clock = make_service(side, index, faults=faults, register=False,
                              **cfg)
    svc.register_tenant("t", index, resident_bytes=20_000)
    return svc, clock


def test_tiered_tenant_matches_oracle_and_warm_prefills():
    def run(side):
        index = make_index(side)
        svc, _ = make_tiered_service(side, index)
        store = svc.tenants["t"].tiered
        assert store is not None and not store.is_resident
        out = svc.warm("t", shapes=[(len(QUERIES), K)])
        assert out["programs"] == [(4, K)]
        assert out["tiered"]["blocks_cached"] > 0
        assert svc.counters["submitted"] == 0
        r = svc.search_sync("t", QUERIES, K)
        assert r.quality == "exact"
        np.testing.assert_array_equal(
            r.ids, host(oracle(side, index, QUERIES).ids))
        return [r], svc, None
    _, svc, _ = both(run)
    # The CPU misses the port's table (swept on the card only).
    assert svc.tenants["t"].block_rows is None
    assert svc.tenants["t"].tiered.block_rows == 4096


def test_fetch_stall_within_timeout_rides_like_latency():
    def run(side):
        index = make_index(side)
        plan = side.faults.FaultPlan(
            [side.faults.FetchStall(0.2, at_launches=0, tenant="t")],
            seed=11)
        svc, _ = make_tiered_service(side, index, faults=plan)
        r = svc.search_sync("t", QUERIES, K)
        assert len(plan.fired("fetch_stall")) == 1
        assert r.quality == "exact" and r.latency_s >= 0.2
        np.testing.assert_array_equal(
            r.ids, host(oracle(side, index, QUERIES).ids))
        return [r], svc, plan
    both(run)


def test_fetch_stall_beyond_timeout_contained_by_retry():
    def run(side):
        index = make_index(side)
        plan = side.faults.FaultPlan(
            [side.faults.FetchStall(10.0, at_launches=0, tenant="t")],
            seed=12)
        svc, _ = make_tiered_service(side, index, faults=plan)
        r = svc.search_sync("t", QUERIES, K, deadline_s=20.0)
        events = plan.fired("fetch_stall")
        assert len(events) == 1 and "FetchTimeout" in events[0].detail
        assert r.quality == "exact"
        assert svc.counters["launches"] >= 2
        assert r.latency_s >= 5.0
        assert "FetchTimeout" not in (r.error or "")
        np.testing.assert_array_equal(
            r.ids, host(oracle(side, index, QUERIES).ids))
        return [r], svc, plan
    both(run)


def test_fetch_stall_noop_on_resident_tenant():
    def run(side):
        plan = side.faults.FaultPlan(
            [side.faults.FetchStall(10.0, tenant="t")], seed=13)
        svc, _ = make_service(side, make_index(side), faults=plan)
        assert svc.tenants["t"].tiered is None
        r = svc.search_sync("t", QUERIES, K)
        assert not plan.fired("fetch_stall") and r.quality == "exact"
        return [r], svc, plan
    both(run)


@pytest.fixture(scope="module")
def meshes():
    """Each package's one-rank mesh: the JAX package's 1x1 mesh, the
    port's over gloo on an in-process HashStore (the group ends with the
    module, so no other test sees it)."""
    assert not torch.distributed.is_initialized()
    out = {"jax": jmake_mesh((1,), ("data",)),
           "port": tmake_mesh((1,), ("data",), device="cpu")}
    yield out
    torch.distributed.destroy_process_group()


def test_mesh_and_resident_bytes_are_mutually_exclusive(meshes):
    """mesh= and resident_bytes= together are refused; a mesh= tenant
    registers, is sharded and answers exactly, as the reference's does."""
    def run(side):
        mesh = meshes[side.name]
        svc, _ = make_service(side, make_index(side))
        with pytest.raises(ValueError, match="resident_bytes"):
            svc.register_tenant("x", make_index(side, seed=3), mesh=mesh,
                                resident_bytes=20_000)
        assert "x" not in svc.tenants
        index = make_index(side, seed=3)
        tenant = svc.register_tenant("x", index, mesh=mesh)
        assert tenant.sharded is not None and tenant.tiered is None
        assert tenant.sharded.global_live_n == N
        r = svc.search_sync("x", QUERIES, K)
        assert r.quality == "exact"
        np.testing.assert_array_equal(
            r.ids, host(oracle(side, index, QUERIES).ids))
        return [r], svc, None
    both(run)


def test_sharded_tenant_serves_every_tier_like_the_resident_one(meshes):
    """A mesh= tenant's exact, approximate and partial responses: the
    reference's labels and ids, and on the port the resident tenant's
    bits (a one-rank shard runs the single-host search's math)."""
    def run(side):
        index = make_index(side, mutable=True)
        svc, _ = make_service(side, index, register=False)
        svc.register_tenant("t", index)
        svc.register_tenant("s", index, mesh=meshes[side.name])
        warmed = svc.warm("s", shapes=[(4, K)])
        assert warmed["programs"] == [(4, K)]
        out = []
        for kw in ({}, {"target_recall": 0.9}):
            resident = svc.search_sync("t", QUERIES, K, **kw)
            sharded = svc.search_sync("s", QUERIES, K, **kw)
            assert sharded.quality == resident.quality
            np.testing.assert_array_equal(sharded.ids, resident.ids)
            if side is PORT:
                np.testing.assert_array_equal(sharded.dists, resident.dists)
            out.append(sharded)
        plan = side.faults.FaultPlan(
            [side.faults.ShardStall(2.0, at_launches=[0], tenant="s")],
            seed=3)
        svc.faults = plan
        svc.tenants["s"].cost.observe(2.0)
        out.append(svc.search_sync("s", QUERIES, K, deadline_s=1.5))
        assert out[-1].meta["tier_path"] == ["partial"]
        assert plan.fired("shard_stall")
        return out, svc, plan
    both(run)


class TickingClock(tfaults.VirtualClock):
    """A virtual clock that moves on by ``tick`` seconds at every read,
    so every launch takes time."""

    def __init__(self, tick: float):
        super().__init__()
        self.tick = tick

    def now(self) -> float:
        t = super().now()
        self.sleep(self.tick)
        return t


def test_slow_sharded_launch_raises_launch_timeout_and_degrades(meshes):
    """distributed_knn raises LaunchTimeout past launch_timeout_s, with
    the completed result and its time on it; the service uses the result,
    counts the timeout as a breaker failure and, after three, sheds the
    tenant's traffic."""
    index = make_index(PORT)
    sharded = tdk.shard_index(index, meshes["port"], device="cpu")
    want = tdk.distributed_knn(sharded, QUERIES, family="shannon", k=K,
                               budget=N, device="cpu")
    reads = iter([10.0, 12.5])
    with pytest.raises(tdk.LaunchTimeout) as info:
        tdk.distributed_knn(sharded, QUERIES, family="shannon", k=K,
                            budget=N, launch_timeout_s=1.0,
                            clock=lambda: next(reads), device="cpu")
    assert isinstance(info.value, TimeoutError)
    assert info.value.elapsed_s == 2.5
    for f in want._fields:
        assert torch.equal(getattr(info.value.result, f), getattr(want, f))

    clock = TickingClock(0.1)
    svc = tret.RetrievalService(
        tret.ServiceConfig(launch_timeout_s=0.05, default_deadline_s=100.0),
        clock=clock)
    svc.register_tenant("s", index, mesh=meshes["port"])
    answered = [svc.search_sync("s", QUERIES, K) for _ in range(3)]
    assert all(r.quality != "shed" for r in answered)
    assert svc.counters["launch_timeouts"] == 3
    assert svc.counters["launch_failures"] == 0
    assert svc.tenants["s"].breaker.state == "open"
    shed = svc.search_sync("s", QUERIES, K)
    assert shed.quality == "shed" and shed.shed_reason == "breaker_open"


# ---------------------------------------------------------------------------
# Calibration on the serving path (tests/test_calibration.py's cases)
# ---------------------------------------------------------------------------

def test_service_approx_reports_expected_recall():
    def run(side):
        sf = make_index(side, seed=21, n=200, mutable=True)
        svc, _ = make_service(side, sf, register=False)
        svc.register_tenant("t", sf, calibrate=True, calibrate_k=K)
        assert sf.calibration is not None
        r1 = svc.search_sync("t", QUERIES, K, target_recall=0.9)
        assert r1.quality == "approx" and r1.expected_recall is not None
        assert r1.meta["expected_recall"] == r1.expected_recall
        p, expected = side.cal.resolve_p_guarantee(sf.view(), 0.9)
        assert r1.meta["p_guarantee"] == p
        assert r1.expected_recall == expected
        r2 = svc.search_sync("t", QUERIES, K)
        assert r2.quality == "exact" and r2.expected_recall is None
        return [r1, r2], svc, None
    both(run)


def test_service_uncalibrated_approx_reports_nothing():
    def run(side):
        svc, _ = make_service(side, make_index(side, seed=22, n=200,
                                               mutable=True))
        r = svc.search_sync("t", QUERIES, K, target_recall=0.9)
        assert r.quality == "approx" and r.expected_recall is None
        assert r.meta["p_guarantee"] == 0.9
        return [r], svc, None
    both(run)


def test_microbatch_key_separates_divergent_tenants():
    """Two tenants sharing target_recall = 0.9 resolve to different shrink
    levels through their own curves."""
    def run(side):
        curves = {"weak": (0.2, 0.9, 1.0), "strong": (0.95, 0.99, 1.0)}
        svc, _ = make_service(side, None, register=False)
        for i, (name, rec) in enumerate(curves.items()):
            cal = side.cal.RecallCalibration(
                p_grid=(0.0, 0.5, 1.0), recall_grid=rec, k=K,
                num_queries=8, seed=0)
            svc.register_tenant(name, dataclasses.replace(
                make_index(side, seed=30 + i, n=200), calibration=cal))
        t1 = svc.submit("weak", QUERIES, K, target_recall=0.9)
        t2 = svc.submit("strong", QUERIES, K, target_recall=0.9)
        while not (t1.done and t2.done):
            svc.step()
        assert t1.response.meta["p_guarantee"] == 0.5
        assert t1.response.expected_recall == 0.9
        assert t2.response.meta["p_guarantee"] == 0.0
        assert t2.response.expected_recall == 0.95
        return [t1.response, t2.response], svc, None
    both(run)


# ---------------------------------------------------------------------------
# The port's own contract
# ---------------------------------------------------------------------------

def test_fault_plans_replay_the_same_events():
    """One seed, the same events in the same order, twice and against the
    reference: jittered latency, launch errors and backoff draws."""
    def run(side):
        plan = side.faults.FaultPlan(
            [side.faults.LatencySpike(0.01, jitter_s=0.2, every=2),
             side.faults.LaunchError(at_launches=(1, 4)),
             side.faults.ShardStall(0.05, at_launches=3)], seed=42)
        svc, _ = make_service(side, make_index(side), faults=plan,
                              breaker_threshold=5)
        out = [svc.search_sync("t", QUERIES[: 1 + i % 4], K,
                               deadline_s=30.0) for i in range(6)]
        back = [side.faults.jittered_backoff(0.05, a, 1.0, plan.rng)
                for a in range(4)]
        return out, svc, plan, back
    runs = [run(PORT), run(PORT), run(JAX)]
    events = [[dataclasses.astuple(e) for e in r[2].events] for r in runs]
    assert events[0] == events[1] == events[2]
    assert runs[0][3] == runs[1][3] == runs[2][3]
    assert {"latency", "error", "shard_stall"} <= {e[0] for e in events[0]}
    assert [observe(r) for r in runs[0][0]] == [observe(r)
                                                for r in runs[2][0]]


def test_responses_carry_numpy_and_torch_queries_alike():
    """A torch query block (the hook's route) is admitted as a host copy:
    the same response as the numpy block."""
    index = make_index(PORT)
    svc, _ = make_service(PORT, index)
    a = svc.search_sync("t", QUERIES, K)
    b = svc.search_sync("t", torch.from_numpy(QUERIES.copy()), K)
    assert observe(a)["ids"] == observe(b)["ids"]
    np.testing.assert_array_equal(a.dists, b.dists)
    assert a.ids.dtype == np.int32 and a.dists.dtype == np.float32
