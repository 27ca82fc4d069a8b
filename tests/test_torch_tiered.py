"""The port's out-of-core TieredPointStore against the JAX package's store
and against the port's resident search, on the CPU at small shapes (the
reference's own forests imported through numpy).

The contract: a store whose cold blocks live in host memory returns, on
the same forest, the resident ``knn_search_batch`` /
``knn_search_batch_approx`` results bit for bit, and the JAX store's
results within the parity contract, fetching what the JAX store fetches.
The residency mechanics of tests/test_tiered.py are held on the port: the
routing, the pinned ``block_rows``, the resident fast path, the LRU budget
and pinned blocks, ``warm_cache``, ``FetchTimeout`` and the resolvers.
"""

import dataclasses
import functools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.search as jsearch
from repro.core.bregman import family_names
from repro.core.index import build_index as jax_build_index
from repro.core.tiered import TieredPointStore as JaxStore
from repro.core.tiered import _stage_a_jit as jax_stage_a

import repro_torch.core.search as tsearch
from repro_torch.core import tiered
from repro_torch.core.index import cold_point_fields
from repro_torch.core.tiered import (DEFAULT_PREFETCH_DEPTH, FetchTimeout,
                                     TieredPointStore,
                                     resolve_prefetch_depth,
                                     resolve_resident_bytes)
from repro_torch.kernels import bregman_prune, ops

from torch_parity import D, K, M, N, NUM_CLUSTERS, Q, jax_forest, to_port

FAMILIES = family_names()
BLOCK_ROWS = 96          # 5 cold blocks at N = 420
BUDGET = 64
P_APPROX = 0.8
DIST_TOL = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def port_forest(family: str, quantize: bool):
    return to_port(jax_forest(family, quantize)[0])


@functools.lru_cache(maxsize=None)
def blob_forest():
    """Six far-apart Gaussian blobs stored blob by blob (the layout of
    benchmarks/bench_tiered.py) with queries from blob 0, so the envelope
    gate rejects whole blocks: (reference forest, port forest, queries)."""
    rng = np.random.default_rng(0)
    per = -(-N // 6)
    data = np.concatenate([rng.normal(size=(per, D)) + 100.0 * j
                           for j in range(6)])[:N].astype(np.float32)
    queries = (data[rng.integers(0, per, Q)] + 0.01).astype(np.float32)
    jf = jax_build_index(data, "squared_euclidean", m=M,
                         num_clusters=NUM_CLUSTERS, seed=0)
    return jf, to_port(jf), queries


def _cold_bytes(forest) -> int:
    return sum(getattr(forest, f).numel() * getattr(forest, f).element_size()
               for f in cold_point_fields(forest))


def _budget(forest, share=0.6) -> int:
    """``share`` of the forest's cold bytes: tiered, holds a few blocks."""
    return max(1, int(share * _cold_bytes(forest)))


def _assert_bit_equal(got, want):
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _assert_same_result(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.exact.numpy(), np.asarray(want.exact))
    np.testing.assert_array_equal(got.num_candidates.numpy(),
                                  np.asarray(want.num_candidates))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               **DIST_TOL)


def _store(forest, share=0.6, **kw):
    return TieredPointStore(forest, resident_bytes=_budget(forest, share),
                            block_rows=BLOCK_ROWS, **kw)


# ---------------------------------------------------------------------------
# Parity: 5 families x {fp32, int8} x {exact, approx}
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("approx", [False, True], ids=["exact", "approx"])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_tiered_matches_resident_and_the_jax_store(family, quantize, approx):
    jf, _, queries = jax_forest(family, quantize)
    forest = port_forest(family, quantize)
    p = P_APPROX if approx else None
    store = _store(forest)
    assert not store.is_resident and store.num_blocks == 5
    jstore = JaxStore(jf, resident_bytes=store.resident_bytes,
                      block_rows=BLOCK_ROWS)
    assert jstore.cold_bytes == store.cold_bytes
    before = bregman_prune.launches, bregman_prune.launches_quant
    got = store.search(queries, K, BUDGET, p_guarantee=p, device="cpu")
    assert (bregman_prune.launches, bregman_prune.launches_quant) == before
    if approx:
        resident = tsearch.knn_search_batch_approx(
            forest, queries, K, BUDGET, p, block_rows=BLOCK_ROWS,
            device="cpu")
        want = jsearch.knn_search_batch_approx(
            jf, jnp.asarray(queries), K, BUDGET, jnp.float32(p),
            block_rows=BLOCK_ROWS)
    else:
        resident = tsearch.knn_search_batch(forest, queries, K, BUDGET,
                                            block_rows=BLOCK_ROWS,
                                            device="cpu")
        want = jsearch.knn_search_batch(jf, jnp.asarray(queries), K, BUDGET,
                                        block_rows=BLOCK_ROWS)
    _assert_bit_equal(got, resident)
    _assert_same_result(got, want)
    _assert_same_result(got, jstore.search(jnp.asarray(queries), K, BUDGET,
                                           p_guarantee=p))
    assert store.stats == jstore.stats
    assert store.stats["host_bytes_fetched"] > 0


def test_gate_prunes_blocks_like_the_jax_store():
    """On blob-sorted data the gate rejects blocks: the same blocks as the
    JAX store, the same bytes fetched; then the warm path (every admitted
    block cached) runs the pooled prune, bit-equal again."""
    jf, forest, queries = blob_forest()
    store = _store(forest, share=0.8)
    jstore = JaxStore(jf, resident_bytes=store.resident_bytes,
                      block_rows=BLOCK_ROWS)
    want = tsearch.knn_search_batch(forest, queries, K, BUDGET,
                                    block_rows=BLOCK_ROWS, device="cpu")
    for rep in range(2):
        got = store.search(queries, K, BUDGET, device="cpu")
        _assert_bit_equal(got, want)
        _assert_same_result(got, jstore.search(jnp.asarray(queries), K,
                                               BUDGET))
        assert store.stats == jstore.stats, rep
    assert store.stats["blocks_admitted"] < store.stats["blocks_total"]
    assert store.cache_info()["pool_bytes"] > 0          # the warm path ran
    assert store.stats["cache_hits"] > 0
    fetched = store.stats["host_bytes_fetched"]
    assert 0 < fetched < store.cold_bytes


def _per_block_fill(sel, count, corners, qs, qb, off, budget, n, storage):
    """The per-block oracle: one block's admit tile (its corner tables
    alone), then the resident scan's slot fill over the block's real rows
    (its pad rows cut off)."""
    admit = tsearch._prune_block(storage, corners, qs, qb)
    return tsearch._fill_block_slots(sel, count, admit[:n - off], off, budget)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("budget", [8, 64, N])
def test_pooled_prune_equals_the_per_block_fills(quantize, budget):
    forest = port_forest("itakura_saito", quantize)
    queries = torch.from_numpy(jax_forest("itakura_saito", quantize)[2])
    store = _store(forest, share=0.99)
    qs = tsearch.query_struct(queries, forest.partition, forest.family)
    qb = tsearch._filter_bounds(forest, qs, K, BLOCK_ROWS)
    q, n, bn = queries.shape[0], forest.n, store._bn
    names = tsearch.CORNER_FIELDS[forest.storage]
    blocks = [store._block(b) for b in range(store.num_blocks)]
    sel = torch.full((q, budget), n - 1, dtype=torch.long)
    count = torch.zeros(q, dtype=torch.long)
    for b, bundle in enumerate(blocks):
        sel, count = _per_block_fill(sel, count, store._fields(bundle, names),
                                     qs, qb, b * bn, budget, n,
                                     forest.storage)
    corners, gidx, _, _ = store._pooled(tuple(range(store.num_blocks)))
    psel, pcount = tiered._prune_pool(
        torch.full((q, budget), n - 1, dtype=torch.long),
        torch.zeros(q, dtype=torch.long), corners, gidx, qs, qb, budget, n,
        forest.storage)
    assert torch.equal(psel, sel) and torch.equal(pcount, count)
    assert int(count.min()) > 0


def _corner_row_bytes(forest) -> int:
    return sum(getattr(forest, f)[0].numel() * getattr(forest, f)
               .element_size() for f in tsearch.CORNER_FIELDS[forest.storage])


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "approx"])
@pytest.mark.parametrize("quantize", [False, True])
def test_stage_b_windows_equal_the_per_block_loop_and_the_jax_store(
        monkeypatch, quantize, approx):
    """Stage B at a window cap of two blocks (several windows, a short
    last one) against a cap below one block (the per-block loop): the
    same results bit for bit, the same ``_block`` calls in the same order,
    the JAX store's results and stats; one prune launch a window.  The
    window cap is Stage B's alone: Stage A's filter launches the same
    either way."""
    family = "itakura_saito"
    jf, _, queries = jax_forest(family, quantize)
    forest = port_forest(family, quantize)
    p = P_APPROX if approx else None
    q = queries.shape[0]
    prune = ("bregman_prune_block_quant" if quantize
             else "bregman_prune_block")
    masks = []

    def prune_spy(*args, _fn=getattr(ops, prune)):
        out = _fn(*args)
        masks.append(out.shape[0])
        return out

    monkeypatch.setattr(ops, prune, prune_spy)

    filters = []
    ub = "bregman_ub_matrix_quant" if quantize else "bregman_ub_matrix"

    def ub_spy(*args, _fn=getattr(ops, ub)):
        out = _fn(*args)
        filters.append(out.shape[0])
        return out

    monkeypatch.setattr(ops, ub, ub_spy)

    def run(cap):
        monkeypatch.setattr(tiered, "WINDOW_BYTES", cap)
        store = _store(forest)
        calls = []

        def block_spy(bid, _fn=store._block):
            calls.append(bid)
            return _fn(bid)

        store._block = block_spy
        masks.clear()
        filters.clear()
        res = store.search(queries, K, BUDGET, p_guarantee=p, device="cpu")
        return (res, dict(store.stats), calls, list(masks), list(filters),
                store.cache_info()["window_bytes"])

    (want, want_stats, want_calls, per_block, want_filters,
     one_bytes) = run(0)
    admitted = want_stats["blocks_admitted"]
    assert admitted >= 3 and per_block == [BLOCK_ROWS] * admitted
    row_bytes = _corner_row_bytes(forest)
    assert tiered._window_blocks(row_bytes, BLOCK_ROWS, q) == 1
    assert one_bytes == BLOCK_ROWS * row_bytes
    two = 2 * BLOCK_ROWS * (row_bytes + 4 * q)
    monkeypatch.setattr(tiered, "WINDOW_BYTES", two)
    assert tiered._window_blocks(row_bytes, BLOCK_ROWS, q) == 2
    got, stats, calls, windows, got_filters, two_bytes = run(two)
    assert want_filters and got_filters == want_filters
    assert two_bytes == 2 * BLOCK_ROWS * row_bytes
    _assert_bit_equal(got, want)
    assert stats == want_stats and calls == want_calls
    assert windows == ([2 * BLOCK_ROWS] * (admitted // 2)
                       + [BLOCK_ROWS] * (admitted % 2))
    jstore = JaxStore(jf, resident_bytes=_budget(forest),
                      block_rows=BLOCK_ROWS)
    _assert_same_result(got, jstore.search(jnp.asarray(queries), K, BUDGET,
                                           p_guarantee=p))
    assert stats == jstore.stats


# ---------------------------------------------------------------------------
# Stage A reads hot tables only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [False, True])
def test_stage_a_reads_no_cold_table_and_gates_like_jax(quantize):
    jf, _, queries = jax_forest("exponential", quantize)
    forest = port_forest("exponential", quantize)
    store = _store(forest)
    for f in cold_point_fields(forest):
        assert getattr(store._hot, f).device.type == "meta", f
    meta = dataclasses.replace(forest, **{
        f: getattr(forest, f).to("meta") for f in cold_point_fields(forest)})
    ys = torch.from_numpy(queries)
    for p in (None, P_APPROX):
        _, qb, admit = tiered._stage_a(meta, ys, K, BLOCK_ROWS, 256, p)
        _, qb_full, admit_full = tiered._stage_a(forest, ys, K, BLOCK_ROWS,
                                                 256, p)
        assert torch.equal(qb, qb_full) and torch.equal(admit, admit_full)
        want = jax_stage_a(jf, jnp.asarray(queries), K, BLOCK_ROWS, 256,
                           jnp.float32(p or 0.0), p is not None)
        np.testing.assert_array_equal(admit.numpy(),
                                      np.asarray(want["env_admit"]))
        np.testing.assert_allclose(qb.numpy(), np.asarray(want["qb"]),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Routing: one public API for both residency modes
# ---------------------------------------------------------------------------

def test_public_entry_points_route_tiered_stores():
    forest = port_forest("squared_euclidean", False)
    queries = jax_forest("squared_euclidean", False)[2]
    store = _store(forest)
    ref = tsearch.knn_search_batch(forest, queries, K, BUDGET,
                                   block_rows=BLOCK_ROWS, device="cpu")
    _assert_bit_equal(tsearch.knn_search_batch(
        store, queries, K, BUDGET, block_rows=BLOCK_ROWS, device="cpu"), ref)
    ref_a = tsearch.knn_search_batch_approx(
        forest, queries, K, BUDGET, P_APPROX, block_rows=BLOCK_ROWS,
        device="cpu")
    _assert_bit_equal(tsearch.knn_search_batch_approx(
        store, queries, K, BUDGET, P_APPROX, block_rows=BLOCK_ROWS,
        device="cpu"), ref_a)
    # knn_batch retries through the store, and its brute-force escape
    # scans as_resident_forest().
    for doublings in (8, 0):
        got, stats = tsearch.knn_batch(store, queries, K, budget=K,
                                       max_doublings=doublings,
                                       return_stats=True, device="cpu")
        want = tsearch.knn_batch(forest, queries, K, budget=K,
                                 max_doublings=doublings, device="cpu")
        _assert_bit_equal(got, want)
        assert stats.escalated_to_scan == (doublings == 0)
    with pytest.raises(TypeError, match="as_resident_forest"):
        tsearch.knn_search_batch_stats(store, queries, K, BUDGET,
                                       device="cpu")
    resident = store.as_resident_forest()
    for f in cold_point_fields(resident):
        assert torch.equal(getattr(resident, f), getattr(forest, f)), f
    _assert_bit_equal(tsearch.knn_search_batch(
        resident, queries, K, BUDGET, block_rows=BLOCK_ROWS, device="cpu"),
        ref)


def test_search_rejects_conflicting_block_rows_and_knob_misuse():
    forest = port_forest("squared_euclidean", False)
    queries = jax_forest("squared_euclidean", False)[2]
    store = _store(forest)
    with pytest.raises(ValueError, match="pinned"):
        store.search(queries, K, BUDGET, block_rows=2 * BLOCK_ROWS,
                     device="cpu")
    with pytest.raises(ValueError, match="p_guarantee"):
        store.search(queries, K, BUDGET, p_guarantee=1.5, device="cpu")
    with pytest.raises(ValueError, match=r"\(q, d\)"):
        store.search(queries[0], K, BUDGET, device="cpu")
    with pytest.raises(ValueError, match="cuda or cpu device"):
        store.search(queries, K, BUDGET, device="meta")
    store.search(queries, K, BUDGET, block_rows=BLOCK_ROWS, device="cpu")


# ---------------------------------------------------------------------------
# Residency mechanics
# ---------------------------------------------------------------------------

def test_resident_fast_path_when_budget_fits():
    forest = port_forest("squared_euclidean", False)
    queries = jax_forest("squared_euclidean", False)[2]
    ref = tsearch.knn_search_batch(forest, queries, K, BUDGET,
                                   block_rows=BLOCK_ROWS, device="cpu")
    for budget_bytes in (None, 10**9, _cold_bytes(forest)):
        store = TieredPointStore(forest, resident_bytes=budget_bytes,
                                 block_rows=BLOCK_ROWS)
        assert store.is_resident and store.as_resident_forest() is forest
        _assert_bit_equal(store.search(queries, K, BUDGET, device="cpu"),
                          ref)
        assert store.stats["host_bytes_fetched"] == 0
        assert store.warm_cache()["resident_fast_path"]
        assert store.cache_info()["resident_fast_path"]


def test_block_cache_hits_and_lru_budget():
    forest = port_forest("squared_euclidean", False)
    queries = jax_forest("squared_euclidean", False)[2]
    ref = tsearch.knn_search_batch(forest, queries, K, BUDGET,
                                   block_rows=BLOCK_ROWS, device="cpu")
    # Blocks 0-1 pinned: never evicted, so repeat traffic hits them.
    store = _store(forest, pinned_row_range=(0, 2 * BLOCK_ROWS))
    assert not store.is_resident and store._pinned == {0, 1}
    _assert_bit_equal(store.search(queries, K, BUDGET, device="cpu"), ref)
    assert store.stats["host_bytes_fetched"] > 0
    _assert_bit_equal(store.search(queries, K, BUDGET, device="cpu"), ref)
    assert store.stats["cache_hits"] > 0
    assert {0, 1} <= set(store._cache)
    info = store.cache_info()
    assert 0 < info["blocks_cached"] <= store.num_blocks
    assert info["pinned_blocks"] == 2
    per_block = max(b["nbytes"] for b in store._cache.values())
    assert info["bytes_cached"] <= store.resident_bytes + 3 * per_block

    # A budget under one block refetches on every pass, and the cache holds
    # at most the one block the eviction must keep.
    tiny = TieredPointStore(forest, resident_bytes=per_block // 2,
                            block_rows=BLOCK_ROWS)
    for _ in range(2):
        _assert_bit_equal(tiny.search(queries, K, BUDGET, device="cpu"), ref)
        assert tiny._cache_bytes <= tiny.resident_bytes + per_block
    assert tiny.stats["fetches"] > tiny.num_blocks
    tiny.close()
    tiny.close()


def test_from_index_pins_the_append_rows_of_a_mutable_index():
    forest = port_forest("burg", True)
    queries = jax_forest("burg", True)[2]

    class Mutable:
        """The two methods ``from_index`` duck-types on a mutable index."""

        def view(self):
            return forest

        def append_row_range(self):
            return forest.n - 30, forest.n

    store = TieredPointStore.from_index(Mutable(),
                                        resident_bytes=_budget(forest),
                                        block_rows=BLOCK_ROWS)
    assert store._pinned == {store.num_blocks - 1}
    assert store.num_blocks - 1 in store._cache
    _assert_bit_equal(
        store.search(queries, K, BUDGET, device="cpu"),
        tsearch.knn_search_batch(forest, queries, K, BUDGET,
                                 block_rows=BLOCK_ROWS, device="cpu"))
    assert store.num_blocks - 1 in store._cache


def test_warm_cache_populates_up_to_budget():
    forest = port_forest("squared_euclidean", False)
    store = _store(forest)
    out = store.warm_cache()
    assert 0 < out["blocks_cached"] < store.num_blocks
    assert out["bytes_cached"] <= store.resident_bytes
    assert store.stats["fetches"] == 0 and store.stats["queries"] == 0


def test_fetch_timeout_surfaces_as_fetch_timeout():
    """A wedged copy raises FetchTimeout instead of blocking the search;
    the stalled fetch lands in the background and a retry uses it."""
    forest = port_forest("squared_euclidean", False)
    queries = jax_forest("squared_euclidean", False)[2]
    calls = {"n": 0}

    def stuck_transfer(tiles):
        calls["n"] += 1
        if calls["n"] == 1:          # one wedged copy, then healthy
            time.sleep(0.5)
        return {f: t.clone() for f, t in tiles.items()}

    store = _store(forest, transfer=stuck_transfer, fetch_timeout_s=0.05)
    with pytest.raises(FetchTimeout, match="exceeded"):
        store.search(queries, K, BUDGET, device="cpu")
    time.sleep(0.8)
    _assert_bit_equal(
        store.search(queries, K, BUDGET, device="cpu"),
        tsearch.knn_search_batch(forest, queries, K, BUDGET,
                                 block_rows=BLOCK_ROWS, device="cpu"))


def test_resolve_resident_bytes_validation():
    assert resolve_resident_bytes(None) is None
    assert resolve_resident_bytes(1) == 1
    assert resolve_resident_bytes(np.int64(1 << 30)) == 1 << 30
    for bad in (0, -1, 1.5, True, "1GB"):
        with pytest.raises(ValueError, match="resident_bytes"):
            resolve_resident_bytes(bad)
    with pytest.raises(ValueError, match="resident_bytes"):
        TieredPointStore(port_forest("burg", False), resident_bytes=0)


def test_resolve_prefetch_depth_validation():
    assert resolve_prefetch_depth(None) == DEFAULT_PREFETCH_DEPTH
    assert resolve_prefetch_depth(1) == 1
    assert resolve_prefetch_depth(64) == 64
    for bad in (0, -2, 65, 2.5, True):
        with pytest.raises(ValueError, match="prefetch_depth"):
            resolve_prefetch_depth(bad)


def test_hot_forest_keeps_the_statics():
    forest = port_forest("shannon", True)
    store = _store(forest)
    assert store.family_name == "shannon" and store.storage == "int8"
    assert (store.n, store.d, store.m) == (forest.n, forest.d, forest.m)
    assert store.live_n == forest.n and store.device == forest.device
    for f in ("alpha", "sqrt_gamma", "point_ids", "alpha_scale"):
        assert getattr(store._hot, f) is getattr(forest, f), f
