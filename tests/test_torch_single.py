"""The port's single-query search, its materialized mask oracle, the §8
knob of ``knn_batch`` and the Bregman family helpers against the JAX
package, on the reference's own forests imported through numpy (CPU,
small shapes, both storage tiers)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.bregman as jbregman
import repro.core.search as jsearch
from repro.core.bregman import family_names
from repro.kernels import ops as jops

import repro_torch.core.bregman as tbregman
import repro_torch.core.search as tsearch
from repro_torch.core.tiered import TieredPointStore
from repro_torch.kernels import ops

from torch_parity import N, K, blob_forest, jax_forest, sample, to_port

FAMILIES = family_names()
TIERS = [False, True]
DIST_TOL = dict(rtol=1e-5, atol=1e-5)
# The reference's budget-8 case: below most queries' union, so the ids
# depend on which members the priority order keeps.
SMALL_BUDGET = 8
HALF = N // 2


@functools.lru_cache(maxsize=None)
def port_forest(family: str, quantize: bool):
    return to_port(jax_forest(family, quantize)[0])


@functools.lru_cache(maxsize=None)
def clustered_forests(quantize: bool):
    """(reference forest, port forest, queries) of the blob corpus, where
    the Theorem-3 mask is mixed."""
    jf, _, queries = blob_forest(quantize)
    return jf, to_port(jf), queries


def _assert_same(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.exact.numpy(), np.asarray(want.exact))
    np.testing.assert_array_equal(got.num_candidates.numpy(),
                                  np.asarray(want.num_candidates))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               **DIST_TOL)


def _assert_bit_equal(got, want):
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.parametrize("quantize", TIERS)
@pytest.mark.parametrize("family", FAMILIES)
def test_knn_search_and_knn_match_jax(family, quantize):
    """At half of n (below these unions: ``exact`` False) and through the
    ladder from there, which doubles to n."""
    jf, _, queries = jax_forest(family, quantize)
    tf = port_forest(family, quantize)
    for y in queries:
        _assert_same(tsearch.knn_search(tf, y, K, HALF, device="cpu"),
                     jsearch.knn_search(jf, jnp.asarray(y), K, HALF))
    _assert_same(tsearch.knn(tf, queries[0], K, HALF, device="cpu"),
                 jsearch.knn(jf, queries[0], K, HALF))


def test_default_budget_and_the_ladder_from_it_match_jax():
    for quantize in TIERS:
        jf, _, queries = jax_forest("burg", quantize)
        tf = port_forest("burg", quantize)
        assert tsearch.default_budget(tf, K) == jsearch.default_budget(jf, K)
        for kk in (1, K, 40):
            assert tsearch.default_budget(tf, kk) == \
                jsearch.default_budget(jf, kk)
        _assert_same(tsearch.knn(tf, queries[1], K, device="cpu"),
                     jsearch.knn(jf, queries[1], K))


@pytest.mark.parametrize("quantize", TIERS)
@pytest.mark.parametrize("family", FAMILIES)
def test_knn_search_approx_matches_jax(family, quantize):
    jf, _, queries = jax_forest(family, quantize)
    tf = port_forest(family, quantize)
    for p in (0.5, 0.9):
        for y in queries:
            _assert_same(
                tsearch.knn_search_approx(tf, y, K, HALF, p, device="cpu"),
                jsearch.knn_search_approx(jf, jnp.asarray(y), K, HALF,
                                          jnp.float32(p)))
        _assert_same(tsearch.knn(tf, queries[0], K, HALF, approx_p=p,
                                 device="cpu"),
                     jsearch.knn(jf, queries[0], K, HALF, approx_p=p))


@pytest.mark.parametrize("quantize", TIERS)
@pytest.mark.parametrize("family", ["itakura_saito", "squared_euclidean"])
def test_budget_below_the_union_keeps_the_reference_members(family,
                                                            quantize):
    """At a budget below ``num_candidates`` the ids depend on which union
    members the priority order keeps (members first, in index order)."""
    jf, _, queries = jax_forest(family, quantize)
    tf = port_forest(family, quantize)
    cut = 0
    for y in queries:
        want = jsearch.knn_search(jf, jnp.asarray(y), K, SMALL_BUDGET)
        got = tsearch.knn_search(tf, y, K, SMALL_BUDGET, device="cpu")
        _assert_same(got, want)
        cut += int(want.num_candidates) > SMALL_BUDGET
        want = jsearch.knn_search_approx(jf, jnp.asarray(y), K, SMALL_BUDGET,
                                         jnp.float32(0.9))
        _assert_same(tsearch.knn_search_approx(tf, y, K, SMALL_BUDGET, 0.9,
                                               device="cpu"), want)
    assert cut == len(queries)


@pytest.mark.parametrize("quantize", TIERS)
@pytest.mark.parametrize("family", FAMILIES)
def test_single_query_equals_its_batch_row(family, quantize):
    """Exact and approximate: the one-query search at the batch's final
    budget gives row j of the batched search."""
    _, _, queries = jax_forest(family, quantize)
    tf = port_forest(family, quantize)
    batch, stats = tsearch.knn_batch(tf, queries, K, return_stats=True,
                                     device="cpu")
    b = stats.budget_final
    approx = tsearch.knn_search_batch_approx(tf, queries, K, b, 0.9,
                                             device="cpu")
    for j, y in enumerate(queries):
        for got, want in (
                (tsearch.knn_search(tf, y, K, b, device="cpu"), batch),
                (tsearch.knn_search_approx(tf, y, K, b, 0.9, device="cpu"),
                 approx)):
            assert torch.equal(got.ids, want.ids[j])
            assert bool(got.exact) == bool(want.exact[j])
            assert int(got.num_candidates) == int(want.num_candidates[j])
            torch.testing.assert_close(got.dists, want.dists[j], **DIST_TOL)


@pytest.mark.parametrize("p", [None, 0.9])
@pytest.mark.parametrize("quantize", TIERS)
def test_oracle_matches_jax_and_the_streamed_search(quantize, p):
    """The materialized oracle against the reference's on a mixed mask;
    the port's streamed search, fused and unfused, bit-equal to it."""
    jf, tf, queries = clustered_forests(quantize)
    budget = 64
    want = jsearch.knn_search_batch_reference(
        jf, jnp.asarray(queries), K, budget,
        p_guarantee=None if p is None else jnp.float32(p), block_rows=96)
    oracle = tsearch.knn_search_batch_reference(
        tf, queries, K, budget, p_guarantee=p, block_rows=96, device="cpu")
    _assert_same(oracle, want)
    assert 0 < int(oracle.num_candidates.sum()) < tf.n * len(queries)
    if p is None:
        streamed = tsearch.knn_search_batch(tf, queries, K, budget,
                                            block_rows=96, device="cpu")
        _assert_bit_equal(streamed, oracle)
        _assert_bit_equal(tsearch._knn_search_batch_unfused(
            tf, queries, K, budget, 96, device="cpu"), oracle)
    else:
        _assert_bit_equal(tsearch.knn_search_batch_approx(
            tf, queries, K, budget, p, block_rows=96, device="cpu"), oracle)


def test_oracle_mask_matches_jax_off_the_tie_rows():
    """The (n, q) oracle mask against the reference's, on the clustered
    forest's own bounds, in both tiers; only rows whose lower bound ties
    ``qb`` exactly may differ (the reference's compare contracts into an
    FMA under jit on the CPU)."""
    for quantize in TIERS:
        jf, tf, queries = clustered_forests(quantize)
        qs = tsearch.query_struct(torch.from_numpy(queries), tf.partition,
                                  tf.family)
        qb = tsearch._filter_bounds(tf, qs, K, 96)
        got = tsearch._candidate_mask_batch(tf, qs, qb, 96).numpy()
        jqs = jsearch.query_struct(jnp.asarray(queries), jf.partition,
                                   jf.family)
        want = np.asarray(jsearch._candidate_mask_batch(
            jf, jqs, jnp.asarray(qb.numpy()), 96))
        assert 0 < got.sum() < got.size
        amin, gmax = (t.numpy() for t in tsearch.qz.decoded_corner_tables(tf)) \
            if quantize else (tf.alpha_min_pt.numpy(),
                              tf.sqrt_gamma_max_pt.numpy())
        lb = (amin[:, :, None] + qs["qconst"].T.numpy()[None]
              - gmax[:, :, None] * qs["sqrt_delta"].T.numpy()[None])
        tie = (lb == qb.T.numpy()[None]).any(axis=1)
        np.testing.assert_array_equal(got[~tie], want[~tie])


@pytest.mark.parametrize("quantize", TIERS)
def test_single_mask_is_the_oracle_column(quantize):
    """The one-query Theorem-3 mask (the prune-only kernel's plain version
    at q = 1 over all rows) equals column j of the materialized oracle."""
    _, tf, queries = clustered_forests(quantize)
    qs = tsearch.query_struct(torch.from_numpy(queries), tf.partition,
                              tf.family)
    qb = tsearch._filter_bounds(tf, qs, K, 96)
    oracle = tsearch._candidate_mask_batch(tf, qs, qb, 96)
    for j in range(len(queries)):
        q1 = {f: v[j] for f, v in qs.items()}
        assert torch.equal(tsearch._candidate_mask(tf, q1, qb[j]),
                           oracle[:, j])


@pytest.mark.parametrize("quantize", TIERS)
@pytest.mark.parametrize("family", ["burg", "exponential"])
def test_knn_batch_approx_p_matches_jax(family, quantize):
    jf, _, queries = jax_forest(family, quantize)
    tf = port_forest(family, quantize)
    want, want_stats = jsearch.knn_batch(jf, queries, K, approx_p=0.7,
                                         block_rows=96, return_stats=True)
    got, got_stats = tsearch.knn_batch(tf, queries, K, approx_p=0.7,
                                       block_rows=96, return_stats=True,
                                       device="cpu")
    assert got_stats == want_stats
    _assert_same(got, want)


def test_ub_filter_matches_jax_and_refuses_a_batch():
    jf, _, queries = jax_forest("burg")
    tf = port_forest("burg", False)
    jq = jsearch.query_struct(jnp.asarray(queries[0]), jf.partition,
                              jf.family)
    tq = tsearch.query_struct(torch.from_numpy(queries[0]), tf.partition,
                              tf.family)
    want, jcomp = jops.bregman_ub_filter(jf.alpha, jf.sqrt_gamma,
                                         jq["qconst"], jq["sqrt_delta"])
    got, tcomp = ops.bregman_ub_filter(tf.alpha, tf.sqrt_gamma,
                                       tq["qconst"], tq["sqrt_delta"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DIST_TOL)
    np.testing.assert_allclose(tcomp(7).numpy(), np.asarray(jcomp(7)),
                               **DIST_TOL)
    with pytest.raises(ValueError, match="single-query"):
        ops.bregman_ub_filter(tf.alpha, tf.sqrt_gamma, tq["qconst"][None],
                              tq["sqrt_delta"][None])


@pytest.mark.parametrize("quantize", TIERS)
def test_tiered_store_routes_one_query(quantize):
    """A store's single-query search is its batched search on the one
    query, bit-equal to the resident batched search on it; the oracle
    refuses a store."""
    _, tf, queries = clustered_forests(quantize)
    store = TieredPointStore.from_index(tf, resident_bytes=2048,
                                        block_rows=96)
    assert not store.is_resident
    try:
        for y in queries:
            want = tsearch.knn_search_batch(tf, y[None], K, 64,
                                            block_rows=96, device="cpu")
            wapprox = tsearch.knn_search_batch_approx(
                tf, y[None], K, 64, 0.9, block_rows=96, device="cpu")
            for got, w in ((tsearch.knn_search(store, y, K, 64,
                                               device="cpu"), want),
                           (tsearch.knn_search_approx(store, y, K, 64, 0.9,
                                                      device="cpu"),
                            wapprox)):
                for f in got._fields:
                    assert torch.equal(getattr(got, f), getattr(w, f)[0]), f
        with pytest.raises(TypeError, match="materializes the full"):
            tsearch.knn_search_batch_reference(store, queries, K, 64,
                                               device="cpu")
    finally:
        store.close()


def test_knob_errors():
    tf = port_forest("burg", False)
    y = jax_forest("burg")[2][0]
    with pytest.raises(ValueError, match="p_guarantee"):
        tsearch.knn_search_approx(tf, y, K, 64, 1.5, device="cpu")
    with pytest.raises(ValueError, match="needs p_guarantee"):
        tsearch.knn_search_approx(tf, y, K, 64, None, device="cpu")
    with pytest.raises(ValueError, match="p_guarantee"):
        tsearch.knn(tf, y, K, approx_p=-0.5, device="cpu")
    with pytest.raises(ValueError, match="p_guarantee"):
        tsearch.knn_search_batch_reference(tf, y[None], K, 64,
                                           p_guarantee=2.0, device="cpu")
    with pytest.raises(ValueError, match="one \\(d,\\) query"):
        tsearch.knn_search(tf, y[None], K, 64, device="cpu")
    with pytest.raises(ValueError, match="budget"):
        tsearch.knn_search(tf, y, K, K - 1, device="cpu")


def test_family_helpers_match_jax():
    rng = np.random.default_rng(5)
    for name in FAMILIES:
        jf, tf = jbregman.get_family(name), tbregman.get_family(name)
        xs = sample(name, (9, 6), seed=3)
        y = sample(name, (6,), seed=4)
        mask = (rng.random(6) < 0.6).astype(np.float32)
        np.testing.assert_allclose(
            tf.distance_masked(torch.from_numpy(xs), torch.from_numpy(y),
                               torch.from_numpy(mask)).numpy(),
            np.asarray(jf.distance_masked(xs, y, mask)), **DIST_TOL)
        np.testing.assert_allclose(
            tf.pairwise_distance(torch.from_numpy(xs),
                                 torch.from_numpy(y)).numpy(),
            np.asarray(jf.pairwise_distance(xs, y)), **DIST_TOL)
        wide = (rng.normal(size=(7, 5)) * 3).astype(np.float32)
        np.testing.assert_array_equal(
            tf.project(torch.from_numpy(wide)).numpy(),
            np.asarray(jf.project(wide)))
        # The sampler's domain rule, applied to each package's own normals.
        gen = torch.Generator().manual_seed(11)
        got = tf.sample(gen, (50, 4), scale=2.0)
        raw = torch.randn((50, 4), generator=torch.Generator()
                          .manual_seed(11)) * 2.0
        key = jax.random.PRNGKey(11)
        want = np.asarray(jf.sample(key, (50, 4), scale=2.0))
        jraw = np.asarray(jax.random.normal(key, (50, 4))) * 2.0
        np.testing.assert_array_equal(got.numpy(), _domain_rule(name, raw))
        np.testing.assert_array_equal(want, _domain_rule(name, jraw))
        assert got.dtype == torch.float32
        assert tbregman.validate_rows(name, got, mode="mask").all()


def _domain_rule(name, raw) -> np.ndarray:
    raw = np.asarray(raw, np.float32)
    if name in ("itakura_saito", "burg", "shannon"):
        return np.abs(raw) + np.float32(0.05)
    if name == "exponential":
        return np.clip(raw, -4.0, 4.0)
    return raw


def test_mahalanobis_matches_jax():
    q_diag = np.array([0.5, 2.0, 1.25, 3.0], np.float32)
    jf, tf = jbregman.mahalanobis(q_diag), tbregman.mahalanobis(q_diag)
    assert tf.name == jf.name == "mahalanobis"
    assert "mahalanobis" not in tbregman.family_names()
    rng = np.random.default_rng(6)
    xs = rng.normal(size=(11, 4)).astype(np.float32)
    y = rng.normal(size=4).astype(np.float32)
    tx, ty = torch.from_numpy(xs), torch.from_numpy(y)
    for got, want in (
            (tf.pairwise_distance(tx, ty), jf.pairwise_distance(xs, y)),
            (tf.distance(tx, ty[None]), jf.distance(xs, y[None])),
            (tf.f(tx), jf.f(xs)),
            (tf.grad_f(tx), jf.grad_f(xs)),
            (tf.phi_prime_inv(tx), jf.phi_prime_inv(xs))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DIST_TOL)
