"""The port's exact batched search against the JAX package's, on the
reference's own forest imported through numpy (CPU, small shapes)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.bounds as jbounds
import repro.core.index as jidx
import repro.core.search as jsearch
from repro.core.bregman import family_names

import repro_torch.core.bounds as tbounds
import repro_torch.core.index as tidx
import repro_torch.core.search as tsearch
from repro_torch.data.pipeline import PAPER_DATASETS, make_queries, \
    make_vectors

from torch_parity import D, K, M, N, NUM_CLUSTERS, jax_forest, sample, \
    to_port

FAMILIES = family_names()
DIST_TOL = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def port_forest(family: str):
    return to_port(jax_forest(family)[0])


def _assert_same_result(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.exact.numpy(), np.asarray(want.exact))
    np.testing.assert_array_equal(got.num_candidates.numpy(),
                                  np.asarray(want.num_candidates))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               **DIST_TOL)


@pytest.mark.parametrize("env_block_rows", [256, 512])
@pytest.mark.parametrize("block_rows", [96, 4096])
@pytest.mark.parametrize("family", FAMILIES)
def test_knn_search_batch_matches_jax(family, block_rows, env_block_rows):
    jf, _, queries = jax_forest(family)
    want = jsearch.knn_search_batch(jf, jnp.asarray(queries), K, None,
                                    block_rows=block_rows,
                                    env_block_rows=env_block_rows)
    got = tsearch.knn_search_batch(port_forest(family), queries, K, None,
                                   block_rows=block_rows,
                                   env_block_rows=env_block_rows,
                                   device="cpu")
    _assert_same_result(got, want)


@pytest.mark.parametrize("family", FAMILIES)
def test_knn_search_batch_stats_match_jax(family):
    jf, _, queries = jax_forest(family)
    want_res, want = jsearch.knn_search_batch_stats(
        jf, jnp.asarray(queries), K, 64, block_rows=96)
    got_res, got = tsearch.knn_search_batch_stats(
        port_forest(family), queries, K, 64, block_rows=96, device="cpu")
    _assert_same_result(got_res, want_res)
    assert set(got) == set(want)
    for key in ("block_rows", "num_blocks", "num_blocks_run",
                "env_admitted_tiles", "block_skip_rate",
                "whole_block_skip_rate"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["tau_admit"].numpy(),
                               np.asarray(want["tau_admit"]), **DIST_TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_knn_batch_escalates_like_jax(family):
    jf, _, queries = jax_forest(family)
    want, want_stats = jsearch.knn_batch(jf, queries, K, budget=K,
                                         block_rows=96, return_stats=True)
    got, got_stats = tsearch.knn_batch(port_forest(family), queries, K,
                                       budget=K, block_rows=96,
                                       return_stats=True, device="cpu")
    assert got_stats == want_stats
    assert got_stats.escalations > 0
    _assert_same_result(got, want)


def test_knn_batch_scan_fallback_and_stop_match_jax():
    jf, _, queries = jax_forest("itakura_saito")
    tf = port_forest("itakura_saito")
    for kwargs in (dict(max_doublings=0),
                   dict(max_doublings=2, stop_retry=lambda: True)):
        want, want_stats = jsearch.knn_batch(jf, queries, K, budget=K,
                                             return_stats=True, **kwargs)
        got, got_stats = tsearch.knn_batch(tf, queries, K, budget=K,
                                           return_stats=True, device="cpu",
                                           **kwargs)
        assert got_stats == want_stats
        _assert_same_result(got, want)


@pytest.mark.parametrize("budget", [3, 17, 64, 300])
def test_fill_block_slots_matches_jax(budget):
    rng = np.random.default_rng(budget)
    q, bn = 4, 40
    admit = (rng.random((bn, q)) < 0.4).astype(np.int32)
    count = rng.integers(0, budget, q).astype(np.int32)
    # Earlier blocks filled slots [0, count) with lower rows; the rest
    # hold n - 1, as _stream_prune_compact leaves them.
    n = 1000
    sel = np.where(np.arange(budget)[None] < count[:, None],
                   rng.integers(0, 96, (q, budget)), n - 1).astype(np.int32)
    j_sel, j_count = jsearch._fill_block_slots(
        jnp.asarray(sel), jnp.asarray(count), jnp.asarray(admit),
        jnp.int32(96), budget)
    t_sel, t_count = tsearch._fill_block_slots(
        torch.from_numpy(sel).long(), torch.from_numpy(count).long(),
        torch.from_numpy(admit), 96, budget)
    np.testing.assert_array_equal(t_sel.numpy(), np.asarray(j_sel))
    np.testing.assert_array_equal(t_count.numpy(), np.asarray(j_count))


@pytest.mark.parametrize("family", FAMILIES)
def test_torch_built_index_returns_brute_force_ids(family):
    data = sample(family, (N, D), seed=20)
    queries = sample(family, (6, D), seed=21)
    forest = tidx.build_index(data, family, m=M, num_clusters=NUM_CLUSTERS,
                              device="cpu")
    res = tsearch.knn_batch(forest, queries, K, device="cpu")
    bf_ids, bf_dists = tsearch.brute_force_knn(data, queries, K, family,
                                               device="cpu")
    want_ids, want_dists = jsearch.brute_force_knn(data, queries, K, family)
    np.testing.assert_array_equal(bf_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(bf_dists.numpy(), np.asarray(want_dists),
                               **DIST_TOL)
    assert bool(res.exact.all())
    np.testing.assert_array_equal(res.ids.numpy(), bf_ids.numpy())
    np.testing.assert_allclose(res.dists.numpy(), bf_dists.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_theorem4_pccp_build_returns_brute_force_ids():
    data = sample("exponential", (N, D), seed=22)
    queries = data[:5]
    forest = tidx.build_index(data, "ed", m=None, pccp=True, device="cpu")
    assert 1 <= forest.m <= D
    res, stats = tsearch.knn_batch(forest, queries, K, return_stats=True,
                                   device="cpu")
    bf_ids, _ = tsearch.brute_force_knn(data, queries, K, "ed", device="cpu")
    np.testing.assert_array_equal(res.ids.numpy(), bf_ids.numpy())
    assert stats.budget_final >= int(res.num_candidates.max())


def test_brute_force_single_query_matches_jax():
    data = sample("burg", (N, D), seed=23)
    y = sample("burg", (D,), seed=24)
    ids, dists = tsearch.brute_force_knn(data, y, K, "burg", device="cpu")
    want_ids, want_dists = jsearch.brute_force_knn(data, y, K, "burg")
    assert ids.shape == (K,)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(dists.numpy(), np.asarray(want_dists),
                               **DIST_TOL)


def test_resolvers_match_jax():
    for n, k, budget in ((420, 5, None), (420, 5, 7), (10, 2, 99),
                         (5000, 10, None)):
        assert (tsearch.resolve_budget(budget, n, k)
                == jsearch.resolve_budget(budget, n, k))
    for n, k, need in ((420, 5, 1), (420, 5, 33), (420, 5, 4000)):
        assert (tsearch.fitted_budget_for_n(n, k, need)
                == jsearch.fitted_budget_for_n(n, k, need))
    for br in (8, 96, 100_000):
        assert (tsearch.resolve_block_rows(br, 420)
                == jsearch.resolve_block_rows(br, 420))
    assert tsearch.resolve_block_rows(None, 420) == 4096
    for eb in (None, 256, 1024):
        assert (tsearch.resolve_env_block_rows(eb)
                == jsearch.resolve_env_block_rows(eb))
    for bad in (lambda m: m.resolve_budget(3, 420, 5),
                lambda m: m.resolve_budget(5, 420, 500),
                lambda m: m.resolve_block_rows(4, 420),
                lambda m: m.resolve_block_rows(96, 0),
                lambda m: m.resolve_env_block_rows(300)):
        with pytest.raises(ValueError):
            bad(jsearch)
        with pytest.raises(ValueError):
            bad(tsearch)
    assert tsearch._block_layout(420, 96) == jsearch._block_layout(420, 96)


def test_invalid_queries_are_refused():
    queries = sample("burg", (3, D), seed=25)
    queries[1, 2] = -1.0
    with pytest.raises(ValueError, match="query row 1 is invalid"):
        tsearch.knn_batch(port_forest("burg"), queries, K, device="cpu")
    with pytest.raises(ValueError, match=r"\(q, d\)"):
        tsearch.knn_batch(port_forest("burg"), queries[0], K, device="cpu",
                          validate=False)


def test_paper_dataset_search_matches_jax():
    """A paper dataset's stand-in: on the forest the reference builds
    with Theorem 4 and PCCP, the port's search gives the reference's
    candidates and ids."""
    spec = PAPER_DATASETS["audio"]
    scale = 800 / spec.n
    data = make_vectors(spec, scale=scale)
    queries = make_queries(spec, num=8, scale=scale, data=data)
    jf = jidx.build_index(data, spec.measure, m=None, pccp=True)
    want = jsearch.knn_search_batch(jf, jnp.asarray(queries), K, None)
    got = tsearch.knn_search_batch(to_port(jf), queries, K, None,
                                   device="cpu")
    _assert_same_result(got, want)


def test_paper_dataset_blocks_match_jax():
    """The same stand-in at 12,288 rows, three 4096-row blocks: the
    port's Alg.-4 bounds qb, envelope gate and Theorem-3 candidates equal
    the reference's on the reference's forest.  Prints how many of the M
    subspaces let each (point, query) pair through (run with -s)."""
    spec = PAPER_DATASETS["audio"]
    scale = 12_288 / spec.n
    data = make_vectors(spec, scale=scale)
    queries = make_queries(spec, num=8, scale=scale, data=data)
    jf = jidx.build_index(data, spec.measure, m=None, pccp=True)
    tf = to_port(jf)
    want, want_stats = jsearch.knn_search_batch_stats(
        jf, jnp.asarray(queries), K, None, block_rows=4096)
    got, got_stats = tsearch.knn_search_batch_stats(
        tf, queries, K, None, block_rows=4096, device="cpu")
    _assert_same_result(got, want)
    for key in ("num_blocks", "num_blocks_run", "env_admitted_tiles"):
        assert got_stats[key] == want_stats[key], key

    jqs = jsearch._query_struct(jf, jnp.asarray(queries))
    _, jrows = jsearch._batch_filter_topk(jf, jqs, K, 4096)
    want_qb = jbounds.ub_components(jsearch._tuple_rows(jf, jrows[:, -1]),
                                    jqs)
    qs = tsearch.query_struct(torch.as_tensor(queries), tf.partition,
                              tf.family)
    _, rows = tsearch._batch_filter_topk(tf, qs, K, 4096)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    qb = tbounds.ub_components(tsearch._tuple_rows(tf, rows[:, -1]), qs)
    np.testing.assert_allclose(qb.numpy(), np.asarray(want_qb), rtol=1e-5,
                               atol=1e-3)

    lb = (tf.alpha_min_pt[:, :, None] + qs["qconst"].T[None]
          - tf.sqrt_gamma_max_pt[:, :, None] * qs["sqrt_delta"].T[None])
    passing = (lb <= qb.T[None]).sum(dim=1).double()      # (n, q)
    print(f"\naudio stand-in n={tf.n} M={tf.m} blocks={got_stats['num_blocks']}"
          f" run={got_stats['num_blocks_run']}: candidates per query "
          f"{got.num_candidates.tolist()} (reference "
          f"{np.asarray(want.num_candidates).tolist()}); subspaces passing "
          f"a (point, query) pair: min {int(passing.min())}, mean "
          f"{float(passing.mean()):.2f}, max {int(passing.max())} of {tf.m}")
