"""The port's mutable index (core/segments.py) against the JAX package's, on
the CPU at small shapes, in both storage tiers.

The reference's own forests (tests/torch_parity.py) are imported into the
port and wrapped by ``SegmentedForest.from_forest`` on both sides; the same
numpy rows are inserted and the same ids deleted on each.  After the
mutation, a merge and a rebuild, the port's tables and search results are
held to the reference's: integer tables and data (or codes) bit-equal,
float stats within the tolerance of tests/test_torch_core.py, search ids,
exact and num_candidates equal, dists within 1e-5.  The mutation
invariants of tests/test_segments.py (those that need no mesh), and the
segmented cases of tests/test_stream_prune.py, test_tiered.py,
test_quantized.py and test_calibration.py, are held on the port.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core.search as jsearch
from repro.core.bregman import family_names
from repro.core.segments import SegmentedForest as JaxSegmented

import repro_torch.core.search as tsearch
from repro_torch.core.bregman import get_family
from repro_torch.core.calibrate import ensure_calibration
from repro_torch.core.index import (build_index, cold_point_fields,
                                    concat_points, pad_points, point_fields,
                                    slice_points, tombstone_rows)
from repro_torch.core.partition import CostModel, decide_compaction
from repro_torch.core.segments import (SegmentedForest,
                                       build_segmented_index)
from repro_torch.core.tiered import TieredPointStore

from torch_parity import D, K, M, N, jax_forest, sample, to_port

FAMILIES = family_names()
TIERS = [False, True]
N_ADD = 44
# Two ids of the sealed main segment, one appended.
DELETED = (3, 7, N + 10)
STAT_TOL = dict(rtol=1e-6, atol=1e-5)
DIST_TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_ROWS = 96
P_APPROX = 0.8
GRID = (0.0, 0.5, 0.8, 1.0)


def _extra(family: str) -> np.ndarray:
    return sample(family, (N_ADD, D), seed=7)


def _pair(family: str, quantize: bool):
    """(reference, port) mutable indexes over the reference's forest,
    after the same insert and delete, with the queries."""
    jf, _, queries = jax_forest(family, quantize)
    jsf = JaxSegmented.from_forest(jf)
    tsf = SegmentedForest.from_forest(to_port(jf))
    extra = _extra(family)
    np.testing.assert_array_equal(jsf.insert(extra, auto_compact=False),
                                  tsf.insert(extra, auto_compact=False))
    assert (tsf.delete(DELETED, auto_compact=False)
            == jsf.delete(DELETED, auto_compact=False) == len(DELETED))
    return jsf, tsf, queries


# The int8 stat tables and their decode fields: (codes, scale, zero point).
INT8_STATS = (("alpha", "alpha_scale", "alpha_zp"),
              ("sqrt_gamma", "sg_scale", "sg_zp"),
              ("alpha_min_pt", "amin_scale", "amin_zp"),
              ("sqrt_gamma_max_pt", "gmax_scale", "gmax_zp"))


def _assert_tables_match(tview, jview):
    """Ids, assignments and data (int8: its codes and decode) bit-equal;
    fp32 stats within the transforms' tolerance.  An int8 stat table is
    held through its decode, within that tolerance plus one code step:
    the appended rows' stats agree only to fp32 rounding across the two
    packages, and a code rounded (a corner directionally) from two such
    values can land one step apart."""
    assert tview.n == jview.n and tview.storage == jview.storage
    stat_fields = {f for t in INT8_STATS for f in t}
    for f in point_fields(jview):
        got, want = getattr(tview, f).numpy(), np.asarray(getattr(jview, f))
        if tview.storage == "int8" and f in stat_fields:
            continue
        if f in ("data", "point_ids", "assign", "data_scale", "data_zp"):
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, **STAT_TOL, err_msg=f)
    if tview.storage == "int8":
        for fields in INT8_STATS:
            got, want = _decode(tview, *fields), _decode(jview, *fields)
            step = np.asarray(getattr(jview, fields[1]))[:, None] * (1 + 1e-3)
            limit = STAT_TOL["atol"] + STAT_TOL["rtol"] * np.abs(want) + step
            assert (np.abs(got - want) <= limit).all(), fields[0]


def _decode(view, codes, scale, zp) -> np.ndarray:
    """An int8 stat table's decode in float64, from either package."""
    c, s, z = (np.asarray(getattr(view, f).numpy()
                          if isinstance(getattr(view, f), torch.Tensor)
                          else getattr(view, f)) for f in (codes, scale, zp))
    return c.astype(np.float64) * s[:, None] + z[:, None]


def _assert_same_result(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.exact.numpy(), np.asarray(want.exact))
    np.testing.assert_array_equal(got.num_candidates.numpy(),
                                  np.asarray(want.num_candidates))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               **DIST_TOL)


def _assert_bit_equal(got, want):
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _search_both(jsf, tsf, queries, budget):
    want = jsearch.knn_search_batch(jsf, jnp.asarray(queries), K, budget)
    got = tsearch.knn_search_batch(tsf, queries, K, budget, device="cpu")
    return got, want


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", TIERS)
@pytest.mark.parametrize("family", FAMILIES)
def test_mutated_index_matches_jax(family, quantize):
    jsf, tsf, queries = _pair(family, quantize)
    assert (tsf.n, tsf.live_n, tsf.next_id) == (jsf.n, jsf.live_n,
                                                jsf.next_id)
    assert tsf.stale_fraction == jsf.stale_fraction
    assert tsf.append_row_range() == jsf.append_row_range()
    np.testing.assert_array_equal(tsf.live_ids(), jsf.live_ids())
    _assert_tables_match(tsf.view(), jsf.view())
    assert tsf.view() is tsf.view()
    got, want = _search_both(jsf, tsf, queries, tsf.live_n)
    _assert_same_result(got, want)
    assert not set(DELETED) & set(got.ids.numpy().ravel().tolist())
    assert tsf.decide() == jsf.decide()


@pytest.mark.parametrize("quantize", TIERS)
@pytest.mark.parametrize("family", FAMILIES)
def test_merge_matches_jax(family, quantize):
    jsf, tsf, queries = _pair(family, quantize)
    budget = tsf.live_n
    before = tsearch.knn_search_batch(tsf, queries, K, budget, device="cpu")
    rows_before = dict(zip(tsf.view().point_ids.tolist(),
                           tsf.view().data.numpy(), strict=True))
    assert tsf.compact("merge") == jsf.compact("merge") == "merge"
    assert not tsf.segments and tsf.n == tsf.live_n == jsf.n
    _assert_tables_match(tsf.view(), jsf.view())
    got, want = _search_both(jsf, tsf, queries, budget)
    _assert_same_result(got, want)
    _assert_bit_equal(got, before)
    # The stored rows (the codes in int8) move bit for bit.
    for i, row in zip(tsf.view().point_ids.tolist(), tsf.view().data.numpy(),
                      strict=True):
        np.testing.assert_array_equal(row, rows_before[i])


@pytest.mark.parametrize("quantize", TIERS)
@pytest.mark.parametrize("family", FAMILIES)
def test_rebuild_matches_jax(family, quantize):
    jsf, tsf, queries = _pair(family, quantize)
    budget = tsf.live_n
    assert tsf.compact("rebuild") == jsf.compact("rebuild") == "rebuild"
    assert not tsf.segments and tsf.n == tsf.live_n == jsf.n
    # The layouts differ (each package seeds its own k-means draw); the
    # live ids and the search results are the same.
    np.testing.assert_array_equal(np.sort(tsf.main.point_ids.numpy()),
                                  np.sort(np.asarray(jsf.main.point_ids)))
    got, want = _search_both(jsf, tsf, queries, budget)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert bool(got.exact.all())


def test_cost_model_and_decision_match_jax():
    jsf, tsf, _ = _pair("burg", False)
    tm, jm = tsf.fitted_cost_model(), jsf.fitted_cost_model()
    assert tsf.fitted_cost_model() is tm
    for f in ("a", "alpha", "beta"):
        np.testing.assert_allclose(getattr(tm, f), getattr(jm, f),
                                   rtol=1e-4, err_msg=f)
    assert (tm.n, tm.d) == (jm.n, jm.d) == (tsf.live_n, D)
    for stale in (0.0, 0.5, 5.0, 50.0):
        assert (decide_compaction(tm, M, stale_fraction=stale,
                                  amortize_queries=10**9)
                == decide_compaction(jm, M, stale_fraction=stale,
                                     amortize_queries=10**9))
    tsf.compact("merge")
    assert tsf.cost_model is None


def test_mutated_datastore_hook_matches_jax():
    """The Datastore contract of tests/test_segments.py, grown and evicted
    the same way on both sides: the hooks' mixed log-probs agree and
    their neighbour ids are equal."""
    from repro.serve import knnlm as jknnlm
    from repro_torch.serve import knnlm as tknnlm
    jf, data, _ = jax_forest("squared_euclidean", False)
    vocab = 32
    toks = np.arange(N, dtype=np.int32) % vocab
    jstore = jknnlm.Datastore(index=jf, next_tokens=toks, hidden_dim=D)
    tstore = tknnlm.Datastore(index=to_port(jf), next_tokens=toks,
                              hidden_dim=D)
    extra = _extra("squared_euclidean")
    new = np.full(N_ADD, 7, np.int32)
    np.testing.assert_array_equal(tstore.grow(extra, new),
                                  jstore.grow(extra, new))
    assert tstore.evict(DELETED) == jstore.evict(DELETED) == 3
    assert tstore.version == jstore.version == 2
    jhook = jknnlm.KNNLMHook(store=jstore, k=4, lam=0.5)
    thook = tknnlm.KNNLMHook(store=tstore, k=4, lam=0.5)
    logits = np.random.default_rng(1).normal(size=(3, vocab)).astype(
        np.float32)
    hidden = np.concatenate([extra[:2], data[:1]])
    want = np.asarray(jhook(jnp.asarray(logits), jnp.asarray(hidden)))
    got = thook(torch.from_numpy(logits), torch.from_numpy(hidden)).numpy()
    np.testing.assert_allclose(got, want, **DIST_TOL)
    np.testing.assert_array_equal(
        thook.last_result.ids.numpy(),
        np.asarray(jsearch.knn_batch(jstore.index, jnp.asarray(hidden),
                                     4).ids))
    assert int(np.argmax(got[0])) == 7


# ---------------------------------------------------------------------------
# The mutation invariants of tests/test_segments.py, on the port
# ---------------------------------------------------------------------------

def _mutated_setup(family, quantize=False, seed=0):
    """A port-built mutable index after insert and delete, the port's
    fresh build over the same live rows, the live rows' original ids and
    queries."""
    data = sample(family, (N + N_ADD, D), seed=seed + 11)
    queries = sample(family, (5, D), seed=seed + 12)
    kw = dict(m=M, num_clusters=16, seed=seed, quantize=quantize,
              device="cpu")
    sf = build_segmented_index(data[:N], family, **kw)
    ids = sf.insert(data[N:], auto_compact=False)
    assert ids.tolist() == list(range(N, N + N_ADD))
    assert sf.delete(DELETED, auto_compact=False) == len(DELETED)
    live = np.ones(N + N_ADD, bool)
    live[list(DELETED)] = False
    fresh = build_index(data[live], family, **kw)
    return sf, fresh, np.arange(N + N_ADD)[live], queries, data


@pytest.mark.parametrize("family", FAMILIES)
def test_exact_bit_identical_to_fresh_rebuild(family):
    sf, fresh, orig, queries, _ = _mutated_setup(family)
    assert sf.live_n == N + N_ADD - len(DELETED)
    budget = sf.live_n
    res = tsearch.knn_search_batch(sf, queries, K, budget, device="cpu")
    ref = tsearch.knn_search_batch(fresh, queries, K, budget, device="cpu")
    np.testing.assert_array_equal(res.ids.numpy(), orig[ref.ids.numpy()])
    assert torch.equal(res.dists, ref.dists)
    assert bool(res.exact.all()) and bool(ref.exact.all())
    single = tsearch.knn_search(sf, queries[0], K, budget, device="cpu")
    single_ref = tsearch.knn_search(fresh, queries[0], K, budget,
                                    device="cpu")
    np.testing.assert_array_equal(single.ids.numpy(),
                                  orig[single_ref.ids.numpy()])
    assert torch.equal(single.dists, single_ref.dists)
    assert bool(single.exact) and bool(single_ref.exact)


@pytest.mark.parametrize("family", FAMILIES)
def test_approx_mode_on_mutated_forest(family):
    sf, _, _, queries, _ = _mutated_setup(family)
    res = tsearch.knn_batch(sf, queries, K, approx_p=0.9, device="cpu")
    for qi in range(queries.shape[0]):
        single = tsearch.knn(sf, queries[qi], K, approx_p=0.9, device="cpu")
        assert int(res.num_candidates[qi]) == int(single.num_candidates)
        if bool(res.exact[qi]) and bool(single.exact):
            assert set(res.ids[qi].tolist()) == set(single.ids.tolist())
    assert not np.isin(res.ids.numpy(), DELETED).any()
    view = sf.view()
    row_of = {int(i): r for r, i in enumerate(view.point_ids.tolist())
              if i >= 0}
    for qi in range(queries.shape[0]):
        rows = view.data[[row_of[int(i)] for i in res.ids[qi]]]
        true_d = sf.family.distance(rows, torch.as_tensor(queries[qi])[None])
        np.testing.assert_allclose(res.dists[qi].numpy(), true_d.numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_deleted_true_neighbors_never_surface():
    family = "squared_euclidean"
    fam = get_family(family)
    data = sample(family, (N + N_ADD, D), seed=2)
    queries = sample(family, (3, D), seed=3)
    sf = build_segmented_index(data[:N], family, m=M, num_clusters=16,
                               seed=0, device="cpu")
    sf.insert(data[N:], auto_compact=False)
    top, _ = tsearch.brute_force_knn(data, queries[0], K, fam, device="cpu")
    doomed = top.tolist()
    sf.delete(doomed, auto_compact=False)
    live = np.ones(N + N_ADD, bool)
    live[doomed] = False
    bf_ids, bf_d = tsearch.brute_force_knn(data[live], queries, K, fam,
                                           device="cpu")
    bf_ids = np.arange(N + N_ADD)[live][bf_ids.numpy()]
    batch = tsearch.knn_batch(sf, queries, K, device="cpu")
    single = tsearch.knn(sf, queries[0], K, device="cpu")
    for ids in (batch.ids.numpy(), single.ids.numpy()[None]):
        assert not np.isin(ids, doomed).any()
    assert bool(batch.exact.all())
    np.testing.assert_array_equal(batch.ids.numpy(), bf_ids)
    np.testing.assert_allclose(batch.dists.numpy(), bf_d.numpy(), **DIST_TOL)


def test_exact_flag_truthful_under_tiny_budget():
    sf, fresh, orig, queries, _ = _mutated_setup("itakura_saito", seed=4)
    res = tsearch.knn_batch(sf, queries, K, budget=K, device="cpu")
    assert bool(res.exact.all())
    ref = tsearch.knn_search_batch(fresh, queries, K, fresh.n, device="cpu")
    np.testing.assert_array_equal(res.ids.numpy(), orig[ref.ids.numpy()])


def test_budget_cap_escalation_skips_tombstones():
    sf, _, _, queries, _ = _mutated_setup("squared_euclidean", seed=6)
    res, stats = tsearch.knn_batch(sf, queries, K, budget=K, max_doublings=0,
                                   return_stats=True, device="cpu")
    assert stats.escalated_to_scan and bool(res.exact.all())
    ids = res.ids.numpy()
    assert not np.isin(ids, DELETED).any() and (ids >= 0).all()
    view = sf.view()
    live = view.data[view.point_ids >= 0]
    _, bf_d = tsearch.brute_force_knn(live, queries, K, sf.family,
                                      device="cpu")
    np.testing.assert_allclose(res.dists.numpy(), bf_d.numpy(), **DIST_TOL)


def test_budget_exceeding_n_is_clamped():
    data = sample("squared_euclidean", (64, D), seed=9)
    sf = build_segmented_index(data, "squared_euclidean", m=M,
                               num_clusters=4, seed=0, device="cpu")
    sf.delete(range(40), auto_compact=False)
    sf.compact("merge")                       # n shrinks to 24
    assert sf.n == 24
    res = tsearch.knn_batch(sf, data[40:43], 3, budget=512, device="cpu")
    np.testing.assert_array_equal(res.ids[:, 0].numpy(), np.arange(40, 43))
    single = tsearch.knn(sf, data[41], 3, budget=512, device="cpu")
    assert int(single.ids[0]) == 41


@pytest.mark.parametrize("quantize", TIERS)
def test_pad_slice_roundtrip_with_segments_and_tombstones(quantize):
    sf, _, _, queries, _ = _mutated_setup("exponential", quantize)
    view = sf.view()
    padded = pad_points(view, 7)
    assert padded.n % 7 == 0
    _assert_bit_equal(
        tsearch.knn_search_batch(padded, queries, K, view.n, device="cpu"),
        tsearch.knn_search_batch(view, queries, K, view.n, device="cpu"))
    h = padded.n // 2
    rt = concat_points([slice_points(padded, 0, h),
                        slice_points(padded, h, padded.n - h)])
    for f in point_fields(padded):
        assert torch.equal(getattr(rt, f), getattr(padded, f)), f
    assert torch.equal(rt.env_alpha_min, padded.env_alpha_min)
    with pytest.raises(ValueError, match="segments of one index"):
        concat_points([view, _mutated_setup("burg", quantize)[0].view()])


@pytest.mark.parametrize("quantize", TIERS)
def test_tombstone_rows_matches_jax(quantize):
    from repro.core.index import tombstone_rows as jax_tombstone
    jf, _, _ = jax_forest("shannon", quantize)
    dead = np.zeros(N, bool)
    dead[::5] = True
    got = tombstone_rows(to_port(jf), torch.from_numpy(dead))
    want = jax_tombstone(jf, jnp.asarray(dead))
    for f in point_fields(jf) + ("env_alpha_min",):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_compact_merge_and_rebuild_preserve_results_and_ids():
    family = "shannon"
    sf, _, _, queries, _ = _mutated_setup(family)
    budget = sf.live_n
    before = tsearch.knn_search_batch(sf, queries, K, budget, device="cpu")
    for mode in ("merge", "rebuild"):
        other = _mutated_setup(family)[0]
        assert other.compact(mode) == mode
        assert not other.segments and other.n == other.live_n
        _assert_bit_equal(
            tsearch.knn_search_batch(other, queries, K, budget, device="cpu"),
            before)
    with pytest.raises(ValueError, match="unknown compaction mode"):
        _mutated_setup(family)[0].compact("defrag")


def test_auto_compact_on_threshold():
    data = sample("squared_euclidean", (200, D), seed=5)
    sf = build_segmented_index(data[:100], "squared_euclidean", m=M,
                               num_clusters=8, seed=0, device="cpu",
                               compact_threshold=0.25)
    sf.insert(data[100:110], auto_compact=True)      # 10%: below
    assert len(sf.segments) == 1
    sf.insert(data[110:160], auto_compact=True)      # about 60%: crosses
    assert not sf.segments and sf.n == sf.live_n == 160
    res = tsearch.knn_batch(sf, data[:4], 1, device="cpu")
    np.testing.assert_array_equal(res.ids.numpy().ravel(), np.arange(4))


def test_decide_compaction_cost_rule():
    model = CostModel(a=1.0, alpha=0.5, beta=1e-4, n=4096, d=64)
    assert decide_compaction(model, 4, stale_fraction=0.0) == "merge"
    assert decide_compaction(model, 4, stale_fraction=50.0,
                             amortize_queries=10**9) == "rebuild"
    flips = [decide_compaction(model, 4, stale_fraction=s,
                               amortize_queries=10**9)
             for s in (0.0, 0.5, 5.0, 50.0)]
    assert flips == sorted(flips, key=lambda x: x == "rebuild")


def test_k_validated_against_live_count():
    data = sample("squared_euclidean", (32, D), seed=6)
    sf = build_segmented_index(data, "squared_euclidean", m=M,
                               num_clusters=4, seed=0, device="cpu")
    sf.delete(range(16), auto_compact=False)
    for call in (lambda: tsearch.knn_batch(sf, data[:2], 17, device="cpu"),
                 lambda: tsearch.knn(sf, data[0], 17, device="cpu"),
                 lambda: tsearch.knn_search_batch(sf, data[:2], 17, 32,
                                                  device="cpu")):
        with pytest.raises(ValueError, match="live point count"):
            call()


def test_delete_everything_then_reinsert():
    data = sample("squared_euclidean", (48, D), seed=10)
    sf = build_segmented_index(data[:32], "squared_euclidean", m=M,
                               num_clusters=4, seed=0, device="cpu")
    assert sf.delete(range(32)) == 32     # the automatic compaction runs
    assert sf.live_n == 0 and sf.n == 0 and not sf.segments
    with pytest.raises(ValueError, match="live point count"):
        tsearch.knn_batch(sf, data[:1], 1, device="cpu")
    ids = sf.insert(data[32:], auto_compact=False)
    assert ids.tolist() == list(range(32, 48))
    res = tsearch.knn_batch(sf, data[32:35], 1, device="cpu")
    np.testing.assert_array_equal(res.ids.numpy().ravel(), ids[:3])


def test_insert_rejects_bad_shape_and_invalid_rows():
    data = sample("itakura_saito", (64, D), seed=7)
    sf = build_segmented_index(data, "itakura_saito", m=M, num_clusters=4,
                               seed=0, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        sf.insert(np.ones((3, D + 1), np.float32))
    with pytest.raises(ValueError, match="expected"):
        sf.insert(np.ones((D,), np.float32))
    bad = np.full((1, D), 0.5, np.float32)
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="insert row 0"):
        sf.insert(bad, validate=True)
    assert sf.find_invalid().size == 0
    (bid,) = sf.insert(bad, validate=False)
    assert sf.find_invalid().tolist() == [bid]
    assert sf.quarantine().tolist() == [bid]
    assert sf.find_invalid().size == 0 and bid not in sf.live_ids()


# ---------------------------------------------------------------------------
# The segmented cases of the streamed, tiered, int8 and calibration tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", TIERS)
@pytest.mark.parametrize("family", FAMILIES)
def test_stream_matches_reference_mutated_segmented(family, quantize):
    _, tsf, queries = _pair(family, quantize)
    budget = tsf.live_n
    res = tsearch.knn_search_batch(tsf, queries, K, budget,
                                   block_rows=BLOCK_ROWS, device="cpu")
    ref = tsearch.knn_search_batch_reference(tsf, queries, K, budget,
                                             block_rows=BLOCK_ROWS,
                                             device="cpu")
    _assert_bit_equal(res, ref)
    assert bool(res.exact.all())
    assert not set(DELETED) & set(res.ids.numpy().ravel().tolist())
    _assert_bit_equal(
        tsearch.knn_search_batch_approx(tsf, queries, K, budget, P_APPROX,
                                        block_rows=BLOCK_ROWS, device="cpu"),
        tsearch.knn_search_batch_reference(tsf, queries, K, budget,
                                           p_guarantee=P_APPROX,
                                           block_rows=BLOCK_ROWS,
                                           device="cpu"))


def _cold_budget(sf, share=0.6) -> int:
    """``share`` of a mutable index's cold bytes: tiered, a few blocks."""
    view = sf.view()
    return max(1, int(share * sum(getattr(view, f).numel()
                                  * getattr(view, f).element_size()
                                  for f in cold_point_fields(view))))


@pytest.mark.parametrize("quantize", TIERS)
@pytest.mark.parametrize("family", FAMILIES)
def test_tiered_matches_resident_mutated_segmented(family, quantize):
    """A real mutable index through ``TieredPointStore.from_index``: the
    append rows' blocks pinned and kept, results bit-equal to the
    resident search over ``view()``."""
    _, tsf, queries = _pair(family, quantize)
    store = TieredPointStore.from_index(tsf, resident_bytes=_cold_budget(tsf),
                                        block_rows=BLOCK_ROWS)
    lo, hi = tsf.append_row_range()
    assert lo == tsf.main.n and hi == tsf.n
    pinned = set(range(lo // BLOCK_ROWS, -(-hi // BLOCK_ROWS)))
    assert store._pinned == pinned and pinned
    assert not store.is_resident and store.live_n == tsf.live_n
    budget = tsf.live_n
    _assert_bit_equal(
        store.search(queries, K, budget, device="cpu"),
        tsearch.knn_search_batch(tsf, queries, K, budget,
                                 block_rows=BLOCK_ROWS, device="cpu"))
    assert pinned <= set(store._cache)
    _assert_bit_equal(
        store.search(queries, K, budget, p_guarantee=P_APPROX, device="cpu"),
        tsearch.knn_search_batch_approx(tsf, queries, K, budget, P_APPROX,
                                        block_rows=BLOCK_ROWS, device="cpu"))
    store.close()


def test_tiered_matches_after_compact():
    _, tsf, queries = _pair("shannon", False)
    tsf.compact("merge")
    store = TieredPointStore.from_index(tsf, resident_bytes=_cold_budget(tsf),
                                        block_rows=BLOCK_ROWS)
    assert tsf.append_row_range()[0] == tsf.append_row_range()[1]
    assert not store._pinned
    _assert_bit_equal(
        store.search(queries, K, 64, device="cpu"),
        tsearch.knn_search_batch(tsf, queries, K, 64, block_rows=BLOCK_ROWS,
                                 device="cpu"))
    store.close()


def _decoded_oracle(view, queries, k, fam):
    rows = view.rows_view()
    live = view.point_ids >= 0
    ids, dists = tsearch.brute_force_knn(rows[live], queries, k, fam,
                                         device="cpu")
    return view.point_ids[live][ids].numpy(), dists.numpy()


@pytest.mark.parametrize("family", FAMILIES)
def test_quantized_segmented_mutations_stay_exact(family):
    _, tsf, queries = _pair(family, True)
    tsf.delete(np.arange(0, 30), auto_compact=False)
    res = tsearch.knn_batch(tsf, queries, K, device="cpu")
    assert bool(res.exact.all())
    ids, dists = _decoded_oracle(tsf.view(), queries, K, tsf.family)
    np.testing.assert_array_equal(res.ids.numpy(), ids)
    np.testing.assert_allclose(res.dists.numpy(), dists, **DIST_TOL)
    assert not (res.ids.numpy() < 30).any()


def test_quantized_rebuild_compaction_stays_exact_over_new_codes():
    _, tsf, queries = _pair("itakura_saito", True)
    assert tsf.compact(mode="rebuild") == "rebuild"
    assert tsf.storage == "int8"
    res = tsearch.knn_batch(tsf, queries, K, device="cpu")
    assert bool(res.exact.all())
    ids, dists = _decoded_oracle(tsf.view(), queries, K, tsf.family)
    np.testing.assert_array_equal(res.ids.numpy(), ids)
    np.testing.assert_allclose(res.dists.numpy(), dists, **DIST_TOL)


def test_curve_survives_mutations_and_compact_refits():
    import repro.core.calibrate as jcal
    data = sample("shannon", (200, D), seed=1)
    sf = build_segmented_index(data, "shannon", m=M, device="cpu")
    sf = ensure_calibration(sf, k=K, num_queries=16, p_grid=GRID)
    fitted = sf.calibration
    assert fitted is not None
    ids = sf.insert(sample("shannon", (40, D), seed=3), auto_compact=False)
    assert sf.calibration is fitted
    sf.delete(ids[:10], auto_compact=False)
    assert sf.calibration is fitted and sf.view().calibration is fitted
    # The curve of the mutated index, through its view, as the reference
    # measures it over the same rows.
    jview = to_jax_view(sf)
    want = jcal.fit_calibration(jview, k=K, num_queries=16, p_grid=GRID)
    from repro_torch.core.calibrate import fit_calibration
    got = fit_calibration(sf, k=K, num_queries=16, p_grid=GRID)
    np.testing.assert_array_equal(got.recall_grid, want.recall_grid)
    sf.compact("merge")
    assert sf.calibration is not None and sf.calibration is not fitted
    assert sf.calibration.k == K and tuple(sf.calibration.p_grid) == GRID

    sf2 = build_segmented_index(sample("burg", (60, D), seed=2), "burg", m=M,
                                device="cpu")
    sf2 = ensure_calibration(sf2, k=K, num_queries=8, p_grid=GRID)
    sf2.delete(np.arange(60 - K + 1), auto_compact=False)
    sf2.compact("merge")                   # live_n < k: nothing to measure
    assert sf2.calibration is None


def test_uncalibrated_compact_stays_uncalibrated():
    sf = build_segmented_index(sample("exponential", (80, D), seed=4),
                               "exponential", m=M, device="cpu")
    sf.insert(sample("exponential", (10, D), seed=2), auto_compact=False)
    sf.compact("merge")
    assert sf.calibration is None


def to_jax_view(sf):
    """The port's mutable index's view as a reference forest (numpy)."""
    import dataclasses as dc
    from repro.core.index import BallForest as JaxForest
    from repro.core.transform import Partition as JaxPartition
    view = sf.view()
    p = view.partition
    fields = {f.name for f in dc.fields(JaxForest)}
    arrays = {f: jnp.asarray(getattr(view, f).numpy())
              for f in fields if isinstance(getattr(view, f, None),
                                            torch.Tensor)}
    return JaxForest(
        family_name=view.family_name,
        partition=JaxPartition(d=p.d, num_subspaces=p.num_subspaces,
                               width=p.width, idx=p.idx, mask=p.mask),
        num_clusters=view.num_clusters, storage=view.storage, **arrays)

