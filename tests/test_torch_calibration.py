"""The port's recall calibration (core/calibrate.py), the ``target_recall``
knob and ``build_index(calibrate=True)`` against the JAX package, on the
reference's own forests imported through numpy (CPU, small shapes, both
storage tiers)."""

import dataclasses
import functools
import logging

import numpy as np
import pytest
import torch

import repro.core.calibrate as jcal
import repro.core.search as jsearch

import repro_torch.core.calibrate as tcal
import repro_torch.core.index as tidx
import repro_torch.core.search as tsearch
from repro_torch.core.tiered import TieredPointStore

from torch_parity import K, blob_forest, jax_forest, sample, to_port

TIERS = [False, True]
GRID = (0.0, 0.5, 0.8, 1.0)
FIT_QUERIES = 16


@functools.lru_cache(maxsize=None)
def forests(case: str, quantize: bool):
    """(reference forest, port forest, queries) of a family's forest or
    of the blob corpus (``case == "blobs"``, a mixed Theorem-3 mask)."""
    jf, _, queries = (blob_forest(quantize) if case == "blobs"
                      else jax_forest(case, quantize))
    return jf, to_port(jf), queries


def _curve(recall_grid, p_grid=(0.0, 0.5, 1.0), module=tcal):
    return module.RecallCalibration(p_grid=tuple(p_grid),
                                    recall_grid=tuple(recall_grid),
                                    k=K, num_queries=8, seed=0)


def _assert_bit_equal(got, want):
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.parametrize("quantize", TIERS)
def test_held_out_queries_match_jax(quantize):
    for case in ("burg", "blobs"):
        jf, tf, _ = forests(case, quantize)
        for seed, num in ((0, FIT_QUERIES), (3, 500)):
            got = tcal.held_out_queries(tf, num, seed)
            want = jcal.held_out_queries(jf, num, seed)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case, quantize", [
    ("blobs", False), ("blobs", True), ("burg", False),
    ("itakura_saito", True), ("shannon", False)])
def test_fit_calibration_matches_jax(case, quantize):
    jf, tf, _ = forests(case, quantize)
    want = jcal.fit_calibration(jf, k=K, num_queries=FIT_QUERIES,
                                p_grid=GRID, seed=1)
    got = tcal.fit_calibration(tf, k=K, num_queries=FIT_QUERIES,
                               p_grid=GRID, seed=1)
    np.testing.assert_array_equal(got.p_grid, want.p_grid)
    np.testing.assert_array_equal(got.recall_grid, want.recall_grid)
    assert (got.k, got.num_queries, got.seed, got.jitter) == \
        (want.k, want.num_queries, want.seed, want.jitter)
    assert got.recall_grid[-1] == 1.0
    assert np.all(np.diff(got.recall_grid) >= 0)


def test_fit_calibration_refuses_a_bad_grid():
    _, tf, _ = forests("burg", False)
    for grid in ((0.5,), (0.0, 0.9), (0.5, 0.2, 1.0)):
        with pytest.raises(ValueError, match="p_grid"):
            tcal.fit_calibration(tf, k=K, p_grid=grid)


def test_resolve_and_expected_recall_match_jax():
    for grid, p_grid in (((0.4, 0.8, 1.0), (0.0, 0.5, 1.0)),
                         ((0.2, 0.5, 0.9), (0.0, 0.5, 1.0)),
                         ((0.1, 0.1, 0.6, 0.95, 1.0), (0, .3, .6, .9, 1))):
        got, want = _curve(grid, p_grid), _curve(grid, p_grid, jcal)
        for t in (0.0, 0.1, 0.3, 0.4, 0.41, 0.7, 0.9, 0.95, 0.99, 1.0):
            assert got.resolve(t) == want.resolve(t), (grid, t)
        for p in (0.0, 0.25, 0.5, 0.8, 1.0):
            assert got.expected_recall(p) == want.expected_recall(p)
        for bad in (-0.1, 1.1, float("nan")):
            with pytest.raises(ValueError, match="target_recall"):
                got.resolve(bad)
    cal = _curve((0.4, 0.8, 1.0))
    assert cal.resolve(0.7) == (0.5, 0.8)
    assert cal.resolve(0.9) == (1.0, 1.0)
    assert _curve((0.2, 0.5, 0.9)).resolve(0.95) == (1.0, 0.9)
    assert cal.expected_recall(0.25) == pytest.approx(0.6)


def test_uncalibrated_fallback_warns_once(monkeypatch, caplog):
    """No curve: ``target_recall`` runs as ``p = target`` with no expected
    recall, bit-equal to ``approx_p``, announced once per process."""
    monkeypatch.setattr(tcal, "_warned_uncalibrated", False)
    _, tf, queries = forests("burg", False)
    assert tf.calibration is None
    with caplog.at_level(logging.WARNING, logger=tcal.logger.name):
        assert tcal.resolve_p_guarantee(tf, 0.9) == (0.9, None)
        a = tsearch.knn_batch(tf, queries, K, target_recall=0.9,
                              device="cpu")
        assert tcal.resolve_p_guarantee(tf, 0.5) == (0.5, None)
    warnings = [r for r in caplog.records if "uncalibrated" in r.message]
    assert len(warnings) == 1
    _assert_bit_equal(a, tsearch.knn_batch(tf, queries, K, approx_p=0.9,
                                           device="cpu"))
    with pytest.raises(ValueError, match="target_recall"):
        tcal.resolve_p_guarantee(tf, 1.5)


def test_validate_target_recall():
    for ok in (None, 0, 0.5, 1.0, np.float32(0.9)):
        tcal.validate_target_recall(ok)
    for bad in (-0.01, 1.01, float("nan")):
        with pytest.raises(ValueError, match="target_recall"):
            tcal.validate_target_recall(bad)


def test_exclusive_knob_errors():
    _, tf, queries = forests("burg", False)
    tf = dataclasses.replace(tf, calibration=_curve((0.4, 0.8, 1.0)))
    store = TieredPointStore.from_index(tf, resident_bytes=2048,
                                        block_rows=96)
    try:
        for index in (tf, store):
            with pytest.raises(ValueError, match="at most one"):
                tsearch.knn_batch(index, queries, K, approx_p=0.9,
                                  target_recall=0.9, device="cpu")
            with pytest.raises(ValueError, match="exactly one"):
                tsearch.knn_search_batch_approx(index, queries, K, 64,
                                                device="cpu")
            with pytest.raises(ValueError, match="exactly one"):
                tsearch.knn_search_batch_approx(
                    index, queries, K, 64, p_guarantee=0.9,
                    target_recall=0.9, device="cpu")
        with pytest.raises(ValueError, match="at most one"):
            store.search(queries, K, 64, p_guarantee=0.9, target_recall=0.9,
                         device="cpu")
        with pytest.raises(ValueError, match="target_recall"):
            tsearch.knn_batch(tf, queries, K, target_recall=1.5,
                              device="cpu")
    finally:
        store.close()


@pytest.mark.parametrize("quantize", TIERS)
def test_build_index_calibrate_attaches_the_fitted_curve(quantize):
    data = sample("shannon", (300, 8), seed=4)
    plain = tidx.build_index(data, "shannon", m=2, quantize=quantize,
                             seed=0, device="cpu")
    assert plain.calibration is None
    forest = tidx.build_index(data, "shannon", m=2, quantize=quantize,
                              calibrate=True, calibrate_k=K,
                              calibration_queries=FIT_QUERIES, seed=0,
                              device="cpu")
    cal = forest.calibration
    assert isinstance(cal, tcal.RecallCalibration)
    assert (cal.k, cal.num_queries, cal.seed) == (K, FIT_QUERIES, 0)
    np.testing.assert_array_equal(cal.p_grid, tcal.DEFAULT_P_GRID)
    want = tcal.fit_calibration(plain, k=K, num_queries=FIT_QUERIES, seed=0)
    np.testing.assert_array_equal(cal.recall_grid, want.recall_grid)
    for f in tidx.interchange_fields(forest.storage):
        assert torch.equal(getattr(forest, f), getattr(plain, f)), f
    # k above n is cut to n.
    tiny = tidx.build_index(data[:6], "shannon", m=2, calibrate=True,
                            calibrate_k=10, calibration_queries=4,
                            device="cpu")
    assert tiny.calibration.k == 6
    again = tcal.ensure_calibration(plain, k=K, num_queries=FIT_QUERIES,
                                    seed=0)
    np.testing.assert_array_equal(again.calibration.recall_grid,
                                  want.recall_grid)
    assert tcal.ensure_calibration(again) is again


def test_curve_survives_interchange_replace_and_the_store():
    jf, tf, _ = forests("burg", False)
    jcurve = jcal.fit_calibration(jf, k=K, num_queries=8, p_grid=GRID)
    moved = tidx.forest_from_numpy(
        tidx.forest_to_numpy(tf), family_name=tf.family_name,
        partition_idx=tf.partition.idx, partition_mask=tf.partition.mask,
        d=tf.d, num_clusters=tf.num_clusters, calibration=jcurve,
        device="cpu")
    cal = moved.calibration
    assert isinstance(cal, tcal.RecallCalibration)
    np.testing.assert_array_equal(cal.recall_grid, jcurve.recall_grid)
    np.testing.assert_array_equal(cal.p_grid, jcurve.p_grid)
    assert (cal.k, cal.num_queries, cal.seed, cal.jitter) == \
        (jcurve.k, jcurve.num_queries, jcurve.seed, jcurve.jitter)
    assert tcal.resolve_p_guarantee(moved, 0.95) == \
        jcal.resolve_p_guarantee(dataclasses.replace(jf, calibration=jcurve),
                                 0.95)
    assert dataclasses.replace(moved, env_alpha_min=None).calibration is cal
    for resident_bytes in (None, 2048):
        store = TieredPointStore.from_index(moved,
                                            resident_bytes=resident_bytes,
                                            block_rows=96)
        try:
            assert store.calibration is cal
            assert store.is_resident == (resident_bytes is None)
        finally:
            store.close()


@pytest.mark.parametrize("quantize", TIERS)
def test_target_recall_through_the_store_is_bit_equal_to_resident(quantize):
    """On a curve whose resolved p is below 1: ``target_recall`` through
    ``knn_batch``, ``knn_search_batch_approx`` and the store (tiered)
    equals ``approx_p`` / ``p_guarantee`` at the resolved p on the
    resident forest, bit for bit."""
    _, tf, queries = forests("blobs", quantize)
    tf = dataclasses.replace(tf, calibration=_curve((0.3, 0.92, 1.0)))
    p, expected = tcal.resolve_p_guarantee(tf, 0.9)
    assert (p, expected) == (0.5, 0.92)
    want = tsearch.knn_batch(tf, queries, K, approx_p=p, block_rows=96,
                             device="cpu")
    _assert_bit_equal(tsearch.knn_batch(tf, queries, K, target_recall=0.9,
                                        block_rows=96, device="cpu"), want)
    fixed = tsearch.knn_search_batch_approx(tf, queries, K, 64, p,
                                            block_rows=96, device="cpu")
    _assert_bit_equal(tsearch.knn_search_batch_approx(
        tf, queries, K, 64, target_recall=0.9, block_rows=96, device="cpu"),
        fixed)
    store = TieredPointStore.from_index(tf, resident_bytes=2048,
                                        block_rows=96)
    try:
        assert not store.is_resident
        _assert_bit_equal(store.search(queries, K, 64, target_recall=0.9,
                                       device="cpu"), fixed)
        _assert_bit_equal(tsearch.knn_search_batch_approx(
            store, queries, K, 64, target_recall=0.9, device="cpu"), fixed)
        _assert_bit_equal(tsearch.knn_batch(store, queries, K,
                                            target_recall=0.9, device="cpu"),
                          want)
    finally:
        store.close()


@pytest.mark.parametrize("quantize", TIERS)
def test_target_recall_matches_jax_on_the_reference_curve(quantize):
    """The reference's fitted curve carried across: ``knn_batch`` at a
    target recall gives the reference's results, and meets the curve's
    promise within the reference's own 0.15 on exact ids."""
    jf, tf, queries = forests("itakura_saito", quantize)
    jf = jcal.ensure_calibration(jf, k=K, num_queries=FIT_QUERIES,
                                 p_grid=GRID)
    tf = dataclasses.replace(tf, calibration=tcal.as_calibration(
        jf.calibration))
    for t in (0.9, 0.99):
        assert tcal.resolve_p_guarantee(tf, t) == \
            jcal.resolve_p_guarantee(jf, t)
        want = jsearch.knn_batch(jf, queries, K, target_recall=t,
                                 block_rows=96)
        got = tsearch.knn_batch(tf, queries, K, target_recall=t,
                                block_rows=96, device="cpu")
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                                   rtol=1e-5, atol=1e-5)
        exact = tsearch.knn_batch(tf, queries, K, device="cpu")
        _, expected = tcal.resolve_p_guarantee(tf, t)
        recall = tcal._recall_at_k(got.ids.numpy(), exact.ids.numpy())
        assert recall >= expected - 0.15
