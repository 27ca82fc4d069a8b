"""The PyTorch port's math, partition, clustering and index build against
the JAX package, on the same numpy inputs (CPU, small shapes)."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.bounds as jbounds
import repro.core.clustering as jclust
import repro.core.index as jidx
import repro.core.partition as jpart
import repro.core.transform as jtr
import repro.data.pipeline as jpipe
from repro.core.bregman import family_names
from repro.core.bregman import get_family as jfam
from repro.core.bregman import validate_rows as jvalidate

import repro_torch.core.bounds as tbounds
import repro_torch.core.clustering as tclust
import repro_torch.core.index as tidx
import repro_torch.core.partition as tpart
import repro_torch.core.transform as ttr
import repro_torch.data.pipeline as tpipe
from repro_torch.core.bregman import get_family as tfam
from repro_torch.core.bregman import validate_rows as tvalidate

from torch_parity import D, M, N, NUM_CLUSTERS, Q, jax_forest, sample, \
    to_numpy, to_port

FAMILIES = family_names()
# Transforms, bounds and build tables: fp32 elementwise math whose
# reductions run in another order than XLA's.
TOL = dict(rtol=1e-6, atol=1e-6)


def _np(d: dict) -> dict:
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("family", FAMILIES)
def test_transforms_and_bounds_match_jax(family):
    x = sample(family, (N, D), seed=3)
    y = sample(family, (Q, D), seed=4)
    part = jtr.make_partition(D, M)
    tp = ttr.make_partition(D, M)
    jf, tf = jfam(family), tfam(family)
    jp, tp_ = _np(jtr.p_transform(jnp.asarray(x), part, jf)), \
        ttr.p_transform(torch.from_numpy(x), tp, tf)
    jq = _np(jtr.q_transform(jnp.asarray(y), part, jf))
    tq = ttr.q_transform(torch.from_numpy(y), tp, tf)
    # The port's transform in float64: a failure names the side that left
    # it (this comparison failed intermittently in multi-worker runs).
    f64 = ttr.p_transform(torch.from_numpy(x.astype(np.float64)), tp, tf)
    for k in jp:
        want = f64[k].numpy()
        np.testing.assert_allclose(
            tp_[k].numpy(), jp[k], **TOL,
            err_msg=f"{k}: max |port - f64| "
                    f"{np.max(np.abs(tp_[k].numpy() - want)):.3g}, "
                    f"max |jax - f64| {np.max(np.abs(jp[k] - want)):.3g}")
    for k in jq:
        np.testing.assert_allclose(tq[k].numpy(), jq[k], **TOL, err_msg=k)
    jq2 = {k: v for k, v in jq.items() if v.ndim == 2}
    tq2 = {k: v for k, v in tq.items() if v.ndim == 2}
    for name in ("ub_components", "lb_components"):
        j = getattr(jbounds, name)({k: v[:, None] for k, v in jp.items()},
                                   {k: v[None] for k, v in jq2.items()})
        t = getattr(tbounds, name)({k: v[:, None] for k, v in tp_.items()},
                                   {k: v[None] for k, v in tq2.items()})
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(tbounds.ub_matrix(tp_, tq2).numpy(),
                               np.asarray(jbounds.ub_matrix(jp, jq2)),
                               rtol=1e-6, atol=1e-5)
    jc = _np(jbounds.query_refine_constants(jnp.asarray(y), jf))
    tc = tbounds.query_refine_constants(torch.from_numpy(y), tf)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), jc[k], rtol=1e-6,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(
        tf.distance(torch.from_numpy(x), torch.from_numpy(y[:1])).numpy(),
        np.asarray(jf.distance(jnp.asarray(x), jnp.asarray(y[:1]))),
        rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("m", [1, 3, 5, 16])
def test_partitions_bit_equal(m):
    data = sample("exponential", (N, D), seed=5)
    order = np.random.default_rng(m).permutation(D)
    for args in ((D, m), (D, m, order)):
        j, t = jtr.make_partition(*args), ttr.make_partition(*args)
        assert (t.d, t.num_subspaces, t.width) == (j.d, j.num_subspaces,
                                                     j.width)
        np.testing.assert_array_equal(t.idx, j.idx)
        np.testing.assert_array_equal(t.mask, j.mask)
        assert t == ttr.make_partition(*args) and hash(t) == hash(
            ttr.make_partition(*args))
    np.testing.assert_array_equal(tpart.correlation_matrix(data),
                                  jpart.correlation_matrix(data))
    j, t = (jpart.build_pccp_partition(data, m, seed=7),
            tpart.build_pccp_partition(data, m, seed=7))
    np.testing.assert_array_equal(t.idx, j.idx)
    np.testing.assert_array_equal(t.mask, j.mask)


@pytest.mark.parametrize("family", FAMILIES)
def test_cost_model_matches_jax(family):
    data = sample(family, (N, D), seed=6)
    j = jpart.fit_cost_model(data, jfam(family), seed=2)
    t = tpart.fit_cost_model(data, tfam(family), seed=2)
    assert (t.n, t.d) == (j.n, j.d)
    np.testing.assert_allclose([t.a, t.alpha, t.beta], [j.a, j.alpha, j.beta],
                               rtol=1e-5)
    assert t.m_star() == j.m_star()
    assert t.m_star(k=10) == j.m_star(k=10)
    for stale in (0.0, 0.3, 2.0):
        assert (tpart.decide_compaction(t, 4, stale_fraction=stale)
                == jpart.decide_compaction(j, 4, stale_fraction=stale))


def test_cluster_stats_match_jax():
    rng = np.random.default_rng(8)
    values = rng.normal(size=200).astype(np.float32)
    assign = rng.integers(0, 9, 200).astype(np.int32)   # cluster 9 is empty
    j = jclust.cluster_stats(jnp.asarray(values), jnp.asarray(assign), 10)
    t = tclust.cluster_stats(torch.from_numpy(values),
                             torch.from_numpy(assign), 10)
    for k in ("min", "max", "count"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)
    assert t["min"][9] == np.finfo(np.float32).max and t["max"][9] == 0


@pytest.mark.parametrize("family", FAMILIES)
def test_kmeans_matches_jax_from_the_same_init(family):
    x = sample(family, (N, D), seed=9)
    part = jtr.make_partition(D, M)
    view = np.array(part.gather(jnp.asarray(x)))[:, 1, :]       # (N, w)
    mask = part.mask[1]
    key = jax.random.PRNGKey(11)
    init = np.array(jax.random.choice(key, N, shape=(NUM_CLUSTERS,),
                                      replace=False))
    jc, ja = jclust.kmeans(jnp.asarray(view), jnp.asarray(mask), key,
                           family=jfam(family), num_clusters=NUM_CLUSTERS)
    tc, ta = tclust.kmeans(torch.from_numpy(view), torch.from_numpy(mask),
                           family=tfam(family), num_clusters=NUM_CLUSTERS,
                           init_idx=torch.from_numpy(init))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)


def test_kmeans_chunked_assignment_is_row_independent(monkeypatch):
    x = torch.from_numpy(sample("burg", (N, 6), seed=12))
    mask = torch.ones(6)
    whole = tclust.kmeans(x, mask, family=tfam("burg"), num_clusters=7,
                          generator=torch.Generator().manual_seed(1))
    monkeypatch.setattr(tclust, "ASSIGN_CHUNK_ELEMS", 7 * 13)
    chunked = tclust.kmeans(x, mask, family=tfam("burg"), num_clusters=7,
                            generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(chunked[0], whole[0], rtol=0, atol=0)
    assert torch.equal(chunked[1], whole[1])


@pytest.mark.parametrize("family", FAMILIES)
def test_build_tables_match_jax(family):
    jf, data, _ = jax_forest(family)
    nb = 4                                    # build_index's gamma_buckets
    base = np.empty((N, M), np.int64)
    base[np.asarray(jf.point_ids)] = np.asarray(jf.assign) // nb
    jp = jf.partition
    part = ttr.Partition(d=jp.d, num_subspaces=jp.num_subspaces,
                         width=jp.width, idx=jp.idx, mask=jp.mask)
    t = tidx.build_tables(
        torch.from_numpy(data), tfam(family), part,
        torch.from_numpy(base), torch.from_numpy(np.asarray(jf.centers)),
        num_clusters=jf.num_clusters // nb, gamma_buckets=nb, seed=0)
    np.testing.assert_array_equal(t.point_ids.numpy(), np.asarray(jf.point_ids))
    np.testing.assert_array_equal(t.assign.numpy(), np.asarray(jf.assign))
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(jf.counts))
    assert t.num_clusters == jf.num_clusters
    for f in ("data", "alpha", "sqrt_gamma", "alpha_min", "sqrt_gamma_max",
              "alpha_min_pt", "sqrt_gamma_max_pt", "gamma_edges",
              "env_alpha_min", "env_sqrt_gamma_max"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(jf, f)), **TOL,
                                   err_msg=f)
    # XLA sums the cross terms in another order: fp32 tolerance, not bits.
    np.testing.assert_allclose(t.beta_samples.numpy(),
                               np.asarray(jf.beta_samples), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_interchange_round_trip_is_bit_equal(family, quantize):
    jf, _, _ = jax_forest(family, quantize)
    arrays = to_numpy(jf)
    port = to_port(jf)
    assert port.storage == jf.storage
    back = tidx.forest_to_numpy(port)
    assert set(back) == set(arrays)
    if quantize:
        assert set(tidx.QUANT_FIELDS) <= set(back)
        assert back["data"].dtype == np.int8
    for f, a in arrays.items():
        assert back[f].dtype == a.dtype, f
        np.testing.assert_array_equal(back[f], a, err_msg=f)


def test_interchange_rejects_missing_fields():
    jf, _, _ = jax_forest("burg")
    arrays = to_numpy(jf)
    del arrays["env_alpha_min"]
    layout = dict(family_name="burg", partition_idx=jf.partition.idx,
                  partition_mask=jf.partition.mask, d=D,
                  num_clusters=jf.num_clusters, device="cpu")
    with pytest.raises(KeyError, match="env_alpha_min"):
        tidx.forest_from_numpy(arrays, **layout)
    # An int8 forest needs its decode fields, and int8 codes as its data.
    with pytest.raises(KeyError, match="data_scale"):
        tidx.forest_from_numpy(to_numpy(jf), storage="int8", **layout)
    with pytest.raises(ValueError, match="stores data as float32"):
        tidx.forest_from_numpy(to_numpy(jax_forest("burg", True)[0]),
                               **layout)


@pytest.mark.parametrize("multiple", [64, 512])
def test_pad_points_matches_jax(multiple):
    jf, _, _ = jax_forest("shannon")
    j = jidx.pad_points(jf, multiple)
    t = tidx.pad_points(to_port(jf), multiple)
    for f in tidx.POINT_FIELDS + tidx.ENV_FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


def test_corner_envelopes_match_jax():
    rng = np.random.default_rng(13)
    amin = rng.normal(size=(700, 3)).astype(np.float32)
    gmax = rng.uniform(size=(700, 3)).astype(np.float32)
    j = jidx.corner_envelopes(jnp.asarray(amin), jnp.asarray(gmax))
    t = tidx.corner_envelopes(torch.from_numpy(amin), torch.from_numpy(gmax))
    for a, b in zip(t, j, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_validate_rows_matches_jax():
    rows = np.array([[1.0, 2.0], [0.0, 1.0], [np.nan, 1.0], [3.0, 0.5]],
                    np.float32)
    for family in FAMILIES:
        np.testing.assert_array_equal(
            tvalidate(family, torch.from_numpy(rows), mode="mask"),
            jvalidate(family, rows, mode="mask"))
    with pytest.raises(ValueError, match="query row 1 is invalid"):
        tvalidate("burg", rows, what="query row")


def test_build_index_options_not_ported_raise():
    """Both options are ported: calibrate=True attaches a fitted recall
    curve (host-side) and quantize=True builds the int8 tier."""
    data = sample("burg", (64, 4), seed=0)
    calibrated = tidx.build_index(data, "burg", m=2, calibrate=True,
                                  calibration_queries=8, device="cpu")
    assert calibrated.calibration is not None
    assert calibrated.calibration.recall_grid[-1] == 1.0
    forest = tidx.build_index(data, "burg", m=2, quantize=True, device="cpu")
    assert forest.storage == "int8" and forest.data.dtype == torch.int8
    assert all(getattr(forest, f).shape == (64,) for f in tidx.QUANT_FIELDS)


@pytest.mark.parametrize("name", ["audio", "normal", "uniform"])
def test_make_vectors_matches_reference_under_the_same_seed(name,
                                                             monkeypatch):
    # The reference seeds from the process-salted builtin hash; give it
    # the port's crc32 seed so both draw the same stream.
    monkeypatch.setattr(jpipe, "hash",
                        lambda s: zlib.crc32(s.encode()), raising=False)
    spec = tpipe.PAPER_DATASETS[name]
    scale = 300 / spec.n
    t = tpipe.make_vectors(spec, scale=scale, seed=3)
    j = jpipe.make_vectors(jpipe.PAPER_DATASETS[name], scale=scale, seed=3)
    assert t.shape == j.shape and t.dtype == j.dtype
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        tpipe.make_queries(spec, num=7, scale=scale, data_seed=3, data=t),
        t[np.random.default_rng(1).choice(t.shape[0], 7, replace=False)])


@pytest.mark.parametrize("d", [1, 3, 16, 192, 256, 3072])
def test_query_constants_do_not_depend_on_the_batch(d):
    """On the CPU a query's ``c_y`` has the same bits alone, in a batch of
    14 or of 32, and agrees with the float64 sum and the reference's;
    ``bounds.fixed_order_sum`` (the card's order) is the float64 sum's
    too."""
    from repro.core.bregman import get_family as jget
    from repro_torch.core.bregman import get_family as tget
    y = np.abs(np.random.default_rng(d).normal(size=(32, d))).astype(
        np.float32) + np.float32(0.05)
    fam = tget("shannon")
    whole = tbounds.query_refine_constants(torch.from_numpy(y), fam)["c_y"]
    for q in (1, 14):
        part = tbounds.query_refine_constants(torch.from_numpy(y[:q]),
                                              fam)["c_y"]
        assert torch.equal(part, whole[:q])
    want = (y.astype(np.float64) * np.log(y) - (y * np.log(y) - y)).sum(-1)
    np.testing.assert_allclose(whole.double().numpy(), want, rtol=2e-6)
    jc = _np(jbounds.query_refine_constants(jnp.asarray(y), jget("shannon")))
    np.testing.assert_allclose(whole.numpy(), jc["c_y"], rtol=1e-6,
                               atol=1e-5)
    x = torch.from_numpy(y).double()
    np.testing.assert_allclose(tbounds.fixed_order_sum(x).numpy(),
                               x.sum(-1).numpy(), rtol=1e-12)
