"""The port's int8 storage tier against the JAX package's, on the same numpy
inputs (CPU, small shapes): the quantizer bit for bit, the index tables,
the plain versions of the three int8 kernels (against the reference's
oracles and its Pallas kernels in interpret mode), and int8 search on the
reference's own int8 forest imported through numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.index as jidx
import repro.core.quantize as jqz
import repro.core.search as jsearch
from repro.core.bregman import family_names
from repro.core.bregman import get_family as jfam
from repro.kernels import ref as jref
from repro.kernels.bregman_dist import \
    bregman_refine_batch_quant as pallas_refine_quant
from repro.kernels.bregman_fused import \
    bregman_filter_prune_quant as pallas_filter_prune_quant
from repro.kernels.bregman_ub import \
    bregman_ub_matrix_quant as pallas_ub_quant

import repro_torch.core.index as tidx
import repro_torch.core.quantize as tqz
import repro_torch.core.search as tsearch
from repro_torch.core.bounds import query_refine_constants
from repro_torch.core.bregman import get_family
from repro_torch.kernels import bregman_dist, bregman_fused, bregman_ub, ops

from torch_parity import D, K, M, N, NUM_CLUSTERS, filter_inputs_quant, \
    jax_forest, quant_inputs, sample, to_port

FAMILIES = family_names()
EPS32 = 2.0 ** -23
DIST_TOL = dict(rtol=1e-5, atol=1e-5)
PALLAS_TILES = dict(block_n=32, block_q=4, interpret=True)
# (n, M, q): odd row counts, M = 1, q = 1, and M past the kernels' chunk.
SHAPES = [(64, 8, 1), (100, 28, 3), (257, 50, 5), (32, 1, 1), (7, 5, 2)]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _quant_launches():
    return (bregman_ub.launches_quant, bregman_fused.launches_quant,
            bregman_dist.launches_quant)


def _rows_with_constant_rows(family: str, seed: int) -> np.ndarray:
    """Valid rows with a wide spread of magnitudes, two constant rows and a
    row whose extremes sit exactly one level apart."""
    x = sample(family, (60, 33), seed=seed) * np.float32(3.0)
    x[5] = x[5, 0]
    x[6] = np.float32(0.5)
    x[7, :] = np.float32(1.0)
    x[7, 0] = np.float32(2.0)
    return x


@pytest.mark.parametrize("family", FAMILIES)
def test_quantize_rows_is_bit_equal_to_jax(family):
    x = _rows_with_constant_rows(family, seed=30)
    want = [np.asarray(a) for a in jqz.quantize_rows(jnp.asarray(x))]
    got = [a.numpy() for a in tqz.quantize_rows(torch.from_numpy(x))]
    for g, w, name in zip(got, want, ("codes", "scale", "zp"), strict=True):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[1][5] == 0 and got[1][6] == 0 and not got[0][5:7].any()
    np.testing.assert_array_equal(
        tqz.dequantize_rows(*_t(*want), family).numpy(),
        np.asarray(jqz.dequantize_rows(*map(jnp.asarray, want),
                                       jfam(family))))


@pytest.mark.parametrize("rounding", ["nearest", "floor", "ceil"])
def test_quantize_stats_is_bit_equal_to_jax(rounding):
    rng = np.random.default_rng(31)
    v = (rng.normal(size=(200, 37))
         * rng.uniform(1e-3, 1e3, (200, 1))).astype(np.float32)
    v[3] = np.float32(-2.5)                     # a constant row
    want = [np.asarray(a) for a in jqz.quantize_stats(jnp.asarray(v),
                                                      rounding)]
    got = [a.numpy() for a in tqz.quantize_stats(torch.from_numpy(v),
                                                 rounding)]
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    decoded = tqz.dequantize_stats(*_t(*got)).numpy()
    np.testing.assert_array_equal(
        decoded, np.asarray(jqz.dequantize_stats(*map(jnp.asarray, want))))
    # Directed rounding keeps the decoded value on its side of the truth.
    if rounding == "floor":
        assert np.all(decoded <= v)
    elif rounding == "ceil":
        assert np.all(decoded >= v)
    else:
        assert np.all(np.abs(decoded - v)
                      <= 0.5 * got[1][:, None] * (1 + 1e-3) + 1e-6 * np.abs(v))


@pytest.mark.parametrize("family", FAMILIES)
def test_int8_tables_match_jax_bit_for_bit(family):
    """quantize_point_tables on the reference's fp32 forest over the
    decoded rows gives the reference's int8 forest, every field (the
    envelopes over the decoded corners too); the decoded corners lie on the
    conservative side of the true ones."""
    jq, _, _ = jax_forest(family, True)
    codes = np.asarray(jq.data)
    order = np.argsort(np.asarray(jq.point_ids))      # layout -> original
    xhat = np.asarray(jq.rows_view())[order]
    jf = jidx.build_index(xhat, family, m=M, num_clusters=NUM_CLUSTERS,
                          seed=0)
    np.testing.assert_array_equal(np.asarray(jf.point_ids),
                                  np.asarray(jq.point_ids))
    got = tidx.quantize_point_tables(
        to_port(jf), *_t(codes, np.asarray(jq.data_scale),
                         np.asarray(jq.data_zp)))
    assert got.storage == "int8"
    for f in tidx.interchange_fields("int8"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(jq, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    amin, gmax = (t.numpy() for t in tqz.decoded_corner_tables(got))
    assert np.all(amin <= np.asarray(jf.alpha_min_pt))
    assert np.all(gmax >= np.asarray(jf.sqrt_gamma_max_pt))
    np.testing.assert_array_equal(got.rows_view().numpy(),
                                  np.asarray(jq.rows_view()))
    with pytest.raises(ValueError, match="wants an f32 forest"):
        tidx.quantize_point_tables(got, got.data, got.data_scale,
                                   got.data_zp)


@pytest.mark.parametrize("multiple", [64, 512])
def test_int8_pad_points_matches_jax(multiple):
    jq, _, _ = jax_forest("shannon", True)
    j = jidx.pad_points(jq, multiple)
    t = tidx.pad_points(to_port(jq), multiple)
    for f in tidx.point_fields("int8") + tidx.ENV_FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert tidx.inert_fill(t) is tidx.INERT_FILL_INT8


def _ub_tolerance(n, m, a_q, a_s, a_z, g_q, g_s, g_z, qc, sd):
    """(M + 2) * eps32 times the magnitudes of the summed terms:
    |a_s * sum(codes)|, |M * a_z|, |qsum|, |g_s| * (|codes| . sd) (the
    dot's terms, which may cancel) and |g_z * sum(sd)|."""
    f64 = np.float64
    mags = (np.abs(a_s * a_q.astype(f64).sum(-1)) + np.abs(m * a_z))[:, None]
    mags = mags + np.abs(qc.astype(f64).sum(-1))[None, :]
    mags = mags + np.abs(g_s)[:, None] * (np.abs(g_q.astype(f64)) @ sd.T)
    mags = mags + np.abs(g_z[:, None] * sd.astype(f64).sum(-1)[None, :])
    return (m + 2) * EPS32 * mags


@pytest.mark.parametrize("n,m,q", SHAPES)
def test_ub_quant_plain_version_matches_jax(n, m, q):
    ops_in = filter_inputs_quant(n, m, q, seed=n)
    filt = ops_in[:6]
    qc, sd = ops_in[12], ops_in[13]
    before = _quant_launches()
    got = ops.bregman_ub_matrix_quant(*_t(*filt, qc, sd)).numpy()
    assert _quant_launches() == before          # the CPU runs no kernel
    tol = _ub_tolerance(n, m, *filt, qc, sd)
    want_ref = np.asarray(jref.bregman_ub_matrix_quant(*filt, qc, sd))
    want_pallas = np.asarray(pallas_ub_quant(
        *map(jnp.asarray, filt), jnp.sum(jnp.asarray(qc), -1),
        jnp.asarray(sd), **PALLAS_TILES))
    for want in (want_ref, want_pallas):
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


@pytest.mark.parametrize("n,m,q", SHAPES)
def test_filter_prune_quant_plain_version_matches_jax(n, m, q):
    inputs = filter_inputs_quant(n, m, q, seed=n + 1)
    ub, admit = ops.bregman_filter_prune_block_quant(*_t(*inputs))
    assert admit.dtype == torch.int32 and ub.dtype == torch.float32
    assert torch.all(admit[0] == 1)            # the tie at column 0 admits
    if n * q >= 64:
        assert 0 < int(admit.sum()) < n * q    # a mixed mask
    j_ub, j_admit = jref.bregman_filter_prune_quant(*inputs)
    p_ub, p_admit = pallas_filter_prune_quant(
        *map(jnp.asarray, inputs[:12]),
        jnp.sum(jnp.asarray(inputs[12]), -1),
        *map(jnp.asarray, inputs[12:]), **PALLAS_TILES)
    tol = _ub_tolerance(n, m, *inputs[:6], inputs[12], inputs[13])
    for want_ub in (j_ub, p_ub):
        assert np.all(np.abs(ub.numpy() - np.asarray(want_ub)) <= tol)
    # The eager oracle decodes and compares op by op, as the port does.
    np.testing.assert_array_equal(admit.numpy(), np.asarray(j_admit))
    # Under jit XLA on the CPU may contract the tie's compare into a fused
    # multiply-add (ROADMAP queue 3): row 0 holds the tie.
    np.testing.assert_array_equal(admit.numpy()[1:],
                                  np.asarray(p_admit)[1:])


def _refine_quant_inputs(family, q, b, d, seed):
    codes, scale, zp = quant_inputs(q * b, d, seed)
    if get_family(family).domain_low == 0.0:
        # Decoded rows straddle DOMAIN_EPS, so the clamp decides some.
        zp = np.abs(zp) * np.float32(2.0)
    ys = torch.from_numpy(sample(family, (q, d), seed=seed + 1))
    c = query_refine_constants(ys, get_family(family))
    return (codes.reshape(q, b, d), scale.reshape(q, b), zp.reshape(q, b),
            c["grad"].numpy(), c["c_y"].numpy())


def _refine_tolerance(family, codes, scale, zp, grad, c_y):
    """d * eps32 times ``sum |phi(x)| + |x . grad| + |c_y|`` per (query,
    row), x the decoded rows: the refine form cancels, so its error scales
    with its terms, not its result."""
    x = tqz.dequantize_rows(*_t(codes, scale, zp), family).double()
    phi = get_family(family).phi(x).numpy()
    x = x.numpy()
    scale_ = (np.abs(phi).sum(-1) + np.abs(np.einsum("qbd,qd->qb", x, grad))
              + np.abs(c_y)[:, None])
    return codes.shape[-1] * EPS32 * scale_


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("q,b,d", [(3, 16, 24), (2, 37, 129), (1, 1, 1)])
def test_refine_quant_plain_version_matches_jax(family, q, b, d):
    inputs = _refine_quant_inputs(family, q, b, d, seed=b + d)
    before = _quant_launches()
    got = ops.bregman_refine_batch_quant(*_t(*inputs), family).numpy()
    assert _quant_launches() == before
    tol = _refine_tolerance(family, *inputs)
    want_ref = np.asarray(jref.bregman_refine_batch_quant(*inputs, family))
    want_pallas = np.asarray(pallas_refine_quant(
        *map(jnp.asarray, inputs), family, block_b=16, block_d=64,
        interpret=True))
    for want in (want_ref, want_pallas):
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    # The plain version refines exactly the rows dequantize_rows defines.
    rows = tqz.dequantize_rows(*_t(*inputs[:3]), family)
    np.testing.assert_array_equal(
        got, ops.bregman_refine_batch(rows, *_t(*inputs[3:]),
                                      family).numpy())


def test_quant_wrappers_refuse_cpu_tensors_and_bad_shapes():
    inputs = _t(*filter_inputs_quant(16, 3, 2, seed=0))
    qsum, sdsum = inputs[12].sum(-1), inputs[13].sum(-1)
    before = _quant_launches()
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bregman_ub.bregman_ub_matrix_quant(*inputs[:6], qsum, inputs[13],
                                           sdsum)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bregman_fused.bregman_filter_prune_quant(*inputs[:12], qsum,
                                                 *inputs[12:14], sdsum,
                                                 inputs[14])
    codes, scale, zp, grad, c_y = _t(*_refine_quant_inputs("burg", 2, 4, 3,
                                                           seed=0))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bregman_dist.bregman_refine_batch_quant(codes, scale, zp, grad, c_y,
                                                "burg")
    assert _quant_launches() == before
    with pytest.raises(ValueError, match=r"\(q, M\) query batches"):
        ops.bregman_ub_matrix_quant(*inputs[:6], inputs[12][0], inputs[13])
    with pytest.raises(ValueError, match="must share"):
        ops.bregman_filter_prune_block_quant(*inputs[:6], inputs[6][:5],
                                             *inputs[7:])
    with pytest.raises(ValueError, match=r"\(q,b\) decode rows"):
        ops.bregman_refine_batch_quant(codes[0], scale, zp, grad, c_y,
                                       "burg")
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        ops.bregman_refine_batch_quant(
            torch.empty((2, 4, 3), dtype=torch.int8, device="meta"),
            *(torch.empty(s, device="meta")
              for s in ((2, 4), (2, 4), (2, 3), (2,))), "burg")


def _assert_same_result(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.exact.numpy(), np.asarray(want.exact))
    np.testing.assert_array_equal(got.num_candidates.numpy(),
                                  np.asarray(want.num_candidates))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               **DIST_TOL)


def _port_int8(family):
    return to_port(jax_forest(family, True)[0])


@pytest.mark.parametrize("block_rows", [96, 4096])
@pytest.mark.parametrize("family", FAMILIES)
def test_int8_knn_search_batch_matches_jax(family, block_rows):
    jq, _, queries = jax_forest(family, True)
    tq = _port_int8(family)
    want = jsearch.knn_search_batch(jq, jnp.asarray(queries), K, None,
                                    block_rows=block_rows)
    got = tsearch.knn_search_batch(tq, queries, K, None,
                                   block_rows=block_rows, device="cpu")
    _assert_same_result(got, want)
    # The Alg.-4 bounds carry the reference's int8 slack.
    jqs = jsearch._query_struct(jq, jnp.asarray(queries))
    _, jrows = jsearch._batch_filter_topk(jq, jqs, K, block_rows)
    qs = tsearch.query_struct(torch.as_tensor(queries), tq.partition,
                              tq.family)
    _, rows = tsearch._batch_filter_topk(tq, qs, K, block_rows)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_allclose(
        tsearch._qb_slack(tq, rows, qs["sqrt_delta"]).numpy(),
        np.asarray(jsearch._qb_slack(jq, jrows, jqs["sqrt_delta"])),
        rtol=1e-6, atol=0)


@pytest.mark.parametrize("family", FAMILIES)
def test_int8_knn_batch_escalates_like_jax(family):
    jq, _, queries = jax_forest(family, True)
    want, want_stats = jsearch.knn_batch(jq, queries, K, budget=K,
                                         block_rows=96, return_stats=True)
    got, got_stats = tsearch.knn_batch(_port_int8(family), queries, K,
                                       budget=K, block_rows=96,
                                       return_stats=True, device="cpu")
    assert got_stats == want_stats
    assert got_stats.escalations > 0
    _assert_same_result(got, want)


def test_int8_scan_fallback_and_stats_match_jax():
    jq, _, queries = jax_forest("burg", True)
    tq = _port_int8("burg")
    want, want_stats = jsearch.knn_batch(jq, queries, K, budget=K,
                                         max_doublings=0, return_stats=True)
    got, got_stats = tsearch.knn_batch(tq, queries, K, budget=K,
                                       max_doublings=0, return_stats=True,
                                       device="cpu")
    assert got_stats == want_stats and got_stats.escalated_to_scan
    _assert_same_result(got, want)
    want_res, want = jsearch.knn_search_batch_stats(
        jq, jnp.asarray(queries), K, 64, block_rows=96)
    got_res, got = tsearch.knn_search_batch_stats(
        tq, queries, K, 64, block_rows=96, device="cpu")
    _assert_same_result(got_res, want_res)
    for key in ("num_blocks", "num_blocks_run", "env_admitted_tiles"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["tau_admit"].numpy(),
                               np.asarray(want["tau_admit"]), **DIST_TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_port_built_int8_index_returns_brute_force_ids(family):
    data = sample(family, (N, D), seed=40)
    queries = sample(family, (6, D), seed=41)
    forest = tidx.build_index(data, family, m=M, num_clusters=NUM_CLUSTERS,
                              quantize=True, device="cpu")
    assert forest.storage == "int8" and forest.data.dtype == torch.int8
    codes, scale, zp = tqz.quantize_rows(torch.from_numpy(data))
    order = forest.point_ids.long()
    assert torch.equal(forest.data, codes[order])
    rows = forest.rows_view()
    res = tsearch.knn_batch(forest, queries, K, device="cpu")
    bf_ids, bf_dists = tsearch.brute_force_knn(rows, queries, K, family,
                                               device="cpu")
    assert bool(res.exact.all())
    np.testing.assert_array_equal(res.ids.numpy(),
                                  forest.point_ids[bf_ids].numpy())
    np.testing.assert_allclose(res.dists.numpy(), bf_dists.numpy(),
                               rtol=1e-4, atol=1e-4)
    # The envelopes dominate the decoded corners of their rows.
    amin, gmax = tqz.decoded_corner_tables(forest)
    ea, eg = tidx.corner_envelopes(amin, gmax)
    assert torch.equal(ea, forest.env_alpha_min)
    assert torch.equal(eg, forest.env_sqrt_gamma_max)
