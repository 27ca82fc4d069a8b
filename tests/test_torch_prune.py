"""Kernels #5 and #6 (the prune-only admit mask) and the search paths that
run them, on the CPU, against the JAX package on the same numpy inputs:
the plain versions against the reference's oracles and its Pallas kernels
(interpret mode), the unfused comparator (``fused=False``) against the
fused search and the reference's unfused program, and the §8 approximate
batched search."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.search as jsearch
from repro.core.bregman import family_names
from repro.kernels import ref as jref
from repro.kernels.bregman_prune import bregman_prune_mask as pallas_prune
from repro.kernels.bregman_prune import \
    bregman_prune_mask_quant as pallas_prune_quant

import repro_torch.core.search as tsearch
from repro_torch.kernels import _build, bregman_prune, ops

from torch_parity import K, filter_inputs, filter_inputs_quant, \
    jax_forest, to_port

FAMILIES = family_names()
DIST_TOL = dict(rtol=1e-5, atol=1e-5)
PALLAS_TILES = dict(block_n=32, block_q=4, interpret=True)
# (n, M, q): odd row counts, M = 1, q = 1, and M past the kernels' chunk.
SHAPES = [(64, 8, 1), (100, 28, 3), (257, 50, 5), (32, 1, 1), (7, 5, 2)]
P_APPROX = 0.8


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _launches():
    return bregman_prune.launches, bregman_prune.launches_quant


@functools.lru_cache(maxsize=None)
def port_forest(family: str, quantize: bool):
    return to_port(jax_forest(family, quantize)[0])


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


# ---------------------------------------------------------------------------
# Kernels #5 and #6: the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,q", SHAPES)
def test_prune_plain_version_matches_jax(n, m, q):
    _, _, amin, gmax, qc, sd, qb = filter_inputs(n, m, q, seed=n + 2)
    before = _launches()
    admit = ops.bregman_prune_block(*_t(amin, gmax, qc, sd, qb))
    assert _launches() == before               # the CPU runs no kernel
    assert admit.dtype == torch.int32 and admit.shape == (n, q)
    assert torch.all(admit[0] == 1)            # the tie at column 0 admits
    if n * q >= 64:
        assert 0 < int(admit.sum()) < n * q    # a mixed mask
    # The eager oracle compares op by op, as the port does: bit-equal.
    np.testing.assert_array_equal(
        admit.numpy(), np.asarray(jref.bregman_prune_mask(amin, gmax, qc,
                                                          sd, qb)))
    # Under jit XLA on the CPU may contract the tie's compare into a fused
    # multiply-add (ROADMAP queue 3): row 0 holds the tie.
    want = np.asarray(pallas_prune(*map(jnp.asarray, (amin, gmax, qc, sd,
                                                      qb)), **PALLAS_TILES))
    np.testing.assert_array_equal(admit.numpy()[1:], want[1:])


@pytest.mark.parametrize("n,m,q", SHAPES)
def test_prune_quant_plain_version_matches_jax(n, m, q):
    inputs = filter_inputs_quant(n, m, q, seed=n + 3)
    corners, query = inputs[6:12], inputs[12:]
    before = _launches()
    admit = ops.bregman_prune_block_quant(*_t(*corners, *query))
    assert _launches() == before
    assert admit.dtype == torch.int32 and admit.shape == (n, q)
    assert torch.all(admit[0] == 1)
    if n * q >= 64:
        assert 0 < int(admit.sum()) < n * q
    np.testing.assert_array_equal(
        admit.numpy(),
        np.asarray(jref.bregman_prune_mask_quant(*corners, *query)))
    want = np.asarray(pallas_prune_quant(*map(jnp.asarray, corners + query),
                                         **PALLAS_TILES))
    np.testing.assert_array_equal(admit.numpy()[1:], want[1:])


@pytest.mark.parametrize("n,m,q", [(100, 28, 3), (257, 50, 5)])
def test_prune_masks_equal_the_fused_admit(n, m, q):
    """#5 and #6 share the fused kernels' compare and decode, so their masks
    are the admit outputs of #3 and #4 on the same corners."""
    inputs = filter_inputs(n, m, q, seed=n + 4)
    _, fused = ops.bregman_filter_prune_block(*_t(*inputs))
    alone = ops.bregman_prune_block(*_t(*inputs[2:]))
    assert torch.equal(alone, fused)
    inputs = filter_inputs_quant(n, m, q, seed=n + 5)
    _, fused = ops.bregman_filter_prune_block_quant(*_t(*inputs))
    alone = ops.bregman_prune_block_quant(*_t(*inputs[6:]))
    assert torch.equal(alone, fused)


def test_prune_quant_inert_rows_never_admit():
    """The int8 pad row (codes 0, scale 0, zero-point 1e30) decodes to a
    corner of 1e30 and never admits, even under the loosest bound."""
    corners = [torch.from_numpy(a.copy())
               for a in filter_inputs_quant(40, 6, 3, seed=9)[6:12]]
    corners[0][5:9] = 0
    corners[1][5:9] = 0.0
    corners[2][5:9] = 1e30
    qc = torch.zeros((3, 6))
    sd = torch.ones((3, 6))
    qb = torch.full((3, 6), 1e29)
    admit = ops.bregman_prune_block_quant(*corners, qc, sd, qb)
    assert not bool(admit[5:9].any())
    assert bool(admit[:5].all()) and bool(admit[9:].all())


def test_prune_wrappers_refuse_cpu_tensors_and_bad_shapes():
    _, _, amin, gmax, qc, sd, qb = _t(*filter_inputs(16, 3, 2, seed=0))
    corners = _t(*filter_inputs_quant(16, 3, 2, seed=0)[6:12])
    before = _launches()
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bregman_prune.bregman_prune_mask(amin, gmax, qc, sd, qb)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bregman_prune.bregman_prune_mask_quant(*corners, qc, sd, qb)
    assert _launches() == before
    with pytest.raises(ValueError, match=r"\(q, M\) query operands"):
        ops.bregman_prune_block(amin, gmax, qc[0], sd, qb)
    with pytest.raises(ValueError, match=r"\(q, M\) query operands"):
        ops.bregman_prune_block_quant(*corners, qc, sd, qb[0])
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        ops.bregman_prune_block(amin.to("meta"), gmax, qc, sd, qb)
    assert {"brk_prune_mask", "brk_prune_mask_quant"} <= set(
        _build.SIGNATURES)
    assert "bregman_prune.cu" in _build.SOURCES


# ---------------------------------------------------------------------------
# The unfused comparator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_unfused_search_matches_fused_and_jax(family, quantize):
    jf, _, queries = jax_forest(family, quantize)
    forest = port_forest(family, quantize)
    fused = tsearch.knn_search_batch(forest, queries, K, 64, block_rows=96,
                                     device="cpu")
    before = _launches()
    got = tsearch._knn_search_batch_unfused(forest, queries, K, 64, 96,
                                            device="cpu")
    assert _launches() == before
    _assert_bit_equal(got, fused)
    want = jsearch._knn_search_batch_unfused_jit(jf, jnp.asarray(queries),
                                                 K, 64, 96)
    _assert_same_result(got, want)


@pytest.mark.parametrize("env_block_rows", [256, 512])
@pytest.mark.parametrize("block_rows", [96, 100, 4096])
def test_windowed_gate_equals_the_hoisted_gate(block_rows, env_block_rows):
    for quantize in (False, True):
        forest = port_forest("shannon", quantize)
        _, _, queries = jax_forest("shannon", quantize)
        qs = tsearch.query_struct(torch.from_numpy(queries),
                                  forest.partition, forest.family)
        qb = tsearch._filter_bounds(forest, qs, K, block_rows)
        # A looser bound in half the queries, so some gate bits differ.
        qb[::2] += 0.5 * qb[::2].abs()
        bn, nb = tsearch._block_layout(forest.n, block_rows)
        hoisted = tsearch._envelope_gate(forest, qs, qb, bn, nb,
                                         env_block_rows)
        windowed = tsearch._envelope_gate_windowed(forest, qs, qb, bn, nb,
                                                   env_block_rows)
        assert hoisted.shape == (nb, queries.shape[0])
        assert torch.equal(hoisted, windowed)


# ---------------------------------------------------------------------------
# §8 approximate batched search
# ---------------------------------------------------------------------------

def test_cdf_shrink_matches_jax():
    rng = np.random.default_rng(5)
    samples = np.sort(rng.normal(size=257)).astype(np.float32)
    mu = np.abs(rng.normal(size=9)).astype(np.float32)
    mu[0] = 0.0
    kappa = rng.normal(size=9).astype(np.float32)
    for p in (0.0, 0.3, P_APPROX, 1.0):
        want = jsearch._cdf_shrink(jnp.asarray(samples), jnp.asarray(mu),
                                   jnp.asarray(kappa), jnp.float32(p))
        got = tsearch._cdf_shrink(*_t(samples, mu, kappa),
                                  torch.tensor(p, dtype=torch.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
        assert bool(((got >= 0) & (got <= 1)).all())


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_knn_search_batch_approx_matches_jax(family, quantize):
    jf, _, queries = jax_forest(family, quantize)
    want = jsearch.knn_search_batch_approx(jf, jnp.asarray(queries), K, 64,
                                           jnp.float32(P_APPROX),
                                           block_rows=96)
    got = tsearch.knn_search_batch_approx(port_forest(family, quantize),
                                          queries, K, 64, P_APPROX,
                                          block_rows=96, device="cpu")
    _assert_same_result(got, want)
    exact = tsearch.knn_search_batch(port_forest(family, quantize), queries,
                                     K, 64, block_rows=96, device="cpu")
    assert bool((got.num_candidates <= exact.num_candidates).all())


def test_validate_p_guarantee():
    for ok in (None, 0, 0.5, 1.0, np.float32(0.8), torch.tensor(0.25)):
        tsearch.validate_p_guarantee(ok)
    for bad in (-0.1, 1.5, float("nan")):
        with pytest.raises(ValueError, match="p_guarantee"):
            tsearch.validate_p_guarantee(bad)
    for bad in (True, "0.9", [0.5]):
        with pytest.raises(TypeError, match="p_guarantee"):
            tsearch.validate_p_guarantee(bad)
    forest = port_forest("burg", False)
    queries = jax_forest("burg", False)[2]
    with pytest.raises(ValueError, match="needs p_guarantee"):
        tsearch.knn_search_batch_approx(forest, queries, K, 64, None,
                                        device="cpu")
    with pytest.raises(ValueError, match="p_guarantee"):
        tsearch.knn_search_batch_approx(forest, queries, K, 64, 2.0,
                                        device="cpu")
