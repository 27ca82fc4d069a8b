"""Kernel #9 on the CPU: the port's ``ops.pccp_correlation`` (its plain
version) against the JAX package's Pallas kernel in interpret mode and its
``ref.pccp_correlation``, at tests/test_kernels.py::test_corr_kernel's
shapes and tolerance (rtol = atol = 1e-3), and the PCCP partition built
from it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as jpart
from repro.kernels import ref as jref
from repro.kernels.pccp_corr import pccp_correlation as pallas_corr

from repro_torch.core import partition as tpart
from repro_torch.kernels import ops, pccp_corr

TOL = dict(rtol=1e-3, atol=1e-3)


def _x(n, d):
    return np.random.default_rng(3).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("n,d", [(100, 8), (257, 40), (64, 129)])
def test_pccp_correlation_plain_version_matches_jax(n, d):
    x = _x(n, d)
    before = pccp_corr.launches
    got = ops.pccp_correlation(torch.from_numpy(x))
    assert pccp_corr.launches == before          # the CPU runs no kernel
    assert got.dtype == torch.float32 and got.shape == (d, d)
    assert bool((torch.diagonal(got) == 0).all())
    want_pallas = pallas_corr(jnp.asarray(x), block_d=16, block_n=64,
                              interpret=True)
    want_ref = jref.pccp_correlation(jnp.asarray(x))
    for want in (want_pallas, want_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # numpy float64, the reference build's correlations
    np.testing.assert_allclose(got.numpy(), tpart.correlation_matrix(x),
                               **TOL)


def test_pccp_partition_from_the_kernel_route_matches_jax():
    """``build_pccp_partition(..., corr=)`` over the port's correlations
    gives the reference's partition over its Pallas kernel's."""
    x = _x(257, 40)
    corr_t = ops.pccp_correlation(torch.from_numpy(x)).numpy()
    corr_j = np.asarray(pallas_corr(jnp.asarray(x), block_d=16,
                                    block_n=64, interpret=True))
    for m in (2, 5):
        got = tpart.build_pccp_partition(x, m, seed=0, corr=corr_t)
        want = jpart.build_pccp_partition(x, m, seed=0, corr=corr_j)
        np.testing.assert_array_equal(got.idx, want.idx)
        np.testing.assert_array_equal(got.mask, want.mask)


def test_constant_columns_and_cpu_refusal():
    x = _x(50, 6)
    x[:, 2] = 1.5                                # std 0 -> divides by 1
    got = ops.pccp_correlation(torch.from_numpy(x)).numpy()
    want = np.asarray(jref.pccp_correlation(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[2] == 0) and np.all(got[:, 2] == 0)
    with pytest.raises(ValueError, match="CUDA"):
        pccp_corr.pccp_gram(torch.from_numpy(x))
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        ops.pccp_correlation(torch.zeros(3))
