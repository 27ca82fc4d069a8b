"""The port's kernel layer on the CPU: the plain PyTorch versions of the
three CUDA kernels against the JAX package's oracles and its Pallas kernels
(interpret mode), dispatch by device, and the C binding's declarations."""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.bregman_dist import bregman_refine as pallas_refine
from repro.kernels.bregman_dist import \
    bregman_refine_batch as pallas_refine_batch
from repro.kernels.bregman_fused import \
    bregman_filter_prune as pallas_filter_prune
from repro.kernels.bregman_ub import bregman_ub_matrix as pallas_ub
from repro.core.bregman import family_names

from repro_torch.core.bounds import query_refine_constants
from repro_torch.core.bregman import get_family
from repro_torch.kernels import _build, bregman_dist, bregman_fused, \
    bregman_ub, ops

from torch_parity import filter_inputs, sample

# (n, M, q): odd row counts, M = 1, q = 1, and M past the kernels' chunk.
SHAPES = [(64, 8, 1), (100, 28, 3), (257, 50, 5), (32, 1, 1), (7, 5, 2)]
TOL = dict(rtol=1e-5, atol=1e-5)
PALLAS_TILES = dict(block_n=32, block_q=4, interpret=True)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _launch_counts():
    return (bregman_ub.launches, bregman_fused.launches,
            bregman_dist.launches)


@pytest.mark.parametrize("n,m,q", SHAPES)
def test_ub_plain_version_matches_jax(n, m, q):
    alpha, sg, _, _, qc, sd, _ = filter_inputs(n, m, q, seed=n)
    before = _launch_counts()
    got = ops.bregman_ub_matrix(*_t(alpha, sg, qc, sd)).numpy()
    assert _launch_counts() == before          # the CPU runs no kernel
    np.testing.assert_allclose(
        got, np.asarray(jref.bregman_ub_matrix(alpha, sg, qc, sd)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(pallas_ub(jnp.asarray(alpha), jnp.asarray(sg),
                                  jnp.sum(jnp.asarray(qc), -1),
                                  jnp.asarray(sd), **PALLAS_TILES)), **TOL)


@pytest.mark.parametrize("n,m,q", SHAPES)
def test_filter_prune_plain_version_matches_jax(n, m, q):
    inputs = filter_inputs(n, m, q, seed=n + 1)
    ub, admit = ops.bregman_filter_prune_block(*_t(*inputs))
    assert admit.dtype == torch.int32 and ub.dtype == torch.float32
    assert torch.all(admit[0] == 1)            # the tie at column 0 admits
    if n * q >= 64:
        assert 0 < int(admit.sum()) < n * q    # a mixed mask
    j_ub, j_admit = jref.bregman_filter_prune(*inputs)
    p_ub, p_admit = pallas_filter_prune(
        *map(jnp.asarray, inputs[:4]), jnp.sum(jnp.asarray(inputs[4]), -1),
        *map(jnp.asarray, inputs[4:]), **PALLAS_TILES)
    for want_ub in (j_ub, p_ub):
        np.testing.assert_allclose(ub.numpy(), np.asarray(want_ub), **TOL)
    np.testing.assert_array_equal(admit.numpy(), np.asarray(j_admit))
    # Row 0 holds the exact tie.  Under jit, XLA on the CPU contracts the
    # admit compare into a fused multiply-add and may round the tie the
    # other way, so the jitted Pallas kernel is held bit-equal on the
    # other rows; the eager oracle above, rounded op by op, on all rows.
    np.testing.assert_array_equal(admit.numpy()[1:],
                                  np.asarray(p_admit)[1:])


def _refine_inputs(family, q, b, d, seed):
    rows = sample(family, (q, b, d), seed=seed)
    ys = torch.from_numpy(sample(family, (q, d), seed=seed + 1))
    c = query_refine_constants(ys, get_family(family))
    return rows, c["grad"].numpy(), c["c_y"].numpy()


def _refine_tolerance(family, rows, grad, c_y):
    """The refine form ``sum phi(x) - x.grad + c_y`` cancels badly (the
    exponential family most), so its error scales with the size of the
    three terms, not with the result: 1e-5 of
    ``sum |phi(x)| + |x . grad| + |c_y|`` per (query, row)."""
    x = rows.astype(np.float64)
    phi = get_family(family).phi(torch.from_numpy(x)).numpy()
    scale = (np.abs(phi).sum(-1) + np.abs(np.einsum("qbd,qd->qb", x, grad))
             + np.abs(c_y)[:, None])
    return 1e-5 * scale


@pytest.mark.parametrize("family", family_names())
@pytest.mark.parametrize("q,b,d", [(3, 16, 24), (2, 100, 128), (1, 33, 300)])
def test_refine_plain_version_matches_jax(family, q, b, d):
    rows, grad, c_y = _refine_inputs(family, q, b, d, seed=b)
    before = _launch_counts()
    got = ops.bregman_refine_batch(*_t(rows, grad, c_y), family).numpy()
    assert _launch_counts() == before
    tol = _refine_tolerance(family, rows, grad, c_y)
    want_ref = np.asarray(jref.bregman_refine_batch(rows, grad, c_y, family))
    want_pallas = np.asarray(pallas_refine_batch(
        jnp.asarray(rows), jnp.asarray(grad), jnp.asarray(c_y), family,
        block_b=16, block_d=64, interpret=True))
    for want in (want_ref, want_pallas):
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    one = ops.bregman_refine(*_t(rows[0], grad[0], c_y[0]), family).numpy()
    want_one = np.asarray(pallas_refine(
        jnp.asarray(rows[0]), jnp.asarray(grad[0]), jnp.asarray(c_y[0]),
        family, block_b=16, block_d=64, interpret=True))
    assert np.all(np.abs(one - want_one) <= tol[0])


def test_family_aliases_reach_the_same_plain_version():
    rows, grad, c_y = _refine_inputs("exponential", 2, 8, 6, seed=0)
    torch.testing.assert_close(
        ops.bregman_refine_batch(*_t(rows, grad, c_y), "ed"),
        ops.bregman_refine_batch(*_t(rows, grad, c_y), "exponential"),
        rtol=0, atol=0)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: it never computes a CPU
    tensor's result some other way."""
    alpha, sg, amin, gmax, qc, sd, qb = _t(*filter_inputs(16, 3, 2, seed=0))
    qsum = qc.sum(-1)
    before = _launch_counts()
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bregman_ub.bregman_ub_matrix(alpha, sg, qsum, sd)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bregman_fused.bregman_filter_prune(alpha, sg, amin, gmax, qsum, qc,
                                           sd, qb)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bregman_dist.bregman_refine_batch(alpha[None], sg[:1], qsum[:1],
                                          "burg")
    with pytest.raises(ValueError, match="unknown Bregman family"):
        bregman_dist.bregman_refine_batch(alpha[None], sg[:1], qsum[:1],
                                          "kl")
    assert _launch_counts() == before


def test_dispatch_goes_by_device_only():
    meta = [torch.empty((8, 3), device="meta"),
            torch.empty((8, 3), device="meta"),
            torch.empty((2, 3), device="meta"),
            torch.empty((2, 3), device="meta")]
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        ops.bregman_ub_matrix(*meta)
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        ops.bregman_refine_batch(torch.empty((2, 4, 3), device="meta"),
                                 meta[2], torch.empty(2, device="meta"),
                                 "burg")


def test_dispatch_checks_operand_shapes():
    alpha, sg, amin, gmax, qc, sd, qb = _t(*filter_inputs(16, 3, 2, seed=0))
    with pytest.raises(ValueError, match=r"\(q, M\) query operands"):
        ops.bregman_filter_prune_block(alpha, sg, amin, gmax, qc[0], sd, qb)
    with pytest.raises(ValueError, match="must share"):
        ops.bregman_filter_prune_block(alpha, sg, amin[:5], gmax, qc, sd, qb)
    with pytest.raises(ValueError, match="use bregman_refine"):
        ops.bregman_refine_batch(alpha, sd[0], qc.sum(-1), "burg")


_CTYPES = {"void*": ctypes.c_void_p, "int64_t": ctypes.c_int64,
           "int": ctypes.c_int, "float": ctypes.c_float}


def _c_declarations() -> dict:
    """Parameter ctypes of every ``extern "C" int brk_*`` entry point in
    the CUDA sources."""
    out = {}
    for src in _build.SOURCES:
        text = (_build.CSRC / src).read_text()
        for name, params in re.findall(
                r'extern "C" int (brk_\w+)\(([^)]*)\)', text):
            types = []
            for p in params.split(","):
                p = " ".join(p.replace("const", "").split()[:-1])
                types.append(_CTYPES["void*" if "*" in p else p])
            out[name] = tuple(types)
    return out


def test_ctypes_signatures_match_the_c_entry_points():
    """ctypes passes an undeclared pointer as a 32-bit int; every argtype
    list must match its C declaration exactly."""
    assert _c_declarations() == dict(_build.SIGNATURES)
    assert {"brk_ub_matrix_quant", "brk_filter_prune_quant",
            "brk_refine_batch_quant", "brk_flash_attention",
            "brk_pccp_gram"} <= set(_build.SIGNATURES)
    for src in _build.SOURCES + _build.HEADERS:
        text = (_build.CSRC / src).read_text()
        assert "__logf" not in text and "__expf" not in text, src
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
