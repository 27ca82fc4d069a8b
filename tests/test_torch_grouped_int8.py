"""The grouped int8 search on the CPU: the fused filter+prune (#4) launched
once per group of row blocks, against the JAX package's int8 search on a
quantized blob corpus whose envelope gate admits some blocks and rejects
others; the plain version of #4's block-list entry against the JAX
package's oracle and Pallas kernel (interpret mode) over the listed rows;
and the int8 filter (#2), which still launches once a row block.

The group cap is ``search.GROUP_OUTPUT_BYTES``; the tests set it small so
that one search makes several groups, a short last block included."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.core.search as jsearch
from repro.core.index import build_index as jax_build_index
from repro.kernels import ref as jref
from repro.kernels.bregman_fused import \
    bregman_filter_prune_quant as pallas_filter_prune_quant

import repro_torch.core.search as tsearch
from repro_torch.kernels import bregman_fused, ops, ref

from torch_parity import filter_inputs_quant, to_port

K = 10
BLOCK_ROWS = 96
# 16 blobs of 147 rows: n = 2352, 25 blocks of 96 rows, the last of 48.
BLOBS, PER, D, M, CLUSTERS, Q = 16, 147, 16, 4, 32, 8
EPS32 = 2.0 ** -23
DIST_TOL = dict(rtol=1e-5, atol=1e-5)
PALLAS_TILES = dict(block_n=32, block_q=4, interpret=True)


@functools.lru_cache(maxsize=None)
def blob_forests():
    """(reference int8 forest, port forest, queries): the blob corpus of
    tests/test_torch_grouped.py (contiguous Gaussian blobs 100 apart,
    squared Euclidean, queries near blob 0), quantized by the JAX
    package's ``build_index(..., quantize=True)``."""
    rng = np.random.default_rng(0)
    data = np.concatenate([rng.normal(size=(PER, D)) + 100.0 * j
                           for j in range(BLOBS)]).astype(np.float32)
    queries = (data[rng.integers(0, PER, size=Q)] + 0.01).astype(np.float32)
    jf = jax_build_index(data, "squared_euclidean", m=M,
                         num_clusters=CLUSTERS, seed=0, quantize=True)
    return jf, to_port(jf), queries


def _cap_for(blocks_a_group: int) -> int:
    """A cap at which #4 takes ``blocks_a_group`` row blocks a launch."""
    return blocks_a_group * BLOCK_ROWS * Q * 8


@pytest.fixture
def launches(monkeypatch):
    """The (rows, q) tiles #2 was handed, and the block lists of #4."""
    seen = {"ub": [], "fp": []}
    ub, fp = ops.bregman_ub_matrix_quant, ops.bregman_filter_prune_blocks_quant

    def ub_spy(alpha_q, *args):
        seen["ub"].append(alpha_q.shape[0])
        return ub(alpha_q, *args)

    def fp_spy(*args):
        out = fp(*args)
        seen["fp"].append((args[15].tolist(), out[1].shape[0]))
        return out

    monkeypatch.setattr(ops, "bregman_ub_matrix_quant", ub_spy)
    monkeypatch.setattr(ops, "bregman_filter_prune_blocks_quant", fp_spy)
    return seen


def _assert_same_result(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.exact.numpy(), np.asarray(want.exact))
    np.testing.assert_array_equal(got.num_candidates.numpy(),
                                  np.asarray(want.num_candidates))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               **DIST_TOL)


@pytest.mark.parametrize("blocks_a_group", [1, 2, 3])
def test_grouped_int8_search_matches_jax(monkeypatch, launches,
                                         blocks_a_group):
    jf, tf, queries = blob_forests()
    assert tf.storage == "int8"
    monkeypatch.setattr(tsearch, "GROUP_OUTPUT_BYTES",
                        _cap_for(blocks_a_group))
    want_res, want = jsearch.knn_search_batch_stats(
        jf, jnp.asarray(queries), K, 64, block_rows=BLOCK_ROWS)
    got_res, got = tsearch.knn_search_batch_stats(
        tf, queries, K, 64, block_rows=BLOCK_ROWS, device="cpu")
    _assert_same_result(got_res, want_res)
    for key in ("block_rows", "num_blocks", "num_blocks_run",
                "env_admitted_tiles", "block_skip_rate",
                "whole_block_skip_rate"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["tau_admit"].numpy(),
                               np.asarray(want["tau_admit"]), **DIST_TOL)
    nb = got["num_blocks"]
    assert nb == 25 and 0 < got["num_blocks_run"] < nb
    # #2 saw every row block once; #4 the admitted blocks, in order, at
    # most the cap's count a launch.
    assert launches["ub"] == [BLOCK_ROWS] * (nb - 1) + [tf.n - (nb - 1)
                                                        * BLOCK_ROWS]
    listed = [b for blocks, _ in launches["fp"] for b in blocks]
    assert listed == sorted(listed) and len(listed) == got["num_blocks_run"]
    assert all(len(b) <= blocks_a_group for b, _ in launches["fp"])
    assert len(launches["fp"]) == -(-len(listed) // blocks_a_group)
    assert all(rows == len(b) * BLOCK_ROWS for b, rows in launches["fp"])


@pytest.mark.parametrize("blocks_a_group", [1, None])
def test_grouped_int8_knn_batch_matches_jax(monkeypatch, blocks_a_group):
    jf, tf, queries = blob_forests()
    if blocks_a_group is not None:
        monkeypatch.setattr(tsearch, "GROUP_OUTPUT_BYTES",
                            _cap_for(blocks_a_group))
    want, want_stats = jsearch.knn_batch(jf, queries, K, budget=K,
                                         block_rows=BLOCK_ROWS,
                                         return_stats=True)
    got, got_stats = tsearch.knn_batch(tf, queries, K, budget=K,
                                       block_rows=BLOCK_ROWS,
                                       return_stats=True, device="cpu")
    assert got_stats == want_stats
    assert got_stats.escalations > 0
    _assert_same_result(got, want)


def _ub_tolerance(m, a_q, a_s, a_z, g_q, g_s, g_z, qc, sd):
    """(M + 2) * eps32 times the magnitudes of the summed terms (as
    tests/test_torch_quantized.py bounds the one-block UB)."""
    f64 = np.float64
    mags = (np.abs(a_s * a_q.astype(f64).sum(-1)) + np.abs(m * a_z))[:, None]
    mags = mags + np.abs(qc.astype(f64).sum(-1))[None, :]
    mags = mags + np.abs(g_s)[:, None] * (np.abs(g_q.astype(f64)) @ sd.T)
    mags = mags + np.abs(g_z[:, None] * sd.astype(f64).sum(-1)[None, :])
    return (m + 2) * EPS32 * mags


# (n, M, q, bn, listed blocks): non-contiguous lists with a short last
# block, one block, M = 1, and q past one Pallas query tile.
BLOCK_CASES = [(257, 50, 5, 64, [0, 2, 4]), (100, 28, 3, 32, [3]),
               (64, 8, 1, 8, [0, 5, 6, 7]), (300, 1, 6, 64, [0, 1, 4]),
               (130, 37, 9, 48, [0, 2])]


@pytest.mark.parametrize("n,m,q,bn,listed", BLOCK_CASES)
def test_blocks_quant_plain_version_matches_jax(n, m, q, bn, listed):
    """The plain version of #4's block-list entry against the JAX
    package's oracle and Pallas kernel (interpret mode) over the listed
    rows: admit bit-equal, UB within (M + 2) eps32 of its terms, a short
    last block's rows past n inert."""
    inputs = filter_inputs_quant(n, m, q, seed=n + 7)
    blocks = torch.tensor(listed, dtype=torch.int32)
    before = bregman_fused.launches_quant
    ub, admit = ops.bregman_filter_prune_blocks_quant(
        *(torch.from_numpy(x) for x in inputs), blocks, bn)
    assert bregman_fused.launches_quant == before     # no kernel on the CPU
    assert ub.shape == admit.shape == (len(listed) * bn, q)
    assert ub.dtype == torch.float32 and admit.dtype == torch.int32
    rows = ref.block_rows(blocks, bn).numpy()
    real = rows < n
    assert np.isinf(ub.numpy()[~real]).all() and (ub.numpy()[~real] > 0).all()
    assert not admit.numpy()[~real].any()
    idx = rows[real]
    sub = [x[idx] for x in inputs[:12]] + list(inputs[12:])
    j_ub, j_admit = jref.bregman_filter_prune_quant(*sub)
    p_ub, p_admit = pallas_filter_prune_quant(
        *map(jnp.asarray, sub[:12]), jnp.sum(jnp.asarray(sub[12]), -1),
        *map(jnp.asarray, sub[12:]), **PALLAS_TILES)
    tol = _ub_tolerance(m, *sub[:6], sub[12], sub[13])
    for want_ub in (j_ub, p_ub):
        assert np.all(np.abs(ub.numpy()[real] - np.asarray(want_ub)) <= tol)
    np.testing.assert_array_equal(admit.numpy()[real], np.asarray(j_admit))
    # Under jit XLA on the CPU may contract row 0's exact tie into a fused
    # multiply-add (ROADMAP queue 3): off that row, bit-equal.
    off_tie = idx != 0
    np.testing.assert_array_equal(admit.numpy()[real][off_tie],
                                  np.asarray(p_admit)[off_tie])
    # Each listed block's rows are the one-block plain version's.
    for i, b in enumerate(listed):
        s = slice(b * bn, min((b + 1) * bn, n))
        one_ub, one_admit = ops.bregman_filter_prune_block_quant(
            *(torch.from_numpy(x[s]) for x in inputs[:12]),
            *(torch.from_numpy(x) for x in inputs[12:]))
        got = slice(i * bn, i * bn + s.stop - s.start)
        assert torch.equal(one_admit, admit[got])
        np.testing.assert_allclose(one_ub.numpy(), ub[got].numpy(),
                                   **DIST_TOL)
    if int(real.sum()) * q >= 64:
        assert 0 < int(admit.sum()) < int(real.sum()) * q


class _LargestOutput(TorchDispatchMode):
    """Records the most elements of any tensor an operator returns."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("blocks_a_group", [2, None])
def test_no_int8_tensor_of_n_q_elements_once_the_cap_is_below_it(
        monkeypatch, blocks_a_group):
    """With the cap below the (n, q) outputs no operator of the int8
    search returns a tensor of n * q elements; with the default cap (every
    admitted block in one group) #4's outputs span all admitted rows, so
    the guard sees tensors that large."""
    _, tf, queries = blob_forests()
    if blocks_a_group is not None:
        monkeypatch.setattr(tsearch, "GROUP_OUTPUT_BYTES",
                            _cap_for(blocks_a_group))
    _, stats = tsearch.knn_search_batch_stats(tf, queries, K, 64,
                                              block_rows=BLOCK_ROWS,
                                              device="cpu")
    with _LargestOutput() as mode:
        tsearch.knn_search_batch(tf, queries, K, 64, block_rows=BLOCK_ROWS,
                                 device="cpu")
    if blocks_a_group is None:
        assert mode.largest >= stats["num_blocks_run"] * BLOCK_ROWS * Q
    else:
        assert mode.largest < tf.n * Q


def test_blocks_quant_dispatch_checks_its_operands():
    inputs = [torch.from_numpy(x) for x in filter_inputs_quant(16, 3, 2,
                                                               seed=0)]
    qc, sd, qb = inputs[12:]
    blocks = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(q, M\) query operands"):
        ops.bregman_filter_prune_blocks_quant(*inputs[:12], qc[0], sd, qb,
                                              blocks, 8)
    with pytest.raises(ValueError, match="must share"):
        ops.bregman_filter_prune_blocks_quant(*inputs[:6], inputs[6][:5],
                                              *inputs[7:], blocks, 8)
    before = bregman_fused.launches_quant
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bregman_fused.bregman_filter_prune_blocks_quant(
            *inputs[:12], qc.sum(-1), qc, sd, sd.sum(-1), qb, blocks, 8)
    assert bregman_fused.launches_quant == before
