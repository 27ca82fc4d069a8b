"""The grouped int8 search on the CPU: the filter (#2), the fused
filter+prune (#4) and, under ``fused=False``, the prune-only kernel (#6)
launched once per group of row blocks, against the JAX package's int8
search on a quantized blob corpus whose envelope gate admits some blocks
and rejects others; the plain versions of #4's and #6's block-list
entries against the JAX package's oracle and Pallas kernel (interpret
mode) over the listed rows.

The group cap is ``search.GROUP_OUTPUT_BYTES``; the tests set it small so
that one search makes several groups, a short last block included."""

import functools

import jax
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
from repro.kernels.bregman_prune import \
    bregman_prune_mask_quant as pallas_prune_quant

import repro_torch.core.search as tsearch
from repro_torch.kernels import _build, bregman_fused, bregman_prune, ops, \
    ref

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
    """A cap at which #4 takes ``blocks_a_group`` row blocks a launch (#2
    and #6, four output bytes a pair to #4's eight, twice as many)."""
    return blocks_a_group * BLOCK_ROWS * Q * 8


def _group_rows(n: int, span: int) -> list:
    """The rows of each group of ``span`` consecutive rows over n rows, a
    short last group included."""
    return [min(span, n - s) for s in range(0, n, span)]


@pytest.fixture
def launches(monkeypatch):
    """The (rows, q) tiles #2 was handed, and the block lists of #4, #6
    and #5 (with the rows of each mask)."""
    seen = {"ub": [], "fp": [], "prune": [], "prune_f32": []}
    ub, fp = ops.bregman_ub_matrix_quant, ops.bregman_filter_prune_blocks_quant
    pr, pr32 = ops.bregman_prune_blocks_quant, ops.bregman_prune_blocks

    def ub_spy(alpha_q, *args):
        seen["ub"].append(alpha_q.shape[0])
        return ub(alpha_q, *args)

    def fp_spy(*args):
        out = fp(*args)
        seen["fp"].append((args[15].tolist(), out[1].shape[0]))
        return out

    def pr_spy(*args):
        out = pr(*args)
        seen["prune"].append((args[9].tolist(), out.shape[0]))
        return out

    def pr32_spy(*args):
        out = pr32(*args)
        seen["prune_f32"].append((args[5].tolist(), out.shape[0]))
        return out

    monkeypatch.setattr(ops, "bregman_ub_matrix_quant", ub_spy)
    monkeypatch.setattr(ops, "bregman_filter_prune_blocks_quant", fp_spy)
    monkeypatch.setattr(ops, "bregman_prune_blocks_quant", pr_spy)
    monkeypatch.setattr(ops, "bregman_prune_blocks", pr32_spy)
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
    # #2 saw the rows in groups of twice the cap's blocks (its outputs
    # take half #4's bytes a pair), a short last group included; #4 the
    # admitted blocks, in order, at most the cap's count a launch.
    assert tsearch._group_blocks(BLOCK_ROWS, Q, 4) == 2 * blocks_a_group
    assert launches["ub"] == _group_rows(tf.n,
                                         2 * blocks_a_group * BLOCK_ROWS)
    assert launches["ub"][-1] < 2 * blocks_a_group * BLOCK_ROWS
    listed = [b for blocks, _ in launches["fp"] for b in blocks]
    assert listed == sorted(listed) and len(listed) == got["num_blocks_run"]
    assert all(len(b) <= blocks_a_group for b, _ in launches["fp"])
    assert len(launches["fp"]) == -(-len(listed) // blocks_a_group)
    assert all(rows == len(b) * BLOCK_ROWS for b, rows in launches["fp"])
    assert launches["prune"] == launches["prune_f32"] == []


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


@functools.lru_cache(maxsize=None)
def jax_unfused(forest_key: str):
    """The JAX package's unfused int8 (or fp32) search on the blob corpus at
    budget 64, with its gate's stats: (result, env_admitted, blocks_run,
    tau)."""
    jf = blob_forests()[0] if forest_key == "int8" else fp32_blob_forests()[0]
    queries = blob_forests()[2]
    run = jax.jit(lambda index, ys: jsearch._knn_search_batch_core(
        index, ys, K, 64, None, BLOCK_ROWS, with_stats=True, fused=False))
    return run(jf, jnp.asarray(queries))


@functools.lru_cache(maxsize=None)
def fp32_blob_forests():
    """(reference fp32 forest, port forest): the blob corpus unquantized."""
    _, _, queries = blob_forests()
    rng = np.random.default_rng(0)
    data = np.concatenate([rng.normal(size=(PER, D)) + 100.0 * j
                           for j in range(BLOBS)]).astype(np.float32)
    jf = jax_build_index(data, "squared_euclidean", m=M,
                         num_clusters=CLUSTERS, seed=0)
    return jf, to_port(jf)


@pytest.mark.parametrize("blocks_a_group", [1, 2, 3, None])
def test_grouped_unfused_int8_search_matches_jax(monkeypatch, launches,
                                                 blocks_a_group):
    """``fused=False`` in the int8 tier: #6 handed the admitted blocks in
    order, once per group of the cap's blocks (twice #4's: four output
    bytes a pair), with the JAX package's unfused search's ids, exact,
    num_candidates and gate stats, and the fused search's result bit for
    bit."""
    _, tf, queries = blob_forests()
    if blocks_a_group is not None:
        monkeypatch.setattr(tsearch, "GROUP_OUTPUT_BYTES",
                            _cap_for(blocks_a_group))
    want, want_env, want_run, want_tau = jax_unfused("int8")
    ys = torch.from_numpy(queries)
    got, env, blocks_run, tau = tsearch._knn_search_batch_core(
        tf, ys, K, 64, BLOCK_ROWS, with_stats=True, fused=False)
    _assert_same_result(got, want)
    np.testing.assert_array_equal(env.numpy(), np.asarray(want_env))
    assert blocks_run == int(want_run) and 0 < blocks_run < 25
    np.testing.assert_array_equal(tau.numpy(), np.asarray(want_tau))
    fused = tsearch.knn_search_batch(tf, queries, K, 64,
                                     block_rows=BLOCK_ROWS, device="cpu")
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(fused, f)), f
    gb = tsearch._group_blocks(BLOCK_ROWS, Q, 4)
    assert gb == 2 * blocks_a_group if blocks_a_group else gb >= 25
    unfused = launches["prune"]
    listed = [b for blocks, _ in unfused for b in blocks]
    assert len(unfused) == -(-blocks_run // gb)
    assert listed == sorted(listed) and len(listed) == blocks_run
    assert all(len(b) <= gb for b, _ in unfused)
    assert all(rows == len(b) * BLOCK_ROWS for b, rows in unfused)
    assert launches["prune_f32"] == []


def test_unfused_fp32_search_keeps_one_prune_launch_a_block(launches):
    """#5 no longer launches once a block (the name is the check's older
    form, kept so its history reads on): it takes the admitted blocks as
    #6 does.  The fp32 unfused search (default cap) hands its block-list
    entry every admitted block, in order, in ONE launch (a short last
    block's rows past n included in its mask), and matches the JAX
    package's unfused search."""
    assert not hasattr(tsearch, "PER_BLOCK_KERNELS")
    assert tsearch._group_blocks(BLOCK_ROWS, Q, 4) >= 25
    _, tf = fp32_blob_forests()
    queries = blob_forests()[2]
    want, want_env, want_run, _ = jax_unfused("f32")
    got, env, blocks_run, _ = tsearch._knn_search_batch_core(
        tf, torch.from_numpy(queries), K, 64, BLOCK_ROWS, with_stats=True,
        fused=False)
    _assert_same_result(got, want)
    np.testing.assert_array_equal(env.numpy(), np.asarray(want_env))
    assert blocks_run == int(want_run) and 0 < blocks_run < 25
    assert launches["prune"] == []
    assert len(launches["prune_f32"]) == 1
    listed, rows = launches["prune_f32"][0]
    assert listed == sorted(listed) and len(listed) == blocks_run
    assert rows == blocks_run * BLOCK_ROWS


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


@pytest.mark.parametrize("n,m,q,bn,listed", BLOCK_CASES)
def test_prune_blocks_quant_plain_version_matches_jax(n, m, q, bn, listed):
    """The plain version of #6's block-list entry against the JAX
    package's oracle and Pallas kernel (interpret mode) over the listed
    rows: bit-equal, a short last block's rows past n inert, equal to #4's
    block-list admit and to the one-span entry's mask block by block."""
    inputs = filter_inputs_quant(n, m, q, seed=n + 11)
    corners, query = inputs[6:12], inputs[12:]
    blocks = torch.tensor(listed, dtype=torch.int32)
    before = bregman_prune.launches_quant
    admit = ops.bregman_prune_blocks_quant(
        *(torch.from_numpy(x) for x in corners + query), blocks, bn)
    assert bregman_prune.launches_quant == before     # no kernel on the CPU
    assert admit.shape == (len(listed) * bn, q) and admit.dtype == torch.int32
    rows = ref.block_rows(blocks, bn).numpy()
    real = rows < n
    assert not admit.numpy()[~real].any()
    idx = rows[real]
    sub = [x[idx] for x in corners] + list(query)
    np.testing.assert_array_equal(
        admit.numpy()[real], np.asarray(jref.bregman_prune_mask_quant(*sub)))
    p_admit = pallas_prune_quant(*map(jnp.asarray, sub), **PALLAS_TILES)
    # Row 0's exact tie may contract into a fused multiply-add under jit
    # (ROADMAP queue 3): off that row, bit-equal.
    off_tie = idx != 0
    np.testing.assert_array_equal(admit.numpy()[real][off_tie],
                                  np.asarray(p_admit)[off_tie])
    _, fused = ops.bregman_filter_prune_blocks_quant(
        *(torch.from_numpy(x) for x in inputs), blocks, bn)
    assert torch.equal(admit, fused)
    for i, b in enumerate(listed):
        s = slice(b * bn, min((b + 1) * bn, n))
        one = ops.bregman_prune_block_quant(
            *(torch.from_numpy(x[s]) for x in corners),
            *(torch.from_numpy(x) for x in query))
        assert torch.equal(one, admit[i * bn:i * bn + s.stop - s.start])
    if int(real.sum()) * q >= 64:
        assert 0 < int(admit.sum()) < int(real.sum()) * q


def test_prune_blocks_quant_wrapper_checks_its_operands():
    """#6's block-list wrapper refuses CPU tensors without launching, the
    dispatcher checks the query operands, an empty list gives an empty
    mask, and the C entry point is declared to ctypes."""
    inputs = [torch.from_numpy(x)
              for x in filter_inputs_quant(16, 3, 2, seed=0)]
    corners, (qc, sd, qb) = inputs[6:12], inputs[12:]
    blocks = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(q, M\) query operands"):
        ops.bregman_prune_blocks_quant(*corners, qc, sd[0], qb, blocks, 8)
    before = bregman_prune.launches_quant
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bregman_prune.bregman_prune_mask_blocks_quant(*corners, qc, sd, qb,
                                                      blocks, 8)
    assert bregman_prune.launches_quant == before
    empty = ops.bregman_prune_blocks_quant(*corners, qc, sd, qb, blocks[:0],
                                           8)
    assert empty.shape == (0, 2) and empty.dtype == torch.int32
    assert "brk_prune_mask_blocks_quant" in _build.SIGNATURES
    assert _build.SIGNATURES["brk_prune_mask_blocks_quant"][9:11] == (
        _build.SIGNATURES["brk_prune_mask_blocks_quant"][0],) * 2


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
