"""The grouped exact search on the CPU: the filter (#1), the fused
filter+prune (#3) and, under ``fused=False``, the prune-only kernel (#5)
launched once per group of row blocks, against the JAX package on a blob
corpus whose envelope gate admits some blocks and rejects others, and
against a per-block loop over the same inputs; the plain versions of #3's
and #5's block-list entries against the JAX package's oracle and Pallas
kernel (interpret mode) over the listed rows.

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
    bregman_filter_prune as pallas_filter_prune
from repro.kernels.bregman_prune import \
    bregman_prune_mask as pallas_prune

import repro_torch.core.search as tsearch
from repro_torch.kernels import _build, bregman_fused, bregman_prune, \
    bregman_ub, ops, ref

from torch_parity import filter_inputs, to_port

K = 10
BLOCK_ROWS = 96
# 16 blobs of 147 rows: n = 2352, 25 blocks of 96 rows, the last of 48.
BLOBS, PER, D, M, CLUSTERS, Q = 16, 147, 16, 4, 32, 8
DIST_TOL = dict(rtol=1e-5, atol=1e-5)
PALLAS_TILES = dict(block_n=32, block_q=4, interpret=True)


@functools.lru_cache(maxsize=None)
def blob_forests():
    """(reference forest, port forest, queries): contiguous Gaussian blobs
    100 apart, squared Euclidean, queries near blob 0 (the construction
    of the blob corpus in benchmarks/bench_tiered.py at a small n)."""
    rng = np.random.default_rng(0)
    data = np.concatenate([rng.normal(size=(PER, D)) + 100.0 * j
                           for j in range(BLOBS)]).astype(np.float32)
    queries = (data[rng.integers(0, PER, size=Q)] + 0.01).astype(np.float32)
    jf = jax_build_index(data, "squared_euclidean", m=M,
                         num_clusters=CLUSTERS, seed=0)
    return jf, to_port(jf), queries


def _cap_for(blocks_a_group: int) -> int:
    """A cap at which #3 takes ``blocks_a_group`` row blocks a launch (#1
    twice as many: its outputs are half the bytes)."""
    return blocks_a_group * BLOCK_ROWS * Q * 8


@pytest.fixture
def launches(monkeypatch):
    """The (rows, q) tiles each grouped dispatcher was handed, by name:
    #1's rows, and the block lists of #3 and #5 with their masks' rows."""
    seen = {"ub": [], "fp": [], "prune": []}
    ub, fp = ops.bregman_ub_matrix, ops.bregman_filter_prune_blocks
    pr = ops.bregman_prune_blocks

    def ub_spy(alpha, *args):
        seen["ub"].append(alpha.shape[0])
        return ub(alpha, *args)

    def fp_spy(*args):
        out = fp(*args)
        seen["fp"].append((args[7].tolist(), out[1].shape[0]))
        return out

    def pr_spy(*args):
        out = pr(*args)
        seen["prune"].append((args[5].tolist(), out.shape[0]))
        return out

    monkeypatch.setattr(ops, "bregman_ub_matrix", ub_spy)
    monkeypatch.setattr(ops, "bregman_filter_prune_blocks", fp_spy)
    monkeypatch.setattr(ops, "bregman_prune_blocks", pr_spy)
    return seen


def _assert_same_result(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.exact.numpy(), np.asarray(want.exact))
    np.testing.assert_array_equal(got.num_candidates.numpy(),
                                  np.asarray(want.num_candidates))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               **DIST_TOL)


@pytest.mark.parametrize("blocks_a_group", [1, 3, 7, None])
def test_grouped_search_matches_jax(monkeypatch, launches, blocks_a_group):
    jf, tf, queries = blob_forests()
    if blocks_a_group is not None:
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
    # The gate admits some blocks and rejects others.
    nb = got["num_blocks"]
    assert nb == 25 and 0 < got["num_blocks_run"] < nb
    # #1 saw every row once, in groups of the cap; #3 the admitted blocks.
    per = nb if blocks_a_group is None else 2 * blocks_a_group
    assert sum(launches["ub"]) == tf.n
    assert len(launches["ub"]) == -(-nb // per)
    listed = [b for blocks, _ in launches["fp"] for b in blocks]
    assert listed == sorted(listed) and len(listed) == got["num_blocks_run"]
    if blocks_a_group is not None:
        assert all(len(b) <= blocks_a_group for b, _ in launches["fp"])
        assert len(launches["fp"]) == -(-len(listed) // blocks_a_group)
    assert all(rows == len(b) * BLOCK_ROWS for b, rows in launches["fp"])


@pytest.mark.parametrize("blocks_a_group", [1, 2, None])
def test_grouped_knn_batch_matches_jax(monkeypatch, blocks_a_group):
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
def jax_unfused():
    """The JAX package's unfused search on the blob corpus at budget 64,
    with its gate's stats: (result, env_admitted, blocks_run, tau)."""
    jf, _, queries = blob_forests()
    run = jax.jit(lambda index, ys: jsearch._knn_search_batch_core(
        index, ys, K, 64, None, BLOCK_ROWS, with_stats=True, fused=False))
    return run(jf, jnp.asarray(queries))


def _unfused(forest, queries):
    return tsearch._knn_search_batch_core(
        forest, torch.from_numpy(queries), K, 64, BLOCK_ROWS,
        with_stats=True, fused=False)


@pytest.mark.parametrize("blocks_a_group", [1, 2, 3, None])
def test_grouped_unfused_search_matches_jax(monkeypatch, launches,
                                            blocks_a_group):
    """``fused=False`` in fp32: #5's block-list entry handed the admitted
    blocks in order, at most the cap's count a launch (twice #3's: four
    output bytes a pair), with the JAX package's unfused search's ids,
    exact, num_candidates and gate stats, dists within 1e-5, and the
    per-block loop's (a cap below one block) results bit for bit."""
    _, tf, queries = blob_forests()
    cap = (tsearch.GROUP_OUTPUT_BYTES if blocks_a_group is None
           else _cap_for(blocks_a_group))
    monkeypatch.setattr(tsearch, "GROUP_OUTPUT_BYTES", 0)
    per_block = _unfused(tf, queries)
    assert all(len(b) == 1 for b, _ in launches["prune"])
    launches["prune"].clear()
    monkeypatch.setattr(tsearch, "GROUP_OUTPUT_BYTES", cap)
    got, env, blocks_run, tau = _unfused(tf, queries)
    want, want_env, want_run, want_tau = jax_unfused()
    _assert_same_result(got, want)
    np.testing.assert_array_equal(env.numpy(), np.asarray(want_env))
    assert blocks_run == int(want_run) and 0 < blocks_run < 25
    np.testing.assert_array_equal(tau.numpy(), np.asarray(want_tau))
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(per_block[0], f)), f
    assert torch.equal(env, per_block[1]) and blocks_run == per_block[2]
    gb = tsearch._group_blocks(BLOCK_ROWS, Q, 4)
    assert gb == 2 * blocks_a_group if blocks_a_group else gb >= 25
    listed = [b for blocks, _ in launches["prune"] for b in blocks]
    assert listed == sorted(listed) and len(listed) == blocks_run
    assert len(launches["prune"]) == -(-blocks_run // gb)
    assert all(len(b) <= gb for b, _ in launches["prune"])
    assert all(rows == len(b) * BLOCK_ROWS for b, rows in launches["prune"])
    assert launches["fp"] == []


def _per_block_topk(vals, k, bn):
    """The running top-k merged one row block at a time."""
    q = vals.shape[1]
    best_v = torch.full((q, k), tsearch.POS_BIG)
    best_i = torch.zeros((q, k), dtype=torch.long)
    for s in range(0, vals.shape[0], bn):
        best_v, best_i = tsearch._merge_topk(
            best_v, best_i, vals[s:s + bn], torch.arange(s, s + vals[s:s + bn]
                                                         .shape[0]), k)
    return best_v, best_i


@pytest.mark.parametrize("n,bn,group", [(1000, 96, 3), (1000, 96, 11),
                                        (97, 8, 4)])
def test_grouped_merge_equals_the_per_block_merges(n, bn, group):
    """Ties everywhere (totals from eight values): the grouped merge keeps
    the per-block merges' values and rows, element for element."""
    rng = np.random.default_rng(n + group)
    vals = torch.from_numpy(rng.integers(0, 8, size=(n, 5))
                            .astype(np.float32))
    want_v, want_i = _per_block_topk(vals, K, bn)
    got_v, got_i = _per_block_topk(vals, K, bn * group)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    # Stable: within equal totals the rows ascend.
    for v, i in zip(want_v, want_i, strict=True):
        for a in range(K - 1):
            assert v[a] < v[a + 1] or i[a] < i[a + 1]


@pytest.mark.parametrize("budget", [3, 40, 500])
def test_grouped_slot_routing_equals_the_per_block_fills(budget):
    """One routing of a block-list tile (non-contiguous blocks, a short
    last block with inert rows) fills the slots the per-block fills do."""
    rng = np.random.default_rng(budget)
    n, bn, q = 1000, 96, 6
    listed = [0, 2, 3, 7, 10]                 # block 10 has 40 rows
    blocks = torch.tensor(listed, dtype=torch.int32)
    rows = ref.block_rows(blocks, bn)
    admit = torch.from_numpy((rng.random((len(rows), q)) < 0.3)
                             .astype(np.int32))
    admit[rows >= n] = 0                      # what the kernel writes there
    sel0 = torch.full((q, budget), n - 1, dtype=torch.long)
    count0 = torch.zeros(q, dtype=torch.long)
    want_sel, want_count = sel0.clone(), count0.clone()
    for i, b in enumerate(listed):
        real = min(bn, n - b * bn)
        want_sel, want_count = tsearch._fill_block_slots(
            want_sel, want_count, admit[i * bn:i * bn + real], b * bn,
            budget)
    got_sel, got_count = tsearch._fill_slots(sel0.clone(), count0.clone(),
                                             admit, rows, budget)
    assert torch.equal(got_sel, want_sel)
    assert torch.equal(got_count, want_count)
    assert int(got_count.max()) > 0


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
def test_no_tensor_of_n_q_elements_once_the_cap_is_below_it(
        monkeypatch, blocks_a_group):
    """With the cap below the (n, q) outputs no operator of the search
    returns a tensor of n * q elements; with the default cap (the whole
    index in one group) one does, so the guard sees such tensors."""
    _, tf, queries = blob_forests()
    if blocks_a_group is not None:
        monkeypatch.setattr(tsearch, "GROUP_OUTPUT_BYTES",
                            _cap_for(blocks_a_group))
    with _LargestOutput() as mode:
        tsearch.knn_search_batch(tf, queries, K, 64, block_rows=BLOCK_ROWS,
                                 device="cpu")
    if blocks_a_group is None:
        assert mode.largest >= tf.n * Q
    else:
        assert mode.largest < tf.n * Q


@pytest.mark.parametrize("n,m,q,bn,listed", [(257, 50, 5, 64, [0, 2, 4]),
                                             (100, 28, 3, 32, [3]),
                                             (64, 8, 1, 8, [1, 5, 6, 7])])
def test_blocks_plain_version_matches_jax(n, m, q, bn, listed):
    """The plain version of #3's block-list entry against the JAX
    package's oracle and Pallas kernel (interpret mode) over the listed
    rows; a short last block's rows past n are inert."""
    inputs = filter_inputs(n, m, q, seed=n + 5)
    a, g, am, gm, qc, sd, qb = (torch.from_numpy(x) for x in inputs)
    blocks = torch.tensor(listed, dtype=torch.int32)
    before = (bregman_ub.launches, bregman_fused.launches)
    ub, admit = ops.bregman_filter_prune_blocks(a, g, am, gm, qc, sd, qb,
                                                blocks, bn)
    assert (bregman_ub.launches, bregman_fused.launches) == before
    assert ub.shape == admit.shape == (len(listed) * bn, q)
    rows = ref.block_rows(blocks, bn).numpy()
    real = rows < n
    assert np.isinf(ub.numpy()[~real]).all()
    assert not admit.numpy()[~real].any()
    idx = rows[real]
    sub = [x[idx] for x in inputs[:4]] + list(inputs[4:])
    j_ub, j_admit = jref.bregman_filter_prune(*sub)
    p_ub, p_admit = pallas_filter_prune(
        *map(jnp.asarray, sub[:4]), jnp.sum(jnp.asarray(sub[4]), -1),
        *map(jnp.asarray, sub[4:]), **PALLAS_TILES)
    for want_ub in (j_ub, p_ub):
        np.testing.assert_allclose(ub.numpy()[real], np.asarray(want_ub),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(admit.numpy()[real], np.asarray(j_admit))
    # The jitted Pallas kernel may round row 0's exact tie the other way
    # (XLA contracts the compare on the CPU): off that row, bit-equal.
    off_tie = idx != 0
    np.testing.assert_array_equal(admit.numpy()[real][off_tie],
                                  np.asarray(p_admit)[off_tie])
    if int(real.sum()) * q >= 64:
        assert 0 < int(admit.sum()) < int(real.sum()) * q


def test_blocks_dispatch_checks_its_operands():
    inputs = [torch.from_numpy(x) for x in filter_inputs(16, 3, 2, seed=0)]
    a, g, am, gm, qc, sd, qb = inputs
    blocks = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(q, M\) query operands"):
        ops.bregman_filter_prune_blocks(a, g, am, gm, qc[0], sd, qb, blocks,
                                        8)
    with pytest.raises(ValueError, match="must share"):
        ops.bregman_filter_prune_blocks(a, g, am[:5], gm, qc, sd, qb,
                                        blocks, 8)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bregman_fused.bregman_filter_prune_blocks(a, g, am, gm, qc.sum(-1),
                                                  qc, sd, qb, blocks, 8)


# (n, M, q, bn, listed blocks): non-contiguous lists with a short last
# block, one block, M = 1, and q past one Pallas query tile.
PRUNE_BLOCK_CASES = [(257, 50, 5, 64, [0, 2, 4]), (100, 28, 3, 32, [3]),
                     (64, 8, 1, 8, [0, 5, 6, 7]), (300, 1, 6, 64, [0, 1, 4]),
                     (130, 37, 9, 48, [0, 2])]


@pytest.mark.parametrize("n,m,q,bn,listed", PRUNE_BLOCK_CASES)
def test_prune_blocks_plain_version_matches_jax(n, m, q, bn, listed):
    """The plain version of #5's block-list entry against the JAX
    package's oracle and Pallas kernel (interpret mode) over the listed
    rows: bit-equal, a short last block's rows past n inert, equal to #3's
    block-list admit and to the one-span entry's mask block by block."""
    inputs = filter_inputs(n, m, q, seed=n + 13)
    corners, query = inputs[2:4], inputs[4:]
    blocks = torch.tensor(listed, dtype=torch.int32)
    before = bregman_prune.launches
    admit = ops.bregman_prune_blocks(
        *(torch.from_numpy(x) for x in corners + query), blocks, bn)
    assert bregman_prune.launches == before           # no kernel on the CPU
    assert admit.shape == (len(listed) * bn, q) and admit.dtype == torch.int32
    rows = ref.block_rows(blocks, bn).numpy()
    real = rows < n
    assert not admit.numpy()[~real].any()
    idx = rows[real]
    sub = [x[idx] for x in corners] + list(query)
    np.testing.assert_array_equal(
        admit.numpy()[real], np.asarray(jref.bregman_prune_mask(*sub)))
    p_admit = pallas_prune(*map(jnp.asarray, sub), **PALLAS_TILES)
    # Row 0's exact tie may contract into a fused multiply-add under jit
    # (ROADMAP queue 3): off that row, bit-equal.
    off_tie = idx != 0
    np.testing.assert_array_equal(admit.numpy()[real][off_tie],
                                  np.asarray(p_admit)[off_tie])
    _, fused = ops.bregman_filter_prune_blocks(
        *(torch.from_numpy(x) for x in inputs), blocks, bn)
    assert torch.equal(admit, fused)
    for i, b in enumerate(listed):
        s = slice(b * bn, min((b + 1) * bn, n))
        one = ref.bregman_prune_mask(*(torch.from_numpy(x[s])
                                       for x in corners),
                                     *(torch.from_numpy(x) for x in query))
        assert torch.equal(one, admit[i * bn:i * bn + s.stop - s.start])
    if int(real.sum()) * q >= 64:
        assert 0 < int(admit.sum()) < int(real.sum()) * q


def test_prune_blocks_wrapper_checks_its_operands():
    """#5's block-list wrapper refuses CPU tensors without launching, the
    dispatcher checks the query operands, an empty list gives an empty
    mask, and the C entry point is declared to ctypes."""
    inputs = [torch.from_numpy(x) for x in filter_inputs(16, 3, 2, seed=0)]
    _, _, am, gm, qc, sd, qb = inputs
    blocks = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(q, M\) query operands"):
        ops.bregman_prune_blocks(am, gm, qc, sd[0], qb, blocks, 8)
    before = bregman_prune.launches
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bregman_prune.bregman_prune_mask_blocks(am, gm, qc, sd, qb, blocks,
                                                8)
    assert bregman_prune.launches == before
    empty = ops.bregman_prune_blocks(am, gm, qc, sd, qb, blocks[:0], 8)
    assert empty.shape == (0, 2) and empty.dtype == torch.int32
    sig = _build.SIGNATURES["brk_prune_mask_blocks"]
    assert len(sig) == 14 and sig[:7] == (sig[0],) * 7
