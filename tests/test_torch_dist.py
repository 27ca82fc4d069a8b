"""The port's distributed search (dist/knn.py) against the JAX package's and
against the port's single-host search, on the CPU.

At world size 1 the port runs in this process over gloo on an in-process
``HashStore`` (a module fixture starts the group and ends it, so no other
test sees it), and the JAX package on a 1x1 mesh.  The counterparts of
tests/test_dist_knn_parity.py hold the port's ``distributed_knn``
bit-equal to its ``knn_search_batch`` (ids, dists, exact,
num_candidates), and to the JAX ``distributed_knn`` as the other parity
tests hold the two packages: ids, exact and num_candidates equal, dists
within 1e-5.  Both storage tiers, every family, exact and approximate,
the overflow ladder, ``row_offset``, and the ``dist`` halves of
tests/test_segments.py.  World sizes 2 and 4 run in one subprocess over
gloo, beside the JAX package on forced host meshes of as many devices
(tests/torch_dist_checks.py).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.bregman import family_names
from repro.core.segments import SegmentedForest as JaxSegmented
from repro.dist import knn as jdk
from repro.dist.sharding import make_mesh as jmake_mesh

from repro_torch.core import search as tsearch
from repro_torch.core.index import pad_points, slice_points
from repro_torch.core.segments import SegmentedForest, build_segmented_index
from repro_torch.dist import knn as tdk
from repro_torch.dist.sharding import make_mesh

from torch_dist_checks import blob_index
from torch_parity import D, K, M, N, jax_forest, sample, to_port

REPO = Path(__file__).resolve().parents[1]
FAMILIES = family_names()
DIST_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def meshes():
    """(the port's world-size-1 mesh, the JAX package's 1x1 mesh)."""
    assert not dist.is_initialized()
    mesh = make_mesh((1,), ("data",), device="cpu")
    yield mesh, jmake_mesh((1,), ("data",))
    dist.destroy_process_group()


def _assert_bit_equal(got, want):
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _assert_matches_jax(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.exact.numpy(), np.asarray(want.exact))
    np.testing.assert_array_equal(got.num_candidates.numpy(),
                                  np.asarray(want.num_candidates))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               **DIST_TOL)


def _both(meshes, family, quantize=False):
    """(JAX sharded forest, port sharded forest, port forest, queries)."""
    tmesh, jmesh = meshes
    jf, _, queries = jax_forest(family, quantize)
    forest = to_port(jf)
    return (jdk.shard_index(jf, jmesh), tdk.shard_index(forest, tmesh,
                                                        device="cpu"),
            forest, queries)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_exact_mode_bit_identical(meshes, family, quantize):
    jsh, tsh, forest, queries = _both(meshes, family, quantize)
    yv = tdk.query_subview(forest.partition, queries, device="cpu")
    for budget in ((N, N // 2) if not quantize else (N,)):
        got = tdk.distributed_knn(tsh, yv, family=family, k=K, budget=budget,
                                  max_doublings=0, device="cpu")
        _assert_bit_equal(got, tsearch.knn_search_batch(
            forest, queries, K, budget, device="cpu"))
        if budget == N:
            _assert_matches_jax(got, jdk.distributed_knn(
                jsh, jnp.asarray(queries), family=family, k=K,
                budget=budget, mesh=meshes[1], max_doublings=0))


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_approx_mode_bit_identical(meshes, family, quantize):
    jsh, tsh, forest, queries = _both(meshes, family, quantize)
    got = tdk.distributed_knn(tsh, queries, family=family, k=K, budget=N,
                              approx_p=0.9, max_doublings=0, device="cpu")
    _assert_bit_equal(got, tsearch.knn_search_batch_approx(
        forest, queries, K, N, 0.9, device="cpu"))
    _assert_matches_jax(got, jdk.distributed_knn(
        jsh, jnp.asarray(queries), family=family, k=K, budget=N,
        mesh=meshes[1], approx_p=0.9, max_doublings=0))


@pytest.mark.parametrize("quantize", [False, True])
def test_budget_overflow_retry_keeps_exact_truthful(meshes, quantize):
    """From a budget of k the capped run reports the overflow and the
    ladder ends exact, as the JAX package's and the port's knn_batch."""
    family = "itakura_saito"
    jsh, tsh, forest, queries = _both(meshes, family, quantize)
    capped = tdk.distributed_knn(tsh, queries, family=family, k=K, budget=K,
                                 max_doublings=0, device="cpu")
    assert not bool(capped.exact.all())
    assert int(capped.num_candidates.max()) > K
    _assert_matches_jax(capped, jdk.distributed_knn(
        jsh, jnp.asarray(queries), family=family, k=K, budget=K,
        mesh=meshes[1], max_doublings=0))
    hook = []
    res = tdk.distributed_knn(tsh, queries, family=family, k=K, budget=K,
                              launch_hook=hook.append, device="cpu")
    assert bool(res.exact.all()) and len(hook) >= 2
    _assert_bit_equal(res, tsearch.knn_batch(forest, queries, K, budget=K,
                                             device="cpu"))
    _assert_matches_jax(res, jdk.distributed_knn(
        jsh, jnp.asarray(queries), family=family, k=K, budget=K,
        mesh=meshes[1]))
    # stop_retry ends the ladder after the first launch, flagged truthfully.
    stopped = tdk.distributed_knn(tsh, queries, family=family, k=K, budget=K,
                                  stop_retry=lambda: True, device="cpu")
    _assert_bit_equal(stopped, capped)


def test_target_recall_resolves_on_the_host(meshes):
    _, tsh, forest, queries = _both(meshes, "burg")
    p, _ = tsearch.resolve_p_guarantee(forest, 0.9)
    got = tdk.distributed_knn(tsh, queries, family="burg", k=K, budget=N,
                              target_recall=0.9, device="cpu")
    _assert_bit_equal(got, tsearch.knn_search_batch_approx(
        forest, queries, K, N, p, device="cpu"))
    with pytest.raises(ValueError, match="at most one"):
        tdk.distributed_knn(tsh, queries, family="burg", k=K, budget=N,
                            target_recall=0.9, approx_p=0.9, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        tdk.distributed_knn(tsh, queries, family="shannon", k=K, budget=N,
                            device="cpu")


def test_query_subview_matches_partition_gather():
    jf, _, queries = jax_forest("shannon")
    forest = to_port(jf)
    yv = tdk.query_subview(forest.partition, queries[:3], device="cpu")
    assert tuple(yv.y.shape) == queries[:3].shape
    np.testing.assert_array_equal(
        yv.sub.numpy(), np.asarray(jf.partition.gather(
            jnp.asarray(queries[:3]))))
    with pytest.raises(ValueError, match="expected"):
        tdk.query_subview(forest.partition, queries[0], device="cpu")


def test_pad_and_slice_points_roundtrip(meshes):
    """pad_points rows are search-inert; a world-size-1 shard holds the
    forest's own tensors, not copies."""
    jf, _, queries = jax_forest("squared_euclidean")
    forest = to_port(jf)
    padded = pad_points(forest, 8)           # 420 -> 424
    assert padded.n == 424 and int(padded.point_ids.min()) == -1
    res = tsearch.knn_search_batch(padded, queries, K, N, device="cpu")
    ref = tsearch.knn_search_batch(forest, queries, K, N, device="cpu")
    assert torch.equal(res.ids, ref.ids) and torch.equal(res.dists, ref.dists)
    local = slice_points(padded, 0, padded.n // 8)
    assert local.n == padded.n // 8
    assert torch.equal(local.data, padded.data[:padded.n // 8])
    sharded = tdk.shard_index(forest, meshes[0], device="cpu")
    assert (sharded.num_shards, sharded.shard, sharded.row_offset) == (1, 0, 0)
    assert sharded.local_n == sharded.global_n == N
    for f in ("data", "alpha", "alpha_min_pt", "env_alpha_min"):
        assert (getattr(sharded.forest, f).data_ptr()
                == getattr(forest, f).data_ptr()), f


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("quantize", [False, True])
def test_row_offset_zero_gives_todays_gate_bits(quantize, fused):
    """row_offset=0 gives the gate bits and prune outputs of None, on
    blobs where the gate rejects blocks; an offset reads the envelope
    rows that far on."""
    forest, queries = blob_index(quantize)
    qs = tsearch.query_struct(torch.as_tensor(queries), forest.partition,
                              forest.family)
    qb = tsearch._filter_bounds(forest, qs, K, 64)
    gate = (tsearch._envelope_gate if fused
            else tsearch._envelope_gate_windowed)
    bn, nb = tsearch._block_layout(forest.n, 64)
    today = gate(forest, qs, qb, bn, nb, 256)
    assert 0 < int(today.sum()) < today.numel()
    assert torch.equal(gate(forest, qs, qb, bn, nb, 256, 0), today)
    out = tsearch._stream_prune_compact(forest, qs, qb, N, 64, fused=fused)
    zero = tsearch._stream_prune_compact(forest, qs, qb, N, 64, fused=fused,
                                         row_offset=0)
    for a, b in zip(out, zero, strict=True):
        assert (a == b if isinstance(a, int) else torch.equal(a, b))
    # Rows [768, 768 + 128) as a forest of their own over the whole
    # forest's envelopes: at offset 768 its two blocks get the bits of
    # the whole forest's blocks 12 and 13.
    part = slice_points(forest, 768, 128)
    part = dataclasses.replace(part, env_alpha_min=forest.env_alpha_min,
                               env_sqrt_gamma_max=forest.env_sqrt_gamma_max)
    assert torch.equal(gate(part, qs, qb, 64, 2, 256, 768), today[12:14])


# ---------------------------------------------------------------------------
# The dist halves of tests/test_segments.py
# ---------------------------------------------------------------------------

N_ADD = 44
DELETED = (3, 7, N + 10)


def _mutated_setup(family, seed=0):
    """A port-built mutable index after insert and delete, the port's
    fresh build over its live rows, their original ids and queries."""
    from repro_torch.core.index import build_index
    data = sample(family, (N + N_ADD, D), seed=seed + 11)
    queries = sample(family, (5, D), seed=seed + 12)
    kw = dict(m=M, num_clusters=16, seed=seed, device="cpu")
    sf = build_segmented_index(data[:N], family, **kw)
    sf.insert(data[N:], auto_compact=False)
    assert sf.delete(DELETED, auto_compact=False) == len(DELETED)
    live = np.ones(N + N_ADD, bool)
    live[list(DELETED)] = False
    fresh = build_index(data[live], family, **kw)
    return sf, fresh, np.arange(N + N_ADD)[live], queries


def test_distributed_1x1_bit_identical(meshes):
    family = "itakura_saito"
    sf, fresh, orig, queries = _mutated_setup(family)
    sharded = tdk.shard_index(sf, meshes[0], device="cpu")
    assert sharded.global_live_n == sf.live_n
    budget = sf.live_n
    res = tdk.distributed_knn(sharded, queries, family=family, k=K,
                              budget=budget, device="cpu")
    ref = tsearch.knn_search_batch(fresh, queries, K, budget, device="cpu")
    np.testing.assert_array_equal(res.ids.numpy(), orig[ref.ids.numpy()])
    assert torch.equal(res.dists, ref.dists)
    assert bool(res.exact.all())
    assert not np.isin(res.ids.numpy(), DELETED).any()
    # The same mutation on the JAX package's mutable index, sharded.
    jf, _, jq = jax_forest(family)
    jsf, tsf = JaxSegmented.from_forest(jf), SegmentedForest.from_forest(
        to_port(jf))
    extra = sample(family, (N_ADD, D), seed=7)
    jsf.insert(extra, auto_compact=False)
    tsf.insert(extra, auto_compact=False)
    jsf.delete(DELETED, auto_compact=False)
    tsf.delete(DELETED, auto_compact=False)
    got = tdk.distributed_knn(tdk.shard_index(tsf, meshes[0], device="cpu"),
                              jq, family=family, k=K, budget=tsf.live_n,
                              device="cpu")
    _assert_matches_jax(got, jdk.distributed_knn(
        jdk.shard_index(jsf, meshes[1]), jnp.asarray(jq), family=family,
        k=K, budget=jsf.live_n, mesh=meshes[1]))


def test_deleted_true_neighbors_never_surface_any_path(meshes):
    family = "squared_euclidean"
    data = sample(family, (N + N_ADD, D), seed=2)
    queries = sample(family, (3, D), seed=3)
    sf = build_segmented_index(data[:N], family, m=M, num_clusters=16,
                               seed=0, device="cpu")
    sf.insert(data[N:], auto_compact=False)
    top, _ = tsearch.brute_force_knn(data, queries[0], K, family,
                                     device="cpu")
    doomed = top.tolist()
    sf.delete(doomed, auto_compact=False)
    sharded = tdk.shard_index(sf, meshes[0], device="cpu")
    res = tdk.distributed_knn(sharded, queries, family=family, k=K,
                              budget=tsearch.default_budget(sf.view(), K),
                              device="cpu")
    assert not np.isin(res.ids.numpy(), doomed).any()
    assert bool(res.exact.all())
    _assert_bit_equal(res, tsearch.knn_batch(sf, queries, K, device="cpu"))


def test_k_validated_against_live_count(meshes):
    data = sample("squared_euclidean", (32, D), seed=6)
    sf = build_segmented_index(data, "squared_euclidean", m=M,
                               num_clusters=4, seed=0, device="cpu")
    sf.delete(range(16), auto_compact=False)
    with pytest.raises(ValueError, match="live"):
        tdk.distributed_knn(tdk.shard_index(sf, meshes[0], device="cpu"),
                            data[:2], family="squared_euclidean", k=17,
                            budget=32, device="cpu")


# ---------------------------------------------------------------------------
# World sizes 2 and 4, over gloo in a subprocess
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One run of tests/torch_dist_checks.py: worlds 2 and 4 over gloo,
    side by side, and the JAX package on forced host meshes of 2 and 4
    devices in a child of its own."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "torch_dist_checks.py"),
         "--worlds", "2", "4", "--out", str(tmp_path_factory.mktemp("jax"))],
        env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.mark.parametrize("world", [2, 4])
def test_spawned_worlds_match_the_single_host_search(spawned, world):
    assert f"ok world={world}" in spawned


@pytest.mark.parametrize("world", [2, 4])
def test_spawned_worlds_match_the_jax_package(spawned, world):
    """The JAX package's indexes (int8 over padded shards, the blobs at
    non-zero row offsets) give the JAX distributed_knn's ids, exact and
    num_candidates at the same world size, and dists within 1e-5."""
    assert f"ok jax world={world}" in spawned


@pytest.mark.parametrize("world", [2, 4])
def test_spawned_ranks_leave_the_ladder_together(spawned, world):
    """Only the last rank's stop_retry, or only rank 0's clock past the
    timeout, still ends the ladder on every rank with one result."""
    assert f"ok exits world={world}" in spawned
