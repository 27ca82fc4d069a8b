"""The port's paper baselines (core/baselines.py) against the JAX package's,
on the same seeded numpy data.

Both run on the host in numpy, with every generator value in float32 (the
reference's through jnp with 64-bit values off, the port's through its
torch families).  Held equal: the tree's node count, the ids of every
search, the I/O ``stats``; dists within 1e-5 (rtol and atol).  The
reference's own assertions (tests/test_baselines.py) are held on the port:
exact against the linear scan, and pruning on clustered data.
"""

import numpy as np
import pytest

from repro.core import baselines as jb

from repro_torch.core import baselines as tb

from torch_parity import sample

TOL = dict(rtol=1e-5, atol=1e-5)
QUERIES = 3
# The reference builds its tree through eager jnp, which compiles for
# every node's row count: every BBTree case shares one small data set.
TREE_SHAPE = (64, 12)


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], **TOL)
    assert got[-1] == want[-1]


@pytest.mark.parametrize("family", ["squared_euclidean", "itakura_saito",
                                    "exponential"])
@pytest.mark.parametrize("bound", ["geodesic", "tuple"])
def test_bbtree_matches_jax(family, bound):
    data = sample(family, TREE_SHAPE, seed=0)
    port = tb.BBTree(data, family, leaf_size=8, bound=bound)
    ref = jb.BBTree(data, family, leaf_size=8, bound=bound)
    assert port.nodes_built == ref.nodes_built
    for qi in range(QUERIES):
        y = data[qi * 7]
        got = port.knn(y, 5)
        _same(got, ref.knn(y, 5))
        _, lin_d, _ = tb.linear_scan(data, y, 5, family)
        np.testing.assert_allclose(np.sort(got[1]), np.sort(lin_d),
                                   rtol=1e-6, atol=1e-8)
        assert got[2]["distance_evals"] <= len(data)


@pytest.mark.parametrize("family", ["squared_euclidean", "itakura_saito"])
def test_bbtree_range_query_matches_jax(family):
    data = sample(family, TREE_SHAPE, seed=0)
    port = tb.BBTree(data, family, leaf_size=8)
    ref = jb.BBTree(data, family, leaf_size=8)
    y = data[3]
    dist = tb._distance(port.family, data, y)
    r = float(np.quantile(dist, 0.1))
    ids, stats = port.range_query(y, r)
    want_ids, want_stats = ref.range_query(y, r)
    np.testing.assert_array_equal(ids, want_ids)
    assert stats == want_stats
    np.testing.assert_array_equal(ids, np.sort(np.flatnonzero(dist <= r)))


@pytest.mark.parametrize("family", ["squared_euclidean", "itakura_saito",
                                    "exponential"])
def test_vafile_matches_jax(family):
    data = sample(family, (300, 10), seed=2)
    port, ref = tb.VAFile(data, family, bits=4), jb.VAFile(data, family,
                                                           bits=4)
    np.testing.assert_array_equal(port.cells, ref.cells)
    np.testing.assert_array_equal(port.bounds, ref.bounds)
    for qi in range(QUERIES):
        y = data[qi * 11]
        got = port.knn(y, 5)
        _same(got, ref.knn(y, 5))
        _, lin_d, _ = tb.linear_scan(data, y, 5, family)
        np.testing.assert_allclose(np.sort(got[1]), np.sort(lin_d),
                                   rtol=1e-6, atol=1e-8)
        assert got[2]["candidates"] <= len(data)


@pytest.mark.parametrize("family", ["burg", "shannon"])
def test_linear_scan_matches_jax(family):
    data = sample(family, (300, 10), seed=3)
    for qi in range(QUERIES):
        y = sample(family, (10,), seed=10 + qi)
        _same(tb.linear_scan(data, y, 5, family),
              jb.linear_scan(data, y, 5, family))


def test_bbtree_prunes():
    """On clustered data the tree evaluates far fewer than n distances."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=10.0, size=(8, 8))
    data = (centers[rng.integers(0, 8, 2000)]
            + rng.normal(scale=0.1, size=(2000, 8)))
    tree = tb.BBTree(data, "squared_euclidean", leaf_size=32)
    _, _, stats = tree.knn(data[0], 3)
    assert stats["distance_evals"] < 800, stats
