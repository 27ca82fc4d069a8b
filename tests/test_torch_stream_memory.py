"""tests/test_stream_memory.py's peak bound restated for the port: the
streamed batched search's live bytes, counted by the dry run's tracker
(``launch.cost_analysis.CostCount``), on the port's CPU ``knn_batch``
path (``knn_search_batch`` at a fixed budget) at that file's shape:
n = 65,536 rows of d = 32, M = 8 subspaces, 64 clusters, q = 128 queries,
k = 8, budget 256, block_rows 4096.

The reference bounds its compiled program's temp bytes by
16 * block_rows * q * 4 + 6 * n * M * 4 and below 2 * n * q.  The port's
CPU path runs the kernels' plain versions, which make (block_rows, M, q)
fp32 broadcasts a row block, M times the (block_rows, q) tile a kernel
keeps, so the (n, q) bound does not hold for it; it is held, over the
per-block loop (``search.GROUP_OUTPUT_BYTES`` = 0, the reference's
streaming), to 4 * block_rows * M * q * 4 + 6 * n * M * 4, which an
(n, q) fp32 tensor beside its broadcasts would pass.  The grouped search
(the module's default cap) trades that bound for launches: a launch's
rows run up to the cap's (all n here), so its temp bytes follow the cap,
not block_rows.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import search
from repro_torch.core.index import build_index
from repro_torch.launch.cost_analysis import CostCount

N, Q, D, M, C, K = 65536, 128, 32, 8, 64, 8
BUDGET = 256
BLOCK_ROWS = 4096


@pytest.fixture(scope="module")
def forest_and_queries():
    rng = np.random.default_rng(0)
    data = rng.standard_normal((N, D)).astype(np.float32)
    ys = torch.from_numpy(rng.standard_normal((Q, D)).astype(np.float32))
    forest = build_index(data, "squared_euclidean", m=M, num_clusters=C,
                         pccp=False, kmeans_iters=2, device="cpu")
    return forest, ys


def _temp_bytes(forest, ys, cap: int, monkeypatch) -> int:
    """Peak live bytes of one search above its arguments (the index's
    tables and the queries)."""
    monkeypatch.setattr(search, "GROUP_OUTPUT_BYTES", cap)
    tables = [v for v in vars(forest).values() if isinstance(v, torch.Tensor)]
    count = CostCount()
    args = count.add_arguments((tables, ys))
    with count:
        res = search.knn_search_batch(forest, ys, K, BUDGET,
                                      block_rows=BLOCK_ROWS, device="cpu")
    assert res.ids.shape == (Q, K)
    return count.peak_bytes - args


def test_peak_temp_bytes_bounded(forest_and_queries, monkeypatch):
    forest, ys = forest_and_queries
    temp = _temp_bytes(forest, ys, 0, monkeypatch)
    # a few (block_rows, M, q) fp32 broadcasts at once, and the index's
    # table terms: an (n, q) fp32 tensor beside them would not fit
    bound = 4 * BLOCK_ROWS * M * Q * 4 + 6 * N * M * 4
    assert 0 < temp <= bound, (temp, bound)
    assert bound - temp < 4 * N * Q
