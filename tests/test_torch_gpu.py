"""The port's CUDA kernels and search on the card (marked ``gpu``; they skip
where there is no CUDA device).  Nothing here imports JAX, so the file runs
on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import repro_torch.core.index as tidx
import repro_torch.core.search as tsearch
from repro_torch.core.bounds import query_refine_constants
from repro_torch.core.bregman import family_names, get_family
from repro_torch.kernels import bregman_dist, bregman_fused, bregman_ub, ref

pytestmark = pytest.mark.gpu
EPS32 = 2.0 ** -23


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _valid(shape, family, gen):
    raw = torch.randn(shape, generator=gen)
    if get_family(family).domain_low == 0.0:
        return raw.abs() + 0.05
    return raw.clamp(-4.0, 4.0)


@pytest.mark.parametrize("n,m,q", [(4133, 37, 50), (31, 1, 1), (77, 70, 33)])
def test_filter_kernels_match_their_plain_versions(cuda, n, m, q):
    gen = torch.Generator().manual_seed(n)
    alpha, sg, amin, gmax = (torch.randn((n, m), generator=gen)
                             for _ in range(4))
    sg, gmax = sg.abs(), gmax.abs()
    qc, sd = torch.randn((q, m), generator=gen), \
        torch.randn((q, m), generator=gen).abs()
    lb = (amin[:, :, None] + qc.T[None]) - gmax[:, :, None] * sd.T[None]
    qb = torch.quantile(lb, 1.0 - 0.5 ** (1.0 / m), dim=0).T.contiguous()
    qb[:, 0] = lb[0, 0, :]                  # an exact tie in row 0
    args = [t.to(cuda) for t in (alpha, sg, amin, gmax, qc, sd, qb)]
    a, g, am, gm, qc, sd, qb = args
    qsum = qc.sum(-1)
    before = (bregman_ub.launches, bregman_fused.launches)
    ub = bregman_ub.bregman_ub_matrix(a, g, qsum, sd)
    fub, admit = bregman_fused.bregman_filter_prune(a, g, am, gm, qsum, qc,
                                                    sd, qb)
    torch.cuda.synchronize()
    assert (bregman_ub.launches, bregman_fused.launches) == (
        before[0] + 1, before[1] + 1)
    want_ub, want_admit = ref.bregman_filter_prune(a, g, am, gm, qc, sd, qb)
    # M + 2 fp32 terms summed in another order.
    tol = (m + 2) * EPS32 * (a.abs().sum(-1)[:, None]
                             + qc.abs().sum(-1)[None] + g @ sd.T)
    assert bool(((ub - want_ub).abs() <= tol).all())
    assert bool(((fub - want_ub).abs() <= tol).all())
    assert torch.equal(admit, want_admit)
    assert bool(admit[0].all())


@pytest.mark.parametrize("family", family_names())
@pytest.mark.parametrize("q,b,d", [(1, 1, 1), (3, 77, 33), (50, 130, 257)])
def test_refine_kernel_matches_its_plain_version(cuda, family, q, b, d):
    gen = torch.Generator().manual_seed(b)
    rows = _valid((q, b, d), family, gen).to(cuda)
    c = query_refine_constants(_valid((q, d), family, gen).to(cuda),
                               get_family(family))
    got = bregman_dist.bregman_refine_batch(rows, c["grad"], c["c_y"],
                                            family)
    want = ref.bregman_refine_batch(rows, c["grad"], c["c_y"], family)
    # The refine form cancels: scale by the summed terms' magnitude.
    x = rows.double()
    scale = (ref.PHIS[family](x).abs().sum(-1)
             + torch.einsum("qbd,qd->qb", x, c["grad"].double()).abs()
             + c["c_y"].double().abs()[:, None])
    assert bool(((got - want).abs() <= d * EPS32 * scale).all())
    one = bregman_dist.bregman_refine(rows[0], c["grad"][0], c["c_y"][0],
                                      family)
    assert torch.allclose(one, got[0], rtol=0, atol=0)


def test_wrappers_refuse_mixed_devices_and_layouts(cuda):
    a = torch.ones((8, 3), device=cuda)
    with pytest.raises(ValueError, match="must be contiguous"):
        bregman_ub.bregman_ub_matrix(a, torch.ones((3, 8), device=cuda).T,
                                     torch.ones(2, device=cuda),
                                     torch.ones((2, 3), device=cuda))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bregman_ub.bregman_ub_matrix(a, a, torch.ones(2),
                                     torch.ones((2, 3), device=cuda))


@pytest.mark.parametrize("family", family_names())
def test_search_on_the_card_matches_the_cpu(cuda, family):
    gen = torch.Generator().manual_seed(3)
    data = _valid((3000, 24), family, gen).numpy()
    forest = tidx.build_index(data, family, m=6, device="cpu")
    moved = tidx.forest_from_numpy(
        tidx.forest_to_numpy(forest), family_name=family,
        partition_idx=forest.partition.idx,
        partition_mask=forest.partition.mask, d=forest.d,
        num_clusters=forest.num_clusters, device=cuda)
    queries = np.ascontiguousarray(data[:12] * 1.01)
    counts = (bregman_ub.launches, bregman_fused.launches,
              bregman_dist.launches)
    got = tsearch.knn_batch(moved, queries, 10, budget=64, block_rows=512,
                            device=cuda)
    assert all(after > was for after, was in zip(
        (bregman_ub.launches, bregman_fused.launches,
         bregman_dist.launches), counts, strict=True))
    want = tsearch.knn_batch(forest, queries, 10, budget=64,
                             block_rows=512, device="cpu")
    assert torch.equal(got.ids.cpu(), want.ids)
    assert torch.allclose(got.dists.cpu(), want.dists, rtol=1e-4,
                          atol=1e-4)
    bf_ids, _ = tsearch.brute_force_knn(data, queries, 10, family,
                                        device=cuda)
    assert torch.equal(got.ids, bf_ids.to(got.ids.dtype))
