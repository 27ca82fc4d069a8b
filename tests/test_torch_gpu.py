"""The port's CUDA kernels and search on the card (marked ``gpu``; they skip
where there is no CUDA device).  Nothing here imports JAX, so the file runs
on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import repro_torch.core.index as tidx
import repro_torch.core.quantize as tqz
import repro_torch.core.search as tsearch
from repro_torch.core.bounds import query_refine_constants
from repro_torch.core.bregman import family_names, get_family
from repro_torch.core.index import cold_point_fields
from repro_torch.core.tiered import TieredPointStore
from repro_torch.kernels import bregman_dist, bregman_fused, bregman_prune, \
    bregman_ub, flash_attention, ops, pccp_corr, ref

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


def _span_operands(n, m, q, seed, tie_row=0):
    """fp32 filter and corner tables with a mixed admit mask; ``tie_row``
    ties its bound exactly in subspace 0 for every query."""
    gen = torch.Generator().manual_seed(seed)
    alpha, amin = (torch.randn((n, m), generator=gen) for _ in range(2))
    sg, gmax = (torch.randn((n, m), generator=gen).abs() for _ in range(2))
    qc = torch.randn((q, m), generator=gen)
    sd = torch.randn((q, m), generator=gen).abs()
    rows = torch.randperm(n, generator=gen)[:1500]
    lb = (amin[rows, :, None] + qc.T[None]) - gmax[rows, :, None] * sd.T[None]
    qb = torch.quantile(lb, 1.0 - 0.5 ** (1.0 / m), dim=0).T.contiguous()
    qb[:, 0] = (amin[tie_row, 0] + qc[:, 0]) - gmax[tie_row, 0] * sd[:, 0]
    return alpha, sg, amin, gmax, qc, sd, qb


def _ub_tolerance(alpha, sg, qc, sd):
    """(M + 2) fp32 terms summed in another order than the plain version's:
    (M + 2) * eps32 times the magnitudes of the summed terms."""
    m = alpha.shape[1]
    return (m + 2) * EPS32 * (alpha.abs().sum(-1)[:, None]
                              + qc.abs().sum(-1)[None] + sg @ sd.T)


# (n, M, q, bn, listed blocks): non-contiguous lists, short last blocks
# (n not a multiple of bn), one-block lists, M odd and even (70: a padded
# row stride), M split into shared-memory chunks (300, 700: neither a
# multiple of the chunk), the query tables held for the CTA's life or
# chunked (700; 300 at q = 50), q from 1 to 65 (two query tiles).
SPAN_CASES = [
    (5000, 37, 14, 1024, [0, 2, 4]),
    (5000, 37, 13, 1024, [4]),
    (3000, 39, 1, 512, [1, 3, 5]),
    (3000, 70, 33, 512, [0, 1, 5]),
    (2000, 300, 50, 256, [0, 7]),
    (2000, 33, 65, 384, [0, 2, 5]),
    (1500, 700, 14, 200, [3, 7]),
    (12293, 39, 14, 4096, [0, 1, 2, 3]),
    (4096, 40, 64, 4096, [0]),
]


@pytest.mark.parametrize("n,m,q,bn,listed", SPAN_CASES)
def test_filter_prune_blocks_matches_its_plain_version(cuda, n, m, q, bn,
                                                       listed):
    first = listed[0] * bn
    ops_ = [t.to(cuda) for t in _span_operands(n, m, q, n + m + q,
                                               tie_row=first)]
    a, g, am, gm, qc, sd, qb = ops_
    blocks = torch.tensor(listed, dtype=torch.int32, device=cuda)
    before = bregman_fused.launches
    ub, admit = bregman_fused.bregman_filter_prune_blocks(
        a, g, am, gm, qc.sum(-1), qc, sd, qb, blocks, bn)
    torch.cuda.synchronize()
    assert bregman_fused.launches == before + 1
    assert ub.shape == admit.shape == (len(listed) * bn, q)
    want_ub, want_admit = ref.bregman_filter_prune_blocks(
        a, g, am, gm, qc, sd, qb, blocks, bn)
    assert admit.dtype == torch.int32 and torch.equal(admit, want_admit)
    rows = ref.block_rows(blocks, bn)
    real = rows < n
    assert bool(torch.isinf(ub[~real]).all()) and not admit[~real].any()
    idx = rows[real]
    tol = _ub_tolerance(a[idx], g[idx], qc, sd)
    assert bool(((ub[real] - want_ub[real]).abs() <= tol).all())
    assert bool(admit[0].all())                     # the tie row
    assert 0 < int(admit.sum()) < int(real.sum()) * q or q * n < 64
    # Each listed block's tile is the one-block kernel's on its rows.
    for i, b in enumerate(listed):
        s = slice(b * bn, min((b + 1) * bn, n))
        one_ub, one_admit = bregman_fused.bregman_filter_prune(
            a[s], g[s], am[s], gm[s], qc.sum(-1), qc, sd, qb)
        rows_b = s.stop - s.start
        got = slice(i * bn, i * bn + rows_b)
        assert torch.equal(one_ub.view(torch.int32), ub[got].view(torch.int32))
        assert torch.equal(one_admit, admit[got])


@pytest.mark.parametrize("q", [1, 13, 14, 33, 50, 65])
@pytest.mark.parametrize("n,m,skip", [(5000, 39, 0), (4133, 1, 3),
                                      (2000, 70, 1), (700, 300, 5)])
def test_ub_span_matches_its_plain_version(cuda, n, m, skip, q):
    """#1 over a row span of any length, whose start need not be 16-byte
    aligned (``skip`` rows into the table)."""
    a, g, _, _, qc, sd, _ = [t.to(cuda)
                             for t in _span_operands(n, m, q, n + q)]
    a, g = a[skip:], g[skip:]
    before = bregman_ub.launches
    ub = bregman_ub.bregman_ub_matrix(a, g, qc.sum(-1), sd)
    torch.cuda.synchronize()
    assert bregman_ub.launches == before + 1
    want = ref.bregman_ub_matrix(a, g, qc, sd)
    assert ub.shape == want.shape == (n - skip, q)
    assert bool(((ub - want).abs() <= _ub_tolerance(a, g, qc, sd)).all())
    # A row's totals do not depend on the span it was launched in.
    part = bregman_ub.bregman_ub_matrix(a[17:300], g[17:300], qc.sum(-1), sd)
    assert torch.equal(part.view(torch.int32), ub[17:300].view(torch.int32))


def test_filter_prune_blocks_refuses_what_it_cannot_run(cuda):
    a = torch.ones((64, 3), device=cuda)
    q = torch.ones((2, 3), device=cuda)
    s = torch.ones(2, device=cuda)
    ok = torch.tensor([0], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="must be torch.int32"):
        bregman_fused.bregman_filter_prune_blocks(a, a, a, a, s, q, q, q,
                                                  ok.long(), 32)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bregman_fused.bregman_filter_prune_blocks(a, a, a, a, s, q, q, q,
                                                  ok.cpu(), 32)
    with pytest.raises(ValueError, match="bn must be a positive int"):
        bregman_fused.bregman_filter_prune_blocks(a, a, a, a, s, q, q, q,
                                                  ok, 0)
    ub, admit = bregman_fused.bregman_filter_prune_blocks(
        a, a, a, a, s, q, q, q, ok[:0], 32)
    assert ub.shape == admit.shape == (0, 2)


# (n, M, q) of #5's span entry: Deep's row block, ragged shapes, M odd
# (16-byte copies of an aligned span) and even (4-byte copies to a padded
# stride), M chunked (300), q past one query tile (65).
PRUNE_SHAPES = [(4096, 39, 14), (4133, 37, 50), (31, 1, 1), (77, 70, 33),
                (4096, 33, 50), (1000, 300, 13), (500, 40, 65)]


@pytest.mark.parametrize("skip", [0, 3])
@pytest.mark.parametrize("n,m,q", PRUNE_SHAPES)
def test_prune_span_matches_its_plain_version_and_the_fused_admit(
        cuda, n, m, q, skip):
    """#5's span entry over rows ``skip`` on (3: no span 16-byte aligned):
    bit-equal to its plain version and to #3's admit on the same rows, a
    row's bits the same in any span."""
    ops_ = [t.to(cuda) for t in _span_operands(n, m, q, n + m + q + 3,
                                               tie_row=skip)]
    a, g, am, gm, qc, sd, qb = ops_
    am, gm, a, g = am[skip:], gm[skip:], a[skip:], g[skip:]
    before = bregman_prune.launches
    admit = bregman_prune.bregman_prune_mask(am, gm, qc, sd, qb)
    torch.cuda.synchronize()
    assert bregman_prune.launches == before + 1
    assert admit.dtype == torch.int32 and admit.shape == (n - skip, q)
    assert torch.equal(admit, ref.bregman_prune_mask(am, gm, qc, sd, qb))
    _, fused = bregman_fused.bregman_filter_prune(a, g, am, gm, qc.sum(-1),
                                                  qc, sd, qb)
    assert torch.equal(admit, fused)
    assert bool(admit[0].all())                     # the tie row
    if (n - skip) * q >= 64:
        assert 0 < int(admit.sum()) < (n - skip) * q
    part = bregman_prune.bregman_prune_mask(am[5:29], gm[5:29], qc, sd, qb)
    assert torch.equal(part, admit[5:29])


@pytest.mark.parametrize("n,m,q,bn,listed", SPAN_CASES
                         + [(n, m, q, 1024, [0, (n - 1) // 1024])
                            for n, m, q in PRUNE_SHAPES])
def test_prune_blocks_matches_its_plain_version_and_the_fused_admit(
        cuda, n, m, q, bn, listed):
    """#5's block-list entry: bit-equal to its plain version and to #3's
    admit over the same list, rows past n inert, each listed block's tile
    the span entry's on its rows."""
    listed = sorted(set(listed))
    first = listed[0] * bn
    ops_ = [t.to(cuda) for t in _span_operands(n, m, q, n + m + q + 4,
                                               tie_row=first)]
    a, g, am, gm, qc, sd, qb = ops_
    blocks = torch.tensor(listed, dtype=torch.int32, device=cuda)
    before = bregman_prune.launches
    admit = bregman_prune.bregman_prune_mask_blocks(am, gm, qc, sd, qb,
                                                    blocks, bn)
    torch.cuda.synchronize()
    assert bregman_prune.launches == before + 1
    assert admit.dtype == torch.int32 and admit.shape == (len(listed) * bn,
                                                          q)
    assert torch.equal(admit, ref.bregman_prune_mask_blocks(
        am, gm, qc, sd, qb, blocks, bn))
    _, fused = bregman_fused.bregman_filter_prune_blocks(
        a, g, am, gm, qc.sum(-1), qc, sd, qb, blocks, bn)
    assert torch.equal(admit, fused)
    real = ref.block_rows(blocks, bn) < n
    assert not admit[~real].any()
    assert bool(admit[0].all())                     # the tie row
    assert 0 < int(admit.sum()) < int(real.sum()) * q or q * n < 64
    for i, b in enumerate(listed):
        s = slice(b * bn, min((b + 1) * bn, n))
        one = bregman_prune.bregman_prune_mask(am[s], gm[s], qc, sd, qb)
        assert torch.equal(one, admit[i * bn:i * bn + s.stop - s.start])


def test_prune_blocks_refuses_what_it_cannot_run(cuda):
    c = torch.zeros((64, 3), device=cuda)
    q = torch.ones((2, 3), device=cuda)
    ok = torch.tensor([0], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="must be torch.int32"):
        bregman_prune.bregman_prune_mask_blocks(c, c, q, q, q, ok.long(), 32)
    with pytest.raises(ValueError, match="must be torch.float32"):
        bregman_prune.bregman_prune_mask_blocks(c.double(), c, q, q, q, ok,
                                                32)
    with pytest.raises(ValueError, match="bn must be a positive int"):
        bregman_prune.bregman_prune_mask_blocks(c, c, q, q, q, ok, 0)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bregman_prune.bregman_prune_mask_blocks(c, c, q, q, q, ok.cpu(), 32)
    before = bregman_prune.launches
    admit = bregman_prune.bregman_prune_mask_blocks(c, c, q, q, q, ok[:0],
                                                    32)
    assert admit.shape == (0, 2) and bregman_prune.launches == before


@pytest.mark.parametrize("quantize", [False, True])
def test_grouped_search_on_the_card_equals_the_per_block_loop(
        cuda, monkeypatch, quantize):
    """The grouped filter and prune (default cap; a cap of three blocks,
    so that one search makes several groups) give the per-block loop's
    results (a cap below one block) bit for bit, stats included, on a
    forest whose gate rejects blocks."""
    rng = np.random.default_rng(0)
    per, d = 1000, 8
    data = np.concatenate([rng.normal(size=(per, d)) + 40.0 * j
                           for j in range(6)]).astype(np.float32)
    queries = (data[rng.integers(0, per, 8)] + 0.01).astype(np.float32)
    forest = tidx.build_index(data, "squared_euclidean", m=2,
                              num_clusters=24, seed=0, quantize=quantize,
                              device=cuda)

    def run(cap):
        monkeypatch.setattr(tsearch, "GROUP_OUTPUT_BYTES", cap)
        counts = _counts(quantize)
        res, stats = tsearch.knn_search_batch_stats(
            forest, queries, 10, 64, block_rows=256, device=cuda)
        batch = tsearch.knn_batch(forest, queries, 10, block_rows=256,
                                  return_stats=True, device=cuda)
        launched = [a - b for a, b in zip(_counts(quantize), counts,
                                          strict=True)]
        return res, stats, batch, launched

    want, want_stats, want_batch, per_block = run(0)
    assert 0 < want_stats["num_blocks_run"] < want_stats["num_blocks"]
    for cap in (3 * 256 * 8 * 8, 1 << 27):
        got, got_stats, got_batch, launched = run(cap)
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), (cap, f)
        for key in want_stats:
            if key == "tau_admit":
                assert torch.equal(got_stats[key], want_stats[key])
            else:
                assert got_stats[key] == want_stats[key], key
        assert got_batch[1] == want_batch[1]
        for f in got_batch[0]._fields:
            assert torch.equal(getattr(got_batch[0], f),
                               getattr(want_batch[0], f)), (cap, f)
        # The filter #1 (#2 in int8) and the fused prune #3 (#4) take
        # fewer launches grouped; the refine one an attempt.
        assert launched[0] < per_block[0]
        assert launched[1] < per_block[1] and launched[2] == per_block[2]
        # The unfused comparator gives the same result bit for bit, its
        # prune-only kernel (#5, #6 in int8) once a group of admitted
        # blocks.
        attr = "launches_quant" if quantize else "launches"
        before = getattr(bregman_prune, attr)
        unfused = tsearch._knn_search_batch_unfused(forest, queries, 10, 64,
                                                    256, device=cuda)
        for f in unfused._fields:
            assert torch.equal(getattr(unfused, f), getattr(want, f)), f
        pruned = getattr(bregman_prune, attr) - before
        gb = tsearch._group_blocks(256, queries.shape[0], 4)
        assert pruned == -(-want_stats["num_blocks_run"] // gb)


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


def _quant_table(n, m, gen, nonneg=False):
    """Int8 codes reaching -128 and 127 with a per-row (scale, zp); row 1
    is a constant row (scale 0)."""
    codes = torch.randint(-128, 128, (n, m), generator=gen,
                          dtype=torch.int32).to(torch.int8)
    codes[0, 0], codes[-1, -1] = -128, 127
    scale = torch.rand(n, generator=gen) * 0.1 + 1e-3
    zp = torch.randn(n, generator=gen)
    if n > 1:
        codes[1], scale[1] = 0, 0.0
    if nonneg:
        zp = zp.abs() + 128.0 * scale
    return codes, scale, zp


@pytest.mark.parametrize("n,m,q", [(4133, 37, 50), (31, 1, 1), (31, 70, 33)])
def test_quant_filter_kernels_match_their_plain_versions(cuda, n, m, q):
    gen = torch.Generator().manual_seed(n + m)
    tables = [t for i in range(4)
              for t in _quant_table(n, m, gen, nonneg=i in (1, 3))]
    qc, sd = torch.randn((q, m), generator=gen), \
        torch.randn((q, m), generator=gen).abs()
    amin = tqz.dequantize_stats(*tables[6:9])
    gmax = tqz.dequantize_stats(*tables[9:12])
    lb = (amin[:, :, None] + qc.T[None]) - gmax[:, :, None] * sd.T[None]
    qb = torch.quantile(lb, 1.0 - 0.5 ** (1.0 / m), dim=0).T.contiguous()
    qb[:, 0] = lb[0, 0, :]                  # an exact tie in row 0
    tables = [t.to(cuda) for t in tables]
    qc, sd, qb = qc.to(cuda), sd.to(cuda), qb.to(cuda)
    qsum, sdsum = qc.sum(-1), sd.sum(-1)
    before = (bregman_ub.launches_quant, bregman_fused.launches_quant)
    ub = bregman_ub.bregman_ub_matrix_quant(*tables[:6], qsum, sd, sdsum)
    fub, admit = bregman_fused.bregman_filter_prune_quant(*tables, qsum, qc,
                                                          sd, sdsum, qb)
    torch.cuda.synchronize()
    assert (bregman_ub.launches_quant, bregman_fused.launches_quant) == (
        before[0] + 1, before[1] + 1)
    want_ub, want_admit = ref.bregman_filter_prune_quant(*tables, qc, sd, qb)
    a_q, a_s, a_z, g_q, g_s, g_z = tables[:6]
    # M + 2 fp32 terms in another order, scaled by their magnitudes.
    mags = ((a_s * a_q.float().sum(-1)).abs() + (m * a_z).abs())[:, None] \
        + qc.sum(-1).abs()[None] + g_s.abs()[:, None] * (g_q.float().abs()
                                                         @ sd.T) \
        + (g_z[:, None] * sd.sum(-1)[None]).abs()
    tol = (m + 2) * EPS32 * mags
    assert bool(((ub - want_ub).abs() <= tol).all())
    assert bool(((fub - want_ub).abs() <= tol).all())
    assert torch.equal(admit, want_admit)
    assert bool(admit[0].all())
    if n * q >= 64:
        assert 0 < int(admit.sum()) < n * q


def _span_operands_quant(n, m, q, seed, tie_row=0):
    """Int8 filter and corner codes with their decode (codes at -128 and
    127, a constant row of scale 0), a mixed admit mask, and ``tie_row``'s
    decoded lower bound tying qb exactly in subspace 0 for every query."""
    gen = torch.Generator().manual_seed(seed)
    tables = [t for i in range(4)
              for t in _quant_table(n, m, gen, nonneg=i in (1, 3))]
    qc = torch.randn((q, m), generator=gen)
    sd = torch.randn((q, m), generator=gen).abs()
    amin = tqz.dequantize_stats(*tables[6:9])
    gmax = tqz.dequantize_stats(*tables[9:12])
    rows = torch.randperm(n, generator=gen)[:1500]
    lb = (amin[rows, :, None] + qc.T[None]) - gmax[rows, :, None] * sd.T[None]
    qb = torch.quantile(lb, 1.0 - 0.5 ** (1.0 / m), dim=0).T.contiguous()
    qb[:, 0] = (amin[tie_row, 0] + qc[:, 0]) - gmax[tie_row, 0] * sd[:, 0]
    return tables, qc, sd, qb


def _ub_tolerance_quant(tables, qc, sd):
    """(M + 2) * eps32 times the magnitudes of the int8 UB's summed terms
    (the dot's by magnitude: signed codes may cancel)."""
    a_q, a_s, a_z, g_q, g_s, g_z = tables[:6]
    m = a_q.shape[1]
    mags = ((a_s * a_q.float().sum(-1)).abs() + (m * a_z).abs())[:, None] \
        + qc.sum(-1).abs()[None] + g_s.abs()[:, None] * (g_q.float().abs()
                                                         @ sd.T) \
        + (g_z[:, None] * sd.sum(-1)[None]).abs()
    return (m + 2) * EPS32 * mags


@pytest.mark.parametrize("q", [1, 13, 14, 33, 50, 65])
@pytest.mark.parametrize("n,m,skip", [(5000, 39, 0), (4133, 1, 3),
                                      (2000, 70, 1), (700, 300, 5)])
def test_ub_span_quant_matches_its_plain_version(cuda, n, m, skip, q):
    """#2 over a row span of any length, whose codes and decode columns
    need not be 16-byte aligned (``skip`` rows into the tables): within
    (M + 2) eps32 of its terms, a row's totals the same bits in any span."""
    tables, qc, sd, _ = _span_operands_quant(n, m, q, n + q + 1)
    filt = [t[skip:].to(cuda) for t in tables[:6]]
    qc, sd = qc.to(cuda), sd.to(cuda)
    qsum, sdsum = qc.sum(-1), sd.sum(-1)
    before = bregman_ub.launches_quant
    ub = bregman_ub.bregman_ub_matrix_quant(*filt, qsum, sd, sdsum)
    torch.cuda.synchronize()
    assert bregman_ub.launches_quant == before + 1
    want = ref.bregman_ub_matrix_quant(*filt, qc, sd)
    assert ub.shape == want.shape == (n - skip, q)
    assert bool(((ub - want).abs()
                 <= _ub_tolerance_quant(filt, qc, sd)).all())
    part = bregman_ub.bregman_ub_matrix_quant(
        *(t[17:300] for t in filt), qsum, sd, sdsum)
    assert torch.equal(part.view(torch.int32), ub[17:300].view(torch.int32))


@pytest.mark.parametrize("n,m,q,bn,listed", SPAN_CASES)
def test_prune_blocks_quant_matches_its_plain_version_and_the_fused_admit(
        cuda, n, m, q, bn, listed):
    """#6's block-list entry on #3's shapes: bit-equal to its plain version
    and to #4's admit over the same list, rows past n inert, each listed
    block's tile the one-span entry's on its rows."""
    first = listed[0] * bn
    tables, qc, sd, qb = _span_operands_quant(n, m, q, n + m + q + 2,
                                              tie_row=first)
    tables = [t.to(cuda) for t in tables]
    qc, sd, qb = qc.to(cuda), sd.to(cuda), qb.to(cuda)
    corners = tables[6:]
    blocks = torch.tensor(listed, dtype=torch.int32, device=cuda)
    before = bregman_prune.launches_quant
    admit = bregman_prune.bregman_prune_mask_blocks_quant(*corners, qc, sd,
                                                          qb, blocks, bn)
    torch.cuda.synchronize()
    assert bregman_prune.launches_quant == before + 1
    assert admit.dtype == torch.int32 and admit.shape == (len(listed) * bn,
                                                          q)
    want = ref.bregman_prune_mask_blocks_quant(*corners, qc, sd, qb, blocks,
                                               bn)
    assert torch.equal(admit, want)
    _, fused = bregman_fused.bregman_filter_prune_blocks_quant(
        *tables, qc.sum(-1), qc, sd, sd.sum(-1), qb, blocks, bn)
    assert torch.equal(admit, fused)
    real = ref.block_rows(blocks, bn) < n
    assert not admit[~real].any()
    assert bool(admit[0].all())                     # the tie row
    assert 0 < int(admit.sum()) < int(real.sum()) * q or q * n < 64
    for i, b in enumerate(listed):
        s = slice(b * bn, min((b + 1) * bn, n))
        one = bregman_prune.bregman_prune_mask_quant(
            *(t[s] for t in corners), qc, sd, qb)
        assert torch.equal(one, admit[i * bn:i * bn + s.stop - s.start])


def test_prune_blocks_quant_refuses_what_it_cannot_run(cuda):
    c = torch.zeros((64, 3), dtype=torch.int8, device=cuda)
    r = torch.ones(64, device=cuda)
    q = torch.ones((2, 3), device=cuda)
    corners = [c, r, r, c, r, r]
    ok = torch.tensor([0], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="must be torch.int32"):
        bregman_prune.bregman_prune_mask_blocks_quant(*corners, q, q, q,
                                                      ok.long(), 32)
    with pytest.raises(ValueError, match="must be torch.int8"):
        bregman_prune.bregman_prune_mask_blocks_quant(
            r[:, None].expand(64, 3).contiguous(), *corners[1:], q, q, q,
            ok, 32)
    with pytest.raises(ValueError, match="bn must be a positive int"):
        bregman_prune.bregman_prune_mask_blocks_quant(*corners, q, q, q, ok,
                                                      0)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bregman_prune.bregman_prune_mask_blocks_quant(*corners, q, q, q,
                                                      ok.cpu(), 32)
    before = bregman_prune.launches_quant
    admit = bregman_prune.bregman_prune_mask_blocks_quant(*corners, q, q, q,
                                                          ok[:0], 32)
    assert admit.shape == (0, 2) and bregman_prune.launches_quant == before


@pytest.mark.parametrize("n,m,q,bn,listed", SPAN_CASES)
def test_filter_prune_blocks_quant_matches_its_plain_version(cuda, n, m, q,
                                                             bn, listed):
    """#4's block-list entry on #3's shapes (M odd, even and chunked, q to
    65, short last blocks): the admit bit-equal to the plain version, the
    UB within (M + 2) eps32 of its terms, rows past n inert, each listed
    block's tile the one-block entry's bit for bit."""
    first = listed[0] * bn
    tables, qc, sd, qb = _span_operands_quant(n, m, q, n + m + q,
                                              tie_row=first)
    tables = [t.to(cuda) for t in tables]
    qc, sd, qb = qc.to(cuda), sd.to(cuda), qb.to(cuda)
    qsum, sdsum = qc.sum(-1), sd.sum(-1)
    blocks = torch.tensor(listed, dtype=torch.int32, device=cuda)
    before = bregman_fused.launches_quant
    ub, admit = bregman_fused.bregman_filter_prune_blocks_quant(
        *tables, qsum, qc, sd, sdsum, qb, blocks, bn)
    torch.cuda.synchronize()
    assert bregman_fused.launches_quant == before + 1
    assert ub.shape == admit.shape == (len(listed) * bn, q)
    want_ub, want_admit = ref.bregman_filter_prune_blocks_quant(
        *tables, qc, sd, qb, blocks, bn)
    assert admit.dtype == torch.int32 and torch.equal(admit, want_admit)
    rows = ref.block_rows(blocks, bn)
    real = rows < n
    assert bool(torch.isinf(ub[~real]).all()) and not admit[~real].any()
    idx = rows[real]
    tol = _ub_tolerance_quant([t[idx] for t in tables[:6]], qc, sd)
    assert bool(((ub[real] - want_ub[real]).abs() <= tol).all())
    assert bool(admit[0].all())                     # the tie row
    assert 0 < int(admit.sum()) < int(real.sum()) * q or q * n < 64
    for i, b in enumerate(listed):
        s = slice(b * bn, min((b + 1) * bn, n))
        one_ub, one_admit = bregman_fused.bregman_filter_prune_quant(
            *(t[s] for t in tables), qsum, qc, sd, sdsum, qb)
        got = slice(i * bn, i * bn + s.stop - s.start)
        assert torch.equal(one_ub.view(torch.int32), ub[got].view(torch.int32))
        assert torch.equal(one_admit, admit[got])


def test_filter_prune_blocks_quant_refuses_what_it_cannot_run(cuda):
    c = torch.zeros((64, 3), dtype=torch.int8, device=cuda)
    r = torch.ones(64, device=cuda)
    q = torch.ones((2, 3), device=cuda)
    s = torch.ones(2, device=cuda)
    tables = [c, r, r] * 4
    ok = torch.tensor([0], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="must be torch.int32"):
        bregman_fused.bregman_filter_prune_blocks_quant(
            *tables, s, q, q, s, q, ok.long(), 32)
    with pytest.raises(ValueError, match="must be torch.int8"):
        bregman_fused.bregman_filter_prune_blocks_quant(
            *[r[:, None].expand(64, 3).contiguous()] + tables[1:], s, q, q,
            s, q, ok, 32)
    with pytest.raises(ValueError, match="bn must be a positive int"):
        bregman_fused.bregman_filter_prune_blocks_quant(
            *tables, s, q, q, s, q, ok, 0)
    ub, admit = bregman_fused.bregman_filter_prune_blocks_quant(
        *tables, s, q, q, s, q, ok[:0], 32)
    assert ub.shape == admit.shape == (0, 2)


@pytest.mark.parametrize("family", family_names())
@pytest.mark.parametrize("q,b,d", [(1, 1, 1), (33, 31, 33), (50, 130, 257)])
def test_quant_refine_kernel_matches_its_plain_version(cuda, family, q, b,
                                                       d):
    gen = torch.Generator().manual_seed(b + d)
    codes, scale, zp = _quant_table(q * b, d, gen)
    if get_family(family).domain_low == 0.0:
        zp = zp.abs() * 2.0                 # some decoded values clamp
    codes = codes.reshape(q, b, d).to(cuda)
    scale, zp = scale.reshape(q, b).to(cuda), zp.reshape(q, b).to(cuda)
    c = query_refine_constants(_valid((q, d), family, gen).to(cuda),
                               get_family(family))
    got = bregman_dist.bregman_refine_batch_quant(codes, scale, zp,
                                                  c["grad"], c["c_y"],
                                                  family)
    want = ref.bregman_refine_batch_quant(codes, scale, zp, c["grad"],
                                          c["c_y"], family)
    x = tqz.dequantize_rows(codes, scale, zp, family).double()
    mags = (ref.PHIS[family](x).abs().sum(-1)
            + torch.einsum("qbd,qd->qb", x, c["grad"].double()).abs()
            + c["c_y"].double().abs()[:, None])
    assert bool(((got - want).abs() <= d * EPS32 * mags).all())


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one byte past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == 1
    return out


@pytest.mark.parametrize("family", family_names())
@pytest.mark.parametrize("d", [1, 33, 256, 257])
def test_quant_refine_kernel_on_unaligned_rows(cuda, family, d):
    """#8 on codes whose base is not 16-byte aligned (byte loads) against
    its plain version, and at d = 256 bit-equal to the aligned codes (16-
    byte loads): the same sums in the same order."""
    q, b = 5, 70
    gen = torch.Generator().manual_seed(d)
    codes, scale, zp = _quant_table(q * b, d, gen)
    if get_family(family).domain_low == 0.0:
        zp = zp.abs() * 2.0
    codes = codes.reshape(q, b, d).to(cuda)
    scale, zp = scale.reshape(q, b).to(cuda), zp.reshape(q, b).to(cuda)
    c = query_refine_constants(_valid((q, d), family, gen).to(cuda),
                               get_family(family))
    args = (scale, zp, c["grad"], c["c_y"], family)
    got = bregman_dist.bregman_refine_batch_quant(_unaligned(codes), *args)
    aligned = bregman_dist.bregman_refine_batch_quant(codes, *args)
    want = ref.bregman_refine_batch_quant(codes, *args)
    x = tqz.dequantize_rows(codes, scale, zp, family).double()
    mags = (ref.PHIS[family](x).abs().sum(-1)
            + torch.einsum("qbd,qd->qb", x, c["grad"].double()).abs()
            + c["c_y"].double().abs()[:, None])
    assert bool(((got - want).abs() <= d * EPS32 * mags).all())
    assert torch.equal(got.view(torch.int32), aligned.view(torch.int32))


@pytest.mark.parametrize("family", ["exponential", "burg"])
@pytest.mark.parametrize("d", [16, 33, 192, 256, 600])
def test_quant_refine_is_bit_invariant_to_b_and_position(cuda, family, d):
    """One (query, row) pair's distance from #8 has the same bits alone
    (b = 1), in a ragged batch at another position, and from an unaligned
    base: the summation order depends on d alone."""
    gen = torch.Generator().manual_seed(d + 1)
    codes, scale, zp = _quant_table(3 * 301, d, gen)
    if get_family(family).domain_low == 0.0:
        zp = zp.abs() * 2.0
    codes = codes.reshape(3, 301, d).to(cuda)
    scale, zp = scale.reshape(3, 301).to(cuda), zp.reshape(3, 301).to(cuda)
    c = query_refine_constants(_valid((3, d), family, gen).to(cuda),
                               get_family(family))
    grad, c_y = c["grad"], c["c_y"]
    full = bregman_dist.bregman_refine_batch_quant(codes, scale, zp, grad,
                                                   c_y, family)
    for qi, row in [(1, 0), (2, 157), (0, 300)]:
        one = bregman_dist.bregman_refine_batch_quant(
            codes[qi:qi + 1, row:row + 1].contiguous(),
            scale[qi:qi + 1, row:row + 1].contiguous(),
            zp[qi:qi + 1, row:row + 1].contiguous(),
            grad[qi:qi + 1].contiguous(), c_y[qi:qi + 1].contiguous(),
            family)
        # The row at position 5 of a ragged batch of 77, and unaligned.
        batch = codes[qi:qi + 1, :77].clone()
        batch[0, 5] = codes[qi, row]
        bs = scale[qi:qi + 1, :77].clone()
        bz = zp[qi:qi + 1, :77].clone()
        bs[0, 5], bz[0, 5] = scale[qi, row], zp[qi, row]
        g1, c1 = grad[qi:qi + 1].contiguous(), c_y[qi:qi + 1].contiguous()
        ragged = bregman_dist.bregman_refine_batch_quant(batch, bs, bz, g1,
                                                         c1, family)
        moved = bregman_dist.bregman_refine_batch_quant(_unaligned(batch), bs,
                                                        bz, g1, c1, family)
        bits = full[qi, row].view(torch.int32)
        assert torch.equal(one[0, 0].view(torch.int32), bits)
        assert torch.equal(ragged[0, 5].view(torch.int32), bits)
        assert torch.equal(moved[0, 5].view(torch.int32), bits)


@pytest.mark.parametrize("family", family_names())
def test_quantizer_on_the_card_is_bit_equal_to_the_cpu(cuda, family):
    gen = torch.Generator().manual_seed(5)
    x = _valid((500, 40), family, gen) * 3.0
    x[7] = x[7, 0]                          # a constant row
    for got, want in zip(tqz.quantize_rows(x.to(cuda)), tqz.quantize_rows(x),
                         strict=True):
        assert torch.equal(got.cpu(), want)
    codes, scale, zp = tqz.quantize_rows(x)
    assert torch.equal(
        tqz.dequantize_rows(codes.to(cuda), scale.to(cuda), zp.to(cuda),
                            family).cpu(),
        tqz.dequantize_rows(codes, scale, zp, family))
    stats = [torch.randn((300, 37), generator=gen) * 10.0 for _ in range(4)]
    stats[0][3] = 1.5
    got = tqz.encode_stat_tables(*(t.to(cuda) for t in stats))
    want = tqz.encode_stat_tables(*stats)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key].cpu(), want[key]), key


def test_wrappers_refuse_mixed_devices_and_layouts(cuda):
    a = torch.ones((8, 3), device=cuda)
    with pytest.raises(ValueError, match="must be contiguous"):
        bregman_ub.bregman_ub_matrix(a, torch.ones((3, 8), device=cuda).T,
                                     torch.ones(2, device=cuda),
                                     torch.ones((2, 3), device=cuda))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bregman_ub.bregman_ub_matrix(a, a, torch.ones(2),
                                     torch.ones((2, 3), device=cuda))


def _counts(quantize: bool) -> tuple:
    attr = "launches_quant" if quantize else "launches"
    return tuple(getattr(mod, attr)
                 for mod in (bregman_ub, bregman_fused, bregman_dist))


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("family", family_names())
def test_search_on_the_card_matches_the_cpu(cuda, family, quantize):
    gen = torch.Generator().manual_seed(3)
    data = _valid((3000, 24), family, gen).numpy()
    forest = tidx.build_index(data, family, m=6, quantize=quantize,
                              device="cpu")
    moved = tidx.forest_from_numpy(
        tidx.forest_to_numpy(forest), family_name=family,
        partition_idx=forest.partition.idx,
        partition_mask=forest.partition.mask, d=forest.d,
        num_clusters=forest.num_clusters, storage=forest.storage,
        device=cuda)
    queries = np.ascontiguousarray(data[:12] * 1.01)
    counts = _counts(quantize)
    got = tsearch.knn_batch(moved, queries, 10, budget=64, block_rows=512,
                            device=cuda)
    assert all(after > was for after, was in zip(
        _counts(quantize), counts, strict=True))
    want = tsearch.knn_batch(forest, queries, 10, budget=64,
                             block_rows=512, device="cpu")
    assert torch.equal(got.ids.cpu(), want.ids)
    assert torch.allclose(got.dists.cpu(), want.dists, rtol=1e-4,
                          atol=1e-4)
    rows = moved.rows_view()
    bf_ids, _ = tsearch.brute_force_knn(rows, queries, 10, family,
                                        device=cuda)
    assert torch.equal(got.ids, moved.point_ids[bf_ids])


def test_int8_build_on_the_card_matches_the_cpu(cuda):
    """build_index(quantize=True) quantizes on the card: its codes are the
    CPU build's, and its search returns brute-force ids over rows_view."""
    gen = torch.Generator().manual_seed(4)
    data = _valid((3000, 24), "burg", gen).numpy()
    on_card = tidx.build_index(data, "burg", m=6, quantize=True, device=cuda)
    assert on_card.data.is_cuda and on_card.data.dtype == torch.int8
    codes, scale, zp = tqz.quantize_rows(torch.from_numpy(data))
    order = on_card.point_ids.long().cpu()
    assert torch.equal(on_card.data.cpu(), codes[order])
    assert torch.equal(on_card.data_scale.cpu(), scale[order])
    queries = np.ascontiguousarray(data[:12] * 1.01)
    got = tsearch.knn_batch(on_card, queries, 10, device=cuda)
    bf_ids, _ = tsearch.brute_force_knn(on_card.rows_view(), queries, 10,
                                        "burg", device=cuda)
    assert torch.equal(got.ids, on_card.point_ids[bf_ids])


def _prune_operands(n, m, q, gen, quantize):
    """Corner operands (fp32, or int8 codes with their decode) and the
    (q, M) query tables, with a mixed mask and an exact tie in row 0; the
    filter tables of the fused kernels come first."""
    if quantize:
        tables = [t for i in range(4)
                  for t in _quant_table(n, m, gen, nonneg=i in (1, 3))]
        amin = tqz.dequantize_stats(*tables[6:9])
        gmax = tqz.dequantize_stats(*tables[9:12])
    else:
        alpha, sg, amin, gmax = (torch.randn((n, m), generator=gen)
                                 for _ in range(4))
        sg, gmax = sg.abs(), gmax.abs()
        tables = [alpha, sg, amin, gmax]
    qc, sd = torch.randn((q, m), generator=gen), \
        torch.randn((q, m), generator=gen).abs()
    lb = (amin[:, :, None] + qc.T[None]) - gmax[:, :, None] * sd.T[None]
    qb = torch.quantile(lb, 1.0 - 0.5 ** (1.0 / m), dim=0).T.contiguous()
    qb[:, 0] = lb[0, 0, :]
    return tables, qc, sd, qb


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("n,m,q", [(4096, 39, 14), (4133, 1, 1), (77, 70, 33)])
def test_prune_kernels_match_their_plain_versions_and_the_fused_admit(
        cuda, n, m, q, quantize):
    gen = torch.Generator().manual_seed(n + m + q)
    tables, qc, sd, qb = _prune_operands(n, m, q, gen, quantize)
    tables = [t.to(cuda) for t in tables]
    qc, sd, qb = qc.to(cuda), sd.to(cuda), qb.to(cuda)
    qsum = qc.sum(-1)
    attr = "launches_quant" if quantize else "launches"
    before = getattr(bregman_prune, attr)
    if quantize:
        corners = tables[6:]
        admit = bregman_prune.bregman_prune_mask_quant(*corners, qc, sd, qb)
        want = ref.bregman_prune_mask_quant(*corners, qc, sd, qb)
        _, fused = bregman_fused.bregman_filter_prune_quant(
            *tables, qsum, qc, sd, sd.sum(-1), qb)
    else:
        corners = tables[2:]
        admit = bregman_prune.bregman_prune_mask(*corners, qc, sd, qb)
        want = ref.bregman_prune_mask(*corners, qc, sd, qb)
        _, fused = bregman_fused.bregman_filter_prune(*tables, qsum, qc, sd,
                                                      qb)
    torch.cuda.synchronize()
    assert getattr(bregman_prune, attr) == before + 1
    assert admit.dtype == torch.int32 and admit.shape == (n, q)
    assert torch.equal(admit, want)
    assert torch.equal(admit, fused)
    assert bool(admit[0].all())
    if n * q >= 64:
        assert 0 < int(admit.sum()) < n * q


def _cold_bytes(forest) -> int:
    return sum(getattr(forest, f).numel() * getattr(forest, f).element_size()
               for f in cold_point_fields(forest))


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("family", ["squared_euclidean", "burg"])
def test_tiered_store_on_the_card_matches_resident_search(cuda, family,
                                                          quantize):
    gen = torch.Generator().manual_seed(5)
    data = _valid((3000, 24), family, gen).numpy()
    forest = tidx.build_index(data, family, m=6, quantize=quantize,
                              device=cuda)
    queries = np.ascontiguousarray(data[:12] * 1.01)
    store = TieredPointStore.from_index(
        forest, resident_bytes=int(0.4 * _cold_bytes(forest)),
        block_rows=512)
    assert not store.is_resident
    for f in cold_point_fields(forest):
        assert store._blocks[f].is_pinned(), f
    attr = "launches_quant" if quantize else "launches"
    before = getattr(bregman_prune, attr)
    for p in (None, 0.8, None):
        if p is None:
            want = tsearch.knn_search_batch(forest, queries, 10, 256,
                                            block_rows=512, device=cuda)
        else:
            want = tsearch.knn_search_batch_approx(
                forest, queries, 10, 256, p, block_rows=512, device=cuda)
        got = store.search(queries, 10, 256, p_guarantee=p, device=cuda)
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), (p, f)
    assert getattr(bregman_prune, attr) > before
    assert store.stats["host_bytes_fetched"] > 0
    got = tsearch.knn_batch(store, queries, 10, device=cuda)
    want = tsearch.knn_batch(forest, queries, 10, device=cuda)
    assert torch.equal(got.ids, want.ids)
    store.close()


def test_store_on_the_card_keeps_no_cold_field_outside_its_cache(cuda):
    gen = torch.Generator().manual_seed(6)
    data = _valid((20000, 64), "squared_euclidean", gen).numpy()
    forest = tidx.build_index(data, "squared_euclidean", m=8, device=cuda)
    queries = np.ascontiguousarray(data[:8] * 1.01)
    cold = _cold_bytes(forest)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    store = TieredPointStore.from_index(forest, resident_bytes=cold // 4,
                                        block_rows=1024)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - base < 1 << 20
    for f in cold_point_fields(forest):
        assert getattr(store._hot, f).device.type == "meta", f
    res = store.search(queries, 10, 512, device=cuda)
    torch.cuda.synchronize()
    info = store.cache_info()
    held = torch.cuda.memory_allocated() - base
    assert held <= info["bytes_cached"] + info["pool_bytes"] + (1 << 20)
    assert info["bytes_cached"] <= cold // 4 + cold // 10
    del res
    store.close()


# ---------------------------------------------------------------------------
# Kernels #10 (flash attention) and #9 (PCCP Gram) and the kNN-LM path
# ---------------------------------------------------------------------------

# tests/test_kernels.py::test_flash_attention's seven cases, then the
# model's shapes: starcoder2-3b's GQA 12:1 at head_dim 128, a ragged Sq,
# the reduced config's head_dim 16 with a window, recurrentgemma-2b's
# MQA at head_dim 256 (with a window, and non-causal with Sq < Skv), and
# the GQA ratios of the MoE and dense configs: 8 (qwen3-moe-30b-a3b 32/4,
# qwen3-32b 64/8), 5 (llama4-scout-17b-a16e and qwen2.5-32b, 40/8) and 4
# (phi3-medium-14b, 40/10).
FLASH_CASES = [
    (2, 4, 4, 64, 64, 32, True, None),
    (1, 8, 2, 64, 64, 32, True, None),
    (2, 4, 1, 32, 32, 16, True, None),
    (1, 4, 4, 64, 64, 32, False, None),
    (1, 4, 2, 64, 64, 32, True, 16),
    (2, 4, 2, 1, 96, 32, True, None),
    (1, 2, 2, 48, 48, 32, True, None),
    (2, 24, 2, 200, 200, 128, True, None),
    (1, 24, 2, 77, 300, 128, True, 100),
    (3, 4, 2, 130, 130, 16, True, 5),
    (1, 8, 8, 70, 70, 64, False, 33),
    (2, 10, 1, 200, 200, 256, True, None),
    (1, 10, 1, 300, 300, 256, True, 100),
    (1, 4, 1, 77, 130, 256, False, None),
    (1, 32, 4, 130, 130, 128, True, None),
    (2, 40, 8, 130, 130, 128, True, None),
    (1, 40, 8, 77, 200, 128, True, 100),
    (1, 40, 10, 200, 200, 128, True, None),
    (2, 6, 6, 1500, 1500, 64, False, None),    # whisper-tiny's encoder
    (2, 6, 6, 512, 512, 64, True, None),       # whisper-tiny's decoder
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _bshd(b, heads, s, d, dtype, gen, cuda):
    """A (B, heads, S, D) view of a contiguous (B, S, heads, D) tensor on
    the card: the layout the model hands the kernel."""
    x = torch.randn((b, s, heads, d), generator=gen).to(dtype)
    return x.to(cuda).transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kh,sq,skv,d,causal,window", FLASH_CASES)
def test_flash_attention_matches_its_plain_version(cuda, b, h, kh, sq, skv,
                                                   d, causal, window, dtype):
    gen = torch.Generator().manual_seed(sq * 1000 + skv)
    q = _bshd(b, h, sq, d, dtype, gen, cuda)
    k = _bshd(b, kh, skv, d, dtype, gen, cuda)
    v = _bshd(b, kh, skv, d, dtype, gen, cuda)
    before = flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, causal=causal,
                                          window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.stride() == q.stride()
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # contiguous (B, H, S, D) operands give the same bits
    again = flash_attention.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=window)
    assert torch.equal(again, got.contiguous())


# bf16 at the tensor-core kernel's edges (csrc/flash_attention_wgmma.cu:
# 128-row q blocks of two 64-row warpgroups, 64 rows of one at D = 256,
# 64-key kv tiles): D 64, 128 and 256, Sq in {1, 77, 200} and Skv in {77,
# 200, 1000} (no multiple of a tile), GQA 12:1, 8:1, 5:1 and 4:1, MQA, a
# window of 100, non-causal (Sq > Skv too).
TC_CASES = [
    (1, 24, 2, 1, 77, 128, True, None),
    (2, 24, 2, 77, 77, 128, True, None),
    (1, 24, 2, 77, 200, 128, True, 100),
    (1, 24, 2, 200, 1000, 128, True, None),
    (1, 24, 2, 200, 1000, 128, True, 100),
    (2, 24, 2, 200, 200, 128, False, None),
    (1, 24, 2, 1, 1000, 128, False, 100),
    (1, 8, 2, 200, 77, 64, False, None),
    (2, 8, 8, 77, 200, 64, True, 100),
    (1, 12, 1, 200, 1000, 64, False, 100),
    (1, 4, 2, 1, 200, 64, True, None),
    (1, 10, 1, 1, 77, 256, True, None),
    (2, 10, 1, 77, 77, 256, True, None),
    (1, 10, 1, 200, 1000, 256, True, 100),
    (1, 10, 1, 200, 77, 256, False, None),
    (2, 32, 4, 200, 200, 128, True, None),
    (1, 64, 8, 77, 1000, 128, True, None),
    (1, 40, 8, 200, 1000, 128, True, None),
    (2, 40, 8, 77, 77, 128, True, 100),
    (1, 40, 10, 200, 200, 128, True, None),
]


@pytest.mark.parametrize("b,h,kh,sq,skv,d,causal,window", TC_CASES)
def test_bf16_flash_kernel_at_its_edges(cuda, b, h, kh, sq, skv, d, causal,
                                        window):
    """Against the plain version on fp32 upcasts within 2^-8 |want| + 1e-5
    (half a bf16 step: the output's own rounding, as chip_smoke.py holds
    the model's shapes); the (B, S, H, D) views and contiguous (B, H, S, D)
    tensors give the same bits."""
    gen = torch.Generator().manual_seed(sq * 7 + skv + d)
    q = _bshd(b, h, sq, d, torch.bfloat16, gen, cuda)
    k = _bshd(b, kh, skv, d, torch.bfloat16, gen, cuda)
    v = _bshd(b, kh, skv, d, torch.bfloat16, gen, cuda)
    before = flash_attention.launches_wgmma
    got = flash_attention.flash_attention(q, k, v, causal=causal,
                                          window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches_wgmma == before + 1
    want = ref.flash_attention(q.float(), k.float(), v.float(),
                               causal=causal, window=window)
    limit = 2.0 ** -8 * want.abs() + 1e-5
    assert bool(((got.float() - want).abs() <= limit).all())
    again = flash_attention.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=window)
    assert torch.equal(again, got.contiguous())


def test_bf16_flash_refuses_what_tma_cannot_read(cuda):
    """TMA reads 16-byte-aligned bases and strides of 8 bf16 elements."""
    wide = torch.zeros((1, 2, 8, 36), dtype=torch.bfloat16, device=cuda)
    q = wide[..., :32]                       # rows 72 bytes apart
    with pytest.raises(ValueError, match="TMA"):
        flash_attention.flash_attention(q, q, q)
    flat = torch.zeros(2 * 8 * 32 + 1, dtype=torch.bfloat16, device=cuda)
    q = flat[1:].view(1, 2, 8, 32)           # base 2 bytes off
    with pytest.raises(ValueError, match="TMA"):
        flash_attention.flash_attention(q, q, q)


def test_flash_attention_refuses_what_it_cannot_run(cuda):
    q = torch.zeros((1, 2, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(torch.zeros((1, 2, 8, 24),
                                                    device=cuda),
                                        torch.zeros((1, 2, 8, 24),
                                                    device=cuda),
                                        torch.zeros((1, 2, 8, 24),
                                                    device=cuda))
    with pytest.raises(ValueError, match="fp32 or bf16"):
        flash_attention.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="last dim"):
        flash_attention.flash_attention(q.transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="no key"):
        flash_attention.flash_attention(q, q[:, :, :4], q[:, :, :4])


def _gram_tolerance(xc: torch.Tensor) -> torch.Tensor:
    """Rounding in a sum of n products grows about as sqrt(n) * eps32
    times the sum of the products' magnitudes, though not as independent
    steps (a sum of positive products drifts further): two fp32 sums in
    different orders stay within 8 * sqrt(n) * eps32 of it (a sum's worst
    case is n * eps32)."""
    a = xc.abs().double()
    return (8 * xc.shape[0] ** 0.5 * EPS32 * (a.T @ a)).float()


def test_pccp_gram_over_repeated_rows_at_the_widest_keys(cuda):
    """qwen2-vl-72b's datastore shape (65,472 x 8192), a quarter of the
    rows one repeated row (the zero keys of the patch positions) and the
    rest offset from 0: the repeated products round in one direction
    along a block's fp32 chain, so a chain of all n rows drifted past the
    limit; chunks of at most MAX_CHUNK_ROWS stay within it."""
    n, d = 65_472, 8192
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((n, d), generator=gen, device=cuda) + 0.5
    x[torch.arange(n, device=cuda) % 1023 < 256] = 0.0
    xc = (x - x.mean(0, keepdim=True)).contiguous()
    del x
    slots = pccp_corr._device_slots(xc.device)
    assert pccp_corr.schedule(n, d, slots)[2] <= pccp_corr.MAX_CHUNK_ROWS
    gram = pccp_corr.pccp_gram(xc)
    diff = (gram - xc.T @ xc).abs()
    assert bool((diff <= _gram_tolerance(xc)).all())


@pytest.mark.parametrize("n,d", [(100, 8), (257, 40), (64, 129),
                                 (5000, 300), (20_001, 300), (12_345, 257)])
def test_pccp_gram_matches_its_plain_version(cuda, n, d):
    """The last three split n into chunks (n not a multiple of a chunk,
    d not a multiple of the 128-column tile; 257 also not of the 16-byte
    copies)."""
    gen = torch.Generator().manual_seed(n + d)
    x = (torch.randn((n, d), generator=gen)
         @ torch.randn((d, d), generator=gen) * 0.3 + 2.0).to(cuda)
    xc = (x - x.mean(0, keepdim=True)).contiguous()
    if n > 1000:
        slots = pccp_corr._device_slots(xc.device)
        assert pccp_corr.schedule(n, d, slots)[1] > 1
    before = pccp_corr.launches
    gram = pccp_corr.pccp_gram(xc)
    torch.cuda.synchronize()
    assert pccp_corr.launches == before + 1
    assert torch.equal(gram, gram.T)      # mirrored upper triangle
    want = xc.T @ xc
    assert bool(((gram - want).abs() <= _gram_tolerance(xc)).all())
    corr = ops.pccp_correlation(x)
    plain = ref.pccp_correlation(x)
    std = torch.sqrt(torch.mean(xc * xc, 0))
    tol = _gram_tolerance(xc) / (n * std[:, None] * std[None, :])
    assert bool(((corr - plain).abs() <= tol).all())
    assert bool((corr.diagonal() == 0).all())
    assert pccp_corr.launches == before + 2


def test_a_cuda_tensor_never_runs_the_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(ref, "flash_attention", refuse)
    monkeypatch.setattr(ref, "pccp_correlation", refuse)
    q = torch.randn((1, 4, 16, 32), device=cuda)
    assert ops.flash_attention(q, q[:, :2], q[:, :2]).is_cuda
    assert ops.pccp_correlation(torch.randn((64, 8), device=cuda)).is_cuda
    with pytest.raises(AssertionError, match="plain version"):
        ops.flash_attention(q.cpu(), q[:, :2].cpu(), q[:, :2].cpu())


def test_knnlm_path_on_the_card_launches_its_kernels(cuda, monkeypatch):
    """Reduced starcoder2-3b on the card: every prefill and forward batch
    launches #10 once a layer; the hook's search launches #1, #3 and #7;
    its ids equal brute force over the datastore's keys."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.registry import build_model
    from repro_torch.serve import knnlm
    from repro_torch.serve.engine import Engine, EngineConfig, Request
    from repro_torch.serve.knnlm import KNNLMHook, build_datastore

    cfg = dataclasses.replace(configs.get_reduced("starcoder2-3b"),
                              compute_dtype=torch.float32)
    bundle = build_model(cfg, device=cuda)
    params = bundle.init(0)
    corpus = np.random.default_rng(0).integers(1, 512, (6, 40))
    monkeypatch.setattr(knnlm, "FORWARD_BATCH", 4)    # two micro-batches
    before = flash_attention.launches
    store = build_datastore(bundle, params, corpus, m=4)
    assert flash_attention.launches - before == 2 * cfg.num_layers
    assert store.index.n == 6 * 39 and store.index.device.type == "cuda"
    hook = KNNLMHook(store=store, k=4)
    seen = {}

    def capture(logits, hidden):
        seen["hidden"] = hidden.clone()
        return hook(logits, hidden)

    eng = Engine(bundle, params, EngineConfig(slots=2, max_seq=48,
                                              prefill_len=12),
                 logits_hook=capture)
    for uid in range(3):
        eng.submit(Request(uid=uid, prompt=np.random.default_rng(uid)
                           .integers(1, 512, 12), max_new_tokens=3))
    counts = (flash_attention.launches, bregman_ub.launches,
              bregman_fused.launches, bregman_dist.launches)
    done = eng.run(max_ticks=20)
    torch.cuda.synchronize()
    assert len(done) == 3 and all(len(r.output) == 3 for r in done)
    after = (flash_attention.launches, bregman_ub.launches,
             bregman_fused.launches, bregman_dist.launches)
    assert after[0] - counts[0] == 2 * cfg.num_layers   # two admissions
    assert all(a > c for a, c in zip(after[1:], counts[1:], strict=True))
    res = hook.last_result
    assert bool(res.exact.all())
    keys = store.index.data[torch.argsort(store.index.point_ids.long())]
    bf_ids, _ = tsearch.brute_force_knn(keys, seen["hidden"].float(), 4,
                                        "squared_euclidean", device=cuda)
    assert torch.equal(res.ids.long(), bf_ids.long())


def _small_pair(cuda, family, quantize, seed):
    """A small index built on the CPU and the same tables on the card."""
    gen = torch.Generator().manual_seed(seed)
    data = _valid((3000, 24), family, gen).numpy()
    forest = tidx.build_index(data, family, m=6, quantize=quantize,
                              device="cpu")
    moved = tidx.forest_from_numpy(
        tidx.forest_to_numpy(forest), family_name=family,
        partition_idx=forest.partition.idx,
        partition_mask=forest.partition.mask, d=forest.d,
        num_clusters=forest.num_clusters, storage=forest.storage,
        device=cuda)
    return forest, moved, np.ascontiguousarray(data[:6] * 1.01)


def _single_counts() -> dict:
    return {(mod.__name__.rsplit(".", 1)[-1], attr): getattr(mod, attr)
            for mod in (bregman_ub, bregman_fused, bregman_prune,
                        bregman_dist)
            for attr in ("launches", "launches_quant")}


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("family", ["exponential", "burg"])
def test_single_query_on_the_card_matches_the_cpu(cuda, family, quantize):
    """knn_search, knn_search_approx and knn on the card against the same
    calls on the CPU; one knn_search launches the filter (#1 or #2), the
    prune-only mask (#5 or #6) and the refine (#7 or #8) once each at
    q = 1, and nothing else."""
    forest, moved, queries = _small_pair(cuda, family, quantize, seed=7)
    attr = "launches_quant" if quantize else "launches"
    for y in queries:
        for call in (
                lambda f, dev: tsearch.knn_search(f, y, 10, 256, device=dev),
                lambda f, dev: tsearch.knn_search_approx(f, y, 10, 256, 0.8,
                                                         device=dev),
                lambda f, dev: tsearch.knn(f, y, 10, device=dev)):
            want = call(forest, "cpu")
            before = _single_counts()
            got = call(moved, cuda)
            torch.cuda.synchronize()
            assert torch.equal(got.ids.cpu(), want.ids)
            assert bool(got.exact) == bool(want.exact)
            assert int(got.num_candidates) == int(want.num_candidates)
            assert torch.allclose(got.dists.cpu(), want.dists, rtol=1e-4,
                                  atol=1e-4)
            grew = {key for key, n in _single_counts().items()
                    if n > before[key]}
            assert {("bregman_ub", attr), ("bregman_prune", attr),
                    ("bregman_dist", attr)} == grew
    before = _single_counts()
    tsearch.knn_search(moved, queries[0], 10, 256, device=cuda)
    after = _single_counts()
    assert {key: after[key] - before[key] for key in after} == {
        key: int(key[1] == attr and key[0] != "bregman_fused")
        for key in after}


@pytest.mark.parametrize("quantize", [False, True])
def test_oracle_on_the_card_equals_the_streamed_search(cuda, quantize):
    """knn_search_batch_reference on the card (the (n, q) mask in plain
    torch) against knn_search_batch and knn_search_batch_approx on the
    card, bit for bit, on blobs where the mask is mixed."""
    rng = np.random.default_rng(0)
    data = np.concatenate([rng.normal(size=(600, 16)) + 10.0 * j
                           for j in range(6)]).astype(np.float32)
    forest = tidx.build_index(data, "squared_euclidean", m=4,
                              quantize=quantize, device=cuda)
    queries = np.ascontiguousarray(data[[0, 90, 700, 1300]] * 1.01)
    for p in (None, 0.9):
        if p is None:
            want = tsearch.knn_search_batch(forest, queries, 10, 512,
                                            block_rows=512, device=cuda)
        else:
            want = tsearch.knn_search_batch_approx(
                forest, queries, 10, 512, p, block_rows=512, device=cuda)
        got = tsearch.knn_search_batch_reference(
            forest, queries, 10, 512, p_guarantee=p, block_rows=512,
            device=cuda)
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), (p, f)
        assert 0 < int(got.num_candidates.sum()) < forest.n * len(queries)


@pytest.mark.parametrize("quantize", [False, True])
def test_calibration_fitted_on_the_card_equals_the_cpu(cuda, quantize):
    from repro_torch.core import calibrate as tcal
    forest, moved, queries = _small_pair(cuda, "exponential", quantize,
                                         seed=8)
    want = tcal.fit_calibration(forest, k=10, num_queries=32)
    got = tcal.fit_calibration(moved, k=10, num_queries=32)
    np.testing.assert_array_equal(got.p_grid, want.p_grid)
    np.testing.assert_array_equal(got.recall_grid, want.recall_grid)
    calibrated = tcal.ensure_calibration(moved, k=10, num_queries=32)
    assert calibrated.calibration.recall_grid.tolist() == \
        got.recall_grid.tolist()
    p, _ = tcal.resolve_p_guarantee(calibrated, 0.95)
    a = tsearch.knn_batch(calibrated, queries, 10, target_recall=0.95,
                          device=cuda)
    b = tsearch.knn_batch(calibrated, queries, 10, approx_p=p, device=cuda)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_build_on_the_card_repeats_bit_for_bit(cuda):
    """Two builds of one blob corpus on the card give the same tables: the
    k-means centre sums add each cluster's rows in a fixed order (with
    ``index_add_``'s atomics the centres drift by an ulp between runs,
    and with them the assignment and the held-out calibration queries)."""
    rng = np.random.default_rng(0)
    data = np.concatenate([rng.normal(size=(1 << 14, 32)) + 100.0 * j
                           for j in range(16)]).astype(np.float32)
    a, b = (tidx.build_index(data, "squared_euclidean", m=4,
                             num_clusters=64, seed=0, device=cuda)
            for _ in range(2))
    for f in tidx.interchange_fields(a.storage):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---------------------------------------------------------------------------
# The mutable index and the kNN-LM mixture on the card
# ---------------------------------------------------------------------------

def _mutated_on_the_card(cuda, family, quantize, seed=11):
    """A mutable index built on the card, after an insert of 300 rows and
    the deletion of 200 ids (150 sealed, 50 appended), with queries."""
    from repro_torch.core.segments import build_segmented_index
    gen = torch.Generator().manual_seed(seed)
    data = _valid((3300, 24), family, gen).numpy()
    sf = build_segmented_index(data[:3000], family, m=6, quantize=quantize,
                               seed=0, device=cuda)
    ids = sf.insert(data[3000:], auto_compact=False)
    assert ids.tolist() == list(range(3000, 3300))
    dead = np.concatenate([np.arange(0, 3000, 20), np.arange(3000, 3300, 6)])
    assert sf.delete(dead, auto_compact=False) == dead.size
    return sf, dead, np.ascontiguousarray(data[::250] * 1.01)


@pytest.mark.parametrize("quantize", [False, True])
def test_mutated_index_on_the_card_matches_brute_force(cuda, quantize):
    family = "burg"
    sf, dead, queries = _mutated_on_the_card(cuda, family, quantize)
    res = tsearch.knn_batch(sf, queries, 10, device=cuda)
    assert bool(res.exact.all())
    assert not bool(torch.isin(res.ids.cpu(), torch.from_numpy(dead)).any())
    view = sf.view()
    live = view.point_ids >= 0
    bf_pos, bf_d = tsearch.brute_force_knn(view.rows_view()[live], queries,
                                           10, family, device=cuda)
    assert torch.equal(res.ids, view.point_ids[live][bf_pos])
    torch.testing.assert_close(res.dists, bf_d, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantize", [False, True])
def test_merge_on_the_card_is_bit_equal_to_before(cuda, quantize):
    sf, _, queries = _mutated_on_the_card(cuda, "exponential", quantize)
    budget = sf.live_n
    before = tsearch.knn_search_batch(sf, queries, 10, budget, device=cuda)
    view = sf.view()
    live = view.point_ids >= 0
    order = torch.argsort(view.point_ids[live])
    codes = view.data[live][order]
    assert sf.compact("merge") == "merge"
    assert sf.n == sf.live_n == budget and sf.main.data.device.type == cuda.type
    after = tsearch.knn_search_batch(sf, queries, 10, budget, device=cuda)
    for f in after._fields:
        assert torch.equal(getattr(after, f), getattr(before, f)), f
    merged = sf.view()
    assert torch.equal(merged.data[torch.argsort(merged.point_ids)], codes)


@pytest.mark.parametrize("quantize", [False, True])
def test_two_rebuilds_on_the_card_are_bit_equal(cuda, quantize):
    """``compact("rebuild")`` is a build: two mutable copies of one seeded
    index, mutated alike, rebuild to the same tables."""
    mains = []
    for _ in range(2):
        sf, _, queries = _mutated_on_the_card(cuda, "squared_euclidean",
                                              quantize)
        sf.compact("rebuild", seed=0)
        mains.append(sf.main)
    a, b = mains
    for f in tidx.interchange_fields(a.storage):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_tiered_store_on_a_mutable_index_on_the_card(cuda):
    sf, _, queries = _mutated_on_the_card(cuda, "squared_euclidean", False)
    view = sf.view()
    store = TieredPointStore.from_index(
        sf, resident_bytes=int(0.4 * _cold_bytes(view)), block_rows=512)
    lo, hi = sf.append_row_range()
    pinned = frozenset(range(lo // 512, -(-hi // 512)))
    assert not store.is_resident and store._pinned == pinned
    want = tsearch.knn_search_batch(sf, queries, 10, 256, block_rows=512,
                                    device=cuda)
    got = store.search(queries, 10, 256, device=cuda)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert pinned <= set(store._cache)
    store.close()


def test_knn_mixture_repeats_on_the_card_and_equals_the_cpu(cuda):
    """The hook's p_knn from given (tokens, w) with repeated tokens: two
    builds on the card bit-equal, and bit-equal to the CPU's."""
    from repro_torch.serve.knnlm import knn_distribution
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, 4, (64, 8), generator=gen)
    w = torch.softmax(torch.randn((64, 8), generator=gen), dim=-1)
    want = knn_distribution(tokens, w, 49152)
    got = [knn_distribution(tokens.to(cuda), w.to(cuda), 49152)
           for _ in range(2)]
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0].cpu(), want)


def _service_run(index, queries, faults_mod, ret_mod, make_plan):
    """A VirtualClock service over ``index`` (tenant "t"): a plain pass, a
    poisoned row, a retried launch error, a priced-out exact tier; the
    responses, counters and fired events."""
    plan = make_plan()
    svc = ret_mod.RetrievalService(ret_mod.ServiceConfig(),
                                   clock=faults_mod.VirtualClock(),
                                   faults=plan)
    svc.register_tenant("t", index)
    out = [svc.search_sync("t", queries, 5) for _ in range(3)]
    tickets = [svc.submit("t", queries[i:i + 1], 5) for i in range(3)]
    svc.run_until_drained()
    out += [t.response for t in tickets]
    out.append(svc.search_sync("t", queries, 5, target_recall=0.9))
    svc.tenants["t"].cost.observe(0.3)
    out.append(svc.search_sync("t", queries, 5, deadline_s=0.4))
    svc.tenants["t"].cost.observe(10.0)
    out.append(svc.search_sync("t", queries, 5, deadline_s=0.2))
    return out, svc, plan


def test_service_on_the_card_equals_the_service_on_the_cpu(cuda):
    """The retrieval service with the same fault plan over the same forest
    on the card and on the CPU: equal labels, ids, tier paths, counters
    and events; dists within 1e-5; the card's search kernels launched."""
    from repro_torch.serve import faults, retrieval
    gen = np.random.default_rng(0)
    data = (gen.random((400, 16)) + 0.1).astype(np.float32)
    queries = (gen.random((4, 16)) + 0.1).astype(np.float32)
    forest = tidx.build_index(data, "shannon", m=4, num_clusters=8, seed=0,
                              device="cpu")
    on_card = tidx.forest_from_numpy(
        tidx.forest_to_numpy(forest), family_name="shannon",
        partition_idx=forest.partition.idx,
        partition_mask=forest.partition.mask, d=16,
        num_clusters=forest.num_clusters, device="cuda")

    def plan():
        return faults.FaultPlan(
            [faults.PoisonQuery(at_submits=1, row=2),
             faults.LaunchError(at_launches=2)], seed=3)
    before = (bregman_ub.launches, bregman_fused.launches,
              bregman_dist.launches)
    got, gsvc, gplan = _service_run(on_card, queries, faults, retrieval, plan)
    after = (bregman_ub.launches, bregman_fused.launches,
             bregman_dist.launches)
    want, wsvc, wplan = _service_run(forest, queries, faults, retrieval, plan)
    # One refine (#7) a search launch; the filter (#1) and the fused
    # prune (#3) at least once.
    assert after[2] - before[2] == gsvc.counters["launches"]
    assert after[0] > before[0] and after[1] > before[1]
    assert gsvc.counters == wsvc.counters
    assert gsvc.counters["launch_failures"] == 1
    assert gplan.events == wplan.events
    qualities = []
    for a, b in zip(got, want, strict=True):
        assert (a.quality, a.row_quality, a.shed_reason,
                a.meta.get("tier_path"), a.flagged_rows) == (
            b.quality, b.row_quality, b.shed_reason,
            b.meta.get("tier_path"), b.flagged_rows)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_allclose(a.dists, b.dists, rtol=1e-5, atol=1e-5)
        qualities.append(a.quality)
    assert {"exact", "approx", "shed"} <= set(qualities)


def test_hook_service_route_on_the_card_equals_the_cpu(cuda):
    """The kNN-LM hook through a RetrievalService on the card and on the
    CPU over the same keys: equal neighbours, the mixed log-probs within
    1e-5, and the card's route equal to its direct hook."""
    from repro_torch.serve.knnlm import Datastore, KNNLMHook
    from repro_torch.serve.retrieval import RetrievalService, ServiceConfig
    gen = np.random.default_rng(4)
    keys = gen.normal(size=(500, 32)).astype(np.float32)
    toks = gen.integers(0, 64, 500).astype(np.int32)
    logits = gen.normal(size=(3, 64)).astype(np.float32)
    hidden = keys[:3] + np.float32(0.01)
    out = {}
    for dev in ("cpu", "cuda"):
        forest = tidx.build_index(keys, "squared_euclidean", m=4,
                                  num_clusters=8, seed=0, device="cpu")
        if dev == "cuda":
            forest = tidx.forest_from_numpy(
                tidx.forest_to_numpy(forest),
                family_name="squared_euclidean",
                partition_idx=forest.partition.idx,
                partition_mask=forest.partition.mask, d=32,
                num_clusters=forest.num_clusters, device="cuda")
        store = Datastore(index=forest, next_tokens=toks, hidden_dim=32,
                          block_rows=4096)
        routed = KNNLMHook(store=store, k=8, lam=0.5,
                           service=RetrievalService(ServiceConfig()),
                           deadline_s=60.0)
        direct = KNNLMHook(store=store, k=8, lam=0.5)
        lt = torch.from_numpy(logits).to(dev)
        ht = torch.from_numpy(hidden).to(dev)
        out[dev] = (routed(lt, ht).cpu(), direct(lt, ht).cpu(),
                    routed.last_result)
    card, cpu = out["cuda"], out["cpu"]
    assert card[2].quality == cpu[2].quality == "exact"
    np.testing.assert_array_equal(card[2].ids, cpu[2].ids)
    assert torch.allclose(card[0], cpu[0], rtol=1e-5, atol=1e-5)
    assert torch.allclose(card[0], card[1], rtol=1e-6, atol=1e-6)


def test_registration_mask_on_the_card_equals_validate_rows(cuda):
    from repro_torch.core.bregman import valid_rows_mask, validate_rows
    gen = np.random.default_rng(5)
    rows = (gen.random((300, 8)) + 0.1).astype(np.float32)
    rows[3, 1], rows[9, 0], rows[20, 7], rows[40] = np.nan, -1.0, 0.0, np.inf
    for fam in family_names():
        got = valid_rows_mask(fam, torch.from_numpy(rows).to(cuda))
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      validate_rows(fam, rows, mode="mask"))


@pytest.mark.parametrize("d", [192, 256, 3072])
def test_query_constants_on_the_card_do_not_depend_on_the_batch(cuda, d):
    """A query's ``c_y`` on the card: the same bits in batches of 1, 14
    and 32 (``bounds.fixed_order_sum``), so the refine gives a query's
    rows the same bits in any microbatch; the CPU's within a reordered
    sum's rounding."""
    gen = torch.Generator().manual_seed(d)
    for family in ("exponential", "shannon", "squared_euclidean"):
        y = _valid((32, d), family, gen)
        fam = get_family(family)
        whole = query_refine_constants(y.to(cuda), fam)["c_y"]
        for q in (1, 14):
            part = query_refine_constants(y[:q].to(cuda), fam)["c_y"]
            assert torch.equal(part, whole[:q]), (family, q)
        # A reordered fp32 sum of d terms: within d * eps32 * sum |terms|.
        tol = d * EPS32 * ((y * fam.phi_prime(y)).abs().sum(-1)
                           + fam.phi(y).abs().sum(-1))
        diff = (whole.cpu() - query_refine_constants(y, fam)["c_y"]).abs()
        assert bool((diff <= tol).all()), family


@pytest.fixture
def nccl_mesh(cuda, monkeypatch):
    """A world-size-1 NCCL group on an in-process store and its ("data",)
    mesh, ended after the test; NCCL's bootstrap on the loopback."""
    import torch.distributed as dist
    from repro_torch.dist.sharding import make_mesh
    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "lo")
    assert not dist.is_initialized()
    mesh = make_mesh((1,), ("data",), device="cuda")
    assert dist.get_backend() == "nccl"
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("quantize", [False, True])
def test_distributed_knn_over_nccl_equals_the_search(nccl_mesh, quantize):
    """World size 1 over NCCL on the card: ``distributed_knn`` bit-equal to
    ``knn_search_batch`` (exact, at p = 0.9, and after the ladder from a
    budget of k), the shard's tables the forest's own tensors, and the
    tier's filter, fused prune and refine launched once an attempt."""
    from repro_torch.dist import knn as dk
    gen = torch.Generator().manual_seed(4)
    data = _valid((3000, 24), "exponential", gen).numpy()
    forest = tidx.build_index(data, "exponential", m=6, quantize=quantize,
                              device="cuda")
    ys = torch.as_tensor(data[:12] * 1.01, device="cuda")
    sharded = dk.shard_index(forest, nccl_mesh)
    assert sharded.forest.data.data_ptr() == forest.data.data_ptr()
    for p in (None, 0.9):
        before = _counts(quantize)
        got = dk.distributed_knn(sharded, ys, family="exponential", k=10,
                                 budget=3000, block_rows=512, approx_p=p,
                                 max_doublings=0)
        assert tuple(a - b for a, b in zip(_counts(quantize), before,
                                           strict=True)) == (1, 1, 1)
        want = (tsearch.knn_search_batch(forest, ys, 10, 3000,
                                         block_rows=512) if p is None else
                tsearch.knn_search_batch_approx(forest, ys, 10, 3000, p,
                                                block_rows=512))
        for f in want._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), (p, f)
    laddered = dk.distributed_knn(sharded, ys, family="exponential", k=10,
                                  budget=10, block_rows=512)
    exact = tsearch.knn_search_batch(forest, ys, 10, 3000, block_rows=512)
    assert bool(laddered.exact.all())
    assert torch.equal(laddered.ids, exact.ids)
    assert torch.equal(laddered.dists, exact.dists)


def test_sharded_tenant_on_the_card_equals_the_resident_tenant(nccl_mesh):
    """A ``mesh=`` tenant over NCCL answers with the resident tenant's
    labels and bits, and its launches run the card's kernels."""
    from repro_torch.serve import faults, retrieval
    gen = np.random.default_rng(0)
    data = (gen.random((400, 16)) + 0.1).astype(np.float32)
    queries = (gen.random((4, 16)) + 0.1).astype(np.float32)
    forest = tidx.build_index(data, "shannon", m=4, num_clusters=8, seed=0,
                              device="cuda")
    svc = retrieval.RetrievalService(clock=faults.VirtualClock())
    svc.register_tenant("t", forest)
    tenant = svc.register_tenant("s", forest, mesh=nccl_mesh)
    assert tenant.device.type == "cuda"
    svc.warm("s", shapes=[(4, 5)])
    for kw in ({}, {"target_recall": 0.9}):
        want = svc.search_sync("t", queries, 5, **kw)
        before = _counts(False)
        got = svc.search_sync("s", queries, 5, **kw)
        assert all(a > b for a, b in zip(_counts(False), before,
                                         strict=True))
        assert got.quality == want.quality
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.dists, want.dists)
    assert svc.counters["launch_failures"] == 0


# ---------------------------------------------------------------------------
# The MoE FFN on the card (models/moe.py: plain torch, no kernel of its own)
# ---------------------------------------------------------------------------

def test_moe_routing_on_the_card_equals_the_cpu(cuda):
    """Top-8 of 128 on the card: ties go to the lower expert (a stable
    descending sort), and the ids, weights and slots equal the CPU's on the
    same fp32 logits, drops included (a decode tick of 8 tokens has one
    slot an expert)."""
    from repro_torch.models import moe
    cfg = moe.MoEConfig(num_experts=128, top_k=8)
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((3, 8, 128), generator=gen) * 2
    logits[0, 0, :] = -5.0
    logits[0, 0, [3, 90, 7, 100, 8, 9, 10, 11, 12]] = 1.0   # a 9-way tie
    logits[:, :, 5] += 3.0                   # one crowded expert: drops
    out = {}
    for dev in ("cpu", cuda):
        w, i, aux = moe.route(logits.to(dev), cfg)
        slot, keep = moe.assign_slots(w, i, cfg)
        out[str(dev)] = [t.cpu() for t in (w, i, aux, slot, keep)]
    cpu, card = out["cpu"], out[str(cuda)]
    assert card[1][0, 0].tolist() == [3, 7, 8, 9, 10, 11, 12, 90]
    assert torch.equal(card[1], cpu[1])
    assert torch.equal(card[3], cpu[3]) and torch.equal(card[4], cpu[4])
    assert int((~card[4]).sum()) > 0
    torch.testing.assert_close(card[0], cpu[0], rtol=1e-6, atol=0)
    torch.testing.assert_close(card[2], cpu[2], rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_on_the_card_repeats_and_equals_the_cpu(cuda, dtype):
    """A 64-expert top-8 layer with a shared expert over two groups of 512
    tokens at capacity factor 1.25 (tokens drop): two calls on the card
    give the same bits (no atomics), and the card's output equals the
    CPU's within 1e-5 of its largest entry in fp32 (the same routes;
    sums in another order) and within 2^-6 of it in bf16 (two bf16 steps
    at that scale: a product rounds once on both sides, after sums in
    another order)."""
    from repro_torch.models import moe
    from repro_torch.models.layers import init_mlp, init_spec
    cfg = moe.MoEConfig(num_experts=64, top_k=8)
    gen = torch.Generator().manual_seed(1)
    p = init_spec(moe.moe_spec(256, 96, 64), gen)
    shared = init_mlp(256, 128, True, False, gen)
    x = torch.randn((2, 512, 256), generator=gen).to(dtype)
    want, _ = moe.apply_moe(p, x, cfg, shared_mlp=shared)
    to = {k: v.to(cuda) for k, v in p.items()}
    sh = {k: v.to(cuda) for k, v in shared.items()}
    got, aux = moe.apply_moe(to, x.to(cuda), cfg, shared_mlp=sh)
    again, _ = moe.apply_moe(to, x.to(cuda), cfg, shared_mlp=sh)
    assert torch.equal(got, again) and got.dtype == dtype
    scale = float(want.float().abs().max())
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0 ** -6 * scale
    assert float((got.cpu().float() - want.float()).abs().max()) <= tol


# ---------------------------------------------------------------------------
# The encoder-decoder and M-RoPE on the card (models/encdec.py, M-RoPE and
# the patch stub in models/transformer.py)
# ---------------------------------------------------------------------------

def _encdec_run(cfg, params, dev):
    """prefill (hidden states, every cache tensor) and two decode steps
    (logits, hidden states) of a reduced config on ``dev``, its inputs as
    the engine gives them (M-RoPE positions, zero frames or patch
    embeddings; the prefill also with seeded non-zero ones), as CPU
    tensors."""
    from repro_torch.models.registry import (build_model, model_inputs,
                                             model_positions)
    from repro_torch.serve.engine import _cache_leaves
    bundle = build_model(cfg, device=dev)
    params = _tree_to(params, dev)
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(1, cfg.vocab_size, (2, 12), generator=gen).to(dev)
    pos = torch.arange(12, device=dev)[None].expand(2, 12)
    batch = model_inputs(bundle, toks, pos)
    for name in bundle.extra_inputs:
        batch[name] = torch.randn(batch[name].shape, generator=gen).to(dev)
    caches = bundle.init_cache(2, 16)
    lengths = torch.zeros(2, dtype=torch.int32, device=dev)
    hidden, caches = bundle.prefill(params, batch, caches, lengths)
    out = {"prefill": hidden.cpu()}
    lengths = lengths + 12
    for step in range(2):
        logits, last, caches = bundle.decode_step(
            params, toks[:, step:step + 1],
            model_positions(cfg, lengths[:, None]), caches, lengths)
        out[f"logits{step}"], out[f"hidden{step}"] = logits.cpu(), last.cpu()
        lengths = lengths + 1
    for i, t in enumerate(_cache_leaves(caches)):
        out[f"cache{i}"] = t.cpu()
    return out


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-72b"])
def test_encdec_and_mrope_on_the_card_equal_the_cpu(cuda, arch):
    """Reduced whisper-tiny (encoder through #10's non-causal path, cross
    attention plain) and reduced qwen2-vl-72b (M-RoPE, patch stub) in fp32:
    prefill and decode on the card equal the CPU's within 1e-5 of each
    tensor's largest entry (the fp32 kernel against the plain version and
    sums in another order through two layers), #10 launched once a
    self-attention layer in the prefill (whisper: encoder and decoder)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              compute_dtype=torch.float32)
    params = build_model(cfg, device="cpu").init(0)
    want = _encdec_run(cfg, params, torch.device("cpu"))
    before = flash_attention.launches
    got = _encdec_run(cfg, params, cuda)
    assert flash_attention.launches - before == cfg.num_layers
    assert got.keys() == want.keys()
    for key, w in want.items():
        scale = float(w.abs().max())
        diff = float((got[key] - w).abs().max())
        assert diff <= 1e-5 * scale, (key, diff, scale)


# ---------------------------------------------------------------------------
# Training (the dense decoder family)
# ---------------------------------------------------------------------------

def _train_setup(dev, compute_dtype=torch.float32):
    """Reduced starcoder2-3b's train state made on the CPU and moved to
    ``dev`` (the seeded generators differ by device), its step and
    batches."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.pipeline import TokenStreamConfig, token_batch
    from repro_torch.models.registry import build_model
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_loop as tloop
    cfg = dataclasses.replace(configs.get_reduced("starcoder2-3b"),
                              compute_dtype=compute_dtype)
    state = tloop.train_state_to(
        tloop.init_train_state(build_model(cfg, device="cpu"), 0), dev)
    step = tloop.make_train_step(
        build_model(cfg, device=dev),
        tloop.TrainConfig(microbatches=2, opt=topt.OptimizerConfig(
            peak_lr=1e-3, warmup_steps=0, total_steps=10)))
    stream = TokenStreamConfig(vocab_size=512, seq_len=32, global_batch=4)
    return state, step, lambda i: token_batch(stream, i, device=dev)


def test_train_step_on_the_card_equals_the_cpu(cuda):
    """One fp32 step (TF32 off, two microbatches): the loss within rtol
    1e-5; the moments within 1e-4 of each leaf's largest; a parameter
    within 1e-6 + 1e-5 of itself plus what a gradient error of 1e-4 of the
    leaf's largest gradient can move AdamW's step, 2 x lr x error / (|g| +
    eps) capped at 2 x lr (the CPU rule of tests/test_torch_train.py)."""
    from repro_torch.train.checkpoint import _flatten_with_names
    runs = []
    for dev in (torch.device("cpu"), cuda):
        state, step, batch = _train_setup(dev)
        state, m = step(state, batch(0))
        runs.append((_flatten_with_names(state), m))
    (want, mw), (got, mg) = runs
    assert abs(float(mg["loss"]) - float(mw["loss"])) <= \
        1e-5 * abs(float(mw["loss"]))
    lr = float(mw["lr"])
    for name, w in want.items():
        g = got[name].cpu()
        if name == ".opt.step":
            assert int(g) == int(w) == 1
        elif name.startswith((".opt.mu", ".opt.nu")):
            assert float((g - w).abs().max()) <= \
                2e-4 * float(w.abs().max()) + 1e-12, name
        else:
            gmag = (want[".opt.nu" + name[len(".params"):]] / 0.05).sqrt()
            err = 1e-4 * float(gmag.max())
            tol = 1e-6 + 1e-5 * w.abs() + lr * torch.clamp(
                2.0 * err / (gmag + 1e-8), max=2.0)
            assert bool(((g - w).abs() <= tol).all()), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_restart_on_the_card_is_bit_exact(cuda, tmp_path, dtype):
    """Four steps; a restart from the step-2 checkpoint gives the same
    losses and the same state, bit for bit (the embedding's and the
    target gather's backward and the tied table's sums add in a fixed
    order on the card)."""
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as topt
    state, step, batch = _train_setup(cuda, dtype)
    losses = []
    for i in range(4):
        if i == 2:
            ckpt.save_checkpoint(str(tmp_path), i, state)
        state, m = step(state, batch(i))
        losses.append(float(m["loss"]))
    again = ckpt.restore_checkpoint(
        str(tmp_path), 2, topt.tree_map(lambda t: t.to("meta"), state),
        device=cuda)
    for i in range(2, 4):
        again, m = step(again, batch(i))
        assert float(m["loss"]) == losses[i]
    for a, b in zip(topt.tree_leaves(state), topt.tree_leaves(again),
                    strict=True):
        assert torch.equal(a, b)


def test_kernel_10_refuses_grad_and_prefill_still_launches_it(cuda):
    """#10's dispatcher raises under grad on the card; a train step leaves
    its counters where they were; the prefill and the no-grad forward
    still launch it once a layer."""
    from repro_torch import configs
    from repro_torch.models.registry import build_model
    q = torch.randn((1, 2, 64, 16), device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        ops.flash_attention(q, q, q)
    state, step, batch = _train_setup(cuda)
    before = flash_attention.launches
    step(state, batch(0))
    torch.cuda.synchronize()
    assert flash_attention.launches == before
    cfg = configs.get_reduced("starcoder2-3b")
    bundle = build_model(cfg, device=cuda)
    params = bundle.init(0)
    b = batch(0)
    bundle.forward_train(params, b)
    caches = bundle.init_cache(4, 40)
    bundle.prefill(params, b, caches, torch.zeros(4, dtype=torch.int32,
                                                  device=cuda))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2 * cfg.num_layers


def test_init_params_on_the_card_are_trainable(cuda):
    """``init_params`` makes ordinary tensors on the card: autograd takes
    them, and a loss's backward reaches every one."""
    from repro_torch import configs
    from repro_torch.models import transformer as ttf
    from repro_torch.train import losses
    from repro_torch.train.optimizer import tree_leaves
    cfg = configs.get_reduced("starcoder2-3b")
    params = ttf.init_params(cfg, 0, device=cuda)
    leaves = tree_leaves(params)
    assert not any(p.is_inference() for p in leaves)
    for p in leaves:
        p.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device=cuda)
    pos = torch.arange(16, device=cuda)[None].expand(2, 16)
    hidden, _ = ttf.forward_autograd(cfg, params, toks, pos)
    loss, _ = losses.chunked_cross_entropy(hidden, toks, params["embed"],
                                           chunk=8)
    loss.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in leaves)


# ---------------------------------------------------------------------------
# Training the MoE, recurrent, encoder-decoder and VLM families
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e",
                "recurrentgemma-2b", "rwkv6-1.6b", "whisper-tiny",
                "qwen2-vl-72b"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_train_step_on_the_card_equals_the_cpu(cuda, arch):
    """One fp32 step (TF32 off, two microbatches, the launcher's batches:
    M-RoPE positions and zero stub inputs) of each family's reduced
    config, from one state on the CPU and the card: the loss within rtol
    1e-5, the moments and parameters by ``repro_torch.train.compare``'s
    rule at 1e-4 of each leaf's largest gradient (the CPU rule of
    tests/test_torch_train.py); whisper's six key biases, which the
    softmax cancels exactly, are its only dead leaves."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.pipeline import TokenStreamConfig
    from repro_torch.models.registry import build_model
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_loop as tloop
    from repro_torch.train.checkpoint import _flatten_with_names
    from repro_torch.train.compare import state_ratios, step_grads
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              compute_dtype=torch.float32)
    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=32,
                               global_batch=4)
    state = tloop.init_train_state(build_model(cfg, device="cpu"), 0)
    runs = []
    for dev in (torch.device("cpu"), cuda):
        bundle = build_model(cfg, device=dev)
        step = tloop.make_train_step(bundle, tloop.TrainConfig(
            microbatches=2, opt=topt.OptimizerConfig(
                peak_lr=1e-3, warmup_steps=0, total_steps=10)))
        st, m = step(tloop.train_state_to(state, dev),
                     tloop.train_batch(bundle, stream, 0))
        runs.append(({k: v.detach().cpu() for k, v in
                      _flatten_with_names(st).items()},
                     {k: float(v) for k, v in m.items()}))
    (want, mw), (got, mg) = runs
    assert abs(mg["loss"] - mw["loss"]) <= 1e-5 * abs(mw["loss"])
    assert abs(mg["aux_loss"] - mw["aux_loss"]) <= \
        1e-5 * abs(mw["aux_loss"]) + 1e-12
    grads = {n[len(".opt.nu"):]: step_grads(w) for n, w in want.items()
             if n.startswith(".opt.nu")}
    assert int(got[".opt.step"]) == 1
    r = state_ratios(want, got, [grads], [mw["lr"]], 1e-4)
    assert len(r["dead"]) == (6 if arch == "whisper-tiny" else 0), r["dead"]
    assert r["params_diff_over_tol"] <= 1.0, r
    assert r["moments_diff_over_tol"] <= 1.0, r


def test_whisper_training_forward_launches_no_kernel_10(cuda):
    """whisper-tiny at full size: ``forward_autograd`` (the encoder over
    1500 frames non-causal, the decoder causal) and its backward launch
    #10 no time; the no-grad ``forward_train`` launches it once a layer,
    4 encoder and 4 decoder layers."""
    from repro_torch import configs
    from repro_torch.models.registry import build_model, model_inputs
    from repro_torch.train import losses
    from repro_torch.train import optimizer as topt
    cfg = configs.get_config("whisper-tiny")
    bundle = build_model(cfg, device=cuda)
    params = bundle.init(0)
    for p in topt.tree_leaves(params):
        p.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab_size, (2, 448), device=cuda)
    pos = torch.arange(448, device=cuda)[None].expand(2, 448)
    batch = model_inputs(bundle, toks, pos)
    before = flash_attention.launches
    hidden, _ = bundle.forward_autograd(params, batch)
    loss, _ = losses.chunked_cross_entropy(hidden, toks, params["embed"])
    loss.backward()
    torch.cuda.synchronize()
    assert flash_attention.launches == before
    assert all(p.grad is not None for p in topt.tree_leaves(params))
    bundle.forward_train(params, batch)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.num_layers


# ---------------------------------------------------------------------------
# Sharded training and the dist/ substrates at world size 1 over NCCL
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_mesh2(cuda, monkeypatch):
    """A world-size-1 NCCL group and its (1, 1) ("data", "model") mesh,
    ended after the test."""
    import torch.distributed as dist
    from repro_torch.dist.sharding import make_mesh
    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "lo")
    assert not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    assert dist.get_backend() == "nccl"
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen3-moe-30b-a3b"])
def test_sharded_step_over_nccl_equals_the_mesh_less_step(nccl_mesh2,
                                                          arch):
    """Two fp32 steps of two microbatches on the card from one seeded
    state: ``make_train_step(..., mesh=)`` on the (1, 1) mesh gives the
    mesh-less step's metrics and state bit for bit (as on the CPU,
    tests/test_torch_train_mesh.py)."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.data.pipeline import TokenStreamConfig
    from repro_torch.models.registry import build_model
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_loop as tl
    from repro_torch.train.checkpoint import _flatten_with_names
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              compute_dtype=torch.float32)
    bundle = build_model(cfg, device="cuda")
    tc = tl.TrainConfig(microbatches=2, loss_chunk=16, opt=topt.OptimizerConfig(
        peak_lr=1e-3, warmup_steps=2, total_steps=10))
    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=32,
                               global_batch=4)
    plain = tl.init_train_state(bundle, 0)
    sharded = tl.init_train_state(bundle, 0, mesh=nccl_mesh2)
    step = tl.make_train_step(bundle, tc)
    sharded_step = tl.make_train_step(bundle, tc, mesh=nccl_mesh2,
                                      shape=ShapeSpec("t", 32, 4, "train"))
    for i in range(2):
        plain, want = step(plain, tl.train_batch(bundle, stream, i))
        sharded, got = sharded_step(
            sharded, tl.train_batch(bundle, stream, i, mesh=nccl_mesh2))
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
    got = _flatten_with_names(sharded)
    for name, w in _flatten_with_names(plain).items():
        g = got[name]
        g = g.full_tensor() if isinstance(g, DTensor) else g
        assert torch.equal(g, w), name


def test_dist_substrates_at_one_rank_over_nccl_equal_their_oracles(
        nccl_mesh):
    """At p = 1 over NCCL on the card: the ring all-gather matmul and its
    bulk oracle equal ``x @ w`` bit for bit, the ring reduce-scatter
    matmul too; the compressed mean is the dequantized int8 gradient and
    the residual its FMA-rounded error (fp64 on the CPU), the codes the
    CPU's; the one-stage pipeline is the stage."""
    from repro_torch.dist.collective_matmul import (ag_matmul,
                                                    ag_matmul_reference,
                                                    matmul_rs)
    from repro_torch.dist.compression import (_quantize_int8,
                                              compressed_psum_mean)
    from repro_torch.dist.pipeline import pipeline_apply
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((96, 64), generator=gen, device="cuda")
    w = torch.randn((64, 32), generator=gen, device="cuda")
    full = x @ w
    assert torch.equal(ag_matmul(x, w, nccl_mesh, "data"), full)
    assert torch.equal(ag_matmul_reference(x, w, nccl_mesh, "data"), full)
    assert torch.equal(matmul_rs(x, w, nccl_mesh, "data"), full)
    g = torch.randn((4, 128), generator=gen, device="cuda")
    mean, res = compressed_psum_mean(g, nccl_mesh, "data",
                                     torch.zeros_like(g))
    code, scale = _quantize_int8(g)
    want_code, want_scale = _quantize_int8(g.cpu())
    assert torch.equal(code.cpu(), want_code)
    assert torch.equal(scale.cpu(), want_scale)
    assert torch.equal(mean, code.float() * scale)
    assert torch.equal(res.cpu(), (g.cpu().double() - want_code.double()
                                   * want_scale.double()).float())
    ws = torch.randn((1, 16, 16), generator=gen, device="cuda") * 0.3
    xs = torch.randn((5, 8, 16), generator=gen, device="cuda")
    got = pipeline_apply(lambda w, x: torch.tanh(x @ w), nccl_mesh, "data",
                         ws, xs)
    assert torch.equal(got, torch.stack([torch.tanh(x @ ws[0])
                                         for x in xs]))
