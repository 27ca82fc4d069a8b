"""Hold this tree's filter and prune kernels (#1-#6) bit for bit, and its
int8 refine (#8) within its tolerance, against another checkout's, on one
CUDA card.

    python3 tools/kernel_tree_parity.py --other DIR [--out FILE]

``DIR`` is the root of another checkout of the repository (for example an
unpacked ``git archive`` of the parent commit under ``build/``).  Both
trees' kernel libraries are built from their own sources
(``src/repro_torch/kernels/_build.py`` of each, loaded by path) and called
through ``ctypes`` on the same inputs: ``brk_ub_matrix`` (#1),
``brk_ub_matrix_quant`` (#2), ``brk_filter_prune`` (#3),
``brk_filter_prune_quant`` (#4), ``brk_prune_mask`` (#5) and
``brk_prune_mask_quant`` (#6) over one row block at the search's block
shape and at ragged shapes, and over a Deep attempt's 10^6 rows, where
this tree's #1 and #2 run as one span launch and its #3, #4, #5 and #6
as one block-list launch over every block (``brk_prune_mask_blocks`` for
#5 and ``brk_prune_mask_blocks_quant`` for #6, each also held against
this tree's #3 or #4 admit; #5 and #6 also as one span launch) against
the other tree's per-block launches.  The UB totals must match bit for bit (compared as
int32 words) and the admit masks exactly.  ``brk_refine_batch_quant``
(#8) of both trees, every family, must each lie within d * eps32 * sum
|terms| of the plain version; the records give their largest difference
over that tolerance and the share of bit-equal distances.  Prints one JSON
line per shape and exits 1 if any check fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# (n, M, q): Deep's row block, the card tests' ragged shapes, Audio's q.
BLOCK_SHAPES = [(4096, 39, 14), (4133, 37, 50), (31, 1, 1), (77, 70, 33),
                (4096, 33, 50), (1000, 300, 13), (500, 40, 65)]
DEEP = (1_000_000, 39, 14, 4096)
DEEP_INT8_Q = 13                  # the int8 tier's query batch on Deep
# (q, b, d) of #8: the int8 Deep refine's d at a slice of its b, Audio's
# d, and ragged ones.
REFINE_SHAPES = [(13, 20000, 256), (5, 3000, 192), (3, 77, 33),
                 (2, 50, 1), (4, 301, 600)]
FAMILIES = ("squared_euclidean", "itakura_saito", "exponential", "burg",
            "shannon")
EPS32 = 2.0 ** -23


def load_build(root: Path, name: str):
    """The ``_build`` module of the checkout at ``root``, under ``name``."""
    path = root / "src" / "repro_torch" / "kernels" / "_build.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(n: int, m: int, q: int, seed: int, dev) -> list:
    """Tables with a mixed admit mask; row 0 ties its bound in subspace 0."""
    gen = torch.Generator().manual_seed(seed)
    alpha = torch.randn((n, m), generator=gen)
    sg = torch.randn((n, m), generator=gen).abs()
    amin = torch.randn((n, m), generator=gen)
    gmax = torch.randn((n, m), generator=gen).abs()
    qc = torch.randn((q, m), generator=gen)
    sd = torch.randn((q, m), generator=gen).abs()
    rows = torch.randperm(n, generator=gen)[:2000]
    lb = (amin[rows, :, None] + qc.T[None]) - gmax[rows, :, None] * sd.T[None]
    qb = torch.quantile(lb, 1.0 - 0.5 ** (1.0 / m), dim=0).T.contiguous()
    qb[:, 0] = (amin[0, 0] + qc[:, 0]) - gmax[0, 0] * sd[:, 0]
    return [t.to(dev) for t in (alpha, sg, amin, gmax, qc, sd, qb)]


def quant_table(n, m, gen, nonneg=False):
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
    return [codes, scale, zp]


def inputs_quant(n: int, m: int, q: int, seed: int, dev) -> list:
    """The int8 kernels' twelve tables (codes, scale, zp each) and qc, sd,
    qb: a mixed admit mask, row 0's decoded lower bound tying its bound in
    subspace 0."""
    gen = torch.Generator().manual_seed(seed)
    tables = [t for i in range(4)
              for t in quant_table(n, m, gen, nonneg=i in (1, 3))]
    qc = torch.randn((q, m), generator=gen)
    sd = torch.randn((q, m), generator=gen).abs()
    amin = tables[6].float() * tables[7][:, None] + tables[8][:, None]
    gmax = tables[9].float() * tables[10][:, None] + tables[11][:, None]
    rows = torch.randperm(n, generator=gen)[:2000]
    lb = (amin[rows, :, None] + qc.T[None]) - gmax[rows, :, None] * sd.T[None]
    qb = torch.quantile(lb, 1.0 - 0.5 ** (1.0 / m), dim=0).T.contiguous()
    qb[:, 0] = (amin[0, 0] + qc[:, 0]) - gmax[0, 0] * sd[:, 0]
    return [t.to(dev) for t in (*tables, qc, sd, qb)]


def fused_quant_of(lib, tables, qc, sd, qb, blocks=None, bn=None):
    """#4 over the int8 tables' n rows (one block), or over ``blocks`` of
    ``bn`` rows through the block-list entry."""
    n, m = tables[0].shape
    q = qc.shape[0]
    rows = n if blocks is None else blocks.shape[0] * bn
    ub = torch.empty((rows, q), device=qc.device)
    admit = torch.empty((rows, q), dtype=torch.int32, device=qc.device)
    qsum, sdsum = qc.sum(-1), sd.sum(-1)
    ptrs = [t.data_ptr() for t in (*tables, qsum, qc, sd, sdsum, qb)]
    stream = torch.cuda.current_stream().cuda_stream
    if blocks is None:
        err = lib.brk_filter_prune_quant(*ptrs, ub.data_ptr(),
                                         admit.data_ptr(), n, m, q,
                                         qc.device.index, stream)
    else:
        err = lib.brk_filter_prune_blocks_quant(
            *ptrs, blocks.data_ptr(), ub.data_ptr(), admit.data_ptr(), n, m,
            q, blocks.shape[0], bn, qc.device.index, stream)
    assert err == 0, err
    return ub, admit


def ub_quant_of(lib, filt, qc, sd):
    """#2 over the int8 filter tables' n rows (codes and decode, six
    tables) in one launch."""
    n, m = filt[0].shape
    q = qc.shape[0]
    out = torch.empty((n, q), device=qc.device)
    ptrs = [t.data_ptr() for t in (*filt, qc.sum(-1), sd, sd.sum(-1))]
    err = lib.brk_ub_matrix_quant(*ptrs, out.data_ptr(), n, m, q,
                                  qc.device.index,
                                  torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def prune_quant_of(lib, corners, qc, sd, qb, blocks=None, bn=None):
    """#6 over the int8 corner tables' n rows (codes and decode, six
    tables), or over ``blocks`` of ``bn`` rows through the block-list
    entry."""
    n, m = corners[0].shape
    q = qc.shape[0]
    rows = n if blocks is None else blocks.shape[0] * bn
    admit = torch.empty((rows, q), dtype=torch.int32, device=qc.device)
    ptrs = [t.data_ptr() for t in (*corners, qc, sd, qb)]
    stream = torch.cuda.current_stream().cuda_stream
    if blocks is None:
        err = lib.brk_prune_mask_quant(*ptrs, admit.data_ptr(), n, m, q,
                                       qc.device.index, stream)
    else:
        err = lib.brk_prune_mask_blocks_quant(
            *ptrs, blocks.data_ptr(), admit.data_ptr(), n, m, q,
            blocks.shape[0], bn, qc.device.index, stream)
    assert err == 0, err
    return admit


def refine_quant_of(lib, codes, scale, zp, grad, c_y, family):
    q, b, d = codes.shape
    out = torch.empty((q, b), device=codes.device)
    err = lib.brk_refine_batch_quant(
        codes.data_ptr(), scale.data_ptr(), zp.data_ptr(), grad.data_ptr(),
        c_y.data_ptr(), out.data_ptr(), q, b, d, FAMILIES.index(family),
        codes.device.index, torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def refine_records(ours, other, dev) -> list:
    """#8 of both trees against the plain version, every family."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.bounds import query_refine_constants
    from repro_torch.core.bregman import get_family
    from repro_torch.core.quantize import dequantize_rows
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(11)
    out = []
    for q, b, d in REFINE_SHAPES:
        for family in FAMILIES:
            fam = get_family(family)
            codes, scale, zp = quant_table(q * b, d, gen)
            if fam.domain_low == 0.0:
                zp = zp.abs() * 2.0            # some decoded values clamp
            codes = codes.reshape(q, b, d).to(dev)
            scale, zp = scale.reshape(q, b).to(dev), zp.reshape(q, b).to(dev)
            ys = torch.randn((q, d), generator=gen)
            ys = ys.abs() + 0.05 if fam.domain_low == 0.0 else ys.clamp(-4, 4)
            c = query_refine_constants(ys.to(dev), fam)
            args = (codes, scale, zp, c["grad"], c["c_y"], family)
            a, o = refine_quant_of(ours, *args), refine_quant_of(other, *args)
            want = ref.bregman_refine_batch_quant(*args)
            x = dequantize_rows(codes, scale, zp, family)
            tol = d * EPS32 * (ref.PHIS[family](x).abs().sum(-1)
                               + torch.einsum("qbd,qd->qb", x,
                                              c["grad"]).abs()
                               + c["c_y"].abs()[:, None])
            over = [float(((k - want).abs() / tol).max()) for k in (a, o)]
            out.append({"refine": family, "shape": [q, b, d],
                        "over_tol": over[0], "other_over_tol": over[1],
                        "within_tol": over[0] <= 1.0 and over[1] <= 1.0,
                        "max_abs_diff_vs_other": float((a - o).abs().max()),
                        "bit_equal_share": float(
                            (a.view(torch.int32) == o.view(torch.int32))
                            .double().mean())})
    return out


def ub_of(lib, a, g, qsum, sd):
    n, m = a.shape
    q = qsum.shape[0]
    out = torch.empty((n, q), device=a.device)
    err = lib.brk_ub_matrix(a.data_ptr(), g.data_ptr(), qsum.data_ptr(),
                            sd.data_ptr(), out.data_ptr(), n, m, q,
                            a.device.index,
                            torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def fused_of(lib, a, g, am, gm, qsum, qc, sd, qb):
    n, m = a.shape
    q = qsum.shape[0]
    ub = torch.empty((n, q), device=a.device)
    admit = torch.empty((n, q), dtype=torch.int32, device=a.device)
    err = lib.brk_filter_prune(
        a.data_ptr(), g.data_ptr(), am.data_ptr(), gm.data_ptr(),
        qsum.data_ptr(), qc.data_ptr(), sd.data_ptr(), qb.data_ptr(),
        ub.data_ptr(), admit.data_ptr(), n, m, q, a.device.index,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return ub, admit


def prune_of(lib, am, gm, qc, sd, qb):
    """#5 over the fp32 corner tables' n rows."""
    n, m = am.shape
    q = qc.shape[0]
    admit = torch.empty((n, q), dtype=torch.int32, device=am.device)
    err = lib.brk_prune_mask(am.data_ptr(), gm.data_ptr(), qc.data_ptr(),
                             sd.data_ptr(), qb.data_ptr(), admit.data_ptr(),
                             n, m, q, am.device.index,
                             torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return admit


def prune_blocks_of(lib, am, gm, qc, sd, qb, blocks, bn):
    """#5 over ``blocks`` of ``bn`` rows of the fp32 corner tables through
    the block-list entry (this tree's)."""
    n, m = am.shape
    q = qc.shape[0]
    admit = torch.empty((blocks.shape[0] * bn, q), dtype=torch.int32,
                        device=am.device)
    err = lib.brk_prune_mask_blocks(
        am.data_ptr(), gm.data_ptr(), qc.data_ptr(), sd.data_ptr(),
        qb.data_ptr(), blocks.data_ptr(), admit.data_ptr(), n, m, q,
        blocks.shape[0], bn, am.device.index,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return admit


def fused_blocks_of(lib, tables, qsum, qc, sd, qb, blocks, bn):
    a, g, am, gm = tables
    n, m = a.shape
    q = qsum.shape[0]
    nb = blocks.shape[0]
    ub = torch.empty((nb * bn, q), device=a.device)
    admit = torch.empty((nb * bn, q), dtype=torch.int32, device=a.device)
    err = lib.brk_filter_prune_blocks(
        a.data_ptr(), g.data_ptr(), am.data_ptr(), gm.data_ptr(),
        qsum.data_ptr(), qc.data_ptr(), sd.data_ptr(), qb.data_ptr(),
        blocks.data_ptr(), ub.data_ptr(), admit.data_ptr(), n, m, q, nb, bn,
        a.device.index, torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return ub, admit


def same_bits(x, y) -> bool:
    return x.shape == y.shape and bool(torch.equal(x.view(torch.int32),
                                                   y.view(torch.int32)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True,
                        help="root of the checkout to compare against")
    parser.add_argument("--out", help="write the records as JSON here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_tree_parity.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    ours = load_build(ROOT, "this_tree_build").library()
    other = load_build(Path(args.other).resolve(), "other_tree_build").library()
    records = []

    def report(rec: dict) -> None:
        records.append(rec)
        print(json.dumps(rec), flush=True)

    for n, m, q in BLOCK_SHAPES:
        a, g, am, gm, qc, sd, qb = inputs(n, m, q, n + m + q, dev)
        qsum = qc.sum(-1)
        ub_a, ub_b = ub_of(ours, a, g, qsum, sd), ub_of(other, a, g, qsum, sd)
        (fu_a, ad_a), (fu_b, ad_b) = (
            fused_of(lib, a, g, am, gm, qsum, qc, sd, qb)
            for lib in (ours, other))
        pr_a, pr_b = (prune_of(lib, am, gm, qc, sd, qb)
                      for lib in (ours, other))
        torch.cuda.synchronize()
        rec = {"shape": [n, m, q], "ub_bit_equal": same_bits(ub_a, ub_b),
               "fused_ub_bit_equal": same_bits(fu_a, fu_b),
               "admit_equal": bool(torch.equal(ad_a, ad_b)),
               "prune_admit_equal": bool(torch.equal(pr_a, pr_b)),
               "prune_equals_fused_admit": bool(torch.equal(pr_a, ad_a)),
               "admitted": int(ad_a.sum()), "pairs": n * q}
        report(rec)
    for n, m, q in BLOCK_SHAPES:
        *tables, qc, sd, qb = inputs_quant(n, m, q, n + m + q + 1, dev)
        (fu_a, ad_a), (fu_b, ad_b) = (fused_quant_of(lib, tables, qc, sd, qb)
                                      for lib in (ours, other))
        ub_a, ub_b = (ub_quant_of(lib, tables[:6], qc, sd)
                      for lib in (ours, other))
        pr_a, pr_b = (prune_quant_of(lib, tables[6:], qc, sd, qb)
                      for lib in (ours, other))
        torch.cuda.synchronize()
        report({"shape": [n, m, q], "int8": True,
                "ub_bit_equal": same_bits(ub_a, ub_b),
                "fused_ub_bit_equal": same_bits(fu_a, fu_b),
                "admit_equal": bool(torch.equal(ad_a, ad_b)),
                "prune_admit_equal": bool(torch.equal(pr_a, pr_b)),
                "prune_equals_fused_admit": bool(torch.equal(pr_a, ad_a)),
                "admitted": int(ad_a.sum()), "pairs": n * q})
    n, m, q, bn = DEEP
    *tables, qc, sd, qb = inputs_quant(n, m, DEEP_INT8_Q, 8, dev)
    nb = -(-n // bn)
    blocks = torch.arange(nb, dtype=torch.int32, device=dev)
    fu_a, ad_a = fused_quant_of(ours, tables, qc, sd, qb, blocks, bn)
    parts = [fused_quant_of(other, [t[s:s + bn] for t in tables], qc, sd, qb)
             for s in range(0, n, bn)]
    fu_b = torch.cat([u for u, _ in parts])
    ad_b = torch.cat([d for _, d in parts])
    del parts
    ub_a = ub_quant_of(ours, tables[:6], qc, sd)
    ub_b = torch.cat([ub_quant_of(other, [t[s:s + bn] for t in tables[:6]],
                                  qc, sd) for s in range(0, n, bn)])
    pr_a = prune_quant_of(ours, tables[6:], qc, sd, qb, blocks, bn)
    pr_span = prune_quant_of(ours, tables[6:], qc, sd, qb)
    pr_b = torch.cat([prune_quant_of(other, [t[s:s + bn] for t in tables[6:]],
                                     qc, sd, qb) for s in range(0, n, bn)])
    torch.cuda.synchronize()
    report({"shape": [n, m, DEEP_INT8_Q], "int8": True, "block_rows": bn,
            "blocks": nb, "ub_bit_equal": same_bits(ub_a, ub_b),
            "fused_ub_bit_equal": same_bits(fu_a[:n], fu_b),
            "admit_equal": bool(torch.equal(ad_a[:n], ad_b)),
            "prune_admit_equal": bool(torch.equal(pr_a[:n], pr_b)),
            "prune_span_admit_equal": bool(torch.equal(pr_span, pr_b)),
            "prune_equals_fused_admit": bool(torch.equal(pr_a, ad_a)),
            "inert_rows_ok": bool(torch.isinf(fu_a[n:]).all()
                                  and not ad_a[n:].any()
                                  and not pr_a[n:].any()),
            "admitted": int(ad_a.sum()), "pairs": n * DEEP_INT8_Q})
    del tables, fu_a, fu_b, ad_a, ad_b, ub_a, ub_b, pr_a, pr_b, pr_span
    a, g, am, gm, qc, sd, qb = inputs(n, m, q, 7, dev)
    qsum = qc.sum(-1)
    nb = -(-n // bn)
    ub_a = ub_of(ours, a, g, qsum, sd)
    ub_b = torch.cat([ub_of(other, a[s:s + bn], g[s:s + bn], qsum, sd)
                      for s in range(0, n, bn)])
    blocks = torch.arange(nb, dtype=torch.int32, device=dev)
    fu_a, ad_a = fused_blocks_of(ours, (a, g, am, gm), qsum, qc, sd, qb,
                                 blocks, bn)
    parts = [fused_of(other, a[s:s + bn], g[s:s + bn], am[s:s + bn],
                      gm[s:s + bn], qsum, qc, sd, qb)
             for s in range(0, n, bn)]
    fu_b = torch.cat([u for u, _ in parts])
    ad_b = torch.cat([d for _, d in parts])
    del parts
    pr_a = prune_blocks_of(ours, am, gm, qc, sd, qb, blocks, bn)
    pr_span = prune_of(ours, am, gm, qc, sd, qb)
    pr_b = torch.cat([prune_of(other, am[s:s + bn], gm[s:s + bn], qc, sd,
                               qb) for s in range(0, n, bn)])
    torch.cuda.synchronize()
    report({"shape": [n, m, q], "block_rows": bn, "blocks": nb,
            "ub_bit_equal": same_bits(ub_a, ub_b),
            "fused_ub_bit_equal": same_bits(fu_a[:n], fu_b),
            "admit_equal": bool(torch.equal(ad_a[:n], ad_b)),
            "prune_admit_equal": bool(torch.equal(pr_a[:n], pr_b)),
            "prune_span_admit_equal": bool(torch.equal(pr_span, pr_b)),
            "prune_equals_fused_admit": bool(torch.equal(pr_a, ad_a)),
            "inert_rows_ok": bool(torch.isinf(fu_a[n:]).all()
                                  and not ad_a[n:].any()
                                  and not pr_a[n:].any()),
            "admitted": int(ad_a.sum()), "pairs": n * q})
    del a, g, am, gm, pr_a, pr_b, pr_span
    for rec in refine_records(ours, other, dev):
        report(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    keys = ("ub_bit_equal", "fused_ub_bit_equal", "admit_equal",
            "prune_admit_equal", "prune_span_admit_equal",
            "prune_equals_fused_admit", "inert_rows_ok", "within_tol")
    bad = [r for r in records if not all(r.get(k, True) for k in keys)]
    mixed = all(0 < r["admitted"] < r["pairs"] for r in records
                if r.get("pairs", 0) >= 64)
    print(json.dumps({"ok": not bad and mixed, "differ": len(bad),
                      "mixed_masks": mixed}))
    return 0 if not bad and mixed else 1


if __name__ == "__main__":
    sys.exit(main())
