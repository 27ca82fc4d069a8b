"""Hold this tree's fp32 filter kernels (#1, #3) bit for bit against another
checkout's, on one CUDA card.

    python3 tools/kernel_tree_parity.py --other DIR [--out FILE]

``DIR`` is the root of another checkout of the repository (for example an
unpacked ``git archive`` of the parent commit under ``build/``).  Both
trees' kernel libraries are built from their own sources
(``src/repro_torch/kernels/_build.py`` of each, loaded by path) and called
through ``ctypes`` on the same inputs: ``brk_ub_matrix`` (#1) and
``brk_filter_prune`` (#3) over one row block at the search's block shape
and at ragged shapes, and over a Deep attempt's 10^6 rows, where this
tree's #3 also runs as one ``brk_filter_prune_blocks`` launch over every
block against the other tree's per-block launches.  The UB totals must
match bit for bit (compared as int32 words) and the admit masks exactly.
Prints one JSON line per shape and exits 1 on the first difference.
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
        torch.cuda.synchronize()
        rec = {"shape": [n, m, q], "ub_bit_equal": same_bits(ub_a, ub_b),
               "fused_ub_bit_equal": same_bits(fu_a, fu_b),
               "admit_equal": bool(torch.equal(ad_a, ad_b)),
               "admitted": int(ad_a.sum()), "pairs": n * q}
        report(rec)
    n, m, q, bn = DEEP
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
    torch.cuda.synchronize()
    report({"shape": [n, m, q], "block_rows": bn, "blocks": nb,
            "ub_bit_equal": same_bits(ub_a, ub_b),
            "fused_ub_bit_equal": same_bits(fu_a[:n], fu_b),
            "admit_equal": bool(torch.equal(ad_a[:n], ad_b)),
            "inert_rows_ok": bool(torch.isinf(fu_a[n:]).all()
                                  and not ad_a[n:].any()),
            "admitted": int(ad_a.sum()), "pairs": n * q})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    keys = ("ub_bit_equal", "fused_ub_bit_equal", "admit_equal",
            "inert_rows_ok")
    bad = [r for r in records if not all(r.get(k, True) for k in keys)]
    mixed = all(0 < r["admitted"] < r["pairs"] for r in records
                if r["pairs"] >= 64)
    print(json.dumps({"ok": not bad and mixed, "differ": len(bad),
                      "mixed_masks": mixed}))
    return 0 if not bad and mixed else 1


if __name__ == "__main__":
    sys.exit(main())
