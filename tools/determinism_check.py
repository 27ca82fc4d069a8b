"""Check that the blob corpus's index build, its search and the brute-force
scan repeat bit for bit on one CUDA card.

    python3 tools/determinism_check.py [--src DIR] [--n N] [--out FILE]

The corpus is chip_smoke.py's blob corpus: 16 Gaussian blobs 100 apart,
squared Euclidean, d = 32, m = 4, 64 clusters, seed 0, n = 2^20 rows by
default.  The script

* builds the index twice and compares every table of the two forests;
* sums the first subspace's rows by their final cluster five times with
  ``index_add_`` and five times with ``index_put_(accumulate=True)`` on the
  card, counting the distinct results of each and comparing them with the
  CPU's ``index_add_`` (the k-means centre update);
* on the first forest, runs ``knn_batch(approx_p=1.0)`` on the
  calibration's 64 held-out queries twice and the live-row brute-force
  scan twice, comparing each pair, and counts the p = 1 ids that differ
  from the scan's;
* fits the recall curve on both forests.

``--src`` imports ``repro_torch`` from another checkout's ``src`` (for
example an unpacked ``git archive`` of the parent commit under
``build/``), whose kernels build from its own sources.  Prints one JSON
object and exits 1 if the build, the search or the scan does not repeat.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
K = 10


def blob_data(n: int) -> np.ndarray:
    """chip_smoke.py's blob corpus rows (its queries are not needed)."""
    d, blobs = 32, 16
    rng = np.random.default_rng(0)
    per = n // blobs
    return np.concatenate([rng.normal(size=(per, d)) + 100.0 * j
                           for j in range(blobs)]).astype(np.float32)


def differing_fields(a, b, fields) -> list:
    return [f for f in fields
            if not torch.equal(getattr(a, f), getattr(b, f))]


def centre_sums(forest, data: np.ndarray) -> dict:
    """Distinct results of five repeats of the centre update's row sums
    of subspace 0, by ``index_add_`` and by ``index_put_``, on the card."""
    dev = forest.device
    part = forest.partition
    x = part.gather(torch.from_numpy(data).to(dev))[:, 0, :].contiguous()
    assign = forest.assign[torch.argsort(forest.point_ids.long()), 0].long()
    c, w = forest.num_clusters, x.shape[1]
    cpu = torch.zeros((c, w)).index_add_(0, assign.cpu(), x.cpu())
    out = {}
    for name, run in (
            ("index_add_", lambda: torch.zeros(
                (c, w), device=dev).index_add_(0, assign, x)),
            ("index_put_", lambda: torch.zeros(
                (c, w), device=dev).index_put_((assign,), x,
                                               accumulate=True))):
        sums = [run().cpu() for _ in range(5)]
        distinct = [s for i, s in enumerate(sums)
                    if not any(torch.equal(s, t) for t in sums[:i])]
        out[name] = {"distinct_of_5": len(distinct),
                     "equal_to_cpu_index_add_": [bool(torch.equal(s, cpu))
                                                 for s in distinct]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("determinism_check: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import calibrate as tcal
    from repro_torch.core import index as tidx
    from repro_torch.core import search as tsearch

    data = blob_data(args.n)
    builds = [tidx.build_index(data, "squared_euclidean", m=4,
                               num_clusters=64, seed=0, device="cuda")
              for _ in range(2)]
    a, b = builds
    fields = tidx.interchange_fields(a.storage)
    rec = {"src": args.src, "n": args.n,
           "device": torch.cuda.get_device_name(0),
           "build_fields_differing": differing_fields(a, b, fields),
           "centre_sums": centre_sums(a, data)}

    qs = torch.as_tensor(tcal.held_out_queries(a, 64, seed=0),
                         device="cuda")
    p1 = [tsearch.knn_batch(a, qs, K, approx_p=1.0, device="cuda")
          for _ in range(2)]
    scan = [tsearch._brute_force_live(a, qs, K) for _ in range(2)]
    rec["p1_search_fields_differing"] = [
        f for f in p1[0]._fields
        if not torch.equal(getattr(p1[0], f), getattr(p1[1], f))]
    rec["scan_repeats"] = all(torch.equal(x, y)
                              for x, y in zip(scan[0], scan[1], strict=True))
    rec["p1_ids_differing_from_scan"] = int(
        (p1[0].ids != scan[0][0]).sum())
    rec["recall_grid"] = [
        tcal.fit_calibration(f, k=K, num_queries=64).recall_grid.tolist()
        for f in builds]
    ok = (not rec["build_fields_differing"]
          and not rec["p1_search_fields_differing"] and rec["scan_repeats"])
    rec["ok"] = ok
    line = json.dumps(rec)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
