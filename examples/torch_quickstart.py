"""Quickstart on the PyTorch port: build a BrePartition index on the card
and run exact + approximate kNN.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--scale 0.05]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import search
from repro_torch.core.index import build_index
from repro_torch.data.pipeline import PAPER_DATASETS, make_queries, make_vectors


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=0.05,
                    help="fraction of Audio's 54,387 rows")
    args = ap.parse_args(argv)

    spec = PAPER_DATASETS["audio"]          # 192-dim, exponential distance
    data = make_vectors(spec, scale=args.scale)
    queries = make_queries(spec, num=5, scale=args.scale, data=data)
    print(f"dataset {spec.name}: n={data.shape[0]} d={spec.d} "
          f"measure={spec.measure} device={args.device}")

    # Offline (paper Alg. 5): M* from Theorem 4, PCCP partitioning,
    # P-transform tuples, ball forest, built on the device.
    index = build_index(data, spec.measure, device=args.device)
    print(f"index: M={index.m} subspaces, {index.num_clusters} balls each")

    # Online (paper Alg. 6): filter with Cauchy bounds, prune balls, refine.
    for k in (5, 20):
        res = search.knn_batch(index, queries, k, device=args.device)
        brute_ids, _ = search.brute_force_knn(data, queries[0], k,
                                              spec.measure,
                                              device=args.device)
        got = res.ids[0].cpu().numpy()
        ok = np.array_equal(np.sort(got), np.sort(brute_ids.cpu().numpy()))
        mean = float(res.num_candidates.to(torch.float64).mean())
        print(f"k={k}: exact={bool(res.exact.all())} "
              f"mean_candidates={mean:.0f} (of {data.shape[0]}), "
              f"matches brute force: {ok}")

    # Approximate mode (paper §8): probability-guaranteed, tighter bounds.
    res_a = search.knn_batch(index, queries, 20, approx_p=0.8,
                             device=args.device)
    mean = float(res_a.num_candidates.to(torch.float64).mean())
    print(f"approx p=0.8: mean_candidates={mean:.0f}")


if __name__ == "__main__":
    main()
