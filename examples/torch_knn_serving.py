"""kNN serving on the PyTorch port through the fault-tolerant retrieval
service (serve/retrieval.py): deadlines, admission control and the
degradation ladder over BrePartition search on one card — plus the
distributed launch path: the same index as a tenant sharded over the
ranks of the process group (``mesh=``, dist/knn.py; one rank when the
example starts the group itself, NCCL on the card, gloo on the CPU).

    PYTHONPATH=src python examples/torch_knn_serving.py [--device cpu] [--scale 0.01]
"""

import argparse

import numpy as np
import torch.distributed as dist

from repro_torch.core import search
from repro_torch.core.index import build_index
from repro_torch.data.pipeline import PAPER_DATASETS, make_queries, make_vectors
from repro_torch.dist.sharding import ensure_process_group
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve import RetrievalService, ServiceConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=0.01,
                    help="fraction of Deep's 10^6 rows")
    args = ap.parse_args(argv)

    spec = PAPER_DATASETS["deep"]
    data = make_vectors(spec, scale=args.scale)
    queries = make_queries(spec, num=16, scale=args.scale, data=data)
    index = build_index(data, spec.measure, m=8, device=args.device)

    svc = RetrievalService(ServiceConfig(default_deadline_s=2.0))
    tenant = svc.register_tenant("demo", index)
    print(f"tenant live_n={tenant.live_n} device={tenant.device} "
          f"block_rows={tenant.block_rows}")

    # k is validated against the LIVE point count up front: an oversized k
    # resolves to an explicit shed, never a deep pipeline error.
    bad = svc.search_sync("demo", queries[:1], k=tenant.live_n + 1)
    print(f"k > live_n: quality={bad.quality} reason={bad.shed_reason}")

    k = 10
    # Run both entry tiers once off the books, then a few unhurried
    # requests, so the cost model learns a warm launch's cost.
    svc.warm("demo", shapes=[(len(queries), k)])
    for _ in range(3):
        r = svc.search_sync("demo", queries, k, deadline_s=60.0)
        svc.search_sync("demo", queries, k, deadline_s=60.0,
                        target_recall=0.9)
    r = svc.search_sync("demo", queries, k)
    print(f"{len(queries)} queries: quality={r.quality} "
          f"latency={r.latency_s * 1e3:.1f} ms "
          f"deadline_met={r.deadline_met}")

    # Exact-tier responses match the index's own search and brute force.
    ref = search.knn_batch(index, queries, k, device=args.device)
    bf_ids, _ = search.brute_force_knn(data, queries, k, spec.measure,
                                       device=args.device)
    same = np.array_equal(r.ids, ref.ids.cpu().numpy())
    match = r.quality == "exact" and np.array_equal(
        np.sort(r.ids, -1), np.sort(bf_ids.cpu().numpy(), -1))
    print(f"matches knn_batch: {same}")
    print(f"matches brute force: {match}")

    # Degraded tiers on demand: a deadline below the known launch cost
    # walks the ladder (exact -> approx -> partial -> shed) instead of
    # blowing the budget.  The quality label reports what actually ran.
    for frac, note in ((1.5, "approx window"), (0.7, "partial window"),
                       (0.1, "must shed")):
        est = tenant.cost.estimate()     # the ladder prices with LIVE est
        resp = svc.search_sync("demo", queries, k, deadline_s=est * frac)
        print(f"deadline={est * frac * 1e3:6.1f} ms ({note}): "
              f"quality={resp.quality} tiers={resp.meta.get('tier_path')}")

    # §8 approximate mode is a first-class request parameter.
    resp = svc.search_sync("demo", queries, k, target_recall=0.9)
    print(f"target_recall=0.9: quality={resp.quality}")
    print(f"stats: launches={svc.counters['launches']} "
          f"tier mix=exact:{svc.counters['exact']} "
          f"approx:{svc.counters['approx']} "
          f"partial:{svc.counters['partial']} shed:{svc.counters['shed']}")

    # The same index sharded over the process group's ranks: its exact
    # responses match the single-device search.
    started = ensure_process_group(args.device)
    try:
        sharded = svc.register_tenant(
            "demo_sharded", index, mesh=make_host_mesh(device=args.device))
        r = svc.search_sync("demo_sharded", queries, k, deadline_s=60.0)
        match = r.quality == "exact" and np.array_equal(
            np.sort(r.ids, -1), np.sort(ref.ids.cpu().numpy(), -1))
        print(f"sharded tenant: {sharded.sharded.num_shards} shard(s) over "
              f"{dist.get_backend()}, quality={r.quality}")
        print(f"matches single-device BrePartition: {match}")
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
