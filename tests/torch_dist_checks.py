"""The port's distributed search at world sizes above 1, on the CPU.

Run as a script (tests/test_torch_dist.py does, in a subprocess):

    PYTHONPATH=src python tests/torch_dist_checks.py --worlds 2 4

For each world size it spawns that many ranks joined over gloo at a free
localhost port; the worlds run side by side.  Every rank builds the same seeded index with the port,
shards it with ``shard_index`` and checks, per family and storage tier:

* at a budget no shard overflows, ``distributed_knn`` is bit-equal to the
  single-host ``knn_search_batch`` (ids, dists, exact, num_candidates),
  exact and at ``approx_p`` 0.9 (bit-equal to ``knn_search_batch_approx``);
* the exchanged global bounds equal the single-host ``_filter_bounds``
  bit for bit (in int8 they carry the slack of the rows that set the k-th
  UB, whichever shard holds them);
* from a budget of k the retry ladder ends exact with the same result,
  and a capped run reports ``exact`` truthfully (the union sizes are the
  single host's, and an exact row is the single host's row);
* on six blobs, where the envelope gate skips whole blocks, the same
  bit-equality: each shard reads the global envelopes at its own rows;
* a mutable index with deletions, sharded, equals its single-host search
  and returns no deleted id;
* every rank leaves the retry ladder at the same launch when only the
  last rank's ``stop_retry`` says stop, and when only rank 0's clock
  passes ``launch_timeout_s`` (each rank raises ``LaunchTimeout`` with
  the same result);
* on indexes the JAX package built (int8 Itakura-Saito, over padded
  shards, and the blobs), the port's ``distributed_knn`` agrees with the
  JAX package's on a forced host mesh of as many devices: ids, exact and
  num_candidates equal, dists within 1e-5.  The JAX side runs in a child
  process of its own (``--jax-side``), beside the ranks, and hands its
  indexes and results over in ``<out>/jax_<world>.npz``.

Rank 0 prints ``ok world=<n>``, ``ok exits world=<n>`` and ``ok jax
world=<n>`` as each part passes on every rank; any failure makes the
process exit with a code other than 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N, D, M, K, Q = 421, 16, 4, 5, 6
BLOB = 250      # rows of a blob; six blobs make 1500 rows
POSITIVE = ("itakura_saito", "burg", "shannon")
CASES = (("squared_euclidean", False), ("itakura_saito", True),
         ("exponential", False), ("shannon", True))


def sample(family: str, shape, seed: int) -> np.ndarray:
    raw = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if family in POSITIVE:
        return np.abs(raw) + np.float32(0.05)
    if family == "exponential":
        return np.clip(raw, -4.0, 4.0)
    return raw


def bit_equal(got, want, what: str) -> None:
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert torch.equal(a, b), f"{what}: {f} differs\n{a}\n{b}"


def blob_data():
    """(data, queries): six blobs of BLOB rows 10 apart, and three
    queries in blob 0, whose bounds are tight."""
    rng = np.random.default_rng(4)
    data = np.concatenate([rng.normal(size=(BLOB, D)) + 10.0 * j
                           for j in range(6)]).astype(np.float32)
    return data, data[[0, 7, 100]] * np.float32(1.01)


def blob_last(point_ids: np.ndarray) -> bool:
    """Whether blob 0's rows lie mostly in the second half of the layout."""
    return float(np.flatnonzero(point_ids < BLOB).mean()) >= len(point_ids) / 2


def blob_index(quantize: bool):
    """(forest, queries) of :func:`blob_data`, squared Euclidean.  Blob 0
    is laid out last (a row order is an index's own choice), so its rows
    sit on the last shard, whose envelope rows are not the first
    shard's."""
    from repro_torch.core.index import (build_index, point_fields,
                                        refresh_envelopes)
    data, ys = blob_data()
    forest = build_index(data, "squared_euclidean", m=M, num_clusters=8,
                         seed=0, quantize=quantize, device="cpu")
    if not blob_last(forest.point_ids.numpy()):
        forest = refresh_envelopes(dataclasses.replace(forest, **{
            f: getattr(forest, f).flip(0) for f in point_fields(forest)}))
    return forest, ys


# The indexes the JAX package builds for the comparison: (family,
# quantize), and the runs held against its distributed_knn.
JAX_CASES = {"is_int8": ("itakura_saito", True),
             "blobs": ("squared_euclidean", False)}


def jax_runs(name: str, local_n: int) -> dict:
    """tag -> distributed_knn knobs for one JAX case at ``local_n`` rows a
    shard: the no-overflow budget exact and approximate, the capped run
    and the ladder (the blobs at the no-overflow budget alone)."""
    if name == "blobs":
        return {"exact": dict(budget=local_n, block_rows=64)}
    return {"exact": dict(budget=local_n, max_doublings=0),
            "approx": dict(budget=local_n, approx_p=0.9, max_doublings=0),
            "capped": dict(budget=K, max_doublings=0),
            "ladder": dict(budget=K)}


def check(rank: int, world: int, mesh) -> None:
    from repro_torch.core import search as ts
    from repro_torch.core.index import build_index
    from repro_torch.core.segments import SegmentedForest
    from repro_torch.dist import knn as dk

    for family, quantize in CASES:
        what = f"world {world} {family} {'int8' if quantize else 'fp32'}"
        data = sample(family, (N, D), seed=0)
        ys = sample(family, (Q, D), seed=1)
        forest = build_index(data, family, m=M, num_clusters=8, seed=0,
                             quantize=quantize, device="cpu")
        sharded = dk.shard_index(forest, mesh, device="cpu")
        assert sharded.num_shards == world and sharded.shard == rank
        assert sharded.local_n == -(-N // world)
        local = sharded.local_n
        for p in (None, 0.9):
            got = dk.distributed_knn(sharded, ys, family=family, k=K,
                                     budget=local, approx_p=p,
                                     max_doublings=0, device="cpu")
            want = (ts.knn_search_batch(forest, ys, K, N, device="cpu")
                    if p is None else
                    ts.knn_search_batch_approx(forest, ys, K, N, p,
                                               device="cpu"))
            assert bool(want.exact.all()), what
            bit_equal(got, want, f"{what} p={p}")
            qs = ts.query_struct(torch.as_tensor(ys), forest.partition,
                                 forest.family)
            qb = dk._global_bounds(sharded.forest, mesh.get_group("data"),
                                   qs, K, ts.DEFAULT_BLOCK_ROWS, p)
            assert torch.equal(qb, ts._filter_bounds(
                forest, qs, K, ts.DEFAULT_BLOCK_ROWS, p)), f"{what} qb"
        exact = ts.knn_search_batch(forest, ys, K, N, device="cpu")
        capped = dk.distributed_knn(sharded, ys, family=family, k=K,
                                    budget=K, max_doublings=0, device="cpu")
        assert torch.equal(capped.num_candidates, exact.num_candidates), what
        assert not bool(capped.exact.all()), f"{what}: no overflow at k"
        rows = capped.exact
        assert torch.equal(capped.ids[rows], exact.ids[rows]), what
        assert torch.equal(capped.dists[rows], exact.dists[rows]), what
        laddered = dk.distributed_knn(sharded, ys, family=family, k=K,
                                      budget=K, device="cpu")
        bit_equal(laddered, exact, f"{what} ladder")

    # Blobs 10 apart: the envelope gate skips whole blocks, so each shard
    # must read the global envelopes from its own first row.
    for quantize in (False, True):
        forest, ys = blob_index(quantize)
        _, stats = ts.knn_search_batch_stats(forest, ys, K, forest.n,
                                             block_rows=64, device="cpu")
        assert stats["whole_block_skip_rate"] > 0.1, stats
        sharded = dk.shard_index(forest, mesh, device="cpu")
        got = dk.distributed_knn(sharded, ys, family="squared_euclidean",
                                 k=K, budget=sharded.local_n, block_rows=64,
                                 device="cpu")
        want = ts.knn_search_batch(forest, ys, K, forest.n, block_rows=64,
                                   device="cpu")
        bit_equal(got, want, f"world {world} blobs int8={quantize}")

    # A mutable index: the tombstoned rows never surface.
    family = "squared_euclidean"
    data = sample(family, (N + 40, D), seed=2)
    ys = sample(family, (Q, D), seed=3)
    sf = SegmentedForest.from_forest(build_index(
        data[:N], family, m=M, num_clusters=8, seed=0, device="cpu"))
    sf.insert(data[N:], auto_compact=False)
    top, _ = ts.brute_force_knn(data, ys[0], K, family, device="cpu")
    doomed = sorted(set(top.tolist()) | {3, N + 5})
    sf.delete(doomed, auto_compact=False)
    sharded = dk.shard_index(sf, mesh, device="cpu")
    assert sharded.global_live_n == sf.live_n
    got = dk.distributed_knn(sharded, ys, family=family, k=K,
                             budget=sharded.local_n, device="cpu")
    want = ts.knn_search_batch(sf, ys, K, sf.view().n, device="cpu")
    bit_equal(got, want, f"world {world} mutable")
    assert not np.isin(got.ids.numpy(), doomed).any()


def check_exits(rank: int, world: int, mesh) -> None:
    """A rank's clock and its stop_retry are its own; every rank must
    still leave the ladder at the same launch, or the others wait in the
    next launch's collectives.  From a budget of k the first launch
    overflows, so a rank that went on alone would hang the run."""
    from repro_torch.core.index import build_index
    from repro_torch.dist import knn as dk

    family = "itakura_saito"
    forest = build_index(sample(family, (N, D), seed=0), family, m=M,
                         num_clusters=8, seed=0, device="cpu")
    ys = sample(family, (Q, D), seed=1)
    sharded = dk.shard_index(forest, mesh, device="cpu")
    kw = dict(family=family, k=K, budget=K, device="cpu")
    capped = dk.distributed_knn(sharded, ys, max_doublings=0, **kw)
    assert not bool(capped.exact.all())
    # Only the last rank's stop_retry says stop.
    hook = []
    got = dk.distributed_knn(sharded, ys, stop_retry=lambda: rank == world - 1,
                             launch_hook=hook.append, **kw)
    bit_equal(got, capped, f"world {world} stop_retry")
    assert len(hook) == 1, hook
    # Only rank 0's clock passes the timeout: each call reads 10 s more.
    ticks = iter(range(0, 1000, 10))
    clock = (lambda: float(next(ticks))) if rank == 0 else time.monotonic
    hook = []
    try:
        dk.distributed_knn(sharded, ys, launch_timeout_s=5.0, clock=clock,
                           launch_hook=hook.append, **kw)
    except dk.LaunchTimeout as e:
        bit_equal(e.result, capped, f"world {world} timeout")
        assert e.elapsed_s == 10.0 and hook == [10.0], (e.elapsed_s, hook)
    else:
        raise AssertionError(f"rank {rank}: no LaunchTimeout")


def load_jax(out: str, world: int, wait_s: float = 300.0) -> dict:
    """The JAX child's indexes and results for ``world``, once written."""
    path = os.path.join(out, f"jax_{world}.npz")
    failed = os.path.join(out, "jax.failed")
    end = time.monotonic() + wait_s
    while not os.path.exists(path):
        if os.path.exists(failed) or time.monotonic() > end:
            raise RuntimeError(f"the JAX side wrote no {path}")
        time.sleep(0.1)
    with np.load(path) as z:
        return dict(z)


def check_against_jax(world: int, mesh, out: str) -> None:
    """The port's distributed_knn on the JAX package's indexes, held
    against the JAX package's distributed_knn at the same world size."""
    from repro_torch.core.index import forest_from_numpy, interchange_fields
    from repro_torch.dist import knn as dk

    got_jax = load_jax(out, world)
    for name, (family, quantize) in JAX_CASES.items():
        storage = "int8" if quantize else "f32"
        forest = forest_from_numpy(
            {f: got_jax[f"{name}/forest/{f}"]
             for f in interchange_fields(storage)},
            family_name=family, partition_idx=got_jax[f"{name}/part_idx"],
            partition_mask=got_jax[f"{name}/part_mask"],
            d=D, num_clusters=8, storage=storage, device="cpu")
        sharded = dk.shard_index(forest, mesh, device="cpu")
        for tag, kw in jax_runs(name, sharded.local_n).items():
            res = dk.distributed_knn(sharded, got_jax[f"{name}/ys"],
                                     family=family, k=K, device="cpu", **kw)
            what = f"world {world} {name} {tag}"
            for f in ("ids", "exact", "num_candidates"):
                np.testing.assert_array_equal(
                    getattr(res, f).numpy(), got_jax[f"{name}/{tag}/{f}"],
                    err_msg=what)
            np.testing.assert_allclose(
                res.dists.numpy(), got_jax[f"{name}/{tag}/dists"],
                rtol=1e-5, atol=1e-5, err_msg=what)


def jax_side(out: str, worlds) -> None:
    """Build the JAX_CASES indexes with the JAX package and write, per
    world size, them and its distributed_knn results on a mesh of that
    many forced host devices to ``<out>/jax_<world>.npz``."""
    import jax
    import jax.numpy as jnp
    from repro.core.index import (REPLICATED_FIELDS, build_index,
                                  point_fields, refresh_envelopes)
    from repro.dist import knn as jdk
    from repro.dist.sharding import make_mesh

    cases = {}
    for name, (family, quantize) in JAX_CASES.items():
        if name == "blobs":
            data, ys = blob_data()
        else:
            data, ys = sample(family, (N, D), 0), sample(family, (Q, D), 1)
        forest = build_index(data, family, m=M, num_clusters=8, seed=0,
                             quantize=quantize)
        if name == "blobs" and not blob_last(np.asarray(forest.point_ids)):
            forest = refresh_envelopes(dataclasses.replace(forest, **{
                f: jnp.flip(getattr(forest, f), 0)
                for f in point_fields(forest)}))
        cases[name] = (family, forest, ys)
    for world in worlds:
        mesh = make_mesh((world,), ("data",), devices=jax.devices()[:world])
        arrays = {}
        for name, (family, forest, ys) in cases.items():
            for f in point_fields(forest) + REPLICATED_FIELDS:
                arrays[f"{name}/forest/{f}"] = np.asarray(getattr(forest, f))
            arrays[f"{name}/part_idx"] = np.asarray(forest.partition.idx)
            arrays[f"{name}/part_mask"] = np.asarray(forest.partition.mask)
            arrays[f"{name}/ys"] = ys
            sharded = jdk.shard_index(forest, mesh)
            for tag, kw in jax_runs(name, sharded.local_n).items():
                res = jdk.distributed_knn(sharded, jnp.asarray(ys),
                                          family=family, k=K, **kw)
                for f in res._fields:
                    arrays[f"{name}/{tag}/{f}"] = np.asarray(getattr(res, f))
        tmp = os.path.join(out, f"jax_{world}.tmp.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, os.path.join(out, f"jax_{world}.npz"))


def worker(rank: int, world: int, port: int, out: str) -> None:
    from repro_torch.dist.sharding import make_mesh

    torch.set_num_threads(1)
    # A rank left waiting in a collective fails the run within a minute.
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh((world,), ("data",), device="cpu")
        for part, run in (("", lambda: check(rank, world, mesh)),
                          ("exits ", lambda: check_exits(rank, world, mesh)),
                          ("jax ", lambda: check_against_jax(world, mesh,
                                                             out))):
            run()
            dist.barrier()
            if rank == 0:
                print(f"ok {part}world={world}", flush=True)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--worlds", type=int, nargs="+", default=[2, 4])
    parser.add_argument("--out", default=None,
                        help="directory for the JAX side's results "
                             "(a temporary one by default)")
    parser.add_argument("--jax-side", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.jax_side:
        try:
            jax_side(args.out, args.worlds)
        except BaseException:
            open(os.path.join(args.out, "jax.failed"), "w").close()
            raise
        return 0
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or tmp
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
            f"--xla_force_host_platform_device_count={max(args.worlds)} "
            + os.environ.get("XLA_FLAGS", "")))
        jax_proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--jax-side",
             "--out", out, "--worlds", *map(str, args.worlds)], env=env)
        try:
            # The worlds run side by side, each on its own port.
            worlds = [mp.spawn(worker, args=(world, free_port(), out),
                               nprocs=world, join=False)
                      for world in args.worlds]
            for ctx in worlds:
                while not ctx.join():
                    pass
        except BaseException:
            jax_proc.kill()
            raise
        finally:
            jax_proc.wait(timeout=300)
        if jax_proc.returncode != 0:
            raise RuntimeError(f"the JAX side exited {jax_proc.returncode}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
