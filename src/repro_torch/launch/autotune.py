"""Block-size autotuner for the streaming batched kNN search (port of
``repro.launch.autotune``).

``block_rows`` is the row block of the two streaming scans (the filter's
top-k merge and the envelope-gated prune) and of the tiered store's host
blocks; ``env_block_rows`` is the envelope gate's granularity.  Both are
pure performance knobs: every value gives the same results bit for bit.
On the card the block size sets the gate's granularity and the tiered
store's fetch unit, not a kernel's launch count (the grouped launches of
#1-#6 cover many blocks, ``search.GROUP_OUTPUT_BYTES``).  The right
values are an empirical property of (n, q, d, M, storage, backend), so a
table records them.

The sweep measures each candidate two ways:

* :func:`measure_memory` runs one search on the built index between
  ``torch.cuda.reset_peak_memory_stats`` and ``max_memory_allocated`` and
  reports the peak above the allocation it started from; a candidate over
  ``--mem-cap-mib`` is rejected before it is timed.  On the CPU it
  returns ``None``, as the reference does on a backend without a memory
  analysis.
* :func:`time_config` takes the median of the search's seconds, each call
  ended by a sync of the index's device, and picks the winner.

The reference compiles a shape-only forest (``forest_spec``) for XLA's
``memory_analysis``; eager torch has no abstract lowering, so
``forest_spec`` has no counterpart here and the probe runs on the index.

Results land in a checked-in JSON file (``block_rows_table.json`` next to
this module, the reference's table stays its own).
``core.search.resolve_block_rows`` consults it whenever a caller passes
``block_rows=None``, and the serving layer (serve/retrieval.py tenant
registration, serve/knnlm.py datastore build) resolves and pins the tuned
value once.  Lookups are bucketed by log2(n) and log2(q) and filtered by
(backend, storage); the backend is ``"cuda"`` or ``"cpu"``, the type of
the device the search runs on.  A miss, including any backend the table
was not swept on, falls back to ``DEFAULT_BLOCK_ROWS``.

Regenerate on one card with::

    PYTHONPATH=src python -m repro_torch.launch.autotune \\
        --n 65536 262144 1048576 --q 8 64 --d 256 --m 39 \\
        --storages f32 int8 --out src/repro_torch/launch/block_rows_table.json
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..core import search
from ..core.index import build_index
from ..device import resolve_device, synchronize

DEFAULT_TABLE_PATH = Path(__file__).resolve().parent / "block_rows_table.json"
TABLE_ENV = "REPRO_TORCH_AUTOTUNE_TABLE"

# The candidate grid the sweep explores (a candidate beyond the index is
# one block).
CANDIDATE_BLOCK_ROWS = (1024, 2048, 4096, 8192, 16384)
CANDIDATE_ENV_BLOCK_ROWS = (256, 512, 1024)

# A tuned entry further than this (in log2 n) from the queried shape is a
# miss: a block size tuned for n = 4096 says nothing about n = 10^8.
MAX_N_LOG2_DISTANCE = 2.0


def device_backend(device=None) -> str:
    """The table's backend key for a device: ``"cuda"`` or ``"cpu"``.
    ``None`` is the card when one is present, as the entry points'
    default device is."""
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


# ---------------------------------------------------------------------------
# Measuring one candidate
# ---------------------------------------------------------------------------

def measure_memory(index, ys, k: int, budget: int, block_rows: int,
                   env_block_rows: int) -> int | None:
    """Peak device bytes one search allocates above what was allocated
    when it started, or None on the CPU (no allocator statistics)."""
    dev = index.device
    if dev.type != "cuda":
        return None
    synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev)
    res = search.knn_search_batch(index, ys, k, budget,
                                  block_rows=block_rows,
                                  env_block_rows=env_block_rows,
                                  validate=False, device=dev)
    synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    del res
    return int(peak - start)


def _synthetic_index(n: int, d: int, m: int, storage: str, seed: int = 0,
                     device="cuda"):
    """Blob data index at the bench shape family (bench_batch_search)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.5, 4.0, size=(128, d))
    rows = centers[rng.integers(0, 128, size=n)]
    rows = rows + rng.normal(0.0, 0.08, size=rows.shape)
    data = (np.abs(rows) + 0.05).astype(np.float32)
    return build_index(data, "squared_euclidean", m=m,
                       quantize=(storage == "int8"), device=device)


def time_config(index, ys, k: int, budget: int, block_rows: int,
                env_block_rows: int, repeats: int = 3) -> float:
    """Median seconds of one search after a warm call, each call ended by
    a sync of the index's device."""
    dev = index.device

    def run():
        search.knn_search_batch(index, ys, k, budget, block_rows=block_rows,
                                env_block_rows=env_block_rows,
                                validate=False, device=dev)
        synchronize(dev)

    run()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SweepConfig:
    ns: tuple = (4096, 16384, 65536)
    qs: tuple = (8, 64)
    d: int = 32
    m: int = 8
    k: int = 10
    storages: tuple = ("f32", "int8")
    block_rows_candidates: tuple = CANDIDATE_BLOCK_ROWS
    env_candidates: tuple = CANDIDATE_ENV_BLOCK_ROWS
    repeats: int = 3
    mem_cap_bytes: int | None = None
    time_it: bool = True
    device: str = "cuda"


def sweep(cfg: SweepConfig, log=print) -> list[dict]:
    """Run the sweep; one winning entry per (n, q, storage) cell."""
    dev = resolve_device(cfg.device)
    backend = dev.type
    entries = []
    for storage in cfg.storages:
        for n in cfg.ns:
            index = _synthetic_index(n, cfg.d, cfg.m, storage, device=dev)
            for q in cfg.qs:
                rng = np.random.default_rng(1)
                ys = torch.as_tensor(
                    np.abs(rng.normal(1.5, 0.5, size=(q, cfg.d))) + 0.05,
                    dtype=torch.float32, device=dev)
                budget = search.fitted_budget_for_n(n, cfg.k, n // 64)
                best = None
                for br in cfg.block_rows_candidates:
                    if br > 2 * n:
                        continue          # degenerate: > one block of slack
                    for eb in cfg.env_candidates:
                        temp = measure_memory(index, ys, cfg.k, budget, br,
                                              eb)
                        if (cfg.mem_cap_bytes is not None and temp is not None
                                and temp > cfg.mem_cap_bytes):
                            log(f"  reject n={n} q={q} {storage} br={br} "
                                f"eb={eb}: temp {temp} > cap")
                            continue
                        sec = (time_config(index, ys, cfg.k, budget, br, eb,
                                           cfg.repeats)
                               if cfg.time_it else float("inf"))
                        cand = {"backend": backend, "storage": storage,
                                "n_log2": round(math.log2(n), 2),
                                "q_log2": round(math.log2(q), 2),
                                "d": cfg.d, "m": cfg.m,
                                "block_rows": br, "env_block_rows": eb,
                                "us_per_call": round(sec * 1e6, 1),
                                "temp_bytes": temp}
                        log(f"  n={n} q={q} {storage} br={br} eb={eb}: "
                            f"{cand['us_per_call']}us temp={temp}")
                        if best is None or sec < best["_sec"]:
                            best = {**cand, "_sec": sec}
                if best is not None:
                    best.pop("_sec")
                    entries.append(best)
                    log(f"-> n={n} q={q} {storage}: block_rows="
                        f"{best['block_rows']} env={best['env_block_rows']}")
            del index
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return entries


def write_table(entries: list[dict], path: str | Path,
                note: str = "") -> None:
    payload = {
        "version": 1,
        "note": note or "swept via `python -m repro_torch.launch.autotune`",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "entries": entries,
    }
    Path(path).write_text(json.dumps(payload, indent=1) + "\n")
    _load_table_cached.cache_clear()


# ---------------------------------------------------------------------------
# Lookup (the consumer side: resolve_block_rows and the serving layer)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _load_table_cached(path_str: str) -> tuple:
    path = Path(path_str)
    if not path.exists():
        return ()
    try:
        payload = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return ()
    if not isinstance(payload, dict):
        return ()
    entries = payload.get("entries", [])
    if not isinstance(entries, list):
        return ()
    return tuple(e for e in entries if isinstance(e, dict))


def load_table(path: str | Path | None = None) -> tuple:
    """The checked-in entries (cached); the environment variable
    ``REPRO_TORCH_AUTOTUNE_TABLE`` overrides the path, and an empty,
    missing or corrupt file reads as no entries."""
    if path is None:
        path = os.environ.get(TABLE_ENV, DEFAULT_TABLE_PATH)
    return _load_table_cached(str(path))


def lookup(n: int, q: int | None = None, *, storage: str | None = None,
           backend: str | None = None, table: tuple | None = None,
           device=None) -> dict | None:
    """Nearest tuned entry for this shape, or None (use the default).

    Entries are filtered to this backend (``backend``, else the type of
    ``device``, see :func:`device_backend`) and storage tier, then ranked
    by log2 distance in n (first) and q (second, when the caller knows
    q).  Misses by more than :data:`MAX_N_LOG2_DISTANCE` in n are
    rejected.
    """
    if n < 1:
        return None
    entries = load_table() if table is None else table
    if not entries:
        return None
    backend = backend or device_backend(device)
    storage = storage or "f32"
    n_l = math.log2(n)
    q_l = math.log2(q) if q else None
    best, best_key = None, None
    for e in entries:
        if e.get("backend") != backend or e.get("storage") != storage:
            continue
        try:
            dn = abs(n_l - float(e["n_log2"]))
            dq = (abs(q_l - float(e["q_log2"]))
                  if q_l is not None and "q_log2" in e else 0.0)
            br = int(e["block_rows"])
        except (KeyError, TypeError, ValueError):
            continue
        if dn > MAX_N_LOG2_DISTANCE or br < 8:
            continue
        key = (dn, dq)
        if best_key is None or key < best_key:
            best, best_key = e, key
    return best


def lookup_block_rows(n: int, q: int | None = None, *,
                      storage: str | None = None,
                      backend: str | None = None,
                      table: tuple | None = None,
                      device=None) -> int | None:
    """Tuned ``block_rows`` for this shape, or None for the default."""
    e = lookup(n, q, storage=storage, backend=backend, table=table,
               device=device)
    return int(e["block_rows"]) if e is not None else None


def lookup_env_block_rows(n: int, q: int | None = None, *,
                          storage: str | None = None,
                          backend: str | None = None,
                          table: tuple | None = None,
                          device=None) -> int | None:
    """Tuned envelope-gate granularity for this shape, or None."""
    e = lookup(n, q, storage=storage, backend=backend, table=table,
               device=device)
    if e is None or "env_block_rows" not in e:
        return None
    return int(e["env_block_rows"])


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or ''."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.splitlines()[0] if out else ""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=str(DEFAULT_TABLE_PATH))
    p.add_argument("--n", type=int, nargs="+", default=[4096, 16384, 65536])
    p.add_argument("--q", type=int, nargs="+", default=[8, 64])
    p.add_argument("--d", type=int, default=32)
    p.add_argument("--m", type=int, default=8)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--storages", nargs="+", default=["f32", "int8"])
    p.add_argument("--block-rows", type=int, nargs="+",
                   default=list(CANDIDATE_BLOCK_ROWS))
    p.add_argument("--env-block-rows", type=int, nargs="+",
                   default=list(CANDIDATE_ENV_BLOCK_ROWS))
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--mem-cap-mib", type=float, default=None,
                   help="reject candidates whose peak search bytes exceed "
                        "this")
    p.add_argument("--no-time", action="store_true",
                   help="memory probe only (records the peak bytes, keeps "
                        "the first surviving candidate per cell)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--note", default=None,
                   help="the table's note (default: the command and the "
                        "card's nvidia-smi name and power limit)")
    args = p.parse_args(argv)

    cfg = SweepConfig(
        ns=tuple(args.n), qs=tuple(args.q), d=args.d, m=args.m, k=args.k,
        storages=tuple(args.storages),
        block_rows_candidates=tuple(args.block_rows),
        env_candidates=tuple(args.env_block_rows),
        repeats=args.repeats,
        mem_cap_bytes=(None if args.mem_cap_mib is None
                       else int(args.mem_cap_mib * 2**20)),
        time_it=not args.no_time, device=args.device,
    )
    card = _card_line() if args.device.startswith("cuda") else ""
    print(f"sweeping on {args.device} ({card or 'no card'}) -> {args.out}")
    entries = sweep(cfg)
    note = args.note
    if note is None:
        cmd = " ".join(["python -m repro_torch.launch.autotune",
                        *(argv if argv is not None else sys.argv[1:])])
        note = f"swept by `{cmd}` on {card or args.device}"
    write_table(entries, args.out, note=note)
    print(f"wrote {len(entries)} entries to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
