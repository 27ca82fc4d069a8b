"""Multi-pod dry run: count every (arch x shape x mesh) cell per device
(port of ``repro.launch.dryrun``).

For each cell this shows, with no card and without allocating a single
parameter:

  * the sharding contract is coherent (the cell's program runs on its
    production mesh's DTensors),
  * whether it fits a card: the per-device peak of live bytes beside the
    H100's 80 GB (``fits``),
  * and the roofline's inputs: per-device FLOPs, transcendentals, bytes
    and per-collective volumes (launch/cost_analysis.py), beside the
    analytic model FLOPs.

Each cell prints its line and then its record as one line of JSON (the
reference's keys: ``memory`` with ``fits``, ``hlo``, ``model_flops``;
besides, ``torch``, the version that counted: DTensor's sharding
propagation, and so the count, changes between versions).

It is the one entry point that touches no device, as the reference's runs
on host devices by design: it starts a ``fake`` process group in its own
process (rank 0 of the world the mesh needs; collectives move nothing)
and runs each cell's one program (launch/lowering.py) on ``meta``
DTensors over the production mesh, (32, 8) ("data", "model") or with
``--multi-pod`` (2, 32, 8) ("pod", "data", "model"), under the cost
count.  The figures are the dry run's counts of rank 0 on ``meta``: no
card ran them.

Usage:
    python -m repro_torch.launch.dryrun --arch starcoder2-3b
    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
    python -m repro_torch.launch.dryrun --all --multi-pod --out dryrun.json
    python -m repro_torch.launch.dryrun --all --both-meshes --out dryrun.json
    python -m repro_torch.launch.dryrun --arch starcoder2-3b \
        --shape prefill_32k --mesh 1x1 --batch 1    # a cell held on one card
"""

from __future__ import annotations

import argparse
import json
import time
import traceback

# An H100 SXM's device memory, the bound of ``fits``.
CARD_BYTES = 80 * 10 ** 9


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: dict | None = None, rules_name: str | None = None,
             microbatches: int = 1, mesh_shape: tuple | None = None,
             batch: int | None = None, seq: int | None = None,
             reduced: bool = False) -> dict:
    """One cell's record; an error is recorded, not raised.
    ``mesh_shape`` replaces the production mesh by a ("data", "model")
    mesh of that shape (("pod", "data", "model") for three dims),
    ``batch`` and ``seq`` the shape's global batch and sequence length,
    and ``reduced`` the config by its CPU-test-sized one (rehearsals)."""
    import dataclasses
    import math

    import torch
    import torch.distributed as dist

    from .. import configs
    from ..dist import sharding as shd
    from ..train.train_loop import TrainConfig
    from . import lowering
    from .mesh import make_production_mesh, mesh_chips, production_world

    world = (math.prod(mesh_shape) if mesh_shape
             else production_world(multi_pod))
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
    if not dist.is_initialized():
        shd.fake_process_group(world)
    if mesh_shape:
        mesh = shd.make_mesh(mesh_shape, ("pod", "data", "model")[
            3 - len(mesh_shape):], device="meta")
    else:
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    shape = configs.SHAPES[shape_name]
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=batch)
    if seq is not None:
        shape = dataclasses.replace(shape, seq_len=seq)
    config = configs.get_reduced(arch) if reduced else None
    rules = {"default": None, "serve": shd.SERVE_RULES,
             "context": shd.CONTEXT_RULES,
             "decode": shd.DECODE_RULES}[rules_name or "default"]
    rec: dict = {"arch": arch, "shape": shape_name,
                 "global_batch": shape.global_batch,
                 "seq_len": shape.seq_len,
                 "mesh": "x".join(str(s) for s in mesh.shape),
                 "chips": mesh_chips(mesh), "torch": torch.__version__,
                 "ok": False}
    t0 = time.time()
    try:
        out = lowering.lower_cell(
            arch, shape_name, mesh, rules=rules, overrides=overrides,
            train_cfg=TrainConfig(microbatches=microbatches), shape=shape,
            config=config)
        rec["lower_s"] = round(time.time() - t0, 1)
        rec.update(out)
        rec["memory"]["fits"] = rec["memory"]["peak_bytes_est"] <= CARD_BYTES
        if shape.kind != "train":
            from ..models.registry import build_model
            bundle = build_model(config or configs.get_config(
                arch, **(overrides or {})), device="meta")
            rec["memory"]["serve_weight_bytes"] = (
                lowering.serve_weight_bytes_per_device(bundle, mesh))
        if not reduced:
            rec["model_flops"] = lowering.analytic_model_flops(
                arch, shape_name, shape)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None,
                    help="arch id, or comma-separated list (all shapes)")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-archs", default="",
                    help="comma-separated archs to skip with --all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--rules", default=None,
                    choices=["default", "serve", "context", "decode"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL (or PODxDATAxMODEL) in place of the "
                         "production mesh, e.g. 1x1")
    ap.add_argument("--batch", type=int, default=None,
                    help="the cells' global batch in place of the shape's")
    ap.add_argument("--seq", type=int, default=None,
                    help="the cells' sequence length in place of the "
                         "shape's")
    ap.add_argument("--reduced", action="store_true",
                    help="the archs' CPU-test-sized configs (rehearsals)")
    args = ap.parse_args(argv)
    mesh_shape = (tuple(int(s) for s in args.mesh.split("x"))
                  if args.mesh else None)

    import torch.distributed as dist

    from .. import configs

    cells = []
    skip = {a for a in args.skip_archs.split(",") if a}
    if args.all:
        for arch, shape, runnable, note in configs.arch_cells():
            if arch in skip:
                continue
            if runnable:
                cells.append((arch, shape))
            else:
                print(f"SKIP {arch} x {shape}: {note}", flush=True)
    elif args.arch and not args.shape:
        for a in args.arch.split(","):
            for arch, shape, runnable, _n in configs.arch_cells():
                if arch == a and runnable:
                    cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    records = []
    try:
        for multi_pod in meshes:
            for arch, shape in cells:
                rec = run_cell(arch, shape, multi_pod, rules_name=args.rules,
                               microbatches=args.microbatches,
                               mesh_shape=mesh_shape, batch=args.batch,
                               seq=args.seq, reduced=args.reduced)
                status = "OK " if rec["ok"] else "FAIL"
                mem = rec.get("memory", {})
                peak = mem.get("peak_bytes_est", 0) / 2 ** 30
                fits = {True: "fits", False: "DOES NOT FIT"}.get(
                    mem.get("fits"), "-")
                print(f"{status} {rec['mesh']:>8} {arch:24s} {shape:12s} "
                      f"lower={rec.get('lower_s', '-'):>6}s "
                      f"peak/dev={peak:6.2f}GiB {fits} "
                      f"{rec.get('error', '')}", flush=True)
                print(json.dumps({k: v for k, v in rec.items()
                                  if k != "traceback"}), flush=True)
                records.append(rec)
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(records, f, indent=1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    n_ok = sum(r["ok"] for r in records)
    print(f"\n{n_ok}/{len(records)} cells counted", flush=True)
    return 0 if n_ok == len(records) else 1


if __name__ == "__main__":
    raise SystemExit(main())
