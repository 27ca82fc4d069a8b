"""Training launcher: any config, on one device or sharded over every
rank ``torchrun`` starts (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir CKPT \\
        [--device cpu]

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch starcoder2-3b --reduced --device cpu --model 2 ...

Under ``torchrun`` with more than one rank it trains on
``make_host_mesh(model=--model)`` (("data",), or ("data", "model") when
``--model`` is above 1), as the reference's launcher does: the sharded
step of ``train/train_loop.py``, each rank making its rows of the batch,
a restore onto the mesh's shardings, rank 0 alone printing and writing
the record.  At one rank it runs today's step without a mesh: the
reference's mesh there is a single device, whose program is the
unsharded one.

The parameters are random, drawn from a seeded generator on the device;
the batches come from the step-addressable token stream
(``data/pipeline.py``), with M-RoPE positions and zero stub inputs
(frames, patch embeddings) where the config takes them, as the
reference's launcher feeds them (``train_loop.train_batch``).  With
``--ckpt-dir`` the run resumes from the latest checkpoint there and saves
one every ``--ckpt-every`` steps.  It prints the loss every 10 steps and
the straggler monitor's summary; ``--record`` writes each step's loss,
aux loss and wall time (each step ends when its loss reaches the host)
and the peak device bytes as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from .. import configs
from ..configs.common import ShapeSpec
from ..data.pipeline import TokenStreamConfig
from ..models.registry import build_model
from ..train import checkpoint as ckpt
from ..train.optimizer import OptimizerConfig
from ..train.straggler import StragglerMonitor
from ..train.train_loop import (TrainConfig, init_train_state,
                                make_train_step, state_shardings,
                                train_batch)
from .mesh import make_host_mesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", type=int, default=1,
                    help="ranks on the mesh's model axis (under torchrun)")
    ap.add_argument("--record", default=None,
                    help="write the steps' losses and ms and the peak "
                         "device bytes to this JSON file")
    args = ap.parse_args(argv)

    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    # the mesh first: under torchrun it gives each rank its card
    mesh = (make_host_mesh(args.model, device=args.device)
            if int(os.environ.get("WORLD_SIZE", "1")) > 1 else None)
    lead = mesh is None or dist.get_rank() == 0
    bundle = build_model(cfg, device=args.device)
    dev = bundle.device
    if lead:
        print(f"{args.arch}: {bundle.count_params / 1e6:.1f}M params on "
              f"{dev}" + ("" if mesh is None else f", mesh {mesh}"))

    tc = TrainConfig(
        microbatches=args.microbatches, loss_chunk=min(512, args.seq),
        opt=OptimizerConfig(peak_lr=args.lr, warmup_steps=args.steps // 10,
                            total_steps=args.steps))
    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch)
    shape = ShapeSpec("train", seq_len=args.seq, global_batch=args.batch,
                      kind="train")
    step_fn = make_train_step(bundle, tc, mesh=mesh, shape=shape)
    start = ckpt.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    state = init_train_state(bundle, 0, mesh=mesh)
    if start is not None:
        state = ckpt.restore_checkpoint(
            args.ckpt_dir, start, state, device=dev,
            shardings=None if mesh is None else state_shardings(bundle,
                                                                mesh))
        if lead:
            print(f"resumed from step {start}")
    start = start or 0

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    record = {"arch": args.arch, "reduced": args.reduced,
              "layers": cfg.num_layers, "batch": args.batch,
              "seq": args.seq, "microbatches": args.microbatches,
              "device": str(dev), "first_step": start, "losses": [],
              "aux_losses": [], "step_ms": []}
    mon = StragglerMonitor()
    t0 = time.time()
    for i in range(start, args.steps):
        mon.start_step()
        t_step = time.perf_counter()
        state, metrics = step_fn(state, train_batch(bundle, stream, i,
                                                    mesh=mesh))
        loss = float(metrics["loss"])
        record["step_ms"].append(1e3 * (time.perf_counter() - t_step))
        record["losses"].append(loss)
        record["aux_losses"].append(float(metrics["aux_loss"]))
        mon.end_step()
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            ckpt.save_checkpoint(args.ckpt_dir, i + 1, state)
        if lead and (i % 10 == 0 or i == args.steps - 1):
            print(f"step {i:4d} loss={loss:.4f} "
                  f"acc={float(metrics['accuracy']):.3f}")
    dt = time.time() - t0
    if lead:
        print(f"{args.steps - start} steps in {dt:.1f}s; "
              f"straggler: {mon.summary()}")
    record["peak_bytes"] = (torch.cuda.max_memory_allocated(dev) if cuda
                            else None)
    if mesh is not None:
        record["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if args.record and lead:
        with open(args.record, "w") as f:
            json.dump(record, f)
    if mesh is not None:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
