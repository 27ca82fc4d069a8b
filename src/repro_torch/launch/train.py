"""Training launcher: any config on one device (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir CKPT \\
        [--device cpu]

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
import time

import torch

from .. import configs
from ..data.pipeline import TokenStreamConfig
from ..models.registry import build_model
from ..train import checkpoint as ckpt
from ..train.optimizer import OptimizerConfig
from ..train.straggler import StragglerMonitor
from ..train.train_loop import (TrainConfig, init_train_state,
                                make_train_step, train_batch)


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
    ap.add_argument("--record", default=None,
                    help="write the steps' losses and ms and the peak "
                         "device bytes to this JSON file")
    args = ap.parse_args(argv)

    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    bundle = build_model(cfg, device=args.device)
    dev = bundle.device
    print(f"{args.arch}: {bundle.count_params / 1e6:.1f}M params on {dev}")

    tc = TrainConfig(
        microbatches=args.microbatches, loss_chunk=min(512, args.seq),
        opt=OptimizerConfig(peak_lr=args.lr, warmup_steps=args.steps // 10,
                            total_steps=args.steps))
    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch)
    step_fn = make_train_step(bundle, tc)
    start = ckpt.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    state = init_train_state(bundle, 0)
    if start is not None:
        state = ckpt.restore_checkpoint(args.ckpt_dir, start, state,
                                        device=dev)
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
        state, metrics = step_fn(state, train_batch(bundle, stream, i))
        loss = float(metrics["loss"])
        record["step_ms"].append(1e3 * (time.perf_counter() - t_step))
        record["losses"].append(loss)
        record["aux_losses"].append(float(metrics["aux_loss"]))
        mon.end_step()
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            ckpt.save_checkpoint(args.ckpt_dir, i + 1, state)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={loss:.4f} "
                  f"acc={float(metrics['accuracy']):.3f}")
    dt = time.time() - t0
    print(f"{args.steps - start} steps in {dt:.1f}s; "
          f"straggler: {mon.summary()}")
    record["peak_bytes"] = (torch.cuda.max_memory_allocated(dev) if cuda
                            else None)
    if args.record:
        with open(args.record, "w") as f:
            json.dump(record, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
