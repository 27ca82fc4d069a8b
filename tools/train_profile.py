"""Profile one training step of a config on one CUDA card.

    python3 tools/train_profile.py [--arch starcoder2-3b] [--layers N]
        [--batch 4] [--seq 4096] [--microbatches 2] [--mesh] [--out FILE]

Full width, seeded weights, bf16 compute, the config's depth or
``--layers``; the step is ``train_loop.make_train_step``'s on
``train_loop.train_batch``'s batches, as ``launch/train.py`` runs it, or
with ``--mesh`` the sharded step on a world-size-1 (1,) ("data",) mesh
over NCCL (DTensor's dispatch on one card).
After two unprofiled steps (the first warms the allocator and the lazy
imports; the second is timed), one more step runs under
``torch.profiler`` (CUPTI).  Prints one JSON object: the
card's name and power limit, the unprofiled step's wall ms, the profiled
step's device ms (its kernels and copies) and their ratio (the device's
busy share), and the host ops that took the most device time (each
kernel's time given to the op that launched it,
``self_device_time_total``), also summed by kind of op.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# op-name groups of the step's device time
GROUPS = {"matmul": ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
                     "aten::linear", "aten::matmul"),
          "copy/cast": ("aten::copy_", "aten::to", "aten::_to_copy",
                        "aten::clone", "aten::contiguous"),
          "exp/log": ("aten::exp", "aten::logsumexp", "aten::log",
                      "aten::_softmax", "aten::_log_softmax")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: the config's)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--mesh", action="store_true",
                    help="the sharded step on a world-size-1 data mesh")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.data.pipeline import TokenStreamConfig
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_loop import (TrainConfig, init_train_state,
                                              make_train_step, train_batch)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = configs.get_config(args.arch, **(
        {} if args.layers is None else {"num_layers": args.layers}))
    mesh = None
    if args.mesh:
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        mesh = make_mesh((1,), ("data",), device=dev)
    bundle = build_model(cfg, device=dev)
    step = make_train_step(bundle, TrainConfig(
        microbatches=args.microbatches,
        opt=OptimizerConfig(peak_lr=3e-4, warmup_steps=0, total_steps=10)),
        mesh=mesh, shape=ShapeSpec("train", args.seq, args.batch, "train"))
    state = init_train_state(bundle, 0, mesh=mesh)
    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch)
    wall = []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, train_batch(bundle, stream, i, mesh=mesh))
        float(m["loss"])
        wall.append(1e3 * (time.perf_counter() - t0))
    batch = train_batch(bundle, stream, 2, mesh=mesh)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        profiled_ms = 1e3 * (time.perf_counter() - t0)
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0
              and not e.key.startswith("Command Buffer Full")]
    # device-side events (kernels, copies) sum to the device time; the host
    # operators that launched them split the same time by op
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == cuda) / 1e3
    ops = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                  for e in events if e.device_type != cuda), reverse=True)
    groups = {g: sum(ms for ms, k, _ in ops if k in names)
              for g, names in GROUPS.items()}
    groups["other"] = sum(o[0] for o in ops) - sum(groups.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    if mesh is not None:
        torch.distributed.destroy_process_group()
    out = {"card": smi, "arch": args.arch, "layers": cfg.num_layers,
           "mesh": args.mesh, "batch": args.batch,
           "seq": args.seq, "microbatches": args.microbatches,
           "step_ms": wall, "profiled_wall_ms": profiled_ms,
           "device_ms": device_ms, "busy_share": device_ms / wall[1],
           "groups_ms": groups,
           "top": [{"op": k, "device_ms": ms, "calls": c}
                   for ms, k, c in ops[:25]]}
    text = json.dumps(out)
    if args.out:
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
