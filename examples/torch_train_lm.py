"""Training on the PyTorch port end to end: a ~100M-parameter LM (12
layers of 512, a 32k vocab, starcoder2-3b's family) for a few hundred
steps with the whole substrate: the train step (remat, chunked loss,
AdamW), checkpoint and restart, the straggler monitor, the step-addressable
token stream.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200 \\
        [--arch ID] [--ckpt-dir DIR] [--device cpu] [--reduced]

``--arch`` trains that config instead (any of ``configs.ARCH_IDS``: the
dense, MoE, recurrent and VLM decoders and the encoder-decoder, their
stub inputs as zeros); ``--reduced`` takes the reduced config of
``--arch`` (starcoder2-3b by default; CPU-sized).  With ``--ckpt-dir`` a
second run resumes from the latest checkpoint there.
"""

import argparse

from repro_torch import configs
from repro_torch.data.pipeline import TokenStreamConfig
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import LMConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.straggler import StragglerMonitor
from repro_torch.train.train_loop import (TrainConfig, init_train_state,
                                          make_train_step, train_batch)


def small_100m() -> LMConfig:
    # ~100M params: 12L x 512 with a 32k vocab
    return configs.get_config(
        "starcoder2-3b", num_layers=12, d_model=512, num_heads=8,
        num_kv_heads=2, head_dim=64, d_ff=2048, vocab_size=32768,
        scan_layers=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default=None, choices=configs.ARCH_IDS,
                    help="train this config (full size unless --reduced)")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config of --arch (starcoder2-3b by "
                         "default)")
    args = ap.parse_args(argv)

    if args.reduced:
        cfg = configs.get_reduced(args.arch or "starcoder2-3b")
    elif args.arch:
        cfg = configs.get_config(args.arch)
    else:
        cfg = small_100m()
    bundle = build_model(cfg, device=args.device)
    print(f"model: {bundle.count_params / 1e6:.1f}M params on "
          f"{bundle.device}")

    tc = TrainConfig(microbatches=1, loss_chunk=min(128, args.seq),
                     opt=OptimizerConfig(peak_lr=3e-4, warmup_steps=20,
                                         total_steps=args.steps))
    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch)
    step_fn = make_train_step(bundle, tc)
    state = init_train_state(bundle, 0)
    start = ckpt.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if start is not None:
        print(f"resuming from checkpoint step {start}")
        state = ckpt.restore_checkpoint(args.ckpt_dir, start, state,
                                        device=bundle.device)
    start = start or 0

    mon = StragglerMonitor()
    for i in range(start, args.steps):
        mon.start_step()
        state, metrics = step_fn(state, train_batch(bundle, stream, i))
        mon.end_step()
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            ckpt.save_checkpoint(args.ckpt_dir, i + 1, state)
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['accuracy']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f}")
    print("straggler summary:", mon.summary())


if __name__ == "__main__":
    main()
