"""Serving launcher: the batched engine, optionally with kNN-LM retrieval
(port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \\
        --reduced --requests 8 --knnlm [--device cpu]

``--arch`` takes all ten configs: starcoder2-3b, the dense and MoE configs
(qwen3-moe-30b-a3b, llama4-scout-17b-a16e, qwen2.5-32b, qwen3-32b,
phi3-medium-14b), recurrentgemma-2b and rwkv6-1.6b (the recurrent archs
take the exact-length prompts the launcher draws), whisper-tiny (the
encoder-decoder, its frames stubbed as zeros) and qwen2-vl-72b (M-RoPE,
its patch embeddings stubbed as zeros: prompts of at least
``num_patch_tokens`` tokens).

Weights are random, drawn from a seeded generator on the device; the
datastore is the model's own hidden states over a seeded corpus.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import configs
from ..models.registry import build_model
from ..serve.engine import Engine, EngineConfig, Request
from ..serve.knnlm import KNNLMHook, build_datastore


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--knnlm", action="store_true")
    ap.add_argument("--knnlm-approx-p", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    patches = getattr(cfg, "num_patch_tokens", 0)
    if args.prompt_len < patches:
        ap.error(f"--prompt-len {args.prompt_len} is shorter than "
                 f"{args.arch}'s {patches} patch embeddings")
    bundle = build_model(cfg, device=args.device)
    params = bundle.init(0)
    vocab = cfg.vocab_size
    rng = np.random.default_rng(0)

    hook = None
    if args.knnlm:
        corpus = rng.integers(1, vocab, (8, 2 * args.prompt_len))
        store = build_datastore(bundle, params, corpus)
        hook = KNNLMHook(store=store, k=8, lam=0.25,
                         approx_p=args.knnlm_approx_p)
        print(f"kNN-LM datastore: {store.index.n} keys, "
              f"M={store.index.m} subspaces")

    eng = Engine(bundle, params,
                 EngineConfig(slots=args.slots,
                              max_seq=args.prompt_len + args.new_tokens + 8,
                              prefill_len=args.prompt_len),
                 logits_hook=hook)
    for uid in range(args.requests):
        eng.submit(Request(uid=uid,
                           prompt=rng.integers(1, vocab, args.prompt_len),
                           max_new_tokens=args.new_tokens))
    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    total_tokens = sum(len(r.output) for r in done)
    print(f"{len(done)} requests, {total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens / dt:.1f} tok/s, {eng.ticks} ticks)")
    if hook:
        print(f"kNN queries served: {hook.queries_served}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
