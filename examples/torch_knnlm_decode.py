"""kNN-LM serving on the PyTorch port: starcoder2-3b (random weights from a
seed) decodes with BrePartition retrieval over a datastore of its own
hidden states, exact, then §8 approximate, then through the retrieval
service.

    PYTHONPATH=src python examples/torch_knnlm_decode.py [--device cpu] [--full]

The default is the reduced config; ``--full`` runs the published widths
(30 layers, d_model 3072), which wants the card.
"""

import argparse

import numpy as np

from repro_torch import configs
from repro_torch.models.registry import build_model
from repro_torch.serve import RetrievalService, ServiceConfig
from repro_torch.serve.engine import Engine, EngineConfig, Request
from repro_torch.serve.knnlm import KNNLMHook, build_datastore


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the published starcoder2-3b widths")
    args = ap.parse_args(argv)

    cfg = (configs.get_config("starcoder2-3b") if args.full
           else configs.get_reduced("starcoder2-3b"))
    bundle = build_model(cfg, device=args.device)
    params = bundle.init(0)
    vocab = cfg.vocab_size

    rng = np.random.default_rng(0)
    corpus = rng.integers(1, vocab, (8, 48))
    store = build_datastore(bundle, params, corpus, calibrate=True)
    print(f"datastore: {store.index.n} keys, dim {store.hidden_dim}, "
          f"M={store.index.m} subspaces, block_rows={store.block_rows}")

    hook = KNNLMHook(store=store, k=8, lam=0.3)
    ecfg = EngineConfig(slots=4, max_seq=96, prefill_len=16)
    eng = Engine(bundle, params, ecfg, logits_hook=hook)
    for uid in range(6):
        eng.submit(Request(uid=uid, prompt=rng.integers(1, vocab, 16),
                           max_new_tokens=12))
    done = eng.run()
    for r in sorted(done, key=lambda r: r.uid):
        print(f"req {r.uid}: {r.output}")
    print(f"kNN queries served: {hook.queries_served} "
          f"(engine ticks: {eng.ticks})")

    # Approximate mode (paper §8): a raw p, then a measured recall target
    # through the calibration curve fitted at build time.
    for knob in ({"approx_p": 0.8}, {"target_recall": 0.9}):
        hook_a = KNNLMHook(store=store, k=8, lam=0.3, **knob)
        eng2 = Engine(bundle, params, ecfg, logits_hook=hook_a)
        eng2.submit(Request(uid=0, prompt=rng.integers(1, vocab, 16),
                            max_new_tokens=8))
        eng2.run()
        print(f"approximate mode {knob} served {hook_a.queries_served} "
              "queries")

    # Through the retrieval service: deadlines and the degradation ladder.
    svc = RetrievalService(ServiceConfig())
    hook_s = KNNLMHook(store=store, k=8, lam=0.3, service=svc,
                       deadline_s=60.0)
    eng3 = Engine(bundle, params, ecfg, logits_hook=hook_s)
    prompt = rng.integers(1, vocab, 16)
    eng3.submit(Request(uid=0, prompt=prompt, max_new_tokens=8))
    routed = eng3.run()[0].output
    eng4 = Engine(bundle, params, ecfg,
                  logits_hook=KNNLMHook(store=store, k=8, lam=0.3))
    eng4.submit(Request(uid=0, prompt=prompt, max_new_tokens=8))
    direct = eng4.run()[0].output
    print(f"service route: {svc.counters['exact']} exact responses, "
          f"tokens equal the direct hook's: {list(routed) == list(direct)}")


if __name__ == "__main__":
    main()
