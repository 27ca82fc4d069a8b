"""The dry run's checks that need a process group, in one process of their
own: torch's ``fake`` group is the default group of the process that
starts it (tests/test_torch_dryrun.py runs this script once and reads the
JSON line it prints last).

    PYTHONPATH=src python tests/torch_dryrun_checks.py

* ``cells``: the five reduced cells of tests/test_lowering_smoke.py on a
  fake (4, 4) ("data", "model") mesh through ``lowering.lower_cell``:
  each cell's FLOPs, bytes, collective bytes and argument bytes;
* ``matmul``: one (64, 48) x (48, 32) fp32 matmul on a fake (2, 4) mesh,
  its rows over ``data`` and its columns over ``model``: the count of
  one rank's local product, beside the whole product's;
* ``heads``: 6 query heads over 2 kv heads on a fake (4, 2) ("data",
  "model") mesh, whose data dim does not divide the heads: the FLOPs of
  one rank's q and o projections under the serving and the training
  rules, and of the reduced starcoder2-3b prefill cell with those heads;
* ``experts``: the reduced qwen3-moe-30b-a3b MoE layer (8 experts) on a
  fake (2, 4) ("data", "model") mesh under the training rules: one
  rank's FLOPs by op and collectives by kind, beside the whole layer's
  (every expert, mesh-less) on one data rank's rows;
* ``world1``: at world size 1 (a (1,) ("data",) mesh), the reduced
  starcoder2-3b prefill, decode and train step counted on ``meta``
  (``lower_cell``) and on real CPU tensors through the same steps;
* ``serving1``: the reduced starcoder2-3b prefill and two greedy decode
  steps on a (1, 1) mesh against the mesh-less ones: whether tokens,
  hidden states and caches are equal bit for bit.
"""

from __future__ import annotations

import json
import sys

import torch
import torch.distributed as dist

SEQ, BATCH = 64, 8
CELLS = [("starcoder2-3b", "train"), ("rwkv6-1.6b", "train"),
         ("qwen3-moe-30b-a3b", "train"), ("recurrentgemma-2b", "decode"),
         ("whisper-tiny", "prefill")]
COUNT_KEYS = ("flops_per_device", "bytes_per_device",
              "collective_bytes_per_device", "transcendentals_per_device")


def _fresh_group(world: int) -> None:
    from repro_torch.dist import sharding as shd
    if dist.is_initialized():
        dist.destroy_process_group()
    shd.fake_process_group(world)


def cells() -> dict:
    from repro_torch import configs
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import lowering
    _fresh_group(16)
    mesh = shd.make_mesh((4, 4), ("data", "model"), device="meta")
    out = {}
    for arch, kind in CELLS:
        rec = lowering.lower_cell(arch, "x", mesh,
                                  config=configs.get_reduced(arch),
                                  shape=ShapeSpec("x", SEQ, BATCH, kind))
        out[f"{arch}/{kind}"] = {
            **{k: rec["hlo"][k] for k in COUNT_KEYS},
            "argument_bytes": rec["memory"]["argument_bytes"],
            "peak_bytes": rec["memory"]["peak_bytes_est"]}
    return out


def matmul() -> dict:
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist import sharding as shd
    from repro_torch.launch.cost_analysis import CostCount
    _fresh_group(8)
    mesh = shd.make_mesh((2, 4), ("data", "model"), device="meta")
    x = shd.place_struct(torch.empty(64, 48, device="meta"),
                         shd.Sharding(mesh, (Shard(0), Replicate())))
    w = shd.place_struct(torch.empty(48, 32, device="meta"),
                         shd.Sharding(mesh, (Replicate(), Shard(1))))
    count = CostCount()
    with count:
        y = x @ w
    whole = CostCount()
    with whole:
        torch.empty(64, 48, device="meta") @ torch.empty(48, 32,
                                                         device="meta")
    return {"flops": count.flops, "whole_flops": whole.flops,
            "bytes": count.bytes, "whole_bytes": whole.bytes,
            "local_shape": list(y.to_local().shape),
            "collective_bytes": count.collective_bytes}


HEADS = dict(num_heads=6, num_kv_heads=2)


def heads() -> dict:
    """Counts where ``model`` divides the heads and ``data`` does not."""
    from repro_torch import configs
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import lowering
    from repro_torch.launch.cost_analysis import CostCount
    from repro_torch.models import attention
    _fresh_group(8)
    mesh = shd.make_mesh((4, 2), ("data", "model"), device="meta")
    cfg = configs.get_reduced("starcoder2-3b")
    d, k = cfg.d_model, cfg.head_dim
    spec = attention.attention_spec(d, HEADS["num_heads"],
                                    HEADS["num_kv_heads"], k)
    out = {}
    for name, rules in (("serve", shd.SERVE_RULES), ("train", None)):
        p = {n: shd.place_struct(torch.empty(sp.shape, device="meta"),
                                 shd.sharding_for(sp.axes, sp.shape, mesh,
                                                  rules))
             for n, sp in spec.items()}
        x = shd.place_struct(
            torch.empty(BATCH, SEQ, d, device="meta"),
            shd.sharding_for(("batch", "seq", "embed"), (BATCH, SEQ, d),
                             mesh, rules))
        count = CostCount()
        with shd.activation_rules(mesh, rules), torch.inference_mode(), \
                count:
            attention.out_project(p, attention._project(x, p["wq"]))
        out[f"projections_{name}"] = count.flops
    import dataclasses
    rec = lowering.lower_cell(
        "starcoder2-3b", "x", mesh,
        config=dataclasses.replace(cfg, **HEADS),
        shape=ShapeSpec("x", SEQ, BATCH, "prefill"))
    out["prefill"] = rec["hlo"]["flops_per_device"]
    return out


def experts() -> dict:
    """Counts of one MoE layer where ``model`` splits the experts."""
    from repro_torch import configs
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.cost_analysis import CostCount
    from repro_torch.models import moe
    _fresh_group(8)
    mesh = shd.make_mesh((2, 4), ("data", "model"), device="meta")
    cfg = configs.get_reduced("qwen3-moe-30b-a3b")
    spec = moe.moe_spec(cfg.d_model, cfg.moe_d_ff, cfg.moe.num_experts)
    x_shape = (BATCH, SEQ, cfg.d_model)
    p = {n: shd.place_struct(torch.empty(sp.shape, device="meta"),
                             shd.sharding_for(sp.axes, sp.shape, mesh))
         for n, sp in spec.items()}
    x = shd.place_struct(torch.empty(x_shape, device="meta"),
                         shd.sharding_for(("batch", "seq", "embed"), x_shape,
                                          mesh))
    count = CostCount()
    with shd.activation_rules(mesh), torch.inference_mode(), count:
        moe.apply_moe(p, x, cfg.moe, act=cfg.act)
    whole = CostCount()
    with torch.inference_mode(), whole:
        moe.apply_moe({n: torch.empty(sp.shape, device="meta")
                       for n, sp in spec.items()},
                      torch.empty(BATCH // 2, SEQ, cfg.d_model,
                                  device="meta"), cfg.moe, act=cfg.act)
    return {"flops_by_op": dict(count.flops_by_op),
            "whole_flops_by_op": dict(whole.flops_by_op),
            "collectives": sorted({c.kind for c in count.collectives})}


def _cpu_inputs(bundle, kind: str, gen: torch.Generator):
    from repro_torch.models.registry import model_inputs
    cfg = bundle.cfg
    s = 1 if kind == "decode" else SEQ
    tokens = torch.randint(0, cfg.vocab_size, (2, s), generator=gen,
                           dtype=torch.int32)
    pos = torch.arange(s, dtype=torch.int32)[None].expand(2, s).contiguous()
    if kind == "decode":
        pos = pos + 10
    return model_inputs(bundle, tokens, pos)


def world1() -> dict:
    """Counts at world size 1: meta against real CPU tensors."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import lowering
    from repro_torch.launch.cost_analysis import CostCount
    from repro_torch.models.registry import build_model
    from repro_torch.train.train_loop import (TrainConfig, init_train_state,
                                              make_train_step)
    _fresh_group(1)
    cfg = configs.get_reduced("starcoder2-3b")
    meta = shd.make_mesh((1,), ("data",), device="meta")
    cpu = shd.make_mesh((1,), ("data",), device="cpu")
    gen = torch.Generator().manual_seed(0)
    out = {}
    for kind in ("prefill", "decode", "train"):
        shape = ShapeSpec("x", SEQ, 2, kind)
        want = lowering.lower_cell("starcoder2-3b", "x", meta, config=cfg,
                                   shape=shape)
        bundle = build_model(cfg, device="cpu")
        batch = _cpu_inputs(bundle, kind, gen)
        if kind == "train":
            batch["labels"] = batch["tokens"].clone()
            state = init_train_state(bundle, 0, mesh=cpu)
            step = make_train_step(bundle, TrainConfig(), mesh=cpu,
                                   shape=dataclasses.replace(shape))
            count = CostCount()
            count.add_arguments((state, batch))
            with count:
                res = step(state, batch)
            got = lowering.record_of(count, res)
        else:
            sh = lowering.serving_shardings(bundle, cpu, shape)
            params = lowering.place_serving(
                lowering.serve_params(cfg, bundle.init(0)), sh["params"])
            caches = lowering.place_serving(bundle.init_cache(2, SEQ),
                                            sh["caches"])
            placed = lowering.place_serving(
                batch, {k: sh["batch"][k] for k in batch})
            lengths = torch.full((2,), 10 if kind == "decode" else 0,
                                 dtype=torch.int32)
            if kind == "prefill":
                got = lowering.count_call(
                    lambda p, b, c, n: lowering.sharded_prefill(
                        bundle, cpu, p, b, c, n),
                    (params, placed, caches, lengths))[1]
            else:
                got = lowering.count_call(
                    lambda p, t, q, c, n: lowering.sharded_decode(
                        bundle, cpu, p, t, q, c, n),
                    (params, placed["tokens"], placed["positions"], caches,
                     lengths))[1]
        out[kind] = {"meta": {**{k: want["hlo"][k] for k in COUNT_KEYS},
                              **want["memory"]},
                     "cpu": {**{k: got["hlo"][k] for k in COUNT_KEYS},
                             **got["memory"]}}
    return out


def serving1() -> dict:
    """The sharded serving steps at world size 1 against the mesh-less
    ones, bit for bit."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import lowering
    from repro_torch.models.registry import build_model, model_inputs
    _fresh_group(1)
    cfg = dataclasses.replace(configs.get_reduced("starcoder2-3b"),
                              compute_dtype=torch.float32)
    bundle = build_model(cfg, device="cpu")
    mesh = shd.make_mesh((1, 1), ("data", "model"), device="cpu")
    params = bundle.init(0)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, SEQ - 8), generator=gen,
                           dtype=torch.int32)
    pos = torch.arange(SEQ - 8, dtype=torch.int32)[None].expand(2, -1)
    shape = ShapeSpec("x", SEQ, 2, "prefill")
    sh = lowering.serving_shardings(bundle, mesh, shape)

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    def run(sharded: bool):
        caches = bundle.init_cache(2, SEQ)
        batch = model_inputs(bundle, tokens, pos.contiguous())
        p = params
        if sharded:
            p = lowering.place_serving(params, sh["params"])
            caches = lowering.place_serving(caches, sh["caches"])
            batch = lowering.place_serving(
                batch, {k: sh["batch"][k] for k in batch})
        lengths = torch.zeros(2, dtype=torch.int32)
        if sharded:
            hidden, caches = lowering.sharded_prefill(bundle, mesh, p, batch,
                                                      caches, lengths)
        else:
            hidden, caches = bundle.prefill(p, batch, caches, lengths)
        hiddens, toks = [local(hidden)], []
        tok = torch.argmax(bundle.logits(params, local(hidden)[:, -1]),
                           dim=-1).to(torch.int32)[:, None]
        lengths = lengths + tokens.shape[1]
        for _ in range(2):
            toks.append(tok)
            step_pos = lengths[:, None].clone()
            t_in, p_in = tok, step_pos
            if sharded:
                t_in = lowering.place_serving(tok, sh["batch"]["tokens"])
                p_in = lowering.place_serving(step_pos,
                                              sh["batch"]["positions"])
                logits, hidden, caches = lowering.sharded_decode(
                    bundle, mesh, p, t_in, p_in, caches, lengths)
            else:
                logits, hidden, caches = bundle.decode_step(
                    p, t_in, p_in, caches, lengths)
            hiddens.append(local(hidden))
            tok = torch.argmax(local(logits), dim=-1).to(torch.int32)[:, None]
            lengths = lengths + 1
        flat = [local(t) for layer in caches for kv in layer.values()
                if kv is not None for t in kv]
        return hiddens, toks, flat

    want, got = run(False), run(True)
    return {"hidden_equal": all(torch.equal(a, b)
                                for a, b in zip(want[0], got[0])),
            "tokens_equal": all(torch.equal(a, b)
                                for a, b in zip(want[1], got[1])),
            "caches_equal": all(torch.equal(a, b)
                                for a, b in zip(want[2], got[2]))}


def main() -> int:
    torch.set_num_threads(1)
    out = {}
    try:
        for name, fn in (("cells", cells), ("matmul", matmul),
                         ("heads", heads), ("experts", experts),
                         ("world1", world1), ("serving1", serving1)):
            out[name] = fn()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
