"""The dry run's cells: each (arch x shape x mesh) cell's one program, run
once under a per-device cost count (port of ``repro.launch.lowering``).

    train_4k     -> the train step (fwd + bwd + AdamW update, in place)
    prefill_32k  -> prefill    (write the caches, return hidden + caches)
    decode_32k   -> decode step (1 token against a seq_len cache)
    long_500k    -> decode step (sub-quadratic archs only)

The reference lowers each program with ``jax.jit(...).lower`` on
ShapeDtypeStructs.  The port runs it eagerly, on ``meta`` DTensors over
the mesh (each rank's local tensors hold shapes only; nothing is
allocated), under ``launch.cost_analysis.CostCount``, and each ``lower_*``
returns the counted record instead of a ``Lowered``.  Serving params are
bf16 (norm scales and biases stay fp32) and shard over ``model`` only
(SERVE_RULES); training params are fp32 and shard fsdp x model.

:func:`sharded_prefill` and :func:`sharded_decode` are the serving steps
under a mesh (``activation_rules``, DTensor inputs placed by
:func:`serving_shardings`, the outputs placed as the reference's
``out_shardings`` place them); the dry run calls them on ``meta``
shards, and the same functions serve real tensors on the card.  The
reference's CPU-upcast "TPU-adjusted" peak has no counterpart:
:func:`serve_weight_bytes_per_device` is the bf16 weight bytes of one
device.
"""

from __future__ import annotations

import contextlib

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor.experimental import implicit_replication

from .. import configs
from ..configs.common import SHAPES, ShapeSpec, batch_axes, batch_structs
from ..dist import sharding as shd
from ..models.registry import ModelBundle, build_model
from ..train.optimizer import tree_map
from ..train.train_loop import TrainConfig, lower_train_step
from .cost_analysis import CostCount


def _serving_cast(cfg, params, cast):
    """``cast(leaf)`` on each fp32 parameter the reference serves in bf16:
    those of two or more dims in its tree.  A ``scan_layers`` config's
    layers are one (L, ...) stack there, so every per-layer leaf, norm
    scales and biases too, is two-dimensional and cast."""
    stacked = getattr(cfg, "scan_layers", False) and len(
        set(cfg.layer_kinds())) == 1

    def one(p, extra: int):
        return cast(p) if p.dtype == torch.float32 and (
            p.ndim + extra >= 2) else p
    return {k: tree_map(lambda p, e=int(stacked and k == "layers"):
                        one(p, e), v) for k, v in params.items()}


def serve_param_structs(bundle: ModelBundle):
    """bf16 serving weights as ``meta`` tensors (the reference's cast:
    :func:`_serving_cast`), the rest fp32."""
    return _serving_cast(bundle.cfg, bundle.param_structs(),
                         lambda s: torch.empty(s.shape, dtype=torch.bfloat16,
                                               device="meta"))


def serve_params(cfg, params):
    """``params`` cast as :func:`serve_param_structs` casts their structs
    (real tensors: the weights a serving cell runs on)."""
    return _serving_cast(cfg, params, lambda p: p.to(torch.bfloat16))


def cache_structs_for(bundle: ModelBundle, shape: ShapeSpec):
    """The caches of ``shape`` as ``meta`` tensors."""
    return configs.cache_structs(bundle, shape)


def _cache_shardings(bundle, shape, mesh, rules):
    return shd.tree_shardings_for_structs(
        bundle.cache_axes(), cache_structs_for(bundle, shape), mesh, rules)


def _batch_shardings(bundle, shape, mesh, rules):
    return shd.tree_shardings_for_structs(
        batch_axes(bundle, shape), batch_structs(bundle, shape), mesh, rules)


def _serve_param_shardings(bundle, mesh, rules):
    return shd.tree_shardings_for_structs(
        bundle.param_axes(), bundle.param_structs(), mesh, rules)


def serving_shardings(bundle: ModelBundle, mesh: DeviceMesh,
                      shape: ShapeSpec, rules=None) -> dict:
    """The ``Sharding`` of every input of a serving step of ``shape``:
    {"params", "batch", "caches"}; ``lengths`` is replicated (None)."""
    rules = rules or shd.SERVE_RULES
    batch = _batch_shardings(bundle, shape, mesh, rules)
    batch["lengths"] = None
    return {"params": _serve_param_shardings(bundle, mesh, rules),
            "batch": batch,
            "caches": _cache_shardings(bundle, shape, mesh, rules)}


@torch.inference_mode()
def place_serving(tree, shardings):
    """Real tensors (the same global values on every rank) placed by
    ``shardings`` (:func:`serving_shardings`' trees) as DTensors, each
    rank keeping its shards; a sharding of None leaves its tensor as it
    is.  Placed in inference mode, as the serving steps run (DTensor
    refuses a view of a DTensor made outside it)."""
    return tree_map(lambda t, sh: t if t is None or sh is None
                    else shd.distribute(t, sh), tree, shardings)


@contextlib.contextmanager
def serve_context(mesh: DeviceMesh, rules=None):
    """Where a serving step runs under a mesh: ``activation_rules`` for
    its anchors and DTensor's implicit replication of plain tensors
    (masks, positions' tables, lengths)."""
    with shd.activation_rules(mesh, rules or shd.SERVE_RULES), \
            implicit_replication():
        yield


def _to(x, sharding):
    """A DTensor ``x`` redistributed to ``sharding``; anything else (None,
    a plain tensor, no sharding) as it is."""
    if sharding is None or not hasattr(x, "placements"):
        return x
    if tuple(x.placements) == sharding.placements:
        return x
    return x.redistribute(sharding.mesh, sharding.placements)


def _redistribute_tree(tree, shardings):
    return tree_map(_to, tree, shardings)


def sharded_prefill(bundle: ModelBundle, mesh: DeviceMesh, params, batch,
                    caches, lengths, rules=None):
    """The prefill under ``mesh``: params, batch and caches DTensors placed
    by :func:`serving_shardings`, ``lengths`` a plain (B,) tensor.  Returns
    (hidden at ("batch", "seq", None), caches placed by the caches'
    shardings)."""
    rules = rules or shd.SERVE_RULES
    b, s = batch["tokens"].shape
    hidden_sh = shd.sharding_for(("batch", "seq", None),
                                 (b, s, bundle.cfg.d_model), mesh, rules)
    with serve_context(mesh, rules):
        hidden, caches = bundle.prefill(params, batch, caches, lengths)
        cache_sh = shd.tree_shardings_for_structs(bundle.cache_axes(),
                                                  caches, mesh, rules)
        return _to(hidden, hidden_sh), _redistribute_tree(caches, cache_sh)


def sharded_decode(bundle: ModelBundle, mesh: DeviceMesh, params, tokens,
                   positions, caches, lengths, rules=None):
    """One decode step under ``mesh`` (inputs as :func:`sharded_prefill`
    takes them).  Returns (logits at ("batch", "vocab"), hidden at
    ("batch", None), caches placed by the caches' shardings)."""
    rules = rules or shd.SERVE_RULES
    b = tokens.shape[0]
    cfg = bundle.cfg
    with serve_context(mesh, rules):
        logits, hidden, caches = bundle.decode_step(params, tokens,
                                                    positions, caches,
                                                    lengths)
        cache_sh = shd.tree_shardings_for_structs(bundle.cache_axes(),
                                                  caches, mesh, rules)
        return (_to(logits, shd.sharding_for(("batch", "vocab"),
                                             tuple(logits.shape), mesh,
                                             rules)),
                _to(hidden, shd.sharding_for(("batch", None),
                                             (b, cfg.d_model), mesh, rules)),
                _redistribute_tree(caches, cache_sh))


def count_call(fn, args) -> tuple:
    """(outputs, record) of ``fn(*args)`` run once under a
    :class:`CostCount` with ``args`` as its arguments."""
    count = CostCount()
    count.add_arguments(args)
    with count:
        out = fn(*args)
    return out, record_of(count, out)


def record_of(count: CostCount, out) -> dict:
    """The reference's ``memory`` and ``hlo`` sections of a counted
    program with outputs ``out``."""
    out_bytes, alias = count.output_bytes(out)
    arg = count.argument_bytes
    peak = count.peak_bytes
    return {"memory": {"argument_bytes": arg, "output_bytes": out_bytes,
                       "temp_bytes": peak - (arg + out_bytes - alias),
                       "alias_bytes": alias, "peak_bytes_est": peak},
            "hlo": count.summary()}


@torch.inference_mode()
def _structs_for(bundle, mesh, shape, rules):
    sh = serving_shardings(bundle, mesh, shape, rules)
    batch = batch_structs(bundle, shape)
    params = shd.place_structs(serve_param_structs(bundle), sh["params"])
    placed = shd.place_structs(batch, sh["batch"])
    caches = shd.place_structs(cache_structs_for(bundle, shape),
                               sh["caches"])
    return params, placed, caches


def lower_prefill(bundle: ModelBundle, mesh: DeviceMesh, shape: ShapeSpec,
                  rules=None) -> dict:
    """The prefill cell, counted (:func:`record_of`)."""
    rules = rules or shd.SERVE_RULES
    params, batch, caches = _structs_for(bundle, mesh, shape, rules)
    lengths = batch.pop("lengths")
    return count_call(
        lambda p, bt, c, n: sharded_prefill(bundle, mesh, p, bt, c, n, rules),
        (params, batch, caches, lengths))[1]


def lower_decode(bundle: ModelBundle, mesh: DeviceMesh, shape: ShapeSpec,
                 rules=None) -> dict:
    """The decode cell, counted (:func:`record_of`)."""
    rules = rules or shd.SERVE_RULES
    params, batch, caches = _structs_for(bundle, mesh, shape, rules)
    return count_call(
        lambda p, t, q, c, n: sharded_decode(bundle, mesh, p, t, q, c, n,
                                             rules),
        (params, batch["tokens"], batch["positions"], caches,
         batch["lengths"]))[1]


def lower_train(bundle: ModelBundle, mesh: DeviceMesh, shape: ShapeSpec,
                rules=None, train_cfg: TrainConfig | None = None) -> dict:
    """The train cell, counted: the step of
    ``train_loop.lower_train_step`` (its state the arguments; the updated
    state is the same storages, so its output aliases them)."""
    count = CostCount()
    state, metrics = lower_train_step(
        bundle, mesh, train_cfg or TrainConfig(), shape,
        batch_structs(bundle, shape), rules, count=count)
    return record_of(count, (state, metrics))


def lower_cell(arch: str, shape_name: str, mesh: DeviceMesh, rules=None,
               overrides: dict | None = None,
               train_cfg: TrainConfig | None = None,
               config=None, shape: ShapeSpec | None = None) -> dict:
    """One dry-run cell -> its counted record.  ``config`` / ``shape``
    override the registry's (reduced configs on small meshes)."""
    shape = shape or SHAPES[shape_name]
    cfg = config if config is not None else configs.get_config(
        arch, **(overrides or {}))
    bundle = build_model(cfg, device="meta")
    if shape.kind == "train":
        return lower_train(bundle, mesh, shape, rules, train_cfg)
    if shape.kind == "prefill":
        return lower_prefill(bundle, mesh, shape, rules)
    return lower_decode(bundle, mesh, shape, rules)


def serve_weight_bytes_per_device(bundle: ModelBundle, mesh: DeviceMesh,
                                  rules=None) -> int:
    """Per-device bytes of the bf16 serving weights."""
    rules = rules or shd.SERVE_RULES
    placed = shd.place_structs(serve_param_structs(bundle),
                               _serve_param_shardings(bundle, mesh, rules))
    total = 0
    for t in torch.utils._pytree.tree_flatten(placed)[0]:
        if t.dtype == torch.bfloat16:
            local = t.to_local() if hasattr(t, "to_local") else t
            total += local.numel() * 2
    return total


def analytic_model_flops(arch: str, shape_name: str,
                         shape: ShapeSpec | None = None) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); D = step tokens.
    Serving: a prefill's B*S tokens at 2*N (forward only), a decode's B
    tokens at 2*N.  ``shape`` overrides the registry's (a cut batch)."""
    shape = shape or SHAPES[shape_name]
    n_active = build_model(configs.get_config(arch),
                           device="meta").active_params
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch
