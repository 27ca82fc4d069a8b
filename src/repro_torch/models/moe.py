"""Mixture-of-Experts FFN: GShard-style grouped top-k dispatch (port of
``repro.models.moe``).

Tokens are regrouped to (G, S', D); each group sends at most
``capacity = S' * top_k * capacity_factor // E`` tokens to each expert,
and an assignment past an expert's capacity is dropped (GShard's
semantics: a token's output depends on the other tokens of its group).
Slots are handed out in token-major order over (S', K), the reference's
sequential-greedy rule.

The reference builds one-hot dispatch and combine tensors (G, S', E, C)
and contracts them with einsums.  The port carries the same routing as
indices: each assignment's expert ``top_i`` (G, S', K), its slot within
the expert ``slot`` and a ``keep`` mask.  Dispatch gathers each expert
slot's token into (E, G, C, D) (a slot no token holds reads a zero row),
and combine gathers each assignment's expert output back and sums the K
of a token in one batched product, weighted by its router weight (0 where
dropped), cast to the compute dtype as the reference casts ``combine``.
Every slot has at most one token, so nothing is summed by atomics and the
result repeats bit for bit on the card.

The router runs in fp32 with TF32 off; the expert products run in the
input's dtype, the fp32 weights cast to it at each use.  Top-k ties go to
the lower expert index, as ``jax.lax.top_k`` breaks them (a stable
descending sort).

Under a mesh (a DTensor input, in the sharded train step) DTensor has no
sharding strategy for the routing's index writes (``owner[flat] = ...``,
an ``index_put`` with a DTensor index), so the layer runs on local
tensors from its first anchor on: the input is redistributed to the
reference's ("batch", None, "embed") (batch over ``pod`` / ``data``,
``Replicate()`` over ``model``), each rank routes and computes the groups
of its own rows with the weights redistributed to ``Replicate()``
(their gradients leave as ``Partial`` over the batch dims, a
reduce-scatter into their shards), and the aux loss's two means are
averaged over the batch dims.  When the group size does not divide a
rank's tokens, the input is redistributed to ``Replicate()`` everywhere
and every rank runs all groups.  The reference's expert-parallel
all-to-alls (experts over ``model``) have no counterpart yet: each model
rank computes its data rank's groups whole.
"""

from __future__ import annotations

import contextlib
import dataclasses

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..dist.sharding import constrain
from .layers import Spec, _act, apply_mlp

Tensor = torch.Tensor


def moe_spec(d: int, f: int, num_experts: int, gated: bool = True) -> dict:
    """Parameter name -> ``Spec`` for ``layers.init_spec``: the
    reference's shapes and axes.  Each expert's matrices are drawn at
    1/sqrt of their own fan-in (d for ``w_in`` / ``w_gate``, f for
    ``w_out``); the reference's ``Spec`` takes it from the experts axis
    (ROADMAP §3)."""
    spec = {
        "router": Spec((d, num_experts), ("fsdp", None)),
        "w_in": Spec((num_experts, d, f), ("experts", "fsdp", "expert_mlp"),
                     scale=d ** -0.5),
        "w_out": Spec((num_experts, f, d), ("experts", "expert_mlp", "fsdp"),
                      scale=f ** -0.5),
    }
    if gated:
        spec["w_gate"] = Spec((num_experts, d, f),
                              ("experts", "fsdp", "expert_mlp"),
                              scale=d ** -0.5)
    return spec


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_tokens: int = 512        # S': tokens per dispatch group
    router_softmax_order: str = "topk_then_softmax"  # qwen3 renormalizes
    aux_loss_weight: float = 1e-2


def _group_size(total_tokens: int, target: int) -> int:
    """Largest divisor of total_tokens that is <= target."""
    for sp in range(min(target, total_tokens), 0, -1):
        if total_tokens % sp == 0:
            return sp
    return 1


def _capacity(cfg: MoEConfig, group_tokens: int | None = None) -> int:
    s = cfg.group_tokens if group_tokens is None else group_tokens
    c = int(s * cfg.top_k * cfg.capacity_factor // cfg.num_experts)
    return max(c, 1)


@contextlib.contextmanager
def _no_tf32(device: torch.device):
    """fp32 products on the card without TF32 for the block (the setting
    restored after it); nothing to do on the CPU."""
    if device.type != "cuda":
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def route(router_logits: Tensor, cfg: MoEConfig, mean=None):
    """Top-k routing.  logits (G, S, E) -> (weights (G, S, K) fp32,
    expert ids (G, S, K) int64, aux loss ()).  Softmax in fp32; ties go to
    the lower expert index; under "topk_then_softmax" the K weights are
    renormalized to sum to 1.  The aux loss is Switch's load-balancing
    term E * <fraction routed first to e> . <mean probability of e>;
    ``mean``, where given, takes each of the two means over these groups
    to the means over all (the sharded layer's average over ranks)."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[..., :cfg.top_k], top_i[..., :cfg.top_k]
    if cfg.router_softmax_order == "topk_then_softmax" and cfg.top_k == 1:
        # p / p: exactly 1 with derivative 0, which autodiff of the
        # division leaves as a rounding residue in the router's gradient
        top_w = torch.ones_like(top_w)
    elif cfg.router_softmax_order == "topk_then_softmax":
        top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    e = cfg.num_experts
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(F.one_hot(top_i[..., 0], e).to(probs.dtype), dim=(0, 1))
    if mean is not None:
        me, ce = mean(me), mean(ce)
    return top_w, top_i, e * torch.sum(me * ce)


def assign_slots(top_w: Tensor, top_i: Tensor, cfg: MoEConfig):
    """Each assignment's slot within its expert and whether it is kept.
    (G, S, K) weights and ids -> (slot (G, S, K) int64, keep (G, S, K)
    bool): the slot counts the group's earlier assignments to the same
    expert in token-major order over (S, K); an assignment is kept below
    the capacity and at a positive weight."""
    g, s, k = top_i.shape
    oh = F.one_hot(top_i, cfg.num_experts).to(torch.int32)   # (G,S,K,E)
    flat = oh.reshape(g, s * k, -1)
    earlier = (torch.cumsum(flat, dim=1, dtype=torch.int32) - flat)
    slot = earlier.reshape(g, s, k, -1).gather(-1, top_i[..., None])[..., 0]
    keep = (slot < _capacity(cfg, s)) & (top_w > 0)
    return slot.long(), keep


def apply_moe(p: dict, x: Tensor, cfg: MoEConfig, act: str = "silu",
              shared_mlp: dict | None = None):
    """MoE FFN.  x (B, T, D) -> (y (B, T, D), aux loss () x
    ``aux_loss_weight``).  Groups of ``_group_size(B*T, group_tokens)``
    consecutive tokens.  A DTensor ``x`` runs on local tensors (module
    docstring) and gives DTensors back, the aux loss replicated."""
    if isinstance(x, DTensor):
        return _apply_moe_sharded(p, x, cfg, act, shared_mlp)
    b, t, _ = x.shape
    return _apply_moe(p, x, cfg, act, shared_mlp,
                      _group_size(b * t, cfg.group_tokens))


def _apply_moe_sharded(p: dict, x: DTensor, cfg: MoEConfig, act: str,
                       shared_mlp: dict | None):
    b, t, _ = x.shape
    sp = _group_size(b * t, cfg.group_tokens)
    x = constrain(x, ("batch", None, "embed"))
    mesh = x.device_mesh
    split = [i for i, pl in enumerate(x.placements) if pl == Shard(0)]
    if (x.to_local().shape[0] * t) % sp:
        # a group would span two ranks' rows: every rank runs all groups
        x = x.redistribute(mesh, [Replicate()] * mesh.ndim)
        split = []
    ranks = math.prod(mesh.size(i) for i in split)
    partial = [Partial() if i in split else Replicate()
               for i in range(mesh.ndim)]

    def gathered(w):
        if isinstance(w, dict):
            return {k: gathered(v) for k, v in w.items()}
        return w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
            grad_placements=partial)

    def mean(v):
        if not split:
            return v
        return DTensor.from_local(v / ranks, mesh, partial).full_tensor()

    experts = {k: v for k, v in p.items() if k != "shared"}
    y, aux = _apply_moe(gathered(experts), x.to_local(), cfg, act,
                        None if shared_mlp is None else gathered(shared_mlp),
                        sp, mean)
    return (DTensor.from_local(y, mesh, x.placements),
            DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim))


def _apply_moe(p: dict, x: Tensor, cfg: MoEConfig, act: str,
               shared_mlp: dict | None, sp: int, mean=None):
    """The layer on tensors of one device, in groups of ``sp`` tokens."""
    b, t, d = x.shape
    dt = x.dtype
    g = (b * t) // sp
    e, c = cfg.num_experts, _capacity(cfg, sp)
    xg = x.reshape(g * sp, d)
    with _no_tf32(x.device):
        logits = xg.to(torch.float32) @ p["router"].to(torch.float32)
    logits = logits.reshape(g, sp, e)
    top_w, top_i, aux = (route(logits, cfg) if mean is None
                         else route(logits, cfg, mean))
    slot, keep = assign_slots(top_w, top_i, cfg)
    k = top_i.shape[-1]
    # Flat expert-slot index of each assignment, (e * G + g) * C + c; a
    # dropped one points one past the last slot, a row that is discarded.
    groups = torch.arange(g, device=x.device)[:, None, None]
    flat = torch.where(keep, (top_i * g + groups) * c + slot, e * g * c)
    flat = flat.reshape(-1)
    # Dispatch: the token in each slot; an empty slot reads row g * sp, a
    # zero row.
    owner = torch.full((e * g * c + 1,), g * sp, dtype=torch.long,
                       device=x.device)
    owner[flat] = torch.arange(g * sp, device=x.device).repeat_interleave(k)
    xpad = torch.cat([xg, xg.new_zeros((1, d))])
    xe = xpad[owner[:-1]].reshape(e, g * c, d)             # (E, G*C, D)
    h = _act(act)(torch.bmm(xe, p["w_in"].to(dt)))
    if "w_gate" in p:
        h = h * torch.bmm(xe, p["w_gate"].to(dt))
    ye = torch.bmm(h, p["w_out"].to(dt)).reshape(e * g * c, d)
    # Combine: each assignment's expert output, weighted and summed over K.
    ypad = torch.cat([ye, ye.new_zeros((1, d))])
    picked = ypad[flat].reshape(g * sp, k, d)
    w = torch.where(keep, top_w, 0.0).to(dt).reshape(g * sp, 1, k)
    y = torch.bmm(w, picked).reshape(b, t, d)
    if shared_mlp is not None:                            # llama4's shared expert
        y = y + apply_mlp(shared_mlp, x, act)
    return y, aux * cfg.aux_loss_weight


def moe_flops_per_token(d: int, f: int, cfg: MoEConfig, gated: bool = True,
                        shared_f: int = 0) -> int:
    """Active matmul FLOPs per token (for 6·N_active·D)."""
    per_expert = 2 * d * f * (3 if gated else 2)
    shared = 2 * d * shared_f * 3 if shared_f else 0
    return cfg.top_k * per_expert + shared + 2 * d * cfg.num_experts
