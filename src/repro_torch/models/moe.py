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

Under a mesh (a DTensor input, in the sharded train step and the sharded
serving steps) the layer runs expert parallel, as the reference's
compiled program does.  DTensor has no sharding strategy for the
routing's index writes (an ``index_put`` with a DTensor index), so it
runs on local tensors from its first anchor on: the input is
redistributed to the reference's ("batch", None, "embed") (batch over
``pod`` / ``data``, ``Replicate()`` over ``model``), and every rank routes
its rows over all experts.  The experts split over the mesh dim that the
reference's dispatched tokens ("experts", "batch", None, "embed")
resolve them to (``model``, where it divides E): each expert stack keeps
its shard there and is gathered over the other dims, and since the rules
give ``model`` to ``expert_mlp`` first, one all-to-all
(``dist.sharding.move_shard``) turns its F shard into its E / m experts
whole (the reference's program does the same, XLA's three all-to-alls of
the stacks).  Each rank dispatches to and combines from its own experts
only (a plain function of one device, :func:`_expert_share`;
:func:`apply_moe_share` runs one rank's share from whole weights), a
shared expert on its ``mlp`` shards, and the partial outputs are summed
by one all-reduce over ``model`` (a ``Partial()`` DTensor redistributed
to the input's placements).  Routing, slots and the aux loss run on
every model rank alike, so their gradient is taken once; the tokens and
router weights that enter a rank's share get their gradients summed over
``model``.  The stacks' gradients leave as ``Partial`` over the batch
dims and ``Shard(0)`` over ``model`` (an all-to-all and a reduce-scatter
back into their shards); the aux loss's two means are averaged over the
batch dims.  When the group size does not divide a rank's tokens, the
input is redistributed to ``Replicate()`` everywhere and every rank runs
all groups.  Where the rules leave the experts whole (``model`` does not
divide E, or is one rank), every weight is gathered and each rank
computes its rows' groups whole, bit-equal at one rank to the mesh-less
layer.
"""

from __future__ import annotations

import contextlib
import dataclasses

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..dist.sharding import anchor_placements, constrain, move_shard
from .layers import Spec, _act, apply_mlp

Tensor = torch.Tensor


_STACKS = ("w_in", "w_gate", "w_out")
# the tensor dim of a dense MLP's ``mlp`` axis
_MLP_DIM = {"w_in": 1, "w_gate": 1, "w_out": 0}


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
    consecutive tokens.  A DTensor ``x`` runs each rank's share on local
    tensors (module docstring) and gives DTensors back, the aux loss
    replicated."""
    if isinstance(x, DTensor):
        return _apply_moe_sharded(p, x, cfg, act, shared_mlp)
    b, t, _ = x.shape
    return _apply_moe(p, x, cfg, act, shared_mlp,
                      _group_size(b * t, cfg.group_tokens))


def apply_moe_share(p: dict, x: Tensor, cfg: MoEConfig, rank: int,
                    ranks: int, act: str = "silu",
                    shared_mlp: dict | None = None) -> Tensor:
    """Model rank ``rank`` of ``ranks``' partial output of
    :func:`apply_moe` on one device, from the whole weights: the tokens
    routed over all experts, then dispatched to and combined from experts
    ``[rank * E / ranks, (rank + 1) * E / ranks)`` only, plus the shared
    expert's columns ``rank`` of ``ranks`` (its ``w_out``'s rows).  The
    ``ranks`` partial outputs sum to ``apply_moe``'s; at ``ranks`` = 1 it
    is ``apply_moe``'s output bit for bit."""
    e = cfg.num_experts
    if e % ranks:
        raise ValueError(f"{ranks} ranks do not divide {e} experts")
    b, t, _ = x.shape
    sp = _group_size(b * t, cfg.group_tokens)
    lo, n = rank * (e // ranks), e // ranks
    xg, top_w, top_i, slot, keep, _aux = _route_groups(p, x, cfg, sp)
    y = _expert_share({k: p[k][lo:lo + n] for k in _STACKS if k in p},
                      xg, top_w, top_i, slot, keep, cfg, act, lo).reshape(
                          x.shape)
    if shared_mlp is not None:
        if ranks > 1:
            if not set(shared_mlp) <= set(_STACKS):
                raise ValueError("a shared expert with biases has no share")
            f = shared_mlp["w_in"].shape[1] // ranks
            shared_mlp = {k: v.narrow(_MLP_DIM[k], rank * f, f)
                          for k, v in shared_mlp.items()}
        y = y + apply_mlp(shared_mlp, x, act)
    return y


def _apply_moe_sharded(p: dict, x: DTensor, cfg: MoEConfig, act: str,
                       shared_mlp: dict | None):
    b, t, d = x.shape
    sp = _group_size(b * t, cfg.group_tokens)
    x = constrain(x, ("batch", None, "embed"))
    mesh = x.device_mesh
    if (x.to_local().shape[0] * t) % sp:
        # a group would span two ranks' rows: every rank runs all groups
        x = x.redistribute(mesh, [Replicate()] * mesh.ndim)
    rows = tuple(x.placements)
    split = [i for i, pl in enumerate(rows) if pl == Shard(0)]
    ranks = math.prod(mesh.size(i) for i in split)
    # The experts split over the mesh dim the reference's dispatched
    # tokens ("experts", "batch", None, "embed") give them (``model``,
    # where it divides E), unless the rows are split there.
    e = cfg.num_experts
    ep = [i for i, pl in enumerate(anchor_placements(
              ("experts", "batch", None, "embed"),
              (e, (b * t) // sp, _capacity(cfg, sp), d), mesh))
          if pl == Shard(0) and i not in split]
    if len(ep) > 1:
        raise ValueError(f"experts split over {len(ep)} mesh dims; expert "
                         "parallelism takes one")
    # The shared expert keeps its ``mlp`` shards there, and its partial
    # output joins the experts'.
    if shared_mlp is not None and ep and not (
            set(shared_mlp) <= set(_STACKS) and all(
                shared_mlp[k].placements[ep[0]] == Shard(_MLP_DIM[k])
                for k in shared_mlp)):
        raise ValueError("the shared expert is not split over the experts' "
                         "mesh dim by its mlp axis alone")

    def local(w, dim=None):
        """``w``'s local tensor, gathered whole over every mesh dim but the
        experts' (``dim`` None: that one too); on the experts' dim its
        shard of tensor dim ``dim``, taken from its shard of another dim
        by one all-to-all (the stacks' ``expert_mlp`` shards at rest) or
        from a whole one by a slice.  Its gradient leaves ``Partial`` over
        the rows' dims."""
        kept = ep if dim is not None else []
        want = tuple((pl if isinstance(pl, Shard) else Shard(dim))
                     if i in kept else Replicate()
                     for i, pl in enumerate(w.placements))
        if tuple(w.placements) != want:
            w = w.redistribute(mesh, want)
        w = w.to_local(grad_placements=tuple(
            Partial() if i in split else pl for i, pl in enumerate(want)))
        for i in kept:
            if want[i].dim != dim:
                w = move_shard(w, mesh, i, want[i].dim, dim)
        return w

    def summed(v):
        """``v`` itself, its gradient summed over the experts' dim (each
        rank's is that of its own share)."""
        if not ep:
            return v
        local_pl = tuple(Shard(0) if i in split else Replicate()
                         for i in range(mesh.ndim))
        return DTensor.from_local(v, mesh, local_pl, run_check=False
                                  ).to_local(grad_placements=tuple(
                                      Partial() if i in ep else pl
                                      for i, pl in enumerate(local_pl)))

    def mean(v):
        if not split:
            return v
        return DTensor.from_local(v / ranks, mesh, tuple(
            Partial() if i in split else Replicate()
            for i in range(mesh.ndim))).full_tensor()

    xl = x.to_local()
    # Routing, slots and the aux loss are the same on every expert rank,
    # and their gradient is taken once: only what enters the experts'
    # share (the tokens, the router weights) has its gradient summed.
    xg, top_w, top_i, slot, keep, aux = _route_groups(
        {"router": local(p["router"])}, xl, cfg, sp, mean)
    xs = summed(xl)
    lo = mesh.get_local_rank(ep[0]) * (e // mesh.size(ep[0])) if ep else 0
    y = _expert_share({k: local(p[k], 0) for k in _STACKS if k in p},
                      xg if xs is xl else xs.reshape(xg.shape),
                      summed(top_w), top_i, slot, keep, cfg, act,
                      lo).reshape(xl.shape)
    if shared_mlp is not None:
        y = y + apply_mlp({k: local(w, _MLP_DIM[k] if ep else None)
                           for k, w in shared_mlp.items()}, xs, act)
    y = DTensor.from_local(y, mesh, tuple(
        Partial() if i in ep else pl for i, pl in enumerate(rows)),
        run_check=False)
    if ep:
        y = y.redistribute(mesh, rows)
    return y, DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim)


def _apply_moe(p: dict, x: Tensor, cfg: MoEConfig, act: str,
               shared_mlp: dict | None, sp: int):
    """The layer on tensors of one device, in groups of ``sp`` tokens."""
    xg, top_w, top_i, slot, keep, aux = _route_groups(p, x, cfg, sp)
    y = _expert_share(p, xg, top_w, top_i, slot, keep, cfg, act,
                      0).reshape(x.shape)
    if shared_mlp is not None:                            # llama4's shared expert
        y = y + apply_mlp(shared_mlp, x, act)
    return y, aux


def _route_groups(p: dict, x: Tensor, cfg: MoEConfig, sp: int, mean=None):
    """Routing over all experts for groups of ``sp`` tokens: x (B, T, D)
    -> (its tokens (G*S', D), weights and expert ids (G, S', K), slots and
    ``keep`` (G, S', K), aux loss () x ``aux_loss_weight``)."""
    d = x.shape[-1]
    g = x.shape[0] * x.shape[1] // sp
    xg = x.reshape(g * sp, d)
    with _no_tf32(x.device):
        logits = xg.to(torch.float32) @ p["router"].to(torch.float32)
    logits = logits.reshape(g, sp, cfg.num_experts)
    top_w, top_i, aux = (route(logits, cfg) if mean is None
                         else route(logits, cfg, mean))
    slot, keep = assign_slots(top_w, top_i, cfg)
    return xg, top_w, top_i, slot, keep, aux * cfg.aux_loss_weight


def _expert_share(p: dict, xg: Tensor, top_w: Tensor, top_i: Tensor,
                  slot: Tensor, keep: Tensor, cfg: MoEConfig, act: str,
                  lo: int) -> Tensor:
    """The output (G*S', D) of the experts ``lo`` .. ``lo`` + len(p["w_in"])
    (the local stacks ``p``) for one routing: the slots of those experts
    dispatched and their products combined; an assignment to any other
    expert gives zero."""
    gs, d = xg.shape
    g, sp, k = top_i.shape
    dt = xg.dtype
    n, c = p["w_in"].shape[0], _capacity(cfg, sp)
    # Flat expert-slot index of each assignment, (e * G + g) * C + c; a
    # dropped one or one to another rank's expert points one past the
    # last slot, a row that is discarded.
    groups = torch.arange(g, device=xg.device)[:, None, None]
    mine = keep & (top_i >= lo) & (top_i < lo + n)
    flat = torch.where(mine, ((top_i - lo) * g + groups) * c + slot,
                       n * g * c)
    flat = flat.reshape(-1)
    # Dispatch: the token in each slot; an empty slot reads row g * sp, a
    # zero row.
    owner = torch.full((n * g * c + 1,), gs, dtype=torch.long,
                       device=xg.device)
    owner[flat] = torch.arange(gs, device=xg.device).repeat_interleave(k)
    xpad = torch.cat([xg, xg.new_zeros((1, d))])
    xe = xpad[owner[:-1]].reshape(n, g * c, d)             # (E, G*C, D)
    h = _act(act)(torch.bmm(xe, p["w_in"].to(dt)))
    if "w_gate" in p:
        h = h * torch.bmm(xe, p["w_gate"].to(dt))
    ye = torch.bmm(h, p["w_out"].to(dt)).reshape(n * g * c, d)
    # Combine: each assignment's expert output, weighted and summed over K.
    ypad = torch.cat([ye, ye.new_zeros((1, d))])
    picked = ypad[flat].reshape(gs, k, d)
    w = torch.where(keep, top_w, 0.0).to(dt).reshape(gs, 1, k)
    return torch.bmm(w, picked)


def moe_flops_per_token(d: int, f: int, cfg: MoEConfig, gated: bool = True,
                        shared_f: int = 0) -> int:
    """Active matmul FLOPs per token (for 6·N_active·D)."""
    per_expert = 2 * d * f * (3 if gated else 2)
    shared = 2 * d * shared_f * 3 if shared_f else 0
    return cfg.top_k * per_expert + shared + 2 * d * cfg.num_experts
