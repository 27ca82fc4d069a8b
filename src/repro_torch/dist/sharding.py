"""Logical-axis sharding over ``DeviceMesh``es, and the meshes themselves
(port of ``repro.dist.sharding``).

Model and training code never name mesh dims.  Parameters, batches and
activations carry *logical* axis names (``batch``, ``seq``, ``heads``,
``vocab``, ``fsdp``, ...); a **rules table** maps each logical name to the
mesh dims it may shard over, and :func:`spec_for_shape` resolves the
entries for one tensor shape on one mesh, with the reference's contract:

* **claim order is rules-table order**: ``heads`` takes ``model`` before
  ``seq`` can (context parallelism is the fallback when the head count is
  indivisible);
* **divisibility is mandatory**: a mesh dim is taken only when the tensor
  dim is divisible by the product of the dims taken for it so far;
* **each mesh dim is used at most once** per spec;
* candidate dims the mesh lacks (``pod`` on a one-pod mesh) are skipped.

Resolution reads only the mesh's dim names and sizes (a ``DeviceMesh``, or
a mapping name -> size), so a spec for a 16 x 16 mesh resolves without 256
ranks.  An entry is ``None``, a mesh dim name, or a tuple of names, as a
reference ``PartitionSpec``'s are.  :func:`placements` turns a spec into
DTensor placements (``Shard(i)`` or ``Replicate()`` per mesh dim), the
counterpart of a ``NamedSharding``; a :class:`Sharding` pairs them with
their mesh.

:func:`constrain` is the activation anchor: inside an
:func:`activation_rules` context it redistributes a DTensor to the
placements its logical axes resolve to (the reference's
``with_sharding_constraint``); outside any context it returns its input
object itself, so the mesh-less path runs unchanged.  DTensor's sharding
propagation stands where the reference has jit's SPMD propagation.  The
reference's ``shard_map`` has no counterpart: torch ranks already run one
program each, so ``dist/``'s substrates are per-rank functions over a mesh
dim's process group (``mesh.get_group(axis)``).

A mesh needs a process group.  :func:`ensure_process_group` starts one
when none runs: from the ``torchrun`` environment (``WORLD_SIZE``,
``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) when it names more than one
rank, else a world-size-1 group on an in-process ``HashStore``.  The
backend is NCCL for the card and gloo only when the caller asks for the
CPU; a group started here is the caller's to end with
``torch.distributed.destroy_process_group()``.  A ``meta`` mesh (the dry
run's: DTensors whose local tensors hold shapes only) needs a running
group, which :func:`fake_process_group` starts: one rank of a world that
moves no data.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Mapping, NamedTuple, Sequence

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset as _local_shape_and_offset)

from ..device import resolve_device

# Logical axis -> candidate mesh dims, in claim-priority order (dict order
# IS the priority).  Entries without candidates document the axes that
# stay replicated on purpose (embed: the residual stream between anchors,
# head_dim: small, layers: the reference's scan axis).
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "expert_mlp": ("model",),
    "experts": ("model",),
    "state": ("model",),
    "seq": ("model",),          # context-parallel fallback (after heads)
    "embed": (),
    "head_dim": (),
    "layers": (),
}

# Serving: weights shard over `model` only (no fsdp).
SERVE_RULES: dict[str, tuple[str, ...]] = dict(DEFAULT_RULES, fsdp=())

# Long-context serving: sequence parallelism outranks head parallelism.
CONTEXT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": ("model",),
    **{k: v for k, v in SERVE_RULES.items() if k not in ("batch", "seq")},
}

# Single-token decode: no sequence axis worth sharding.
DECODE_RULES: dict[str, tuple[str, ...]] = dict(SERVE_RULES, seq=())


class Sharding(NamedTuple):
    """A tensor's layout on a mesh: DTensor placements, one per mesh dim
    (the counterpart of the reference's ``NamedSharding``)."""
    mesh: DeviceMesh
    placements: tuple


def ensure_process_group(device="cuda") -> bool:
    """Start the default process group for ``device`` if none runs; True
    when this call started it.  A group started here on the card first
    gives each rank the device of its local rank (``LOCAL_RANK``, else its
    rank modulo the cards); a running group keeps the devices its ranks
    chose.  A ``meta`` device starts none: it raises unless a group
    runs."""
    dev = resolve_device(device, meta=True)
    if dist.is_initialized():
        return False
    if dev.type == "meta":
        raise RuntimeError("a meta mesh needs a running process group "
                           "(fake_process_group starts one)")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK",
                                       os.environ.get("RANK", "0")))
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def fake_process_group(world: int, rank: int = 0) -> None:
    """Start the default process group as rank ``rank`` of ``world`` ranks
    on torch's ``fake`` backend: collectives return at once and move
    nothing, so one process can stand for a rank of any world.  For the
    dry run's ``meta`` meshes only (launch/dryrun.py)."""
    # importing the module registers the backend's constructor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device="cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over every
    rank of the process group (started here if none runs), row-major.  A
    ``meta`` mesh is a CPU ``DeviceMesh`` over the running group: DTensors
    on it keep ``meta`` local tensors."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    dev = resolve_device(device, meta=True)
    ensure_process_group(dev)
    world = dist.get_world_size()
    size = 1
    for s in shape:
        size *= s
    if size != world:
        raise ValueError(f"a mesh of shape {shape} needs {size} ranks, the "
                         f"process group has {world}")
    return DeviceMesh("cpu" if dev.type == "meta" else dev.type,
                      torch.arange(world).reshape(shape), mesh_dim_names=axes)


def mesh_sizes(mesh) -> dict[str, int]:
    """{dim name: size} of a ``DeviceMesh`` (or of a mapping name ->
    size, returned as a dict), in mesh order."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dims have no names")
    return dict(zip(names, (int(s) for s in mesh.shape), strict=True))


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along the mesh dim named ``axis``."""
    sizes = mesh_sizes(mesh)
    if axis not in sizes:
        raise ValueError(f"mesh {tuple(sizes)} has no {axis!r} axis")
    return sizes[axis]


def spec_for_shape(names: Sequence[str | None], shape: Sequence[int],
                   mesh, rules: dict | None = None) -> tuple:
    """Resolve logical axis names for one tensor shape to a spec: one
    entry per dim, ``None``, a mesh dim name or a tuple of names."""
    rules = DEFAULT_RULES if rules is None else rules
    if len(names) != len(shape):
        raise ValueError(f"axes {tuple(names)} do not match shape "
                         f"{tuple(shape)}")
    sizes = mesh_sizes(mesh)
    rank = {name: i for i, name in enumerate(rules)}
    order = sorted(
        (i for i, nm in enumerate(names) if nm is not None and nm in rules),
        key=lambda i: rank[names[i]])
    used: set[str] = set()
    entries: list[Any] = [None] * len(names)
    for i in order:
        got: list[str] = []
        prod = 1
        for ax in rules[names[i]]:
            if ax not in sizes or ax in used:
                continue
            if shape[i] % (prod * sizes[ax]) != 0:
                continue
            got.append(ax)
            prod *= sizes[ax]
        used.update(got)
        if got:
            entries[i] = got[0] if len(got) == 1 else tuple(got)
    return tuple(entries)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of a spec on ``mesh``: ``Shard(i)`` on each mesh
    dim of more than one rank that tensor dim ``i``'s entry names,
    ``Replicate()`` on the rest.
    A tensor dim over several mesh dims is split by them in mesh order,
    as DTensor splits it, so such an entry must list them in that order
    (the rules' ``("pod", "data")`` does)."""
    sizes = mesh_sizes(mesh)
    order = list(sizes)
    out: list = [Replicate()] * len(order)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [order.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"entry {entry} does not follow the mesh's "
                             f"order {tuple(order)}")
        for p in pos:
            # a mesh dim of one rank splits nothing: Replicate() is the
            # same layout, and DTensor's view rules take it everywhere
            if sizes[order[p]] > 1:
                out[p] = Shard(i)
    return tuple(out)


def sharding_for(names: Sequence[str | None] | None, shape: Sequence[int],
                 mesh: DeviceMesh, rules: dict | None = None) -> Sharding:
    """The :class:`Sharding` of one tensor (``names`` None: replicated)."""
    if names is None:
        return Sharding(mesh, (Replicate(),) * mesh.ndim)
    return Sharding(mesh, placements(
        spec_for_shape(names, shape, mesh, rules), mesh))


def span(t: DTensor, dim: int) -> slice:
    """This rank's slice of the DTensor ``t``'s global ``dim``."""
    shape, offset = _local_shape_and_offset(t.shape, t.device_mesh,
                                            t.placements)
    return slice(offset[dim], offset[dim] + shape[dim])


def place_struct(struct: torch.Tensor, sharding: Sharding | None):
    """A fresh tensor of ``struct``'s shape and dtype on its device
    (``meta`` for the dry run), as a DTensor in ``sharding`` whose local
    tensor has only this rank's shard (nothing global is made); a plain
    tensor for a ``sharding`` of None."""
    if sharding is None:
        return torch.empty(struct.shape, dtype=struct.dtype,
                           device=struct.device)
    local, _ = _local_shape_and_offset(tuple(struct.shape), sharding.mesh,
                                       sharding.placements)
    return DTensor.from_local(
        torch.empty(local, dtype=struct.dtype, device=struct.device),
        sharding.mesh, sharding.placements, run_check=False,
        shape=struct.shape, stride=torch.empty(
            struct.shape, device="meta").stride())


def place_structs(structs: Any, shardings: Any) -> Any:
    """:func:`place_struct` over congruent trees of dicts, lists and
    tuples (NamedTuples too)."""
    if isinstance(structs, torch.Tensor) or structs is None:
        return (None if structs is None
                else place_struct(structs, shardings))
    if isinstance(structs, dict):
        return {k: place_structs(structs[k], shardings[k]) for k in structs}
    vals = [place_structs(s, h)
            for s, h in zip(structs, shardings, strict=True)]
    return type(structs)(*vals) if hasattr(structs, "_fields") else type(
        structs)(vals)


def distribute(t: torch.Tensor, sharding: Sharding) -> DTensor:
    """A DTensor of ``t`` (the same global tensor on every rank) in
    ``sharding``: each rank keeps its own shard, with no communication."""
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


# ---------------------------------------------------------------------------
# Activation anchoring (constrain)
# ---------------------------------------------------------------------------

# Stack of (mesh, rules) pushed by activation_rules; constrain reads the top.
_ACTIVE: list[tuple[DeviceMesh, dict | None]] = []


@contextlib.contextmanager
def activation_rules(mesh: DeviceMesh, rules: dict | None = None):
    """Context in which :func:`constrain` redistributes to ``rules``'
    placements on ``mesh``."""
    _ACTIVE.append((mesh, rules))
    try:
        yield
    finally:
        _ACTIVE.pop()


def anchor_placements(axes: Sequence[str | None], shape: Sequence[int],
                      mesh) -> tuple:
    """The placements on ``mesh`` that ``axes`` resolve to for ``shape``
    under the active rules (the default rules outside a context)."""
    rules = _ACTIVE[-1][1] if _ACTIVE else None
    return placements(spec_for_shape(tuple(axes), shape, mesh, rules), mesh)


def constrain(x, axes: Sequence[str | None]):
    """Anchor an activation to its logical axes' placements.

    Outside an :func:`activation_rules` context: ``x`` itself.  Inside
    one: the DTensor ``x`` redistributed to the placements ``axes``
    resolve to on the context's mesh; a plain tensor there raises
    ``TypeError`` (it would be taken for a replicated value)."""
    if not _ACTIVE:
        return x
    mesh = _ACTIVE[-1][0]
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain{tuple(axes)} under a mesh got a "
                        f"{type(x).__name__}, not a DTensor")
    want = anchor_placements(axes, x.shape, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_tree(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(
            tree)(vals)
    return fn(tree)


def whole_rows(x):
    """``x`` gathered along dim 1 where it is a DTensor split there (a
    (B, S, ...) activation under sequence parallelism); anything else as
    it is.  A matmul's rows flatten (B, S), which DTensor refuses over a
    split S in the torch the card runs (2.11): the gather is the one the
    product's column-split weight needs anyway."""
    if not isinstance(x, DTensor) or Shard(1) not in x.placements:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p == Shard(1) else p for p in x.placements])


class _WholeRowsGrad(torch.autograd.Function):
    """The identity, whose gradient is gathered along dim 1 (whole_rows)."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return whole_rows(g)


def row_matmul(x, w):
    """``x @ w`` for a (B, S, ...) activation and a weight matrix: under a
    mesh, x's rows whole (:func:`whole_rows`) and the product's gradient
    gathered the same way, so neither direction flattens (B, S) over a
    split S; a plain ``x @ w`` otherwise."""
    if not isinstance(x, DTensor):
        return x @ w
    return _WholeRowsGrad.apply(whole_rows(x) @ w)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    out = funcol.all_to_all_single(x.contiguous(), None, None, group)
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) \
        else out


class _AllToAll(torch.autograd.Function):
    """An all-to-all of equal chunks of dim 0; its gradient is the same
    all-to-all (the exchange is its own transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def move_shard(t: torch.Tensor, mesh: DeviceMesh, mesh_dim: int,
               src: int, dst: int) -> torch.Tensor:
    """This rank's shard over mesh dim ``mesh_dim`` moved from tensor dim
    ``src`` to ``dst`` by one all-to-all (DTensor's Shard(src) ->
    Shard(dst), which it runs as an all-gather on a CPU mesh, the dry
    run's included): ``t`` holds its part of ``src`` and all of ``dst``;
    the result all of ``src`` and its part of ``dst``.  Differentiable
    (the gradient moves back)."""
    m = mesh.size(mesh_dim)
    got = _AllToAll.apply(torch.stack(t.chunk(m, dst)), (mesh, mesh_dim))
    return torch.cat(got.unbind(0), dim=src)


def local_call(fn, x, weights, state=None,
               axes: Sequence[str | None] = ("batch", None, "embed")):
    """``fn(weights, x, state) -> (y, new state)`` on each rank's rows.

    A plain ``x`` calls ``fn`` as it is.  A DTensor ``x`` is anchored to
    ``axes`` (by default ("batch", None, "embed"): its batch over ``pod``
    / ``data``, whole over ``model``); every weight is gathered whole
    (its gradient leaving as ``Partial`` over the batch's mesh dims, a
    reduce-scatter into its shards) and every state leaf taken at x's
    placements; ``fn`` runs on the local tensors and ``y`` and the new
    state come back as DTensors at x's placements.  For what DTensor has
    no strategy for (the recurrent scans: RG-LRU, RWKV's time and channel
    mix; an indexing by a DTensor): each model rank computes its data rank's rows whole,
    as the MoE layer does."""
    if not isinstance(x, DTensor):
        return fn(weights, x, state)
    x = constrain(x, axes)
    mesh, rows = x.device_mesh, tuple(x.placements)
    whole = (Replicate(),) * mesh.ndim
    partial = tuple(Partial() if p == Shard(0) else Replicate()
                    for p in rows)

    def gathered(w):
        if not isinstance(w, DTensor):
            return w
        if tuple(w.placements) != whole:
            w = w.redistribute(mesh, whole)
        return w.to_local(grad_placements=partial)

    def local_rows(s):
        if not isinstance(s, DTensor):
            return s
        return (s if tuple(s.placements) == rows
                else s.redistribute(mesh, rows)).to_local()

    y, new = fn(_tree(gathered, weights), x.to_local(),
                _tree(local_rows, state))

    def placed(t):
        return (t if t is None
                else DTensor.from_local(t, mesh, rows, run_check=False))
    return placed(y), _tree(placed, new)


def _is_axes_leaf(x) -> bool:
    return x is None or (isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x))


def tree_shardings_for_structs(axes: Any, structs: Any, mesh: DeviceMesh,
                               rules: dict | None = None) -> Any:
    """A :class:`Sharding` for each leaf of ``structs`` (tensors, ``meta``
    tensors included) from the congruent tree of logical axes (a leaf
    None: replicated); trees of dicts, lists and tuples (NamedTuples
    too)."""
    if _is_axes_leaf(axes):
        if structs is None:
            return None
        return sharding_for(axes, structs.shape, mesh, rules)
    if isinstance(axes, dict):
        return {k: tree_shardings_for_structs(axes[k], structs[k], mesh,
                                              rules) for k in axes}
    vals = [tree_shardings_for_structs(a, s, mesh, rules)
            for a, s in zip(axes, structs, strict=True)]
    return type(axes)(*vals) if hasattr(axes, "_fields") else type(axes)(
        vals)
