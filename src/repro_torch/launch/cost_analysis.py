"""Per-device cost count of one program run eagerly (the port's counterpart
of ``repro.launch.hlo_analysis``).

The reference parses XLA's optimized per-device HLO text for its FLOPs,
bytes and collective volumes, and takes the peak from XLA's memory
analysis.  The port has no compiled module: a program is its sequence of
eager operations on each rank.  :class:`CostCount` is a
``TorchDispatchMode`` that watches that sequence while the program runs
once, on ``meta`` tensors (the dry run: shapes only, nothing allocated,
launch/dryrun.py) or on real ones (the same count on the card or the CPU),
and counts per device:

* **at the level of the kernels that run**: a composite operation that
  reaches the mode whole (``matmul``, ``einsum``, ``softmax`` in
  inference mode) is decomposed, so its parts are counted.
* **at the local level.**  A mode sees a DTensor operation at its global
  shape, and DTensor runs the local operations with the mode still on the
  stack.  The count returns ``NotImplemented`` for an operation with a
  DTensor argument, so DTensor lowers it, and counts only operations on
  plain tensors: each rank's own shards and the collectives DTensor
  issues.  DTensor's sharding propagation (which runs operations on
  global-shape ``meta`` and fake tensors to learn output shapes) is not
  counted: an operation called from its modules is passed through.
* **FLOPs** (in all and by operation) by ``torch.utils.flop_counter``'s
  formulas (matmuls, convolutions, attention), plus kernel #10 by the
  query-key pairs it attends (``kernels.flash_attention.attended``: 4 x
  head dim a pair), which ``kernels.ops.flash_attention`` reports on
  every route, since a kernel launched through ctypes is invisible to a
  mode; the operations inside that call are not counted.  Elementwise
  arithmetic counts no FLOPs (the reference's HLO count gives it 1 an
  element).
* **transcendentals**: one an output element of exp, log, tanh,
  sigmoid, the square roots, the trigonometric functions, erf, pow,
  softmax, GeLU and SiLU; #10 one a pair.
* **bytes**: each operation's tensor operands plus outputs, the port's
  own HBM model, since it runs eagerly and unfused; a view, an
  allocation and a collective's wait move none; an indexed write in
  place (``index_put_``, ``index_copy_``, ``scatter_``) moves its
  indices and twice its values, not the whole tensor it writes into.
* **collectives**: each ``_c10d_functional`` operation by kind
  ("all-gather", "reduce-scatter", "all-reduce", "all-to-all"): count,
  bytes in, bytes out.  Under a ``fake`` process group on ``meta`` they
  reach their meta kernels and never the group.
* **peak bytes**: the most bytes of live storages at once.  Each storage
  an operation creates is followed by a finalizer (a storage's Python
  object lives as long as the storage), so a storage counts from its
  operation until it is freed; arguments registered with
  :meth:`CostCount.add_arguments` count from the start, at their local
  shard's size.  In-place cache writes add nothing (their output is the
  argument's storage, as the reference's donation aliases it).

Reported under the reference's keys (:meth:`CostCount.summary`,
:func:`collective_summary`).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import weakref
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode, _pop_mode,
                                          _push_mode)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import ops as kernel_ops

aten = torch.ops.aten

_TRANSCENDENTAL = {
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log1p", "log2",
    "log10", "rsqrt", "rsqrt_", "sqrt", "sqrt_", "tanh", "tanh_", "sigmoid",
    "sigmoid_", "sin", "cos", "erf", "pow", "pow_", "_softmax",
    "_log_softmax", "gelu", "silu", "silu_", "softplus",
}
_ALLOCATION = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}
_INDEXED_WRITE = {"index_put_", "_index_put_impl_", "index_copy_",
                  "scatter_", "scatter_add_"}
_COLLECTIVE = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    bytes_in: float
    bytes_out: float


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# DTensor's sharding propagation: its strategies, decompositions and the
# fake arguments it makes (torch/distributed/tensor/...)
_PROPAGATION = tuple(
    os.path.join("torch", "distributed", "tensor", name)
    for name in ("_sharding_prop.py", "_decompositions.py", "_op_schema.py",
                 "_ops" + os.sep))


def _composite(func) -> bool:
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)


def _in_propagation() -> bool:
    """Whether the operation being dispatched comes from DTensor's
    sharding propagation (a caller's frame in its modules) rather than
    from the program or DTensor's local execution."""
    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None:
        return True
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if "distributed" in name and any(p in name for p in _PROPAGATION):
            return True
        f = f.f_back
    return False


class CostCount(TorchDispatchMode):
    """The cost count of the module docstring, for the operations run
    while it is entered (one rank's)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.flops_by_op: dict[str, float] = defaultdict(float)
        self.transcendentals = 0.0
        self.bytes = 0.0
        self.collectives: list[CollectiveOp] = []
        self.argument_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}
        self._arguments: set[int] = set()
        self._kernel_depth = 0

    # -- storages ------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> int | None:
        """Follow ``t``'s storage from now until it is freed; its key, or
        None when it is followed already."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return None
        n = int(st.nbytes())
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)
        return key

    def _free(self, key: int) -> None:
        n = self._live.pop(key, 0)
        self.live_bytes -= n

    def add_arguments(self, tree) -> int:
        """Count the tensors of ``tree`` (DTensors at their local shards)
        as the program's arguments, live from the start; returns their
        bytes."""
        n = 0
        for t in _tensors(tree):
            key = self._track(_local(t))
            if key is not None:
                self._arguments.add(key)
                n += self._live[key]
        self.argument_bytes += n
        return n

    def output_bytes(self, tree) -> tuple[int, int]:
        """(bytes of the distinct storages of ``tree``'s tensors, the part
        of them that are arguments' storages: the alias bytes)."""
        seen: dict[int, int] = {}
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            seen[st._cdata] = int(st.nbytes())
        alias = sum(n for k, n in seen.items() if k in self._arguments)
        return sum(seen.values()), alias

    # -- kernels the mode cannot see ----------------------------------------
    def kernel_begin(self) -> None:
        self._kernel_depth += 1

    def kernel_end(self, name, inputs, outputs, flops, transcendentals
                   ) -> None:
        self._kernel_depth -= 1
        if self._kernel_depth == 0:
            self.flops += flops
            self.flops_by_op[name] += flops
            self.transcendentals += transcendentals
            self.bytes += _nbytes(_tensors(inputs)) + _nbytes(
                _tensors(outputs))

    def __enter__(self):
        kernel_ops.KERNEL_OBSERVERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_ops.KERNEL_OBSERVERS.remove(self)
        return super().__exit__(*exc)

    # -- the dispatch --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat_in = tree_flatten((args, kwargs))[0]
        if any(isinstance(a, DTensor) for a in flat_in):
            return NotImplemented
        if _in_propagation():
            return func(*args, **kwargs)
        if func.namespace == "aten" and _composite(func):
            # in inference mode a composite (matmul, einsum, softmax)
            # arrives whole: its parts come back through the count
            _push_mode(self)
            try:
                out = func.decompose(*args, **kwargs)
            finally:
                _pop_mode()
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ins = [a for a in flat_in if isinstance(a, torch.Tensor)]
        outs = _tensors(out)
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if t.untyped_storage()._cdata not in in_keys:
                self._track(t)
        if self._kernel_depth:
            return out
        self._count(func, args, kwargs, ins, outs, out)
        return out

    def _count(self, func, args, kwargs, ins, outs, out) -> None:
        name = func.overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            if name in _COLLECTIVE:
                b_in, b_out = _nbytes(ins), _nbytes(outs)
                self.collectives.append(CollectiveOp(_COLLECTIVE[name],
                                                     b_in, b_out))
                self.bytes += b_in + b_out
            return
        packet = func.overloadpacket
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
            self.flops += flops
            self.flops_by_op[name] += flops
        if name in _TRANSCENDENTAL:
            self.transcendentals += float(sum(t.numel() for t in outs))
        if func.is_view or name in _ALLOCATION:
            return
        if name in _INDEXED_WRITE:
            # (self, indices or index, values): those in, the values out
            self.bytes += _nbytes(ins[1:]) + _nbytes(ins[-1:])
            return
        self.bytes += _nbytes(ins) + _nbytes(outs)

    # -- results -------------------------------------------------------------
    @property
    def collective_bytes(self) -> float:
        return float(sum(c.bytes_in for c in self.collectives))

    def summary(self) -> dict:
        """The counts under the reference's ``hlo`` keys."""
        return {"flops_per_device": self.flops,
                "flops_by_op": dict(sorted(self.flops_by_op.items(),
                                           key=lambda kv: -kv[1])),
                "transcendentals_per_device": self.transcendentals,
                "bytes_per_device": self.bytes,
                "collective_bytes_per_device": self.collective_bytes,
                "collectives": collective_summary(self.collectives),
                "unknown_loops": 0}


def collective_summary(collectives) -> dict[str, dict]:
    """Collectives by kind: count, bytes in, bytes out (per device)."""
    agg: dict[str, dict] = defaultdict(lambda: {"count": 0.0,
                                                "bytes_in": 0.0,
                                                "bytes_out": 0.0})
    for c in collectives:
        a = agg[c.kind]
        a["count"] += 1
        a["bytes_in"] += c.bytes_in
        a["bytes_out"] += c.bytes_out
    return dict(agg)
