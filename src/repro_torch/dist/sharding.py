"""Device meshes over the ranks of a ``torch.distributed`` process group.

The port's counterpart of ``repro.dist.sharding.make_mesh``: a
``DeviceMesh`` with named dims, one rank a device.  The logical-axis
rules of the reference (``spec_for_shape``, ``constrain``, ...) serve the
LM trainer and are not ported with the search.

A mesh needs a process group.  :func:`ensure_process_group` starts one
when none runs: from the ``torchrun`` environment (``WORLD_SIZE``,
``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) when it names more than one
rank, else a world-size-1 group on an in-process ``HashStore``.  The
backend is NCCL for the card and gloo only when the caller asks for the
CPU; a group started here is the caller's to end with
``torch.distributed.destroy_process_group()``.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device


def ensure_process_group(device="cuda") -> bool:
    """Start the default process group for ``device`` if none runs; True
    when this call started it.  A group started here on the card first
    gives each rank the device of its local rank (``LOCAL_RANK``, else its
    rank modulo the cards); a running group keeps the devices its ranks
    chose."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return False
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


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device="cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over every
    rank of the process group (started here if none runs), row-major."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    dev = resolve_device(device)
    ensure_process_group(dev)
    world = dist.get_world_size()
    size = 1
    for s in shape:
        size *= s
    if size != world:
        raise ValueError(f"a mesh of shape {shape} needs {size} ranks, the "
                         f"process group has {world}")
    return DeviceMesh(dev.type, torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along the mesh dim named ``axis``."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh {names} has no {axis!r} axis")
    return int(mesh.shape[names.index(axis)])
