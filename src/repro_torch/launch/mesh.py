"""Meshes over the running process group (port of ``repro.launch.mesh``).

Functions, not module constants: importing this module starts no process
group.  The reference's per-chip peaks belong to its TPU and have no
counterpart here.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device
from ..dist.sharding import ensure_process_group, make_mesh


def make_production_mesh(*, device="cuda") -> DeviceMesh:
    """Every rank of the process group as ("data", "model"): ``model``
    over the ranks of one host (its NVLink domain: ``LOCAL_WORLD_SIZE``,
    else the host's cards, 1 on the CPU), ``data`` across hosts."""
    dev = resolve_device(device)
    ensure_process_group(dev)
    world = dist.get_world_size()
    local = os.environ.get("LOCAL_WORLD_SIZE")
    per = (int(local) if local is not None
           else torch.cuda.device_count() if dev.type == "cuda" else 1)
    model = max(1, min(per, world))
    if world % model:
        raise ValueError(f"{world} ranks do not fill hosts of {model}")
    return make_mesh((world // model, model), ("data", "model"), device=dev)


def make_host_mesh(model: int = 1, *, device="cuda") -> DeviceMesh:
    """Whatever the process group has (tests, examples): (ranks/model,
    model) as ("data", "model"), or ("data",) when ``model`` is 1."""
    dev = resolve_device(device)
    ensure_process_group(dev)
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model={model}")
    if model > 1:
        return make_mesh((n // model, model), ("data", "model"), device=dev)
    return make_mesh((n,), ("data",), device=dev)


def mesh_chips(mesh: DeviceMesh) -> int:
    return int(mesh.mesh.numel())
