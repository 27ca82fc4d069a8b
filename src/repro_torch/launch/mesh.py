"""Meshes over the running process group (port of ``repro.launch.mesh``).

Functions, not module constants: importing this module starts no process
group.  The reference's per-chip peaks belong to its TPU and have no
counterpart here.

The production mesh is ("data", "model") with ``model`` over the ranks of
one host, its NVLink domain (``LOCAL_WORLD_SIZE``; an HGX H100 node's 8
cards on the dry run's ``meta`` device), and ``data`` across hosts; the
multi-pod mesh adds a leading ``pod`` axis of 2.  The dry run
(launch/dryrun.py) builds them at the reference's chip counts,
:data:`POD_RANKS` ranks a pod: (32, 8) and (2, 32, 8).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device
from ..dist.sharding import ensure_process_group, make_mesh

# ranks of one pod and of the pods of a multi-pod mesh (the reference's
# 256 chips a pod, two pods), and the cards of one HGX H100 node
POD_RANKS = 256
PODS = 2
NODE_CARDS = 8


def production_world(multi_pod: bool = False) -> int:
    """The ranks of the dry run's production mesh."""
    return POD_RANKS * (PODS if multi_pod else 1)


def _host_ranks(dev: torch.device) -> int:
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is not None:
        return int(local)
    if dev.type == "cuda":
        return torch.cuda.device_count()
    return NODE_CARDS if dev.type == "meta" else 1


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """Every rank of the process group as ("data", "model"), or with
    ``multi_pod`` as ("pod", "data", "model") over :data:`PODS` pods:
    ``model`` over the ranks of one host (``LOCAL_WORLD_SIZE``, else the
    host's cards, 1 on the CPU, 8 on ``meta``), ``data`` across hosts."""
    dev = resolve_device(device, meta=True)
    ensure_process_group(dev)
    world = dist.get_world_size()
    model = max(1, min(_host_ranks(dev), world))
    pods = PODS if multi_pod else 1
    if world % (model * pods):
        raise ValueError(f"{world} ranks do not fill {pods} pod(s) of "
                         f"hosts of {model}")
    data = world // (model * pods)
    if multi_pod:
        return make_mesh((pods, data, model), ("pod", "data", "model"),
                         device=dev)
    return make_mesh((data, model), ("data", "model"), device=dev)


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
