"""Where a public entry point runs: the CUDA device unless the caller asks
for the CPU, or for ``meta`` (shapes only).  Nothing falls back from the
card to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device, *, meta: bool = False) -> torch.device:
    """``device`` as a :class:`torch.device`; raises for a CUDA device when
    no card is present instead of running elsewhere.  With ``meta`` (the
    models, their caches and meshes: what the dry run,
    ``launch/dryrun.py``, builds) ``"meta"`` is a third explicit choice:
    tensors with shapes and dtypes and no storage, on which no kernel
    launches.  The search entry points do not pass it, so they raise for
    ``meta`` as for any other device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} asked for, but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if meta and dev.type == "meta":
        return dev
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a cuda or cpu device"
                         f"{', or meta' if meta else ''}, got {device!r}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so a host
    clock read after it times the device, not the enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
