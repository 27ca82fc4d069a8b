"""Fault-tolerant checkpointing: atomic shard files, restorable onto
another device and shard count (port of ``repro.train.checkpoint``).

Layout, the reference's (one directory per step):

    <dir>/step_000000123/
        manifest.json         leaf names, shapes, dtypes, the step
        shard_000.npz ...     leaves split along axis 0 into
                              ``num_shards`` files

Guarantees:

* **atomic**: a save writes ``step_X.tmp-<nonce>`` and renames it into
  place only after every shard and the manifest are fsync'd, so a crash
  mid-write never leaves a directory that :func:`latest_step` picks up;
* **elastic restore**: leaves are put together whole and placed on the
  device the caller names, or with ``shardings=`` split onto the current
  mesh, so what one device, mesh and shard count wrote restores onto
  another;
* **retention**: the ``keep`` most recent steps survive a save.

A sharded state (DTensor leaves, the sharded train step's) is written as
its global arrays: every rank takes part in each leaf's gather, rank 0
writes, and every rank waits on a barrier before the save returns.  The
files are the ones a one-device save writes.

Leaves are tensors (any device), numpy arrays or scalars, in trees of
dicts, lists and NamedTuples; a leaf's name is its path, written as the
reference writes it (``.params['layers'][0]['mixer']['wq']``).  bfloat16,
which numpy lacks, is stored as raw bytes.  The token stream is a pure
function of the step (``data/pipeline.py``), so a restart from step k
replays the batches and is bit-exact.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..device import resolve_device
from ..dist.sharding import Sharding, distribute

SEP = "//"

_TORCH_DTYPES = {
    "bool": torch.bool, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
    "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64, "bfloat16": torch.bfloat16,
}


def _flatten_with_names(tree, prefix: str = "") -> dict:
    """{path name: leaf}, in the tree's order (a ``Sharding`` is a
    leaf)."""
    if isinstance(tree, Sharding):
        return {prefix: tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for field, v in zip(tree._fields, tree, strict=True):
            out.update(_flatten_with_names(v, f"{prefix}.{field}"))
        return out
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten_with_names(v, f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten_with_names(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _unflatten(tree, leaves: dict, prefix: str = ""):
    """``tree``'s structure with each leaf taken from ``leaves`` by name."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(v, leaves, f"{prefix}.{field}")
                            for field, v in zip(tree._fields, tree,
                                                strict=True)))
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return leaves[prefix]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(host array, dtype name); bf16 as its raw bytes (shape + (2,))."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).numpy().view(np.uint8)
            return raw.reshape(tuple(t.shape) + (2,)), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write_shard(path: str, shard: dict) -> None:
    with open(path, "wb") as f:
        np.savez(f, **{k.replace("/", SEP): v for k, v in shard.items()})
        f.flush()
        os.fsync(f.fileno())


def _read_shard(path: str) -> dict:
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


def save_checkpoint(directory: str, step: int, state, *,
                    num_shards: int = 4, keep: int = 3) -> str:
    """Write ``state`` atomically.  Returns the final path (on every rank
    of a sharded state, after rank 0 wrote it)."""
    named = _flatten_with_names(state)
    final = os.path.join(directory, f"step_{step:09d}")
    if any(isinstance(v, DTensor) for v in named.values()):
        # every rank gathers each leaf; rank 0 alone keeps and writes them
        writer = dist.get_rank() == 0
        named = {k: v.full_tensor() if isinstance(v, DTensor) else v
                 for k, v in named.items()}
        if writer:
            _write(directory, step, final, named, num_shards, keep)
        dist.barrier()
    else:
        _write(directory, step, final, named, num_shards, keep)
    return final


def _write(directory: str, step: int, final: str, named: dict,
           num_shards: int, keep: int) -> None:
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"step_{step:09d}.tmp-", dir=directory)

    manifest = {"step": step, "num_shards": num_shards, "leaves": {}}
    shards: list[dict] = [{} for _ in range(num_shards)]
    for name, leaf in named.items():
        arr, dtype = _to_numpy(leaf)
        meta = {"shape": list(arr.shape[:-1] if dtype == "bfloat16"
                              else arr.shape), "dtype": dtype}
        if dtype == "bfloat16":
            meta["raw"] = True
        manifest["leaves"][name] = meta
        if arr.ndim == 0 or arr.shape[0] < num_shards:
            shards[0][name] = arr
            meta["sharded"] = False
        else:
            meta["sharded"] = True
            for i, piece in enumerate(np.array_split(arr, num_shards,
                                                     axis=0)):
                shards[i][name] = piece

    paths = [os.path.join(tmp, f"shard_{i:03d}.npz")
             for i in range(num_shards)]
    # one thread a shard file: the zip CRCs and the writes release the GIL
    with ThreadPoolExecutor(num_shards) as pool:
        list(pool.map(_write_shard, paths, shards))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    if os.path.exists(final):
        shutil.rmtree(tmp)
    else:
        os.replace(tmp, final)
    _apply_retention(directory, keep)


def _apply_retention(directory: str, keep: int):
    steps = list_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)


def list_steps(directory: str) -> list[int]:
    """Steps with a finished directory (manifest written), ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and ".tmp-" not in name:
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    """Whether ``t`` lies on ``dev`` ("cuda" names the current card)."""
    if t.device.type != dev.type:
        return False
    if dev.type != "cuda":
        return True
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return t.device.index == index


def restore_checkpoint(directory: str, step: int, target, *,
                       device="cuda", shardings=None):
    """The checkpoint of ``step`` in the structure of ``target``, its
    tensors on ``device`` whatever device and shard count wrote it.

    ``target`` gives the tree and the leaf names; a tensor leaf already on
    ``device`` with the stored shape and dtype receives the values IN
    PLACE (no second copy of the state on the card), any other leaf (a
    tensor elsewhere, on the ``meta`` device, a scalar) is replaced by a
    new tensor (asking for its gradient where the target's leaf does).

    ``shardings``, a tree congruent with ``target`` of
    ``dist.sharding.Sharding`` leaves (None: a plain tensor), is the
    elastic path: every rank reads the global arrays and keeps its shards
    on the current mesh as DTensors, whatever mesh wrote them."""
    dev = resolve_device(device)
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    loaded: dict[str, list] = {}
    paths = [os.path.join(path, f"shard_{i:03d}.npz")
             for i in range(manifest["num_shards"])]
    with ThreadPoolExecutor(len(paths)) as pool:
        for shard in pool.map(_read_shard, paths):     # in shard order
            for key, arr in shard.items():
                loaded.setdefault(key.replace(SEP, "/"), []).append(arr)

    named_sh = ({} if shardings is None
                else _flatten_with_names(shardings))
    out = {}
    for name, tgt in _flatten_with_names(target).items():
        meta = manifest["leaves"][name]
        pieces = loaded[name]
        arr = (np.concatenate(pieces, axis=0) if meta["sharded"]
               else pieces[0])
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
        if meta.get("raw"):
            t = torch.from_numpy(arr.view(np.int16).reshape(meta["shape"])
                                 ).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if list(t.shape) != meta["shape"] or \
                t.dtype != _TORCH_DTYPES[meta["dtype"]]:
            raise ValueError(f"{name}: stored {meta}, read "
                             f"{tuple(t.shape)} {t.dtype}")
        if named_sh.get(name) is not None:
            out[name] = distribute(t.to(dev), named_sh[name])
            if isinstance(tgt, torch.Tensor) and tgt.requires_grad:
                out[name].requires_grad_(True)
        elif (isinstance(tgt, torch.Tensor) and _on(tgt, dev)
                and tgt.shape == t.shape and tgt.dtype == t.dtype):
            with torch.no_grad():
                tgt.copy_(t)
            out[name] = tgt
        else:
            out[name] = t.to(dev)
            if isinstance(tgt, torch.Tensor) and tgt.requires_grad:
                out[name].requires_grad_(True)
    return _unflatten(target, out)
