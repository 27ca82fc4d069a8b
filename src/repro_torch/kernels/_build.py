"""Build and load the CUDA kernels: ``nvcc`` -> one shared library -> ``ctypes``.

Each ``csrc/*.cu`` file compiles to an object in its own ``nvcc`` process,
all started together, and the objects link into
``build/repro_torch/libbrekernels.so`` under the repository root.  The
build runs at first use and is skipped while a hash of the sources and
flags matches the stamp written beside the library.  The C entry points
take raw device pointers, sizes, the device index and the stream, and
return ``cudaGetLastError()`` after the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libbrekernels.so"
SOURCES = ("bregman_ub.cu", "bregman_fused.cu", "bregman_prune.cu",
           "bregman_dist.cu", "flash_attention.cu", "flash_attention_wgmma.cu",
           "pccp_corr.cu")
HEADERS = ("filter_span.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point (pointers and the stream as void*).
SIGNATURES = {
    "brk_ub_matrix": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _P),
    "brk_filter_prune": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I64, _I64, _I64, _I, _P),
    "brk_filter_prune_blocks": (_P,) * 11 + (_I64,) * 5 + (_I, _P),
    "brk_refine_batch": (_P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _P),
    "brk_ub_matrix_quant": (_P,) * 10 + (_I64, _I64, _I64, _I, _P),
    "brk_filter_prune_quant": (_P,) * 19 + (_I64, _I64, _I64, _I, _P),
    "brk_filter_prune_blocks_quant": (_P,) * 20 + (_I64,) * 5 + (_I, _P),
    "brk_refine_batch_quant": (_P,) * 6 + (_I64, _I64, _I64, _I, _I, _P),
    "brk_prune_mask": (_P,) * 6 + (_I64, _I64, _I64, _I, _P),
    "brk_prune_mask_blocks": (_P,) * 7 + (_I64,) * 5 + (_I, _P),
    "brk_prune_mask_quant": (_P,) * 10 + (_I64, _I64, _I64, _I, _P),
    "brk_prune_mask_blocks_quant": (_P,) * 11 + (_I64,) * 5 + (_I, _P),
    "brk_flash_attention": (_P,) * 5 + (_I,) * 8 + (_F, _I, _P),
    "brk_flash_attention_bf16": (_P,) * 5 + (_I,) * 8 + (_F, _I, _P),
    "brk_pccp_slots": (_I,),
    "brk_pccp_gram": (_P, _P, _P, _P, _I, _I64, _I64, _I, _I64, _I, _P),
}

_lib = None
# What the last build in this process did: seconds, ptxas lines, rebuilt.
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the kernels unless the stamped hash matches; returns the
    library's path.  Records the seconds and ``-Xptxas -v`` lines in
    :data:`build_info`."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if (lib_path.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        build_info.update(seconds=0.0, ptxas=[], rebuilt=False)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs, strict=True)]
        logs = [p.communicate()[0] for p in procs]
        for src, p, log in zip(SOURCES, procs, logs, strict=True):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        out = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(out), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(out, lib_path)
    stamp.write_text(digest)
    build_info.update(
        seconds=time.perf_counter() - t0, rebuilt=True,
        ptxas=[ln.strip() for log in logs for ln in log.splitlines()
               if "ptxas info" in ln])
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.brk_error_string.argtypes = (ctypes.c_int,)
        lib.brk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def expect(t: torch.Tensor, name: str, shape: tuple,
           dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` — what the kernels take."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("kernel operands must lie on one CUDA device")
    return dev


def stream_of(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def check(err: int, kernel: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        what = library().brk_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed: {what} ({err})")
