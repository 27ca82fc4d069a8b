"""CUDA refine kernels — exact Bregman distances of gathered candidate rows.

    D_f(x, y) = sum_j phi(x_j)  -  x . phi'(y)  +  c_y

:func:`bregman_refine_batch` replaces ``src/repro/kernels/bregman_dist.py::
bregman_refine_batch`` and its q=1 wrapper ``bregman_refine``;
:func:`bregman_refine_batch_quant` replaces ``bregman_refine_batch_quant``,
which decodes x from int8 codes exactly as ``dequantize_rows`` does.  Bound
by bytes on the H100 (each candidate row is read once), the kernels
(``csrc/bregman_dist.cu``) take the place of the TPU grid's sequential
d-tile accumulator with warp-shuffle reductions: the fp32 one gives a
warp to each (query, row) pair, its lanes striding over d; the int8 one
reads codes in 16-byte loads (up to four of a row a lane), gives a block
runs of one query's rows with that query's grad staged in shared memory,
and sums in an order fixed by d alone, so a pair's distance has the same
bits at any b.  phi is chosen per family at compile time, with log
arguments guarded at 1e-30.  Plain versions: ``ref.bregman_refine_batch``
and ``ref.bregman_refine_batch_quant``.
"""

from __future__ import annotations

import torch

from . import _build

# Family ids of the kernel's template switch (csrc/bregman_dist.cu).
FAMILY_IDS = {"squared_euclidean": 0, "itakura_saito": 1, "exponential": 2,
              "burg": 3, "shannon": 4}

# Launches of each kernel in this process (read and reset by chip_smoke.py).
launches = 0
launches_quant = 0


def bregman_refine_batch(rows: torch.Tensor, grad: torch.Tensor,
                         c_y: torch.Tensor, family: str) -> torch.Tensor:
    """Exact D_f(rows[q, i], y_q) -> (q, b); rows (q, b, d), grad (q, d),
    c_y (q,), contiguous fp32 on one CUDA device; ``family`` a canonical
    family name."""
    global launches
    if family not in FAMILY_IDS:
        raise ValueError(f"unknown Bregman family {family!r}")
    q, b, d = rows.shape
    _build.expect(rows, "rows", (q, b, d))
    _build.expect(grad, "grad", (q, d))
    _build.expect(c_y, "c_y", (q,))
    dev = _build.same_device(rows, grad, c_y)
    out = torch.empty((q, b), dtype=torch.float32, device=dev)
    err = _build.library().brk_refine_batch(
        rows.data_ptr(), grad.data_ptr(), c_y.data_ptr(), out.data_ptr(),
        q, b, d, FAMILY_IDS[family], dev.index, _build.stream_of(dev))
    _build.check(err, "bregman_refine_batch")
    launches += 1
    return out


def bregman_refine(rows: torch.Tensor, grad: torch.Tensor, c_y: torch.Tensor,
                   family: str) -> torch.Tensor:
    """Exact D_f(rows[i], y) -> (b,): the q=1 slice of the batch kernel."""
    return bregman_refine_batch(rows[None], grad[None].contiguous(),
                                c_y.reshape(1).contiguous(), family)[0]


def bregman_refine_batch_quant(codes: torch.Tensor, scale: torch.Tensor,
                               zp: torch.Tensor, grad: torch.Tensor,
                               c_y: torch.Tensor,
                               family: str) -> torch.Tensor:
    """Exact D_f of the decoded rows -> (q, b); codes (q, b, d) int8, scale
    and zp (q, b), grad (q, d), c_y (q,) fp32, contiguous on one CUDA
    device; ``family`` a canonical family name."""
    global launches_quant
    if family not in FAMILY_IDS:
        raise ValueError(f"unknown Bregman family {family!r}")
    q, b, d = codes.shape
    _build.expect(codes, "codes", (q, b, d), torch.int8)
    _build.expect(scale, "scale", (q, b))
    _build.expect(zp, "zp", (q, b))
    _build.expect(grad, "grad", (q, d))
    _build.expect(c_y, "c_y", (q,))
    dev = _build.same_device(codes, scale, zp, grad, c_y)
    out = torch.empty((q, b), dtype=torch.float32, device=dev)
    err = _build.library().brk_refine_batch_quant(
        codes.data_ptr(), scale.data_ptr(), zp.data_ptr(), grad.data_ptr(),
        c_y.data_ptr(), out.data_ptr(), q, b, d, FAMILY_IDS[family],
        dev.index, _build.stream_of(dev))
    _build.check(err, "bregman_refine_batch_quant")
    launches_quant += 1
    return out
