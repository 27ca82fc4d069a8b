"""CUDA prune kernels — the Theorem-3 admit mask of a row block, alone.

    admit[n, q] = any_i ( amin[n, i] + qconst[q, i]
                          - gmax[n, i] * sd[q, i] <= qb[q, i] )

:func:`bregman_prune_mask` replaces ``src/repro/kernels/bregman_prune.py::
bregman_prune_mask`` and :func:`bregman_prune_mask_quant` its int8 sibling
``bregman_prune_mask_quant``, whose corner codes decode per element as
``code * scale + zp``.  The kernels (``csrc/bregman_prune.cu``) are the
fused filter+prune tile with the UB totals switched off: they read only the
corner tables and write only the mask, with the fused kernels' own compare
and decode, so the mask is bit-equal to ``ref.bregman_prune_mask`` /
``ref.bregman_prune_mask_quant`` and to the fused kernels' admit output.
Bound by bytes on the H100, and by the launch at the path's block sizes.
"""

from __future__ import annotations

import torch

from . import _build

# Launches of each kernel in this process (read and reset by chip_smoke.py).
launches = 0
launches_quant = 0


def _query_operands(q: int, m: int, qconst, sqrt_delta, qb) -> None:
    for name, t in (("qconst", qconst), ("sqrt_delta", sqrt_delta),
                    ("qb", qb)):
        _build.expect(t, name, (q, m))


def bregman_prune_mask(amin: torch.Tensor, gmax: torch.Tensor,
                       qconst: torch.Tensor, sqrt_delta: torch.Tensor,
                       qb: torch.Tensor) -> torch.Tensor:
    """(n, q) int32 admit mask; corners (n, M), query tables (q, M), all
    contiguous fp32 on one CUDA device."""
    global launches
    n, m = amin.shape
    q = qconst.shape[0]
    _build.expect(amin, "amin", (n, m))
    _build.expect(gmax, "gmax", (n, m))
    _query_operands(q, m, qconst, sqrt_delta, qb)
    dev = _build.same_device(amin, gmax, qconst, sqrt_delta, qb)
    admit = torch.empty((n, q), dtype=torch.int32, device=dev)
    err = _build.library().brk_prune_mask(
        amin.data_ptr(), gmax.data_ptr(), qconst.data_ptr(),
        sqrt_delta.data_ptr(), qb.data_ptr(), admit.data_ptr(), n, m, q,
        dev.index, _build.stream_of(dev))
    _build.check(err, "bregman_prune_mask")
    launches += 1
    return admit


def bregman_prune_mask_quant(
        amin_q: torch.Tensor, amin_scale: torch.Tensor,
        amin_zp: torch.Tensor, gmax_q: torch.Tensor,
        gmax_scale: torch.Tensor, gmax_zp: torch.Tensor,
        qconst: torch.Tensor, sqrt_delta: torch.Tensor,
        qb: torch.Tensor) -> torch.Tensor:
    """(n, q) int32 admit mask from int8 corner codes (n, M) with their
    per-row decode (n,) fp32; query tables (q, M) fp32; all contiguous on
    one CUDA device."""
    global launches_quant
    n, m = amin_q.shape
    q = qconst.shape[0]
    _build.expect(amin_q, "amin_q", (n, m), torch.int8)
    _build.expect(gmax_q, "gmax_q", (n, m), torch.int8)
    decode = (("amin_scale", amin_scale), ("amin_zp", amin_zp),
              ("gmax_scale", gmax_scale), ("gmax_zp", gmax_zp))
    for name, t in decode:
        _build.expect(t, name, (n,))
    _query_operands(q, m, qconst, sqrt_delta, qb)
    dev = _build.same_device(amin_q, gmax_q, *(t for _, t in decode),
                             qconst, sqrt_delta, qb)
    admit = torch.empty((n, q), dtype=torch.int32, device=dev)
    err = _build.library().brk_prune_mask_quant(
        amin_q.data_ptr(), amin_scale.data_ptr(), amin_zp.data_ptr(),
        gmax_q.data_ptr(), gmax_scale.data_ptr(), gmax_zp.data_ptr(),
        qconst.data_ptr(), sqrt_delta.data_ptr(), qb.data_ptr(),
        admit.data_ptr(), n, m, q, dev.index, _build.stream_of(dev))
    _build.check(err, "bregman_prune_mask_quant")
    launches_quant += 1
    return admit
