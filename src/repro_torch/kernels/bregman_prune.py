"""CUDA prune kernels — the Theorem-3 admit mask of row blocks, alone.

    admit[n, q] = any_i ( amin[n, i] + qconst[q, i]
                          - gmax[n, i] * sd[q, i] <= qb[q, i] )

:func:`bregman_prune_mask` and :func:`bregman_prune_mask_blocks` replace
``src/repro/kernels/bregman_prune.py::bregman_prune_mask``;
:func:`bregman_prune_mask_quant` and :func:`bregman_prune_mask_blocks_quant`
replace its int8 sibling ``bregman_prune_mask_quant``, whose corner codes
decode per element as ``code * scale + zp``.  The kernels
(``csrc/bregman_prune.cu``) are the span tile of the fused filter+prune
(``csrc/filter_span.cuh``) with the UB totals switched off: they read only
the corner tables and write only the mask, with the fused kernels' own
compare and decode, so the mask is bit-equal to ``ref.bregman_prune_mask``
/ ``ref.bregman_prune_mask_quant`` and to the fused kernels' admit output.
Each takes any row span, or a device list of row blocks of the full
tables, in one persistent launch.  Bound by bytes on the H100.
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


def _fp32_operands(amin, gmax, qconst, sqrt_delta, qb) -> int:
    """q once the fp32 corners are (n, M) and the query tables (q, M), all
    contiguous fp32 on the card; raises otherwise."""
    n, m = amin.shape
    q = qconst.shape[0]
    _build.expect(amin, "amin", (n, m))
    _build.expect(gmax, "gmax", (n, m))
    _query_operands(q, m, qconst, sqrt_delta, qb)
    return q


def _corner_operands(amin_q, amin_scale, amin_zp, gmax_q, gmax_scale,
                     gmax_zp, qconst, sqrt_delta, qb) -> tuple[int, tuple]:
    """(q, the operands) once the int8 corners are (n, M) int8 with (n,)
    fp32 decode columns and the query tables (q, M) fp32, all contiguous
    on the card; raises otherwise."""
    n, m = amin_q.shape
    q = qconst.shape[0]
    _build.expect(amin_q, "amin_q", (n, m), torch.int8)
    _build.expect(gmax_q, "gmax_q", (n, m), torch.int8)
    for name, t in (("amin_scale", amin_scale), ("amin_zp", amin_zp),
                    ("gmax_scale", gmax_scale), ("gmax_zp", gmax_zp)):
        _build.expect(t, name, (n,))
    _query_operands(q, m, qconst, sqrt_delta, qb)
    return q, (amin_q, amin_scale, amin_zp, gmax_q, gmax_scale, gmax_zp,
               qconst, sqrt_delta, qb)


def _block_list(blocks: torch.Tensor, bn: int) -> int:
    """The number of listed blocks once ``blocks`` is a (nb,) int32 CUDA
    tensor and ``bn`` a positive int; raises otherwise."""
    if isinstance(bn, bool) or not isinstance(bn, int) or bn < 1:
        raise ValueError(f"bn must be a positive int, got {bn!r}")
    nb = blocks.shape[0] if blocks.ndim == 1 else -1
    _build.expect(blocks, "blocks", (nb,), torch.int32)
    return nb


def bregman_prune_mask(amin: torch.Tensor, gmax: torch.Tensor,
                       qconst: torch.Tensor, sqrt_delta: torch.Tensor,
                       qb: torch.Tensor) -> torch.Tensor:
    """(n, q) int32 admit mask over any n rows, in one launch; corners
    (n, M), query tables (q, M), all contiguous fp32 on one CUDA device."""
    global launches
    n, m = amin.shape
    q = _fp32_operands(amin, gmax, qconst, sqrt_delta, qb)
    dev = _build.same_device(amin, gmax, qconst, sqrt_delta, qb)
    admit = torch.empty((n, q), dtype=torch.int32, device=dev)
    err = _build.library().brk_prune_mask(
        amin.data_ptr(), gmax.data_ptr(), qconst.data_ptr(),
        sqrt_delta.data_ptr(), qb.data_ptr(), admit.data_ptr(), n, m, q,
        dev.index, _build.stream_of(dev))
    _build.check(err, "bregman_prune_mask")
    launches += 1
    return admit


def bregman_prune_mask_blocks(amin: torch.Tensor, gmax: torch.Tensor,
                              qconst: torch.Tensor, sqrt_delta: torch.Tensor,
                              qb: torch.Tensor, blocks: torch.Tensor,
                              bn: int) -> torch.Tensor:
    """(len(blocks) * bn, q) int32 admit mask over the listed row blocks
    of the full fp32 corner tables in one launch: ``blocks`` (nb,) int32
    block ids on the card, block b being rows ``[b * bn, (b + 1) * bn)``;
    listed block i's rows come at ``[i * bn, (i + 1) * bn)``, the rows of
    a short last block past n read 0.  Other operands as
    :func:`bregman_prune_mask`'s."""
    global launches
    n, m = amin.shape
    q = _fp32_operands(amin, gmax, qconst, sqrt_delta, qb)
    nb = _block_list(blocks, bn)
    dev = _build.same_device(amin, gmax, qconst, sqrt_delta, qb, blocks)
    admit = torch.empty((nb * bn, q), dtype=torch.int32, device=dev)
    if nb == 0:
        return admit                          # nothing to launch
    err = _build.library().brk_prune_mask_blocks(
        amin.data_ptr(), gmax.data_ptr(), qconst.data_ptr(),
        sqrt_delta.data_ptr(), qb.data_ptr(), blocks.data_ptr(),
        admit.data_ptr(), n, m, q, nb, bn, dev.index, _build.stream_of(dev))
    _build.check(err, "bregman_prune_mask_blocks")
    launches += 1
    return admit


def bregman_prune_mask_quant(
        amin_q: torch.Tensor, amin_scale: torch.Tensor,
        amin_zp: torch.Tensor, gmax_q: torch.Tensor,
        gmax_scale: torch.Tensor, gmax_zp: torch.Tensor,
        qconst: torch.Tensor, sqrt_delta: torch.Tensor,
        qb: torch.Tensor) -> torch.Tensor:
    """(n, q) int32 admit mask over any n rows, in one launch, from int8
    corner codes (n, M) with their per-row decode (n,) fp32; query tables
    (q, M) fp32; all contiguous on one CUDA device."""
    global launches_quant
    q, ops = _corner_operands(amin_q, amin_scale, amin_zp, gmax_q,
                              gmax_scale, gmax_zp, qconst, sqrt_delta, qb)
    n, m = amin_q.shape
    dev = _build.same_device(*ops)
    admit = torch.empty((n, q), dtype=torch.int32, device=dev)
    err = _build.library().brk_prune_mask_quant(
        *(t.data_ptr() for t in ops), admit.data_ptr(), n, m, q, dev.index,
        _build.stream_of(dev))
    _build.check(err, "bregman_prune_mask_quant")
    launches_quant += 1
    return admit


def bregman_prune_mask_blocks_quant(
        amin_q: torch.Tensor, amin_scale: torch.Tensor,
        amin_zp: torch.Tensor, gmax_q: torch.Tensor,
        gmax_scale: torch.Tensor, gmax_zp: torch.Tensor,
        qconst: torch.Tensor, sqrt_delta: torch.Tensor, qb: torch.Tensor,
        blocks: torch.Tensor, bn: int) -> torch.Tensor:
    """(len(blocks) * bn, q) int32 admit mask over the listed row blocks
    of the full int8 corner tables in one launch: ``blocks`` (nb,) int32
    block ids on the card, block b being rows ``[b * bn, (b + 1) * bn)``;
    listed block i's rows come at ``[i * bn, (i + 1) * bn)``, the rows of
    a short last block past n read 0.  Other operands as
    :func:`bregman_prune_mask_quant`'s."""
    global launches_quant
    q, ops = _corner_operands(amin_q, amin_scale, amin_zp, gmax_q,
                              gmax_scale, gmax_zp, qconst, sqrt_delta, qb)
    n, m = amin_q.shape
    nb = _block_list(blocks, bn)
    dev = _build.same_device(*ops, blocks)
    admit = torch.empty((nb * bn, q), dtype=torch.int32, device=dev)
    if nb == 0:
        return admit                          # nothing to launch
    err = _build.library().brk_prune_mask_blocks_quant(
        *(t.data_ptr() for t in ops), blocks.data_ptr(), admit.data_ptr(),
        n, m, q, nb, bn, dev.index, _build.stream_of(dev))
    _build.check(err, "bregman_prune_mask_blocks_quant")
    launches_quant += 1
    return admit
