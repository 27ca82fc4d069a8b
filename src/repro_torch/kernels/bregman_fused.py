"""CUDA fused filter + prune kernel — UB tile and admit mask of row blocks.

    ub[n, q]    = rowsum(alpha)[n] + qsum[q] + sqrt_gamma[n, :] . sd[q, :]
    admit[n, q] = any_i ( amin[n, i] + qconst[q, i]
                          - gmax[n, i] * sd[q, i] <= qb[q, i] )

:func:`bregman_filter_prune_blocks` and :func:`bregman_filter_prune`
replace ``src/repro/kernels/bregman_fused.py::bregman_filter_prune``: the
first over a device list of row blocks of the full tables in one
persistent launch (what the search runs), the second over one block.
:func:`bregman_filter_prune_blocks_quant` and
:func:`bregman_filter_prune_quant` replace its int8 sibling
``bregman_filter_prune_quant``, whose corners decode per element as
``code * scale + zp``, the same two ways.  Bound by bytes on the H100 (the
int8 launch by its arithmetic's issue): the kernels
(``csrc/bregman_fused.cu`` on ``csrc/filter_span.cuh``) stage the query
tables once for both outputs, read each table element once, and write the
decode and the admit compare with round-to-nearest intrinsics so the mask
is bit-equal to the plain versions in ``ref``.
"""

from __future__ import annotations

import torch

from . import _build

# Launches of each kernel in this process (read and reset by chip_smoke.py).
launches = 0
launches_quant = 0


def bregman_filter_prune(alpha: torch.Tensor, sqrt_gamma: torch.Tensor,
                         amin: torch.Tensor, gmax: torch.Tensor,
                         qsum: torch.Tensor, qconst: torch.Tensor,
                         sqrt_delta: torch.Tensor, qb: torch.Tensor,
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ub (n, q) f32, admit (n, q) int32) over one row block, the tables'
    n rows; point tables (n, M), qsum (q,), query tables (q, M), all
    contiguous fp32 on one CUDA device."""
    global launches
    n, m = alpha.shape
    q = qsum.shape[0]
    for name, t in (("alpha", alpha), ("sqrt_gamma", sqrt_gamma),
                    ("amin", amin), ("gmax", gmax)):
        _build.expect(t, name, (n, m))
    _build.expect(qsum, "qsum", (q,))
    for name, t in (("qconst", qconst), ("sqrt_delta", sqrt_delta),
                    ("qb", qb)):
        _build.expect(t, name, (q, m))
    dev = _build.same_device(alpha, sqrt_gamma, amin, gmax, qsum, qconst,
                             sqrt_delta, qb)
    ub = torch.empty((n, q), dtype=torch.float32, device=dev)
    admit = torch.empty((n, q), dtype=torch.int32, device=dev)
    err = _build.library().brk_filter_prune(
        alpha.data_ptr(), sqrt_gamma.data_ptr(), amin.data_ptr(),
        gmax.data_ptr(), qsum.data_ptr(), qconst.data_ptr(),
        sqrt_delta.data_ptr(), qb.data_ptr(), ub.data_ptr(),
        admit.data_ptr(), n, m, q, dev.index, _build.stream_of(dev))
    _build.check(err, "bregman_filter_prune")
    launches += 1
    return ub, admit


def bregman_filter_prune_blocks(alpha: torch.Tensor, sqrt_gamma: torch.Tensor,
                                amin: torch.Tensor, gmax: torch.Tensor,
                                qsum: torch.Tensor, qconst: torch.Tensor,
                                sqrt_delta: torch.Tensor, qb: torch.Tensor,
                                blocks: torch.Tensor, bn: int,
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ub, admit), each (len(blocks) * bn, q), over the listed row blocks
    of the full (n, M) tables in one launch; ``blocks`` (nb,) int32 block
    ids on the card, block b being rows ``[b * bn, (b + 1) * bn)``.  Listed
    block i's rows come at ``[i * bn, (i + 1) * bn)``; the rows of a short
    last block past n read ``ub = inf`` and ``admit = 0``.  Other operands
    as :func:`bregman_filter_prune`'s."""
    global launches
    n, m = alpha.shape
    q = qsum.shape[0]
    for name, t in (("alpha", alpha), ("sqrt_gamma", sqrt_gamma),
                    ("amin", amin), ("gmax", gmax)):
        _build.expect(t, name, (n, m))
    _build.expect(qsum, "qsum", (q,))
    for name, t in (("qconst", qconst), ("sqrt_delta", sqrt_delta),
                    ("qb", qb)):
        _build.expect(t, name, (q, m))
    if isinstance(bn, bool) or not isinstance(bn, int) or bn < 1:
        raise ValueError(f"bn must be a positive int, got {bn!r}")
    nb = blocks.shape[0] if blocks.ndim == 1 else -1
    _build.expect(blocks, "blocks", (nb,), torch.int32)
    dev = _build.same_device(alpha, sqrt_gamma, amin, gmax, qsum, qconst,
                             sqrt_delta, qb, blocks)
    ub = torch.empty((nb * bn, q), dtype=torch.float32, device=dev)
    admit = torch.empty((nb * bn, q), dtype=torch.int32, device=dev)
    if nb == 0:
        return ub, admit                      # nothing to launch
    err = _build.library().brk_filter_prune_blocks(
        alpha.data_ptr(), sqrt_gamma.data_ptr(), amin.data_ptr(),
        gmax.data_ptr(), qsum.data_ptr(), qconst.data_ptr(),
        sqrt_delta.data_ptr(), qb.data_ptr(), blocks.data_ptr(),
        ub.data_ptr(), admit.data_ptr(), n, m, q, nb, bn, dev.index,
        _build.stream_of(dev))
    _build.check(err, "bregman_filter_prune_blocks")
    launches += 1
    return ub, admit


def _quant_named(alpha_q, alpha_scale, alpha_zp, sg_q, sg_scale, sg_zp,
                 amin_q, amin_scale, amin_zp, gmax_q, gmax_scale, gmax_zp,
                 qconst, sqrt_delta, qb) -> tuple:
    """The int8 kernels' table, decode and query operands, named."""
    return ((("alpha_q", alpha_q), ("sg_q", sg_q), ("amin_q", amin_q),
             ("gmax_q", gmax_q)),
            (("alpha_scale", alpha_scale), ("alpha_zp", alpha_zp),
             ("sg_scale", sg_scale), ("sg_zp", sg_zp),
             ("amin_scale", amin_scale), ("amin_zp", amin_zp),
             ("gmax_scale", gmax_scale), ("gmax_zp", gmax_zp)),
            (("qconst", qconst), ("sqrt_delta", sqrt_delta), ("qb", qb)))


def _check_quant(codes: tuple, decode: tuple, qsum: torch.Tensor,
                 sdsum: torch.Tensor, queries: tuple) -> tuple[int, int]:
    """(m, q) of the int8 operands; raises unless the codes are (n, M)
    int8, their decode (n,) fp32, qsum and sdsum (q,), the query tables
    (q, M), all contiguous on the card."""
    n, m = codes[0][1].shape
    q = qsum.shape[0]
    for name, t in codes:
        _build.expect(t, name, (n, m), torch.int8)
    for name, t in decode:
        _build.expect(t, name, (n,))
    _build.expect(qsum, "qsum", (q,))
    _build.expect(sdsum, "sdsum", (q,))
    for name, t in queries:
        _build.expect(t, name, (q, m))
    return m, q


def bregman_filter_prune_quant(
        alpha_q: torch.Tensor, alpha_scale: torch.Tensor,
        alpha_zp: torch.Tensor, sg_q: torch.Tensor, sg_scale: torch.Tensor,
        sg_zp: torch.Tensor, amin_q: torch.Tensor, amin_scale: torch.Tensor,
        amin_zp: torch.Tensor, gmax_q: torch.Tensor,
        gmax_scale: torch.Tensor, gmax_zp: torch.Tensor, qsum: torch.Tensor,
        qconst: torch.Tensor, sqrt_delta: torch.Tensor, sdsum: torch.Tensor,
        qb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(ub (n, q) f32, admit (n, q) int32) from int8 filter and corner
    codes (n, M) with their per-row decode (n,) fp32; qsum and sdsum (q,)
    (the row sums of qconst and sqrt_delta), query tables (q, M), all
    contiguous on one CUDA device."""
    global launches_quant
    codes, decode, queries = _quant_named(
        alpha_q, alpha_scale, alpha_zp, sg_q, sg_scale, sg_zp, amin_q,
        amin_scale, amin_zp, gmax_q, gmax_scale, gmax_zp, qconst,
        sqrt_delta, qb)
    m, q = _check_quant(codes, decode, qsum, sdsum, queries)
    n = alpha_q.shape[0]
    dev = _build.same_device(*(t for _, t in codes + decode + queries), qsum,
                             sdsum)
    ub = torch.empty((n, q), dtype=torch.float32, device=dev)
    admit = torch.empty((n, q), dtype=torch.int32, device=dev)
    err = _build.library().brk_filter_prune_quant(
        alpha_q.data_ptr(), alpha_scale.data_ptr(), alpha_zp.data_ptr(),
        sg_q.data_ptr(), sg_scale.data_ptr(), sg_zp.data_ptr(),
        amin_q.data_ptr(), amin_scale.data_ptr(), amin_zp.data_ptr(),
        gmax_q.data_ptr(), gmax_scale.data_ptr(), gmax_zp.data_ptr(),
        qsum.data_ptr(), qconst.data_ptr(), sqrt_delta.data_ptr(),
        sdsum.data_ptr(), qb.data_ptr(), ub.data_ptr(), admit.data_ptr(),
        n, m, q, dev.index, _build.stream_of(dev))
    _build.check(err, "bregman_filter_prune_quant")
    launches_quant += 1
    return ub, admit


def bregman_filter_prune_blocks_quant(
        alpha_q: torch.Tensor, alpha_scale: torch.Tensor,
        alpha_zp: torch.Tensor, sg_q: torch.Tensor, sg_scale: torch.Tensor,
        sg_zp: torch.Tensor, amin_q: torch.Tensor, amin_scale: torch.Tensor,
        amin_zp: torch.Tensor, gmax_q: torch.Tensor,
        gmax_scale: torch.Tensor, gmax_zp: torch.Tensor, qsum: torch.Tensor,
        qconst: torch.Tensor, sqrt_delta: torch.Tensor, sdsum: torch.Tensor,
        qb: torch.Tensor, blocks: torch.Tensor,
        bn: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(ub, admit), each (len(blocks) * bn, q), over the listed row blocks
    of the full int8 tables in one launch: ``blocks`` (nb,) int32 block ids
    on the card, block b being rows ``[b * bn, (b + 1) * bn)``; listed
    block i's rows come at ``[i * bn, (i + 1) * bn)``, the rows of a short
    last block past n read ``ub = inf`` and ``admit = 0``.  Other operands
    as :func:`bregman_filter_prune_quant`'s."""
    global launches_quant
    codes, decode, queries = _quant_named(
        alpha_q, alpha_scale, alpha_zp, sg_q, sg_scale, sg_zp, amin_q,
        amin_scale, amin_zp, gmax_q, gmax_scale, gmax_zp, qconst,
        sqrt_delta, qb)
    m, q = _check_quant(codes, decode, qsum, sdsum, queries)
    n = alpha_q.shape[0]
    if isinstance(bn, bool) or not isinstance(bn, int) or bn < 1:
        raise ValueError(f"bn must be a positive int, got {bn!r}")
    nb = blocks.shape[0] if blocks.ndim == 1 else -1
    _build.expect(blocks, "blocks", (nb,), torch.int32)
    dev = _build.same_device(*(t for _, t in codes + decode + queries), qsum,
                             sdsum, blocks)
    ub = torch.empty((nb * bn, q), dtype=torch.float32, device=dev)
    admit = torch.empty((nb * bn, q), dtype=torch.int32, device=dev)
    if nb == 0:
        return ub, admit                      # nothing to launch
    err = _build.library().brk_filter_prune_blocks_quant(
        alpha_q.data_ptr(), alpha_scale.data_ptr(), alpha_zp.data_ptr(),
        sg_q.data_ptr(), sg_scale.data_ptr(), sg_zp.data_ptr(),
        amin_q.data_ptr(), amin_scale.data_ptr(), amin_zp.data_ptr(),
        gmax_q.data_ptr(), gmax_scale.data_ptr(), gmax_zp.data_ptr(),
        qsum.data_ptr(), qconst.data_ptr(), sqrt_delta.data_ptr(),
        sdsum.data_ptr(), qb.data_ptr(), blocks.data_ptr(), ub.data_ptr(),
        admit.data_ptr(), n, m, q, nb, bn, dev.index, _build.stream_of(dev))
    _build.check(err, "bregman_filter_prune_blocks_quant")
    launches_quant += 1
    return ub, admit

