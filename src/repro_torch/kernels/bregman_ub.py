"""CUDA filter kernels — the (n, q) Cauchy upper-bound totals of a row span.

    ub[n, q] = rowsum(alpha)[n] + qsum[q] + sqrt_gamma[n, :] . sqrt_delta[q, :]

:func:`bregman_ub_matrix` replaces ``src/repro/kernels/bregman_ub.py::
bregman_ub_matrix`` (a Pallas MXU product with M padded to 128 lanes) and
:func:`bregman_ub_matrix_quant` its int8 sibling ``bregman_ub_matrix_quant``
(codes plus a per-row affine factored out of both sums).  On the H100 the
work is bound by bytes, not operations.  Both kernels
(``csrc/bregman_ub.cu`` on ``csrc/filter_span.cuh``) take any row span in
one persistent launch, so the search hands them many row blocks at once;
each reads every table element once through shared memory, loops over the
real M and writes each output once.  Plain versions:
``ref.bregman_ub_matrix`` and ``ref.bregman_ub_matrix_quant``.
"""

from __future__ import annotations

import torch

from . import _build

# Launches of each kernel in this process (read and reset by chip_smoke.py).
launches = 0
launches_quant = 0


def bregman_ub_matrix(alpha: torch.Tensor, sqrt_gamma: torch.Tensor,
                      qsum: torch.Tensor,
                      sqrt_delta: torch.Tensor) -> torch.Tensor:
    """(n, q) UB totals over any n rows, in one launch; alpha, sqrt_gamma
    (n, M), qsum (q,), sqrt_delta (q, M), all contiguous fp32 on one CUDA
    device."""
    global launches
    n, m = alpha.shape
    q = qsum.shape[0]
    _build.expect(alpha, "alpha", (n, m))
    _build.expect(sqrt_gamma, "sqrt_gamma", (n, m))
    _build.expect(qsum, "qsum", (q,))
    _build.expect(sqrt_delta, "sqrt_delta", (q, m))
    dev = _build.same_device(alpha, sqrt_gamma, qsum, sqrt_delta)
    out = torch.empty((n, q), dtype=torch.float32, device=dev)
    err = _build.library().brk_ub_matrix(
        alpha.data_ptr(), sqrt_gamma.data_ptr(), qsum.data_ptr(),
        sqrt_delta.data_ptr(), out.data_ptr(), n, m, q, dev.index,
        _build.stream_of(dev))
    _build.check(err, "bregman_ub_matrix")
    launches += 1
    return out


def bregman_ub_matrix_quant(alpha_q: torch.Tensor, alpha_scale: torch.Tensor,
                            alpha_zp: torch.Tensor, sg_q: torch.Tensor,
                            sg_scale: torch.Tensor, sg_zp: torch.Tensor,
                            qsum: torch.Tensor, sqrt_delta: torch.Tensor,
                            sdsum: torch.Tensor) -> torch.Tensor:
    """(n, q) UB totals over any n rows, in one launch, from int8 filter
    codes; codes (n, M) int8, per-row decode (n,) fp32, qsum (q,),
    sqrt_delta (q, M) and its row sums sdsum (q,), all contiguous on one
    CUDA device."""
    global launches_quant
    n, m = alpha_q.shape
    q = qsum.shape[0]
    for name, t in (("alpha_q", alpha_q), ("sg_q", sg_q)):
        _build.expect(t, name, (n, m), torch.int8)
    for name, t in (("alpha_scale", alpha_scale), ("alpha_zp", alpha_zp),
                    ("sg_scale", sg_scale), ("sg_zp", sg_zp)):
        _build.expect(t, name, (n,))
    _build.expect(qsum, "qsum", (q,))
    _build.expect(sqrt_delta, "sqrt_delta", (q, m))
    _build.expect(sdsum, "sdsum", (q,))
    dev = _build.same_device(alpha_q, alpha_scale, alpha_zp, sg_q, sg_scale,
                             sg_zp, qsum, sqrt_delta, sdsum)
    out = torch.empty((n, q), dtype=torch.float32, device=dev)
    err = _build.library().brk_ub_matrix_quant(
        alpha_q.data_ptr(), alpha_scale.data_ptr(), alpha_zp.data_ptr(),
        sg_q.data_ptr(), sg_scale.data_ptr(), sg_zp.data_ptr(),
        qsum.data_ptr(), sqrt_delta.data_ptr(), sdsum.data_ptr(),
        out.data_ptr(), n, m, q, dev.index, _build.stream_of(dev))
    _build.check(err, "bregman_ub_matrix_quant")
    launches_quant += 1
    return out
