"""CUDA filter kernel — the (n, q) Cauchy upper-bound totals of a row block.

    ub[n, q] = rowsum(alpha)[n] + qsum[q] + sqrt_gamma[n, :] . sqrt_delta[q, :]

Replaces ``src/repro/kernels/bregman_ub.py::bregman_ub_matrix`` (a Pallas
MXU product with M padded to 128 lanes).  On the H100 the work is bound by
bytes, not operations: the kernel (``csrc/bregman_ub.cu``) reads each table
element once through shared memory, loops over the real M and writes each
output once.  Plain version: ``ref.bregman_ub_matrix``.
"""

from __future__ import annotations

import torch

from . import _build

# Launches of the kernel in this process (read and reset by chip_smoke.py).
launches = 0


def bregman_ub_matrix(alpha: torch.Tensor, sqrt_gamma: torch.Tensor,
                      qsum: torch.Tensor,
                      sqrt_delta: torch.Tensor) -> torch.Tensor:
    """(n, q) UB totals; alpha, sqrt_gamma (n, M), qsum (q,), sqrt_delta
    (q, M), all contiguous fp32 on one CUDA device."""
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
