"""CUDA fused filter + prune kernel — a row block's UB tile and admit mask.

    ub[n, q]    = rowsum(alpha)[n] + qsum[q] + sqrt_gamma[n, :] . sd[q, :]
    admit[n, q] = any_i ( amin[n, i] + qconst[q, i]
                          - gmax[n, i] * sd[q, i] <= qb[q, i] )

Replaces ``src/repro/kernels/bregman_fused.py::bregman_filter_prune``.
Bound by bytes on the H100: the kernel (``csrc/bregman_fused.cu``) stages
the query tile once for both outputs, reads each table element once, and
writes the admit compare with round-to-nearest intrinsics so the mask is
bit-equal to ``ref.bregman_filter_prune``.
"""

from __future__ import annotations

import torch

from . import _build

# Launches of the kernel in this process (read and reset by chip_smoke.py).
launches = 0


def bregman_filter_prune(alpha: torch.Tensor, sqrt_gamma: torch.Tensor,
                         amin: torch.Tensor, gmax: torch.Tensor,
                         qsum: torch.Tensor, qconst: torch.Tensor,
                         sqrt_delta: torch.Tensor, qb: torch.Tensor,
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ub (n, q) f32, admit (n, q) int32); point tables (n, M), qsum (q,),
    query tables (q, M), all contiguous fp32 on one CUDA device."""
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
