"""CUDA Gram kernel of the PCCP correlation matrix (paper §5.2).

:func:`pccp_gram` is the body of ``src/repro/kernels/pccp_corr.py::
pccp_correlation``: ``xc^T @ xc`` for centred rows xc (n, d) fp32, summed
over n in fp32 with no TF32 (``csrc/pccp_corr.cu``).  The centring, std,
scaling, ``abs`` and zeroed diagonal around it are torch operations in
``ops.pccp_correlation``, as the JAX wrapper keeps them outside its
``pallas_call``.  Only the tiles on and above the diagonal are computed
and mirrored; bound by operations on the H100 (n·d·(d+1) fp32 FLOPs).
"""

from __future__ import annotations

import torch

from . import _build

# Launches in this process (read and reset by chip_smoke.py).
launches = 0


def pccp_gram(xc: torch.Tensor) -> torch.Tensor:
    """(d, d) fp32 Gram matrix of a contiguous (n, d) fp32 CUDA tensor."""
    global launches
    if xc.ndim != 2:
        raise ValueError(f"xc must be (n, d), got {tuple(xc.shape)}")
    n, d = xc.shape
    _build.expect(xc, "xc", (n, d))
    dev = xc.device
    gram = torch.empty((d, d), dtype=torch.float32, device=dev)
    err = _build.library().brk_pccp_gram(
        xc.data_ptr(), gram.data_ptr(), n, d, dev.index,
        _build.stream_of(dev))
    _build.check(err, "pccp_gram")
    launches += 1
    return gram
