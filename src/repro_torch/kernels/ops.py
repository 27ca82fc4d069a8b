"""Kernel dispatch by the operands' device (port of ``repro.kernels.ops``).

A CUDA tensor launches the hand-written kernel (and raises if it cannot);
a CPU tensor runs the plain PyTorch version in ``ref``.  Nothing else
selects the path: no environment switch, no fallback from the card.  A
``meta`` tensor raises everywhere but in :func:`flash_attention`, whose
shape-only route gives the dry run (``launch/dryrun.py``) #10's output
without a launch.

A kernel launched through ctypes is invisible to a dispatch mode, so
:func:`flash_attention` tells each of ``KERNEL_OBSERVERS`` (the cost count
of ``launch/cost_analysis.py``) where a call begins and, at its end, the
operands, the output and the work of #10 by the pairs it attends, on
every route.
"""

from __future__ import annotations

import torch

from ..core.bregman import get_family
from . import bregman_dist as _dist
from . import bregman_fused as _fused
from . import bregman_prune as _prune
from . import bregman_ub as _ub
from . import flash_attention as _flash
from . import pccp_corr as _corr
from . import ref


# Objects with kernel_begin() and kernel_end(name, inputs, outputs, flops,
# transcendentals), told of every flash_attention call.
KERNEL_OBSERVERS: list = []


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def bregman_ub_filter(alpha, sqrt_gamma, qconst, sqrt_delta):
    """Total UBs for one query and a closure for the Alg.-4 k-th components.

    Returns ``(totals (n,), comp_of(kth) -> (M,))``.  Strictly single-query:
    ``qconst``/``sqrt_delta`` must be (M,); a (q, M) batch goes through
    :func:`bregman_ub_matrix`.  On the card the totals are kernel #1 at
    q = 1 over all n rows in one launch.
    """
    if qconst.ndim != 1 or sqrt_delta.ndim != 1:
        raise ValueError(
            "bregman_ub_filter is single-query: qconst/sqrt_delta must be "
            f"(M,), got {tuple(qconst.shape)}/{tuple(sqrt_delta.shape)}; use "
            "bregman_ub_matrix for query batches")
    if not _on_cuda(alpha):
        totals = ref.bregman_ub_totals(alpha, sqrt_gamma, qconst, sqrt_delta)
    else:
        totals = _ub.bregman_ub_matrix(alpha, sqrt_gamma,
                                       torch.sum(qconst)[None],
                                       sqrt_delta[None, :])[:, 0]

    def comp_of(kth):
        return alpha[kth] + qconst + sqrt_gamma[kth] * sqrt_delta

    return totals, comp_of


def bregman_ub_matrix(alpha, sqrt_gamma, qconst, sqrt_delta):
    """(n, q) UB totals for a query batch: (n,M)x2, (q,M)x2 -> (n,q)."""
    if not _on_cuda(alpha):
        return ref.bregman_ub_matrix(alpha, sqrt_gamma, qconst, sqrt_delta)
    return _ub.bregman_ub_matrix(alpha, sqrt_gamma,
                                 torch.sum(qconst, dim=-1), sqrt_delta)


def bregman_ub_matrix_quant(alpha_q, alpha_scale, alpha_zp, sg_q, sg_scale,
                            sg_zp, qconst, sqrt_delta):
    """(n, q) UB totals from the int8 filter tables (per-row affine)."""
    if qconst.ndim != 2 or sqrt_delta.ndim != 2:
        raise ValueError(
            "bregman_ub_matrix_quant wants (q, M) query batches, got "
            f"{tuple(qconst.shape)}/{tuple(sqrt_delta.shape)}")
    if not _on_cuda(alpha_q):
        return ref.bregman_ub_matrix_quant(alpha_q, alpha_scale, alpha_zp,
                                           sg_q, sg_scale, sg_zp, qconst,
                                           sqrt_delta)
    return _ub.bregman_ub_matrix_quant(alpha_q, alpha_scale, alpha_zp, sg_q,
                                       sg_scale, sg_zp,
                                       torch.sum(qconst, dim=-1), sqrt_delta,
                                       torch.sum(sqrt_delta, dim=-1))


def _query_operands(name: str, qconst, sqrt_delta, qb) -> None:
    if qconst.ndim != 2 or sqrt_delta.ndim != 2 or qb.ndim != 2:
        raise ValueError(
            f"{name} wants (q, M) query operands, got "
            f"{tuple(qconst.shape)}/{tuple(sqrt_delta.shape)}/"
            f"{tuple(qb.shape)}")


def bregman_prune_block(amin, gmax, qconst, sqrt_delta, qb):
    """Theorem-3 admit mask over any row span.  (n,M)x2, (q,M)x3 -> (n,q)
    int32: the tiered store's Stage B window and warm pool."""
    _query_operands("bregman_prune_block", qconst, sqrt_delta, qb)
    if not _on_cuda(amin):
        return ref.bregman_prune_mask(amin, gmax, qconst, sqrt_delta, qb)
    return _prune.bregman_prune_mask(amin, gmax, qconst, sqrt_delta, qb)


def bregman_prune_blocks(amin, gmax, qconst, sqrt_delta, qb, blocks,
                         bn: int):
    """Admit mask from the fp32 corner tables over the listed row blocks
    of the full (n, M) tables in one launch: ``blocks`` (nb,) int32 block
    ids, ``bn`` rows a block; output (nb * bn, q) int32, block i's rows at
    ``[i * bn, (i + 1) * bn)``, a short last block's rows past n 0."""
    _query_operands("bregman_prune_blocks", qconst, sqrt_delta, qb)
    if not _on_cuda(amin):
        return ref.bregman_prune_mask_blocks(amin, gmax, qconst, sqrt_delta,
                                             qb, blocks, bn)
    return _prune.bregman_prune_mask_blocks(amin, gmax, qconst, sqrt_delta,
                                            qb, blocks, bn)


def bregman_prune_block_quant(amin_q, amin_scale, amin_zp, gmax_q,
                              gmax_scale, gmax_zp, qconst, sqrt_delta, qb):
    """Admit mask from int8 corner codes (per-row affine, directed-rounded)."""
    _query_operands("bregman_prune_block_quant", qconst, sqrt_delta, qb)
    if not _on_cuda(amin_q):
        return ref.bregman_prune_mask_quant(amin_q, amin_scale, amin_zp,
                                            gmax_q, gmax_scale, gmax_zp,
                                            qconst, sqrt_delta, qb)
    return _prune.bregman_prune_mask_quant(amin_q, amin_scale, amin_zp,
                                           gmax_q, gmax_scale, gmax_zp,
                                           qconst, sqrt_delta, qb)


def bregman_prune_blocks_quant(amin_q, amin_scale, amin_zp, gmax_q,
                               gmax_scale, gmax_zp, qconst, sqrt_delta, qb,
                               blocks, bn: int):
    """Admit mask from the int8 corner codes over the listed row blocks of
    the full (n, M) tables in one launch: ``blocks`` (nb,) int32 block
    ids, ``bn`` rows a block; output (nb * bn, q) int32, block i's rows at
    ``[i * bn, (i + 1) * bn)``, a short last block's rows past n 0."""
    _query_operands("bregman_prune_blocks_quant", qconst, sqrt_delta, qb)
    if not _on_cuda(amin_q):
        return ref.bregman_prune_mask_blocks_quant(
            amin_q, amin_scale, amin_zp, gmax_q, gmax_scale, gmax_zp, qconst,
            sqrt_delta, qb, blocks, bn)
    return _prune.bregman_prune_mask_blocks_quant(
        amin_q, amin_scale, amin_zp, gmax_q, gmax_scale, gmax_zp, qconst,
        sqrt_delta, qb, blocks, bn)


def bregman_filter_prune_block(alpha, sqrt_gamma, amin, gmax, qconst,
                               sqrt_delta, qb):
    """Fused filter UB + Theorem-3 admit for a row block -> (ub, admit)."""
    _query_operands("bregman_filter_prune_block", qconst, sqrt_delta, qb)
    if alpha.shape != amin.shape:
        raise ValueError(
            "filter and corner tables must share (n, M), got "
            f"{tuple(alpha.shape)} vs {tuple(amin.shape)}")
    if not _on_cuda(alpha):
        return ref.bregman_filter_prune(alpha, sqrt_gamma, amin, gmax,
                                        qconst, sqrt_delta, qb)
    return _fused.bregman_filter_prune(alpha, sqrt_gamma, amin, gmax,
                                       torch.sum(qconst, dim=-1), qconst,
                                       sqrt_delta, qb)


def bregman_filter_prune_blocks(alpha, sqrt_gamma, amin, gmax, qconst,
                                sqrt_delta, qb, blocks, bn: int):
    """Fused (ub, admit) over the listed row blocks of the full (n, M)
    tables in one launch: ``blocks`` (nb,) int32 block ids, ``bn`` rows a
    block; each output (nb * bn, q), block i's rows at ``[i * bn,
    (i + 1) * bn)``, a short last block's rows past n inert (ub inf,
    admit 0)."""
    _query_operands("bregman_filter_prune_blocks", qconst, sqrt_delta, qb)
    if alpha.shape != amin.shape:
        raise ValueError(
            "filter and corner tables must share (n, M), got "
            f"{tuple(alpha.shape)} vs {tuple(amin.shape)}")
    if not _on_cuda(alpha):
        return ref.bregman_filter_prune_blocks(alpha, sqrt_gamma, amin, gmax,
                                               qconst, sqrt_delta, qb,
                                               blocks, bn)
    return _fused.bregman_filter_prune_blocks(
        alpha, sqrt_gamma, amin, gmax, torch.sum(qconst, dim=-1), qconst,
        sqrt_delta, qb, blocks, bn)


def bregman_filter_prune_block_quant(alpha_q, alpha_scale, alpha_zp, sg_q,
                                     sg_scale, sg_zp, amin_q, amin_scale,
                                     amin_zp, gmax_q, gmax_scale, gmax_zp,
                                     qconst, sqrt_delta, qb):
    """Fused (ub, admit) from int8 filter and corner codes (per-row
    affine; corners directed-rounded)."""
    _query_operands("bregman_filter_prune_block_quant", qconst, sqrt_delta,
                    qb)
    if alpha_q.shape != amin_q.shape:
        raise ValueError(
            "filter and corner tables must share (n, M), got "
            f"{tuple(alpha_q.shape)} vs {tuple(amin_q.shape)}")
    if not _on_cuda(alpha_q):
        return ref.bregman_filter_prune_quant(
            alpha_q, alpha_scale, alpha_zp, sg_q, sg_scale, sg_zp, amin_q,
            amin_scale, amin_zp, gmax_q, gmax_scale, gmax_zp, qconst,
            sqrt_delta, qb)
    return _fused.bregman_filter_prune_quant(
        alpha_q, alpha_scale, alpha_zp, sg_q, sg_scale, sg_zp, amin_q,
        amin_scale, amin_zp, gmax_q, gmax_scale, gmax_zp,
        torch.sum(qconst, dim=-1), qconst, sqrt_delta,
        torch.sum(sqrt_delta, dim=-1), qb)


def bregman_filter_prune_blocks_quant(alpha_q, alpha_scale, alpha_zp, sg_q,
                                      sg_scale, sg_zp, amin_q, amin_scale,
                                      amin_zp, gmax_q, gmax_scale, gmax_zp,
                                      qconst, sqrt_delta, qb, blocks,
                                      bn: int):
    """Fused (ub, admit) from the int8 filter and corner codes over the
    listed row blocks of the full (n, M) tables in one launch, laid out as
    :func:`bregman_filter_prune_blocks` lays them out."""
    _query_operands("bregman_filter_prune_blocks_quant", qconst, sqrt_delta,
                    qb)
    if alpha_q.shape != amin_q.shape:
        raise ValueError(
            "filter and corner tables must share (n, M), got "
            f"{tuple(alpha_q.shape)} vs {tuple(amin_q.shape)}")
    if not _on_cuda(alpha_q):
        return ref.bregman_filter_prune_blocks_quant(
            alpha_q, alpha_scale, alpha_zp, sg_q, sg_scale, sg_zp, amin_q,
            amin_scale, amin_zp, gmax_q, gmax_scale, gmax_zp, qconst,
            sqrt_delta, qb, blocks, bn)
    return _fused.bregman_filter_prune_blocks_quant(
        alpha_q, alpha_scale, alpha_zp, sg_q, sg_scale, sg_zp, amin_q,
        amin_scale, amin_zp, gmax_q, gmax_scale, gmax_zp,
        torch.sum(qconst, dim=-1), qconst, sqrt_delta,
        torch.sum(sqrt_delta, dim=-1), qb, blocks, bn)


def bregman_refine_batch(rows, grad, c_y, family: str):
    """Per-query exact distances.  (q,b,d),(q,d),(q,) -> (q,b)."""
    if rows.ndim != 3 or grad.ndim != 2:
        raise ValueError(
            "bregman_refine_batch wants (q,b,d)/(q,d), got "
            f"{tuple(rows.shape)}/{tuple(grad.shape)}; use bregman_refine "
            "for one query")
    name = get_family(family).name
    if not _on_cuda(rows):
        return ref.bregman_refine_batch(rows, grad, c_y, name)
    return _dist.bregman_refine_batch(rows, grad, c_y, name)


def bregman_refine(rows, grad, c_y, family: str):
    """Exact distances for one query's rows.  (b,d),(d,),() -> (b,)."""
    name = get_family(family).name
    if not _on_cuda(rows):
        return ref.bregman_refine(rows, grad, c_y, name)
    return _dist.bregman_refine(rows, grad, c_y, name)


def bregman_refine_batch_quant(codes, scale, zp, grad, c_y, family: str):
    """Fused dequantize + exact distances.  (q,b,d) int8, (q,b) x2 -> (q,b)."""
    if codes.ndim != 3 or scale.ndim != 2 or grad.ndim != 2:
        raise ValueError(
            "bregman_refine_batch_quant wants (q,b,d) codes with (q,b) "
            f"decode rows, got {tuple(codes.shape)}/{tuple(scale.shape)}/"
            f"{tuple(grad.shape)}")
    name = get_family(family).name
    if not _on_cuda(codes):
        return ref.bregman_refine_batch_quant(codes, scale, zp, grad, c_y,
                                              name)
    return _dist.bregman_refine_batch_quant(codes, scale, zp, grad, c_y,
                                            name)


def pccp_correlation(x):
    """(d, d) |Pearson| correlations of the columns of x (n, d) fp32, the
    diagonal zeroed.  On the card the Gram ``xc^T xc`` is the CUDA kernel;
    centring, std, scaling, abs and the diagonal are torch operations, as
    the reference keeps them outside its ``pallas_call``."""
    if x.ndim != 2:
        raise ValueError(f"pccp_correlation wants (n, d), got "
                         f"{tuple(x.shape)}")
    if not _on_cuda(x):
        return ref.pccp_correlation(x)
    n, d = x.shape
    xc = x - torch.mean(x, dim=0, keepdim=True)
    std = torch.sqrt(torch.mean(xc * xc, dim=0))
    std = torch.where(std < 1e-12, 1.0, std)
    gram = _corr.pccp_gram(xc.contiguous())
    corr = torch.abs(gram / (n * std[:, None] * std[None, :]))
    return corr * (1.0 - torch.eye(d, dtype=corr.dtype, device=x.device))


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """GQA attention, q (B, H, Sq, D), k/v (B, KH, Skv, D), queries
    end-aligned to the keys; output (B, H, Sq, D) in q's dtype and layout
    (on ``meta`` an empty output and no launch).  Forward only: #10 has no backward pass (nor has
    the reference's Pallas kernel), so with grad mode on and q, k or v
    asking for a gradient this raises ``ValueError`` on either device,
    rather than return an output that cuts the graph; training attends
    through ``models.attention.sdpa_train``."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (q, k, v)):
        raise ValueError(
            "flash_attention (kernel #10) has no backward pass: call it "
            "under torch.no_grad() or torch.inference_mode(), or attend "
            "through models.attention.sdpa_train to train")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"flash_attention wants (B, heads, S, D) tensors, got "
            f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    observers = tuple(KERNEL_OBSERVERS)
    for obs in observers:
        obs.kernel_begin()
    out = None
    try:
        if q.device.type == "meta":
            out = _flash.flash_attention_meta(q, k, v, causal=causal,
                                              window=window)
        elif not _on_cuda(q):
            # in q's layout, as the kernel writes it, so what follows
            # reads the same strides on every route
            out = torch.empty_like(q).copy_(ref.flash_attention(
                q, k, v, causal=causal, window=window, scale=scale))
        else:
            out = _flash.flash_attention(q, k, v, causal=causal,
                                         window=window, scale=scale)
        return out
    finally:
        if observers:
            b, h, sq, d = q.shape
            pairs = b * h * _flash.attended(sq, k.shape[2], causal,
                                            window)[0]
            for obs in reversed(observers):
                obs.kernel_end("flash_attention", (q, k, v),
                               () if out is None else (out,),
                               flops=4 * d * pairs, transcendentals=pairs)
