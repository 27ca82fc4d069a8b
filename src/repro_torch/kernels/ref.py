"""Plain PyTorch versions of the CUDA kernels (the correctness ground truth).

Each function mirrors its kernel's arithmetic.  A wrapper in ``ops`` runs
these for tensors on the CPU; ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""

from __future__ import annotations

import torch

from ..core import quantize as qz

Tensor = torch.Tensor


def bregman_ub_totals(alpha: Tensor, sqrt_gamma: Tensor, qconst: Tensor,
                      sqrt_delta: Tensor) -> Tensor:
    """Total UB per point for a single query.  (n,M),(n,M),(M,),(M,) -> (n,)."""
    return (torch.sum(alpha, -1) + torch.sum(qconst, -1)
            + sqrt_gamma @ sqrt_delta)


def bregman_ub_matrix(alpha: Tensor, sqrt_gamma: Tensor, qconst: Tensor,
                      sqrt_delta: Tensor) -> Tensor:
    """UB totals for a query batch.  (n,M),(n,M),(q,M),(q,M) -> (n,q)."""
    return (torch.sum(alpha, -1)[:, None] + torch.sum(qconst, -1)[None, :]
            + sqrt_gamma @ sqrt_delta.T)


def bregman_ub_matrix_quant(alpha_q: Tensor, alpha_scale: Tensor,
                            alpha_zp: Tensor, sg_q: Tensor, sg_scale: Tensor,
                            sg_zp: Tensor, qconst: Tensor,
                            sqrt_delta: Tensor) -> Tensor:
    """UB totals from the int8 filter tables.  Codes (n, M) int8, per-row
    decode (n,), queries (q, M) -> (n, q).  The per-row affine factors out
    of both reductions:

        rowsum(alpha_hat) = alpha_scale * rowsum(alpha_q) + M * alpha_zp
        sg_hat . sd       = sg_scale * (sg_q . sd) + sg_zp * sum(sd)
    """
    m = alpha_q.shape[1]
    arow = (alpha_scale * torch.sum(alpha_q.to(torch.float32), -1)
            + float(m) * alpha_zp)
    qsum = torch.sum(qconst, -1)                                  # (q,)
    sdsum = torch.sum(sqrt_delta, -1)                             # (q,)
    cauchy = (sg_scale[:, None] * (sg_q.to(torch.float32) @ sqrt_delta.T)
              + sg_zp[:, None] * sdsum[None, :])
    return arow[:, None] + qsum[None, :] + cauchy


def bregman_prune_mask(amin: Tensor, gmax: Tensor, qconst: Tensor,
                       sqrt_delta: Tensor, qb: Tensor) -> Tensor:
    """Theorem-3 per-point admit mask.  (n,M)x2, (q,M)x3 -> (n,q) int32.

    Admit point x for query y iff SOME subspace's cluster lower bound
    ``amin + qconst - gmax * sqrt_delta`` (each operation rounded on its
    own, no fused multiply-add) is within that subspace's bound ``qb``.
    """
    lb = (amin[:, :, None] + qconst.T[None, :, :]
          - gmax[:, :, None] * sqrt_delta.T[None, :, :])     # (n, M, q)
    return torch.any(lb <= qb.T[None, :, :], dim=1).to(torch.int32)


def bregman_prune_mask_quant(amin_q: Tensor, amin_scale: Tensor,
                             amin_zp: Tensor, gmax_q: Tensor,
                             gmax_scale: Tensor, gmax_zp: Tensor,
                             qconst: Tensor, sqrt_delta: Tensor,
                             qb: Tensor) -> Tensor:
    """Admit mask from int8 corner codes (n, M) and their per-row decode
    (n,).  The corners decode through ``dequantize_stats``, op by op, as
    every other reader of the int8 corner tables (the envelopes too)
    decodes them; they were rounded to the conservative side at encode, so
    no slack term enters."""
    amin = qz.dequantize_stats(amin_q, amin_scale, amin_zp)
    gmax = qz.dequantize_stats(gmax_q, gmax_scale, gmax_zp)
    return bregman_prune_mask(amin, gmax, qconst, sqrt_delta, qb)


def bregman_filter_prune(alpha: Tensor, sqrt_gamma: Tensor, amin: Tensor,
                         gmax: Tensor, qconst: Tensor, sqrt_delta: Tensor,
                         qb: Tensor) -> tuple[Tensor, Tensor]:
    """Fused filter+prune: (ub (n, q) f32, admit (n, q) int32)."""
    return (bregman_ub_matrix(alpha, sqrt_gamma, qconst, sqrt_delta),
            bregman_prune_mask(amin, gmax, qconst, sqrt_delta, qb))


def block_rows(blocks: Tensor, bn: int) -> Tensor:
    """(nb * bn,) int64 table rows of the listed row blocks, block by block
    (block b is rows ``[b * bn, (b + 1) * bn)``; rows of a short last block
    run past the table)."""
    offs = torch.arange(bn, dtype=torch.long, device=blocks.device)
    return (blocks.long()[:, None] * bn + offs[None, :]).reshape(-1)


def _listed_rows(n: int, blocks: Tensor, bn: int) -> tuple[Tensor, Tensor]:
    """(rows of the listed blocks clamped into the table, which of them
    are real rows): block b is rows ``[b * bn, (b + 1) * bn)``, and the
    rows of a short last block past n are not."""
    rows = block_rows(blocks, bn)
    return torch.clamp(rows, max=n - 1), rows < n


def bregman_filter_prune_blocks(alpha: Tensor, sqrt_gamma: Tensor,
                                amin: Tensor, gmax: Tensor, qconst: Tensor,
                                sqrt_delta: Tensor, qb: Tensor,
                                blocks: Tensor,
                                bn: int) -> tuple[Tensor, Tensor]:
    """:func:`bregman_filter_prune` over the rows of the listed blocks of
    the full (n, M) tables: (ub, admit), each (len(blocks) * bn, q), listed
    block i's rows at ``[i * bn, (i + 1) * bn)``; rows past n (a short
    last block's) read ``ub = inf`` and ``admit = 0``."""
    idx, real = _listed_rows(alpha.shape[0], blocks, bn)
    ub, admit = bregman_filter_prune(alpha[idx], sqrt_gamma[idx], amin[idx],
                                     gmax[idx], qconst, sqrt_delta, qb)
    return (torch.where(real[:, None], ub, torch.inf),
            admit * real[:, None].to(admit.dtype))


def bregman_prune_mask_blocks(amin: Tensor, gmax: Tensor, qconst: Tensor,
                              sqrt_delta: Tensor, qb: Tensor, blocks: Tensor,
                              bn: int) -> Tensor:
    """:func:`bregman_prune_mask` over the rows of the listed blocks of
    the full (n, M) corner tables: (len(blocks) * bn, q) int32, listed
    block i's rows at ``[i * bn, (i + 1) * bn)``; rows past n (a short
    last block's) read 0."""
    idx, real = _listed_rows(amin.shape[0], blocks, bn)
    admit = bregman_prune_mask(amin[idx], gmax[idx], qconst, sqrt_delta, qb)
    return admit * real[:, None].to(admit.dtype)


def bregman_prune_mask_blocks_quant(
        amin_q: Tensor, amin_scale: Tensor, amin_zp: Tensor, gmax_q: Tensor,
        gmax_scale: Tensor, gmax_zp: Tensor, qconst: Tensor,
        sqrt_delta: Tensor, qb: Tensor, blocks: Tensor, bn: int) -> Tensor:
    """:func:`bregman_prune_mask_quant` over the rows of the listed blocks
    of the full int8 corner tables (codes (n, M), decode (n,)):
    (len(blocks) * bn, q) int32, listed block i's rows at ``[i * bn,
    (i + 1) * bn)``; rows past n (a short last block's) read 0."""
    idx, real = _listed_rows(amin_q.shape[0], blocks, bn)
    corners = (amin_q, amin_scale, amin_zp, gmax_q, gmax_scale, gmax_zp)
    admit = bregman_prune_mask_quant(*(t[idx] for t in corners), qconst,
                                     sqrt_delta, qb)
    return admit * real[:, None].to(admit.dtype)


def bregman_filter_prune_quant(alpha_q: Tensor, alpha_scale: Tensor,
                               alpha_zp: Tensor, sg_q: Tensor,
                               sg_scale: Tensor, sg_zp: Tensor,
                               amin_q: Tensor, amin_scale: Tensor,
                               amin_zp: Tensor, gmax_q: Tensor,
                               gmax_scale: Tensor, gmax_zp: Tensor,
                               qconst: Tensor, sqrt_delta: Tensor,
                               qb: Tensor) -> tuple[Tensor, Tensor]:
    """Fused (ub, admit) over the int8 filter and corner codes: the int8
    UB totals and :func:`bregman_prune_mask_quant`."""
    return (bregman_ub_matrix_quant(alpha_q, alpha_scale, alpha_zp, sg_q,
                                    sg_scale, sg_zp, qconst, sqrt_delta),
            bregman_prune_mask_quant(amin_q, amin_scale, amin_zp, gmax_q,
                                     gmax_scale, gmax_zp, qconst, sqrt_delta,
                                     qb))


def bregman_filter_prune_blocks_quant(
        alpha_q: Tensor, alpha_scale: Tensor, alpha_zp: Tensor, sg_q: Tensor,
        sg_scale: Tensor, sg_zp: Tensor, amin_q: Tensor, amin_scale: Tensor,
        amin_zp: Tensor, gmax_q: Tensor, gmax_scale: Tensor, gmax_zp: Tensor,
        qconst: Tensor, sqrt_delta: Tensor, qb: Tensor, blocks: Tensor,
        bn: int) -> tuple[Tensor, Tensor]:
    """:func:`bregman_filter_prune_quant` over the rows of the listed
    blocks of the full int8 tables (codes (n, M), decode (n,)), laid out
    as :func:`bregman_filter_prune_blocks` lays them out; rows past n read
    ``ub = inf`` and ``admit = 0``."""
    idx, real = _listed_rows(alpha_q.shape[0], blocks, bn)
    tables = (alpha_q, alpha_scale, alpha_zp, sg_q, sg_scale, sg_zp, amin_q,
              amin_scale, amin_zp, gmax_q, gmax_scale, gmax_zp)
    ub, admit = bregman_filter_prune_quant(*(t[idx] for t in tables),
                                           qconst, sqrt_delta, qb)
    return (torch.where(real[:, None], ub, torch.inf),
            admit * real[:, None].to(admit.dtype))


def _log_guarded(x: Tensor) -> Tensor:
    return torch.log(torch.clamp(x, min=1e-30))


# The generators the refine kernel evaluates, with log arguments guarded
# at 1e-30 (equal to the family's phi inside its domain).
PHIS = {
    "squared_euclidean": lambda x: 0.5 * x * x,
    "itakura_saito": lambda x: -_log_guarded(x),
    "exponential": torch.exp,
    "burg": lambda x: x - _log_guarded(x),
    "shannon": lambda x: x * _log_guarded(x),
}


def bregman_refine_batch(rows: Tensor, grad: Tensor, c_y: Tensor,
                         family: str) -> Tensor:
    """Exact D_f per query's candidate rows.  (q,b,d),(q,d),(q,) -> (q,b)."""
    fx = torch.sum(PHIS[family](rows), dim=-1)                    # (q, b)
    cross = torch.einsum("qbd,qd->qb", rows, grad)
    return fx - cross + c_y[:, None]


def bregman_refine_batch_quant(codes: Tensor, scale: Tensor, zp: Tensor,
                               grad: Tensor, c_y: Tensor,
                               family: str) -> Tensor:
    """Dequantize + exact D_f over int8 candidate rows.  (q,b,d) int8 codes,
    (q,b) per-row scale and zero-point -> (q,b).  The rows decode through
    ``dequantize_rows``, so the distances are exact over the stored
    points."""
    rows = qz.dequantize_rows(codes, scale, zp, family)
    return bregman_refine_batch(rows, grad, c_y, family)


def bregman_refine(rows: Tensor, grad: Tensor, c_y: Tensor,
                   family: str) -> Tensor:
    """Exact D_f for one query's rows.  (b,d),(d,),() -> (b,)."""
    return bregman_refine_batch(rows[None], grad[None], c_y.reshape(1),
                                family)[0]


def pccp_correlation(x: Tensor) -> Tensor:
    """|Pearson| correlation matrix with zeroed diagonal.  (n,d) -> (d,d)."""
    xc = x - torch.mean(x, dim=0, keepdim=True)
    std = torch.sqrt(torch.mean(xc * xc, dim=0))
    std = torch.where(std < 1e-12, 1.0, std)
    corr = (xc.T @ xc) / (x.shape[0] * std[:, None] * std[None, :])
    corr = torch.abs(corr)
    return corr * (1.0 - torch.eye(x.shape[1], dtype=x.dtype,
                                   device=x.device))


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int | None = None,
                    scale: float | None = None) -> Tensor:
    """Naive GQA attention (the reference's ``ref.attention``).

    q: (B, H, Sq, D); k/v: (B, KH, Skv, D) with H % KH == 0; queries are
    end-aligned to the keys.  The logits and the product with v are in q's
    dtype, the softmax in fp32 (its probabilities cast back to q's dtype),
    so in bf16 this rounds where the kernel keeps fp32.
    """
    b, h, sq, d = q.shape
    kh = k.shape[1]
    rep = h // kh
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(float(d))).to(q.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    skv = k.shape[2]
    qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    ki = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window is not None:
        mask &= (qi - ki) < window
    logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)
