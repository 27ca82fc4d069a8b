"""Exact and approximate kNN on a BallForest (port of ``repro.core.search``).

A (q, d) query block (:func:`knn_search_batch`) runs five phases:

  1. Q-transform of the block (Alg. 3).
  2. Filter: a streaming per-column k-selection over the (n, q) Cauchy
     upper-bound matrix — one ``bregman_ub_matrix`` kernel launch (its
     int8 sibling in the int8 tier) per group of consecutive
     ``block_rows`` row blocks (whose outputs stay within
     :data:`GROUP_OUTPUT_BYTES`), merged into a running (q, k) best set,
     so the (n, q) matrix never exists for large n * q.
  3. Alg.-4 searching bounds ``qb`` from each query's k-th row.
  4. Prune + compact: the block envelopes gate every (block, query) pair
     in one vectorized pass; the host reads which blocks any query admits
     (one device sync per search) and launches the fused
     ``bregman_filter_prune_blocks`` kernel (its int8 sibling in the int8
     tier) once per group of those blocks (``fused=False``, the
     comparator: the windowed gate and the prune-only kernel's block-list
     entry, ``bregman_prune_mask_blocks`` or its int8 sibling, once per
     group); the admitted rows fill the query's ``budget`` candidate
     slots in index order.
  5. Refine: one ``bregman_refine_batch`` launch over all queries'
     candidate rows, then the k smallest exact distances.

In the int8 tier the same phases stream codes plus per-row decode scalars
through the int8 kernels (the filter and the prune a group of blocks a
launch), ``qb`` is inflated by the filter stats' rounding slack, and the
refine decodes only the candidate rows; results are exact over the
decoded points (``BallForest.rows_view``).

The §8 approximate search (:func:`knn_search_batch_approx`) shrinks each
query's bounds by the empirical CDF of the cross term before the prune,
at a guarantee ``p_guarantee``, or at the ``p`` that the index's fitted
recall curve gives for a ``target_recall`` (core/calibrate.py).
:func:`knn_batch` is the host wrapper of both, with the budget ladder: it
takes ``approx_p`` or ``target_recall`` for the approximate mode.  A
:class:`~repro_torch.core.tiered.TieredPointStore` passed to an entry
point runs the same phases with its cold tables fetched block by block.

One (d,) query runs :func:`knn_search` (exact) or
:func:`knn_search_approx` at a fixed budget, :func:`knn` with a doubling
budget (:func:`default_budget` to start): the filter is kernel #1 (int8:
#2) at q = 1 over all n rows, the Theorem-3 mask the prune-only kernel
#5 (#6) at q = 1 over all n rows, the union members are cut to the
budget in index order, and the refine is the q = 1 slice of the batch
refine.  :func:`knn_search_batch_reference` is the materialized oracle:
the (n, q) mask in plain torch and a (q, n) running count, which the
streamed search must match bit for bit.

Ties resolve to the lower row index everywhere (stable sorts), as in the
reference.  When a query's Theorem-3 union overflows the budget it is
flagged ``exact=False``; :func:`knn_batch` retries at the fitted budget and,
when its doublings run out, falls back to a brute-force scan.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops as kernel_ops
from ..kernels import ref as kernel_ref
from . import bounds
from . import quantize as qz
from .bregman import get_family, validate_rows
from .calibrate import resolve_p_guarantee
from .index import ENV_BLOCK_ROWS, BallForest
from .transform import q_transform

Tensor = torch.Tensor

NEG_BIG = -1e30
POS_BIG = 1e30

logger = logging.getLogger(__name__)

# Default row-block size of both streaming passes.
DEFAULT_BLOCK_ROWS = 4096

MAX_BUDGET_DOUBLINGS = 8

# Output bytes of one grouped launch of the filter (#1, #2 in int8: the
# UB), of the fused filter+prune (#3, #4 in int8: the UB and the admit
# mask) and of the prune-only kernel (#5, #6 in int8: the admit mask):
# consecutive or listed row blocks share a launch up to this cap, so no
# (n, q) tile is formed for large n * q.  At 2^27 a Deep attempt (10^6
# rows, q = 14) is one group.  The tiered store's Stage B windows count
# their pooled corner bytes against it too.
GROUP_OUTPUT_BYTES = 1 << 27


def resolve_block_rows(block_rows: int | None, n: int) -> int:
    """Validate the ``block_rows`` knob against an index of n rows.

    ``None`` means :data:`DEFAULT_BLOCK_ROWS` (the port has no autotuner
    table yet).  Values beyond ``n`` are legal (one block); non-integers
    and values below 8 raise.  An empty index raises on every path.
    """
    if n < 1:
        raise ValueError(f"cannot search an empty index (n={n})")
    if block_rows is None:
        return DEFAULT_BLOCK_ROWS
    if isinstance(block_rows, bool) or not isinstance(block_rows, int):
        raise ValueError(f"block_rows must be an int, got {block_rows!r}")
    if block_rows < 8:
        raise ValueError(
            f"block_rows={block_rows} is below the minimum tile of 8 rows")
    return block_rows


def resolve_env_block_rows(env_block_rows: int | None) -> int:
    """Validate the envelope-gate granularity knob: ``None`` is the storage
    granularity :data:`ENV_BLOCK_ROWS`; any positive multiple of it is a
    coarser (looser, results-invariant) gate."""
    if env_block_rows is None:
        return ENV_BLOCK_ROWS
    if (isinstance(env_block_rows, bool)
            or not isinstance(env_block_rows, int)):
        raise ValueError(
            f"env_block_rows must be an int, got {env_block_rows!r}")
    if env_block_rows < ENV_BLOCK_ROWS or env_block_rows % ENV_BLOCK_ROWS:
        raise ValueError(
            f"env_block_rows={env_block_rows} must be a positive multiple "
            f"of the storage granularity {ENV_BLOCK_ROWS}")
    return env_block_rows


def resolve_budget(budget, n: int, k: int) -> int:
    """THE refine-budget resolver: ``None`` picks the cost model's
    candidate estimate; an explicit budget must be an integer >= k and is
    clamped to ``n``."""
    n = int(n)
    if n < 1:
        raise ValueError(f"resolve_budget: empty index (n={n})")
    if k > n:
        raise ValueError(f"k={k} exceeds index size n={n}")
    if budget is None:
        return int(min(n, max(4 * k, 64, n // 16)))
    if isinstance(budget, bool) or budget != int(budget):
        raise TypeError(f"budget must be an int or None, got {budget!r}")
    budget = int(budget)
    if budget < k:
        raise ValueError(f"budget={budget} must be >= k={k} (the refine "
                         "top-k needs at least k slots)")
    return min(budget, n)


def validate_p_guarantee(p) -> None:
    """Range-gate the §8 shrink probability ``p_guarantee``: a real number
    (or a one-element tensor) within [0, 1]; ``None`` passes."""
    if p is None:
        return
    if isinstance(p, torch.Tensor) and p.numel() == 1:
        p = p.item()
    if isinstance(p, bool) or not isinstance(
            p, (int, float, np.floating, np.integer)):
        raise TypeError(f"p_guarantee must be a real number, got {p!r}")
    v = float(p)
    if not 0.0 <= v <= 1.0:    # False for NaN too
        raise ValueError(f"p_guarantee must be within [0, 1], got {v}")


def fitted_budget_for_n(n: int, k: int, needed: int) -> int:
    """Smallest power-of-two budget (>= k, capped at ``n``) covering
    ``needed`` candidates: the one sizing rule for overflow retries."""
    need = max(int(needed), k, 1)
    return int(min(n, 1 << (need - 1).bit_length()))


def fitted_budget(index: BallForest, k: int, needed: int) -> int:
    """:func:`fitted_budget_for_n` against a whole index."""
    return fitted_budget_for_n(index.n, k, needed)


class SearchResult(NamedTuple):
    ids: Tensor             # (q, k) original point ids
    dists: Tensor           # (q, k) exact Bregman distances
    exact: Tensor           # (q,) bool — candidate set fit in the budget
    num_candidates: Tensor  # (q,) Theorem-3 union size


class BatchStats(NamedTuple):
    """Retry telemetry from :func:`knn_batch`."""

    escalations: int         # budget-growth retries taken (0 = first try fit)
    budget_final: int        # the budget the returned launch ran with
    escalated_to_scan: bool  # doublings exhausted -> brute-force scan
    stopped_early: bool      # a stop_retry callback ended the ladder


def validate_queries(measure, q, *, mode: str = "raise"):
    """Admission gate: reject NaN / out-of-domain query rows up front."""
    return validate_rows(measure, q, mode=mode, what="query row")


def query_struct(y: Tensor, partition, family) -> dict:
    """Per-subspace triples (Alg. 3) plus the refine constants."""
    q = q_transform(y, partition, family)
    q.update(bounds.query_refine_constants(y, family))
    return q


def _tuple_rows(index: BallForest, idx: Tensor) -> dict:
    """(alpha, sqrt_gamma) P-tuples at the given row indices, decoded in
    the int8 tier (only the gathered rows reach fp32)."""
    a, g = index.alpha[idx], index.sqrt_gamma[idx]
    if index.storage == "int8":
        a = qz.dequantize_stats(a, index.alpha_scale[idx],
                                index.alpha_zp[idx])
        g = qz.dequantize_stats(g, index.sg_scale[idx], index.sg_zp[idx])
    return {"alpha": a, "sqrt_gamma": g}


def _qb_slack(index: BallForest, idx: Tensor, sqrt_delta: Tensor) -> Tensor:
    """Quantization slack of the Alg.-4 bounds in the int8 tier: from the
    per-query maxima of the filter-stat scales over the filter's (q, k)
    top-k rows ``idx``, so the k-th smallest true distance stays under the
    inflated bound (docs/quantization.md).  Returns (q, M)."""
    a_s = torch.amax(index.alpha_scale[idx], dim=-1)
    g_s = torch.amax(index.sg_scale[idx], dim=-1)
    return qz.ub_slack(a_s, g_s, sqrt_delta)


def _as_forest(index, k: int | None = None):
    """A forest, or the mutable index (core/segments.py) as its cached
    ``view()``.  ``k`` is held to the live count where the index has one
    (a mutable index or a tiered store): tombstoned rows are in the view
    but are never returned.  A tiered store passes through unchanged."""
    live_n = getattr(index, "live_n", None)
    if k is not None and live_n is not None and k > live_n:
        raise ValueError(f"k={k} exceeds live point count {live_n}")
    view = getattr(index, "view", None)
    return view() if callable(view) else index


def _on_index_device(index: BallForest, device) -> torch.device:
    dev = resolve_device(device)
    if index.device.type != dev.type or (
            dev.index is not None and index.device != dev):
        raise ValueError(
            f"the index lives on {index.device}, the search was asked to "
            f"run on {dev}; move the index or pass device={str(index.device)!r}")
    return index.device


# ---------------------------------------------------------------------------
# Batched pipeline
# ---------------------------------------------------------------------------

def _block_layout(n: int, block_rows: int) -> tuple[int, int]:
    """(block, num_blocks) covering n rows; block <= block_rows."""
    bn = max(8, min(block_rows, n))
    return bn, -(-n // bn)


def searching_bounds(index: BallForest, qs: dict, idx: Tensor) -> Tensor:
    """Alg.-4 searching bounds ``qb`` (q, M) from the filter's (q, k)
    top-k rows ``idx``: the k-th row's UB components, inflated in the int8
    tier by the filter stats' rounding slack."""
    qb = bounds.ub_components(_tuple_rows(index, idx[:, -1]), qs)
    if index.storage == "int8":
        qb = qb + _qb_slack(index, idx, qs["sqrt_delta"])
    return qb


def _cdf_shrink(samples: Tensor, mu: Tensor, kappa: Tensor,
                p: Tensor) -> Tensor:
    """§8 Prop.-1 shrink factor c (q,) from the empirical CDF Psi of the
    cross term beta_xy: ``c = Psi^-1(p*Psi(mu) + (1-p)*Psi(-kappa)) / mu``,
    clipped to [0, 1].  ``p`` is an fp32 scalar tensor, so ``1 - p`` rounds
    in fp32 as the reference's does."""
    s = samples.shape[0]

    def cdf(t):
        return torch.searchsorted(samples, t, right=True).to(
            torch.float32) / s

    def inv_cdf(u):
        pos = torch.clamp(u * (s - 1), 0.0, s - 1.0)
        lo = torch.floor(pos).long()
        hi = torch.clamp(lo + 1, max=s - 1)
        w = pos - lo.to(torch.float32)
        return samples[lo] * (1 - w) + samples[hi] * w

    target = p * cdf(mu) + (1.0 - p) * cdf(-kappa)
    return torch.clamp(inv_cdf(target) / torch.clamp(mu, min=1e-12),
                       0.0, 1.0)


def _approx_bounds(index: BallForest, qs: dict, idx: Tensor, qb: Tensor,
                   p_guarantee: float) -> Tensor:
    """The §8 shrink of the searching bounds: each subspace's Cauchy term
    ``sqrt_gamma(kth) * sqrt_delta`` is scaled by :func:`_cdf_shrink`'s c,
    the rest (``kappa_i``, the int8 slack included) is kept."""
    sqrt_term = _tuple_rows(index, idx[:, -1])["sqrt_gamma"] \
        * qs["sqrt_delta"]                                          # (q, M)
    kappa_i = qb - sqrt_term
    p = torch.tensor(float(p_guarantee), dtype=torch.float32,
                     device=qb.device)
    c = _cdf_shrink(index.beta_samples, torch.sum(sqrt_term, -1),
                    torch.sum(kappa_i, -1), p)
    return kappa_i + c[:, None] * sqrt_term


def _filter_bounds(index: BallForest, qs: dict, k: int, block_rows: int,
                   p_guarantee: float | None = None) -> Tensor:
    """Phases 2-3 over the hot tables only: the streaming filter's top-k,
    then the searching bounds ``qb`` (q, M), shrunk when ``p_guarantee``
    is given."""
    _, idx = _batch_filter_topk(index, qs, k, block_rows)
    qb = searching_bounds(index, qs, idx)
    if p_guarantee is not None:
        qb = _approx_bounds(index, qs, idx, qb, p_guarantee)
    return qb


def _row_blocks(fields: tuple, bn: int, nb: int) -> list:
    """Per-block row views of point-major tensors.  The last block is
    short rather than padded: the kernels take any row count, so no padded
    copy of the tables is made."""
    return [tuple(t[b * bn:(b + 1) * bn] for t in fields) for b in range(nb)]


def _group_blocks(bn: int, q: int, pair_bytes: int) -> int:
    """Row blocks one grouped launch takes: its (rows, q) outputs of
    ``pair_bytes`` a (row, query) within :data:`GROUP_OUTPUT_BYTES`."""
    return max(1, GROUP_OUTPUT_BYTES // (bn * q * pair_bytes))


def _filter_blocks(index: BallForest, bn: int, nb: int) -> list:
    """Per-block filter operands: (alpha, sqrt_gamma), or in the int8 tier
    (alpha, a_s, a_z, sqrt_gamma, g_s, g_z) codes plus their decode."""
    if index.storage == "int8":
        fields = (index.alpha, index.alpha_scale, index.alpha_zp,
                  index.sqrt_gamma, index.sg_scale, index.sg_zp)
    else:
        fields = (index.alpha, index.sqrt_gamma)
    return _row_blocks(fields, bn, nb)


# The prune kernels' corner operands and the refine's row operands, by
# storage tier, in argument order.
CORNER_FIELDS = {"f32": ("alpha_min_pt", "sqrt_gamma_max_pt"),
                 "int8": ("alpha_min_pt", "amin_scale", "amin_zp",
                          "sqrt_gamma_max_pt", "gmax_scale", "gmax_zp")}
REFINE_FIELDS = {"f32": ("data",), "int8": ("data", "data_scale", "data_zp")}
# The fused block-list dispatcher of each tier and its table operands (the
# full tables, in argument order).
FUSED_TABLES = {
    "f32": ("bregman_filter_prune_blocks",
            ("alpha", "sqrt_gamma", "alpha_min_pt", "sqrt_gamma_max_pt")),
    "int8": ("bregman_filter_prune_blocks_quant",
             ("alpha", "alpha_scale", "alpha_zp", "sqrt_gamma", "sg_scale",
              "sg_zp", "alpha_min_pt", "amin_scale", "amin_zp",
              "sqrt_gamma_max_pt", "gmax_scale", "gmax_zp")),
}
# The prune-only block-list dispatcher of each tier (``fused=False``) and
# its corner operands.
PRUNE_TABLES = {
    "f32": ("bregman_prune_blocks", CORNER_FIELDS["f32"]),
    "int8": ("bregman_prune_blocks_quant", CORNER_FIELDS["int8"]),
}


def _prune_block(storage: str, corners: tuple, qs: dict,
                 qb: Tensor) -> Tensor:
    """The (rows, q) int32 Theorem-3 admit tile of a row span's corner
    operands (:data:`CORNER_FIELDS` order) through the prune-only kernel
    of the tier, in one launch."""
    fn = (kernel_ops.bregman_prune_block_quant if storage == "int8"
          else kernel_ops.bregman_prune_block)
    return fn(*corners, qs["qconst"], qs["sqrt_delta"], qb)


def _merge_topk(best_v: Tensor, best_i: Tensor, vals: Tensor, rows: Tensor,
                k: int) -> tuple[Tensor, Tensor]:
    """The k smallest of the running (q, k) best set and a (rows, q) UB
    tile whose rows are ``rows`` (ascending, above every carried row), by
    one stable sort of the carry followed by the tile: ties go to the
    lower row, as in a full-column stable top-k."""
    q = best_v.shape[0]
    cand_v = torch.cat([best_v, vals.T], dim=1)
    cand_i = torch.cat([best_i, rows.expand(q, -1)], dim=1)
    sv, order = torch.sort(cand_v, dim=1, stable=True)
    return sv[:, :k], torch.gather(cand_i, 1, order[:, :k])


def _batch_filter_topk(index: BallForest, qs: dict, k: int,
                       block_rows: int) -> tuple[Tensor, Tensor]:
    """Streaming per-column k-selection over the (n, q) UB matrix.

    One UB kernel launch per group of consecutive row blocks
    (:func:`_group_blocks`), each merged into the running (q, k) smallest
    totals and their rows by :func:`_merge_topk`.  The k smallest by
    (total, row) do not depend on how the rows are grouped, so any cap
    gives the per-block result.
    Returns (values, rows), ascending along k.
    """
    n = index.n
    q = qs["qconst"].shape[0]
    dev = index.device
    bn, nb = _block_layout(n, block_rows)
    name = ("bregman_ub_matrix_quant" if index.storage == "int8"
            else "bregman_ub_matrix")
    span = bn * _group_blocks(bn, q, 4)
    ub_fn = getattr(kernel_ops, name)
    best_v = torch.full((q, k), POS_BIG, dtype=torch.float32, device=dev)
    best_i = torch.zeros((q, k), dtype=torch.long, device=dev)
    for g, blk in enumerate(_filter_blocks(index, span, -(-n // span))):
        vals = ub_fn(*blk, qs["qconst"], qs["sqrt_delta"])        # (rows, q)
        rows = torch.arange(g * span, g * span + blk[0].shape[0], device=dev)
        best_v, best_i = _merge_topk(best_v, best_i, vals, rows, k)
    return best_v, best_i


def _fill_slots(sel: Tensor, count: Tensor, admit: Tensor, rows: Tensor,
                budget: int) -> tuple[Tensor, Tensor]:
    """Route a (R, q) admit tile's admitted rows into their budget slots,
    in place.  ``rows`` (R,) are the tile's table rows, ascending and above
    every row already routed; a row the tile does not admit may carry any
    value (the inert rows of a short block do).

    Query j's admitted row of rank r within the tile (rows in index order)
    goes to slot ``count[j] + r``; members past the budget are dropped.
    Unfilled slots hold ``n - 1``, at least every row index, so one
    scatter-min of the (q, R) tile writes each member into its own slot
    and leaves every other slot as it was: O(q * R) work a tile, where
    the reference routes all ``budget`` slots (it avoids scatters, which
    XLA serializes on the CPU).  Returns ``(sel, count + admitted)``.
    """
    admitted = admit.T.contiguous() > 0                     # (q, R)
    rank = torch.cumsum(admitted, dim=1)                    # contiguous scan
    slot = count[:, None] + rank - 1
    src = torch.where(admitted & (slot < budget), rows,
                      torch.iinfo(sel.dtype).max)
    sel.scatter_reduce_(1, slot.clamp(0, budget - 1), src, reduce="amin")
    return sel, count + rank[:, -1]


def _fill_block_slots(sel: Tensor, count: Tensor, admit: Tensor, off: int,
                      budget: int) -> tuple[Tensor, Tensor]:
    """:func:`_fill_slots` for one block's admit tile, rows ``off`` on."""
    rows = torch.arange(off, off + admit.shape[0], device=admit.device)
    return _fill_slots(sel, count, admit, rows, budget)


def _env_tables(index: BallForest, eb: int) -> tuple[Tensor, Tensor]:
    """Envelope tables at gate granularity ``eb`` (a multiple of the
    stored granularity, min/max-coarsened on the fly; the tail group is
    completed with inert rows)."""
    env_a, env_g = index.env_alpha_min, index.env_sqrt_gamma_max
    if env_a is None:
        raise ValueError("the index has no envelope tables; build it with "
                         "build_index or refresh_envelopes")
    if eb == ENV_BLOCK_ROWS:
        return env_a, env_g
    f = eb // ENV_BLOCK_ROWS
    m = env_a.shape[1]
    pad = -env_a.shape[0] % f
    env_a = torch.nn.functional.pad(env_a, (0, 0, 0, pad), value=POS_BIG)
    env_g = torch.nn.functional.pad(env_g, (0, 0, 0, pad))
    return (env_a.reshape(-1, f, m).amin(dim=1),
            env_g.reshape(-1, f, m).amax(dim=1))


def _block_env_span(n: int, bn: int, nb: int, eb: int,
                    dev) -> tuple[Tensor, Tensor]:
    """(first, last) envelope row of each block's rows, (nb,) each; the
    last block's span ends at row n - 1."""
    starts = torch.arange(nb, device=dev) * bn
    return starts // eb, (torch.clamp(starts + bn, max=n) - 1) // eb


def _envelope_gate(index: BallForest, qs: dict, qb: Tensor, bn: int,
                   nb: int, eb: int) -> Tensor:
    """The hoisted envelope gate: (nb, q) bool, True where some envelope
    row that block b spans admits query j.

    The Theorem-3 test runs once over the whole envelope table; a prefix
    sum turns it into each (block, query) pair's OR over the block's
    envelope rows.  An envelope dominates every row it covers, so a block
    no query admits holds no candidate.  It reads the hot envelope tables
    only: the resident prune and the tiered store's Stage A both call it,
    so they admit the same blocks.
    """
    n = index.n
    dev = index.device
    q = qb.shape[0]
    env_a, env_g = _env_tables(index, eb)
    qcT, sdT, qbT = qs["qconst"].T, qs["sqrt_delta"].T, qb.T       # (M, q)
    lb_env = (env_a[:, :, None] + qcT[None]
              - env_g[:, :, None] * sdT[None])                       # (ne, M, q)
    row_admit = torch.any(lb_env <= qbT[None], dim=1)                # (ne, q)
    ecs = torch.cat([torch.zeros((1, q), dtype=torch.long, device=dev),
                     torch.cumsum(row_admit, dim=0)])
    e0s, e_his = _block_env_span(n, bn, nb, eb, dev)
    return (ecs[e_his + 1] - ecs[e0s]) > 0                           # (nb, q)


def _envelope_gate_windowed(index: BallForest, qs: dict, qb: Tensor,
                            bn: int, nb: int, eb: int) -> Tensor:
    """The reference's per-block windowed gate, vectorized over blocks:
    each block gathers the ``win`` envelope rows from its first one, masks
    the rows past its span inert, and ORs the Theorem-3 test over them.
    The same admit bits as :func:`_envelope_gate` (same rows, same test):
    the unfused comparator's gate."""
    dev = index.device
    env_a, env_g = _env_tables(index, eb)
    win = -(-bn // eb) + 1
    e0s, e_his = _block_env_span(index.n, bn, nb, eb, dev)
    rows = e0s[:, None] + torch.arange(win, device=dev)[None, :]    # (nb, win)
    in_span = rows <= e_his[:, None]
    rows = torch.clamp(rows, max=env_a.shape[0] - 1)
    wa = torch.where(in_span[:, :, None], env_a[rows], POS_BIG)     # (nb, win, M)
    wg = torch.where(in_span[:, :, None], env_g[rows], 0.0)
    qcT, sdT, qbT = qs["qconst"].T, qs["sqrt_delta"].T, qb.T        # (M, q)
    lb = (wa[..., None] + qcT[None, None]
          - wg[..., None] * sdT[None, None])                       # (nb, win, M, q)
    return torch.any(lb <= qbT[None, None], dim=2).any(dim=1)       # (nb, q)


def _stream_prune_compact(index: BallForest, qs: dict, qb: Tensor,
                          budget: int, block_rows: int,
                          env_block_rows: int | None = None,
                          with_tau: bool = False, fused: bool = True):
    """Envelope-gated prune + compact over the filter's row blocks.

    1. **Envelope gate** — :func:`_envelope_gate` (``fused=False``: the
       windowed gate, the same bits).  The host reads the (nb,)
       any-admit vector once.
    2. **Per-point admit** — the admitted blocks, in groups of
       :func:`_group_blocks` (a device list of block ids a launch), launch
       the fused filter+prune kernel (its int8 sibling in the int8 tier,
       whose envelopes were reduced over the decoded corners): the (rows,
       q) UB tile and int32 admit tile.  ``fused=False`` launches the
       prune-only kernel's block-list entry instead (:data:`PRUNE_TABLES`),
       the same admit tile without the UB, once a group of twice as many
       blocks (half the output bytes a pair).
    3. **Compaction** — :func:`_fill_slots` routes the tile's members into
       the budget slots; slot order = index order, so any grouping fills
       the slots a per-block loop fills.

    Returns ``(sel (q, budget), valid (q, budget), num_candidates (q,),
    env_admitted (q,), blocks_run, tau (q,))``; ``tau`` is the per-query
    min UB over admitted rows when ``with_tau`` on the fused path (else
    +BIG).  Unfilled slots hold ``n - 1``.
    """
    n = index.n
    dev = index.device
    q = qb.shape[0]
    bn, nb = _block_layout(n, block_rows)
    eb = resolve_env_block_rows(env_block_rows)
    gate = _envelope_gate if fused else _envelope_gate_windowed
    env_admit_all = gate(index, qs, qb, bn, nb, eb)                   # (nb, q)
    run = torch.nonzero(env_admit_all.any(dim=1)).flatten()
    run_blocks = run.tolist()

    sel = torch.full((q, budget), n - 1, dtype=torch.long, device=dev)
    count = torch.zeros((q,), dtype=torch.long, device=dev)
    tau = torch.full((q,), POS_BIG, dtype=torch.float32, device=dev)

    def admitted_tau(ub, admit):
        if not with_tau:
            return tau
        return torch.minimum(tau, torch.where(admit > 0, ub, POS_BIG)
                             .amin(dim=0))

    name, tables = (FUSED_TABLES if fused else PRUNE_TABLES)[index.storage]
    fn = getattr(kernel_ops, name)
    tables = tuple(getattr(index, f) for f in tables)
    gb = _group_blocks(bn, q, 8 if fused else 4)    # UB and admit, or admit
    run = run.to(torch.int32)
    for g in range(0, len(run_blocks), gb):
        blocks = run[g:g + gb]
        admit = fn(*tables, qs["qconst"], qs["sqrt_delta"], qb, blocks, bn)
        if fused:
            tau = admitted_tau(*admit)
            admit = admit[1]
        sel, count = _fill_slots(sel, count, admit,
                                 kernel_ref.block_rows(blocks, bn), budget)
    return (sel, _slot_validity(count, budget), count,
            env_admit_all.sum(dim=0), len(run_blocks), tau)


def _slot_validity(count: Tensor, budget: int) -> Tensor:
    """(q, budget) bool: slot s holds a candidate iff s < min(count,
    budget)."""
    targets = torch.arange(1, budget + 1, device=count.device)
    return targets[None, :] <= torch.clamp(count, max=budget)[:, None]


def _corner_admit(amin: Tensor, gmax: Tensor, qconst: Tensor,
                  sqrt_delta: Tensor, qb: Tensor, sub_axis: int) -> Tensor:
    """The Theorem-3 membership test in plain torch, op by op (no fused
    multiply-add): some subspace's cluster lower bound within its bound.
    ``sub_axis`` names the subspace axis of the broadcast operands."""
    lb = amin + qconst - gmax * sqrt_delta
    return torch.any(lb <= qb, dim=sub_axis)


def _candidate_mask_batch(index: BallForest, qs: dict, qb: Tensor,
                          block_rows: int) -> Tensor:
    """The materialized Theorem-3 union, (n, q) bool: :func:`_corner_admit`
    broadcast over the query batch in ``block_rows``-row chunks (the int8
    corners decoded first), so the (rows, M, q) intermediate bounds the
    peak memory.  Plain torch on every device: the oracle does not run
    the prune kernels it exists to check."""
    bn, nb = _block_layout(index.n, block_rows)
    qc = qs["qconst"].T[None]                                   # (1, M, q)
    sd = qs["sqrt_delta"].T[None]
    qbT = qb.T[None]
    corners = tuple(getattr(index, f) for f in CORNER_FIELDS[index.storage])
    masks = []
    for blk in _row_blocks(corners, bn, nb):
        if index.storage == "int8":
            amin = qz.dequantize_stats(*blk[:3])                # (rows, M)
            gmax = qz.dequantize_stats(*blk[3:])
        else:
            amin, gmax = blk
        masks.append(_corner_admit(amin[:, :, None], gmax[:, :, None], qc,
                                   sd, qbT, sub_axis=1))        # (rows, q)
    return torch.cat(masks)


def _compact_candidates(mask: Tensor,
                        budget: int) -> tuple[Tensor, Tensor, Tensor]:
    """Each query's union members in ``budget`` slots, by the (q, n) int32
    running member count: slot s holds the row where the count first
    reaches s + 1 (``searchsorted``, left), clamped to ``n - 1`` where the
    members ran out.  Returns (sel (q, budget), valid (q, budget),
    num_candidates (q,)); members past the budget are dropped in index
    order."""
    masks = mask.T.contiguous()                                 # (q, n)
    q, n = masks.shape
    csum = torch.cumsum(masks, dim=1, dtype=torch.int32)
    num_candidates = csum[:, -1].long()
    targets = torch.arange(1, budget + 1, dtype=torch.int32,
                           device=mask.device)
    sel = torch.searchsorted(csum, targets.expand(q, budget).contiguous())
    sel = torch.clamp(sel, max=n - 1)
    return sel, _slot_validity(num_candidates, budget), num_candidates


def _refine_topk(tables: tuple, rows: Tensor, sel: Tensor, valid: Tensor,
                 qs: dict, point_ids: Tensor, k: int, family_name: str):
    """One refine kernel launch over all queries' candidates, then the k
    smallest exact distances (stable: ties to the lower slot).

    ``tables`` are the refine operands (:data:`REFINE_FIELDS` order: rows,
    or in the int8 tier codes with their scale and zero-point), ``rows``
    (q, budget) the candidates' rows in them, ``sel`` their global rows
    (the ids come from it).  The int8 tier gathers codes and decode
    scalars, never decoded rows, and the kernel decodes them."""
    gathered = [t[rows] for t in tables]
    if len(gathered) == 3:
        dist = kernel_ops.bregman_refine_batch_quant(
            *gathered, qs["grad"], qs["c_y"], family_name)  # (q, budget)
    else:
        dist = kernel_ops.bregman_refine_batch(
            *gathered, qs["grad"], qs["c_y"], family_name)
    dist = torch.where(valid, dist, POS_BIG)
    sv, pos = torch.sort(dist, dim=1, stable=True)
    ids = point_ids[torch.gather(sel, 1, pos[:, :k])]
    return ids, sv[:, :k]


def _refine_batch(index: BallForest, qs: dict, sel: Tensor, valid: Tensor,
                  k: int):
    """:func:`_refine_topk` over the index's own tables."""
    tables = tuple(getattr(index, f) for f in REFINE_FIELDS[index.storage])
    return _refine_topk(tables, sel, sel, valid, qs, index.point_ids, k,
                        index.family_name)


def _knn_search_batch_core(index: BallForest, ys: Tensor, k: int,
                           budget: int, block_rows: int,
                           with_stats: bool = False,
                           env_block_rows: int | None = None,
                           fused: bool = True,
                           p_guarantee: float | None = None,
                           streaming: bool = True):
    if k > index.n:
        raise ValueError(f"k={k} exceeds index size n={index.n}")
    if budget < k:
        raise ValueError(f"budget={budget} must be >= k={k} (the refine "
                         "top-k needs at least k slots)")
    if ys.ndim != 2:
        raise ValueError(f"expected (q, d) queries, got {tuple(ys.shape)}")
    qs = query_struct(ys, index.partition, index.family)
    qb = _filter_bounds(index, qs, k, block_rows, p_guarantee)       # (q, M)

    if streaming:
        (sel, valid, num_candidates, env_admitted, blocks_run,
         tau) = _stream_prune_compact(index, qs, qb, budget, block_rows,
                                      env_block_rows=env_block_rows,
                                      with_tau=with_stats, fused=fused)
    else:
        # The oracle: the materialized (n, q) mask and (q, n) count.
        mask = _candidate_mask_batch(index, qs, qb, block_rows)
        sel, valid, num_candidates = _compact_candidates(mask, budget)
        del mask
    ids, dists = _refine_batch(index, qs, sel, valid, k)
    res = SearchResult(ids=ids, dists=dists,
                       exact=num_candidates <= budget,
                       num_candidates=num_candidates)
    return (res, env_admitted, blocks_run, tau) if with_stats else res


def _queries(ys, dev: torch.device) -> Tensor:
    return torch.as_tensor(ys, dtype=torch.float32, device=dev).contiguous()


def knn_search_batch(index: BallForest, ys, k: int, budget: int | None,
                     block_rows: int | None = None, validate: bool = True,
                     env_block_rows: int | None = None,
                     device="cuda") -> SearchResult:
    """Exact kNN for a (q, d) query block at a fixed ``budget``; fields are
    (q, ...).  Runs on ``device``, where the index must lie.  A tiered
    store runs its own search, bit-equal by contract."""
    if getattr(index, "is_tiered_store", False):
        return index.search(ys, k, budget, block_rows=block_rows,
                            env_block_rows=env_block_rows,
                            validate=validate, device=device)
    index = _as_forest(index, k)
    dev = _on_index_device(index, device)
    budget = resolve_budget(budget, index.n, k)
    if validate:
        validate_queries(index.family, ys)
    ys = _queries(ys, dev)
    br = resolve_block_rows(block_rows, index.n)
    return _knn_search_batch_core(index, ys, k, budget, br,
                                  env_block_rows=resolve_env_block_rows(
                                      env_block_rows))


def _knn_search_batch_unfused(index: BallForest, ys, k: int, budget: int,
                              block_rows: int,
                              env_block_rows: int | None = None,
                              device="cuda") -> SearchResult:
    """The unfused pipeline (windowed gate, prune-only kernel, no UB tile)
    at resolved knobs: the fused path's comparator, bit-equal to it."""
    dev = _on_index_device(index, device)
    return _knn_search_batch_core(index, _queries(ys, dev), k, budget,
                                  block_rows, env_block_rows=env_block_rows,
                                  fused=False)


def knn_search_batch_approx(index: BallForest, ys, k: int,
                            budget: int | None, p_guarantee=None,
                            block_rows: int | None = None,
                            validate: bool = True,
                            target_recall: float | None = None,
                            device="cuda") -> SearchResult:
    """§8 approximate kNN for a (q, d) block: each query's bounds shrink
    by the cross term's empirical CDF so that a true neighbour is kept
    with probability ``p_guarantee`` (Prop. 1); ``p_guarantee = 1`` keeps
    the exact bounds' candidates.  A tiered store runs its own search.

    Exactly one of ``p_guarantee`` and ``target_recall`` is given.
    ``target_recall`` inverts the index's fitted recall curve on the host
    (``core/calibrate.py``) to the smallest grid ``p`` that met it; on an
    uncalibrated index it falls back to ``p_guarantee = target_recall``
    with a one-time warning."""
    if (p_guarantee is None) == (target_recall is None):
        raise ValueError(
            "knn_search_batch_approx needs p_guarantee or target_recall: "
            "pass exactly one of p_guarantee / target_recall")
    if getattr(index, "is_tiered_store", False):
        return index.search(ys, k, budget, p_guarantee=p_guarantee,
                            target_recall=target_recall,
                            block_rows=block_rows, validate=validate,
                            device=device)
    index = _as_forest(index, k)
    if target_recall is not None:
        p_guarantee, _ = resolve_p_guarantee(index, target_recall)
    validate_p_guarantee(p_guarantee)
    dev = _on_index_device(index, device)
    budget = resolve_budget(budget, index.n, k)
    if validate:
        validate_queries(index.family, ys)
    ys = _queries(ys, dev)
    br = resolve_block_rows(block_rows, index.n)
    return _knn_search_batch_core(index, ys, k, budget, br,
                                  p_guarantee=float(p_guarantee))


def knn_search_batch_stats(index: BallForest, ys, k: int, budget: int | None,
                           block_rows: int | None = None,
                           device="cuda") -> tuple[SearchResult, dict]:
    """:func:`knn_search_batch` plus envelope block-skip telemetry.

    ``block_skip_rate`` is the fraction of (block, query) tiles the
    envelope gate rejected; ``whole_block_skip_rate`` the fraction of
    blocks whose kernel never ran; ``tau_admit`` the tightest UB among
    admitted rows per query.  A tiered store is refused: it reports its
    own ``stats`` and ``cache_info()``.
    """
    if getattr(index, "is_tiered_store", False):
        raise TypeError(
            "knn_search_batch_stats runs the all-resident pipeline; a "
            "TieredPointStore reports its own telemetry via store.stats / "
            "store.cache_info(), or pass store.as_resident_forest()")
    index = _as_forest(index, k)
    dev = _on_index_device(index, device)
    budget = resolve_budget(budget, index.n, k)
    ys = _queries(ys, dev)
    br = resolve_block_rows(block_rows, index.n)
    res, env_admitted, blocks_run, tau = _knn_search_batch_core(
        index, ys, k, budget, br, with_stats=True)
    bn, nb = _block_layout(index.n, br)
    admitted = int(env_admitted.sum())
    stats = {
        "block_rows": bn,
        "num_blocks": nb,
        "num_blocks_run": blocks_run,
        "env_admitted_tiles": admitted,
        "block_skip_rate": 1.0 - admitted / (nb * ys.shape[0]),
        "whole_block_skip_rate": 1.0 - blocks_run / nb,
        "tau_admit": tau,
    }
    return res, stats


def knn_search_batch_reference(index: BallForest, ys, k: int,
                               budget: int | None, p_guarantee=None,
                               block_rows: int | None = None,
                               device="cuda") -> SearchResult:
    """The materialized mask pipeline: the bit-parity oracle.

    The math of :func:`knn_search_batch` (or, with ``p_guarantee``, of
    :func:`knn_search_batch_approx`), but the prune is the full (n, q)
    Theorem-3 mask in plain torch and the compaction a binary search on
    the (q, n) running member count.  O(n * q) peak memory, so for tests
    and checks only; the streamed search must match it bit for bit on
    every output field.  A tiered store is refused.
    """
    if getattr(index, "is_tiered_store", False):
        raise TypeError(
            "knn_search_batch_reference materializes the full (n, q) mask "
            "on device — meaningless for an out-of-core store; pass "
            "store.as_resident_forest() to oracle against the same points")
    index = _as_forest(index, k)
    dev = _on_index_device(index, device)
    budget = resolve_budget(budget, index.n, k)
    validate_p_guarantee(p_guarantee)
    ys = _queries(ys, dev)
    br = resolve_block_rows(block_rows, index.n)
    return _knn_search_batch_core(
        index, ys, k, budget, br, streaming=False,
        p_guarantee=None if p_guarantee is None else float(p_guarantee))


# ---------------------------------------------------------------------------
# Single-query search
# ---------------------------------------------------------------------------

def _smallest(totals: Tensor, k: int) -> Tensor:
    """Rows of the k smallest totals, ascending, ties to the lower row (a
    stable sort)."""
    return torch.sort(totals, stable=True).indices[:k]


def _single_filter(index: BallForest, q: dict, k: int):
    """Filter phase of one query: (totals (n,), top-k rows (k,), qb (M,)).

    The fp32 tier runs ``bregman_ub_filter`` (kernel #1 at q = 1 over all
    n rows); the int8 tier runs the int8 UB kernel (#2) at q = 1 and
    inflates the Alg.-4 bounds by the filter stats' rounding slack."""
    if index.storage == "int8":
        totals = kernel_ops.bregman_ub_matrix_quant(
            index.alpha, index.alpha_scale, index.alpha_zp,
            index.sqrt_gamma, index.sg_scale, index.sg_zp,
            q["qconst"][None], q["sqrt_delta"][None])[:, 0]
        idx = _smallest(totals, k)
        qb = (bounds.ub_components(_tuple_rows(index, idx[-1]), q)
              + _qb_slack(index, idx, q["sqrt_delta"]))
    else:
        totals, comp_of = kernel_ops.bregman_ub_filter(
            index.alpha, index.sqrt_gamma, q["qconst"], q["sqrt_delta"])
        idx = _smallest(totals, k)
        qb = comp_of(idx[-1])
    return totals, idx, qb


def _candidate_mask(index: BallForest, q: dict, qb: Tensor) -> Tensor:
    """Theorem-3 union membership of one query, (n,) bool: the prune-only
    kernel (#5, #6 in int8) at q = 1 over all n rows in one launch."""
    corners = tuple(getattr(index, f) for f in CORNER_FIELDS[index.storage])
    qs1 = {"qconst": q["qconst"][None], "sqrt_delta": q["sqrt_delta"][None]}
    return _prune_block(index.storage, corners, qs1, qb[None])[:, 0] > 0


def _knn_search_core(index: BallForest, y: Tensor, k: int, budget: int,
                     p_guarantee: float | None = None) -> SearchResult:
    """One (d,) query at a fixed budget: filter, bounds (shrunk by §8 when
    ``p_guarantee`` is given), the Theorem-3 mask, then the union members
    first (in index order, as ``POS_BIG - totals`` rounds to ``POS_BIG``
    in fp32), non-members after them by UB, cut at ``budget`` and
    refined as the q = 1 slice of the batch refine."""
    q = query_struct(y, index.partition, index.family)
    totals, idx, qb = _single_filter(index, q, k)
    if p_guarantee is not None:
        qb = _approx_bounds(index, {"sqrt_delta": q["sqrt_delta"][None]},
                            idx[None], qb[None], p_guarantee)[0]
    mask = _candidate_mask(index, q, qb)
    num_candidates = mask.sum()
    priority = torch.where(mask, POS_BIG - totals, NEG_BIG - totals)
    sel = torch.sort(priority, descending=True, stable=True).indices[:budget]
    ids, dists = _refine_batch(
        index, {"grad": q["grad"][None], "c_y": q["c_y"][None]}, sel[None],
        mask[sel][None], k)
    return SearchResult(ids=ids[0], dists=dists[0],
                        exact=num_candidates <= budget,
                        num_candidates=num_candidates)


def _query(y, dev: torch.device) -> Tensor:
    y = torch.as_tensor(y, dtype=torch.float32, device=dev).contiguous()
    if y.ndim != 1:
        raise ValueError(f"expected one (d,) query, got {tuple(y.shape)}")
    return y


def _store_search_one(store, y, k: int, budget, validate: bool, device,
                      **approx) -> SearchResult:
    """One query through a tiered store's batched search, sliced back."""
    res = store.search(torch.as_tensor(y, dtype=torch.float32)[None], k,
                       budget, validate=validate, device=device, **approx)
    return SearchResult(ids=res.ids[0], dists=res.dists[0],
                        exact=res.exact[0],
                        num_candidates=res.num_candidates[0])


def knn_search(index: BallForest, y, k: int, budget: int | None,
               validate: bool = True, device="cuda") -> SearchResult:
    """Exact kNN for one (d,) query at a fixed ``budget``; fields are
    (k,) and scalars.  A tiered store runs its batched search on the one
    query."""
    if getattr(index, "is_tiered_store", False):
        return _store_search_one(index, y, k, budget, validate, device)
    index = _as_forest(index, k)
    dev = _on_index_device(index, device)
    budget = resolve_budget(budget, index.n, k)
    y = _query(y, dev)
    if validate:
        validate_queries(index.family, y)
    return _knn_search_core(index, y, k, budget)


def knn_search_approx(index: BallForest, y, k: int, budget: int | None,
                      p_guarantee, validate: bool = True,
                      device="cuda") -> SearchResult:
    """§8 approximate kNN for one (d,) query at a fixed ``budget``, with
    the probability guarantee ``p_guarantee``.  A tiered store runs its
    batched search on the one query."""
    if p_guarantee is None:
        raise ValueError("knn_search_approx needs p_guarantee")
    if getattr(index, "is_tiered_store", False):
        return _store_search_one(index, y, k, budget, validate, device,
                                 p_guarantee=p_guarantee)
    index = _as_forest(index, k)
    validate_p_guarantee(p_guarantee)
    dev = _on_index_device(index, device)
    budget = resolve_budget(budget, index.n, k)
    y = _query(y, dev)
    if validate:
        validate_queries(index.family, y)
    return _knn_search_core(index, y, k, budget,
                            p_guarantee=float(p_guarantee))


def default_budget(index: BallForest, k: int) -> int:
    """Initial refine budget: the cost model's candidate estimate."""
    return resolve_budget(None, index.n, k)


def knn(index: BallForest, y, k: int, budget: int | None = None,
        approx_p: float | None = None, device="cuda") -> SearchResult:
    """One query with the budget ladder: on overflow the budget doubles
    (capped at n) and the search runs again.  Always exact when
    ``approx_p`` is None; with ``approx_p`` the result carries the §8
    probability guarantee instead."""
    index = _as_forest(index, k)
    dev = _on_index_device(index, device)
    y = _query(y, dev)
    validate_queries(index.family, y)
    validate_p_guarantee(approx_p)
    budget = resolve_budget(budget, index.n, k)
    while True:
        if approx_p is None:
            res = knn_search(index, y, k, budget, validate=False, device=dev)
        else:
            res = knn_search_approx(index, y, k, budget, approx_p,
                                    validate=False, device=dev)
        if bool(res.exact) or budget >= index.n:
            return res
        budget = min(index.n, budget * 2)


# ---------------------------------------------------------------------------
# Host wrapper of the batched search: the budget ladder
# ---------------------------------------------------------------------------

def knn_batch(index: BallForest, ys, k: int, budget: int | None = None,
              approx_p: float | None = None, *,
              target_recall: float | None = None,
              max_doublings: int = MAX_BUDGET_DOUBLINGS,
              block_rows: int | None = None,
              stop_retry=None, return_stats: bool = False,
              validate: bool = True, device="cuda"):
    """Batched kNN with the budget-retry ladder, exact or §8 approximate.

    If any query's Theorem-3 union overflows, the block re-runs at the
    budget fitted to the largest observed union (a power of two), at most
    ``max_doublings`` times; then it falls back to one brute-force scan
    (over ``as_resident_forest()`` for a tiered store), so exact results
    are always exact and approximate ones keep their guarantee.
    ``stop_retry`` (no-arg callable -> bool) is consulted before every
    additional launch and ends the ladder with the best result so far.
    ``return_stats=True`` returns ``(SearchResult, BatchStats)``.

    ``approx_p`` runs every attempt through
    :func:`knn_search_batch_approx` at that ``p_guarantee``;
    ``target_recall`` (not with ``approx_p``) picks it from the index's
    fitted recall curve (``core/calibrate.py``) first.
    """
    index = _as_forest(index, k)
    if target_recall is not None:
        if approx_p is not None:
            raise ValueError("pass at most one of approx_p / target_recall")
        approx_p, _ = resolve_p_guarantee(index, target_recall)
    validate_p_guarantee(approx_p)
    dev = _on_index_device(index, device)
    ys = _queries(ys, dev)
    if ys.ndim != 2:
        raise ValueError(f"knn_batch wants (q, d) queries, got "
                         f"{tuple(ys.shape)}")
    if validate:
        validate_queries(index.family, ys)
    budget = resolve_budget(budget, index.n, k)
    p = None if approx_p is None else float(approx_p)

    def run(b):
        if p is None:
            return knn_search_batch(index, ys, k, b, block_rows,
                                    validate=False, device=dev)
        return knn_search_batch_approx(index, ys, k, b, p, block_rows,
                                       validate=False, device=dev)

    def done(res, escalations, scan=False, stopped=False):
        stats = BatchStats(escalations=escalations, budget_final=budget,
                           escalated_to_scan=scan, stopped_early=stopped)
        return (res, stats) if return_stats else res

    for attempt in range(max_doublings + 1):
        res = run(budget)
        if bool(res.exact.all()) or budget >= index.n:
            return done(res, attempt)
        if attempt == max_doublings:
            break
        if stop_retry is not None and stop_retry():
            return done(res, attempt, stopped=True)
        # needed > budget on overflow, so the fitted budget strictly grows.
        budget = fitted_budget(index, k, int(res.num_candidates.max()))
    if stop_retry is not None and stop_retry():
        return done(res, max_doublings, stopped=True)
    logger.warning(
        "knn_batch: budget cap exhausted after %d doublings (budget=%d, "
        "%d/%d queries overflowed); escalating to a full linear scan "
        "(n=%d)", max_doublings, budget,
        int((~res.exact).sum()), ys.shape[0], index.n)
    scan_index = (index.as_resident_forest()
                  if getattr(index, "is_tiered_store", False) else index)
    ids, dists = _brute_force_live(scan_index, ys, k)
    res = SearchResult(ids=ids, dists=dists,
                       exact=torch.ones(ys.shape[0], dtype=torch.bool,
                                        device=dev),
                       num_candidates=res.num_candidates)
    return done(res, max_doublings, scan=True)


def _scan_topk(rows: Tensor, ys: Tensor, k: int, family,
               live: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Exact D_f of every row for each query, then the k smallest (stable:
    ties to the lower row).  One query at a time, so the temporaries are
    (n, d), not (q, n, d)."""
    ids, dists = [], []
    for y in ys:
        dist = family.distance(rows, y[None, :])
        if live is not None:
            dist = torch.where(live, dist, POS_BIG)
        sv, order = torch.sort(dist, stable=True)
        ids.append(order[:k])
        dists.append(sv[:k])
    return torch.stack(ids), torch.stack(dists)


def _brute_force_live(index: BallForest, ys: Tensor, k: int):
    """Linear scan over the live rows (``point_ids >= 0``) of an index; the
    int8 tier's decoded rows (``rows_view``), so it is exact there too."""
    idx, dists = _scan_topk(index.rows_view(), ys, k, index.family,
                            live=index.point_ids >= 0)
    return index.point_ids[idx], dists


def brute_force_knn(data, y, k: int, family, device="cuda"):
    """Linear-scan oracle.  ``y`` (d,) gives ((k,) ids, (k,) dists); a
    (q, d) batch gives ((q, k), (q, k))."""
    dev = resolve_device(device)
    fam = get_family(family) if isinstance(family, str) else family
    rows = torch.as_tensor(data, dtype=torch.float32, device=dev)
    ys = torch.as_tensor(y, dtype=torch.float32, device=dev)
    if ys.ndim == 1:
        idx, dists = _scan_topk(rows, ys[None], k, fam)
        return idx[0], dists[0]
    return _scan_topk(rows, ys, k, fam)
