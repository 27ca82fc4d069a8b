"""Ring collective matmuls: an all-gather or a reduce-scatter whose chunk
transfers overlap the matmuls (port of ``repro.dist.collective_matmul``).

The building blocks of tensor-parallel layers: instead of a whole
all-gather (or all-reduce) and THEN the matmul, the ring multiplies the
chunk it holds while the next one is on the wire.  Each function is a
per-rank function over one mesh dim: every rank of ``mesh``'s ``axis``
calls it with its own shard, and the ring runs over that dim's process
group (``mesh.get_group(axis)``), the counterpart of the reference's
``shard_map`` body.

* :func:`ag_matmul` — x row-sharded over ``axis``, w replicated: the
  full ``all_gather(x) @ w`` on every rank.
* :func:`ag_matmul_reference` — the same through one
  ``all_gather_into_tensor`` (the oracle of the ring).
* :func:`matmul_rs` — x column-sharded and w row-sharded over ``axis``
  (a contraction-split matmul): the partial products reduce-scattered so
  each rank ends with its row block of the true product.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def _ring(mesh, axis: str):
    """(group, this rank's index on it, its size, global rank of index)."""
    group = mesh.get_group(axis)
    return (group, dist.get_rank(group), dist.get_world_size(group),
            lambda i: dist.get_global_rank(group, i))


def _shift(send: Tensor, to: int, frm: int, group):
    """Start sending ``send`` to global rank ``to`` and receiving a tensor
    like it from ``frm``; returns (buffer, requests)."""
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, to, group),
        dist.P2POp(dist.irecv, recv, frm, group)])
    return recv, reqs


def ag_matmul(x_local: Tensor, w: Tensor, mesh, axis: str) -> Tensor:
    """Ring all-gather matmul: the FULL ``gather(x) @ w`` on every rank.

    Each of the ``p`` steps multiplies the row chunk held while the next
    one travels: a rank sends its chunk to the rank before it and takes
    the next rank's, so after i hops it holds chunk (index + i)."""
    group, idx, p, peer = _ring(mesh, axis)
    rows = x_local.shape[0]
    out = x_local.new_empty((p * rows, w.shape[1]),
                            dtype=torch.promote_types(x_local.dtype,
                                                      w.dtype))
    chunk = x_local.contiguous()
    for i in range(p):
        reqs = []
        if i < p - 1:
            nxt, reqs = _shift(chunk, peer((idx - 1) % p),
                               peer((idx + 1) % p), group)
        src = (idx + i) % p
        out[src * rows:(src + 1) * rows] = chunk @ w
        for r in reqs:
            r.wait()
        if i < p - 1:
            chunk = nxt
    return out


def ag_matmul_reference(x_local: Tensor, w: Tensor, mesh,
                        axis: str) -> Tensor:
    """Oracle for :func:`ag_matmul`: one bulk all-gather, then the matmul."""
    group, _, p, _ = _ring(mesh, axis)
    full = x_local.new_empty((p * x_local.shape[0],) + x_local.shape[1:])
    dist.all_gather_into_tensor(full, x_local.contiguous(), group=group)
    return full @ w


def matmul_rs(x_local: Tensor, w_local: Tensor, mesh, axis: str) -> Tensor:
    """Ring reduce-scatter matmul for contraction-split operands.

    ``x_local (m, k/p)`` and ``w_local (k/p, n)`` hold matching slices of
    the contraction dim, so ``x_local @ w_local`` is a full-shape partial
    product; the ring adds the partials so rank ``i`` of ``axis`` ends with
    rows ``[i*m/p, (i+1)*m/p)`` of the true ``x @ w``, each chunk summed
    in the reference's order.  Raises ``ValueError`` when p does not
    divide m."""
    group, idx, p, peer = _ring(mesh, axis)
    partial = x_local @ w_local                      # (m, n) partial sum
    m = partial.shape[0]
    if m % p:
        raise ValueError(f"rows {m} not divisible by axis size {p}")
    rows = m // p

    def take(c):
        c %= p
        return partial[c * rows:(c + 1) * rows]

    # start with the chunk farthest (p - 1 hops) from its home rank; each
    # hop passes the sum to the next rank
    acc = take(idx - 1).contiguous()
    for s in range(p - 1):
        acc, reqs = _shift(acc, peer((idx + 1) % p), peer((idx - 1) % p),
                           group)
        for r in reqs:
            r.wait()
        acc = acc + take(idx - 2 - s)
    return acc
