"""Chunked softmax cross-entropy: the (B, S, V) logits never exist at once
(port of ``repro.train.losses``).

The sequence is cut into chunks of ``chunk`` positions; each chunk's fp32
logits are made, reduced and dropped under ``torch.utils.checkpoint``, so
the backward pass makes them again instead of keeping them.  The logits
run over the table's padded vocab, as in the reference (the pad rows are
never a label).  An optional z-loss weighs the squared log-partition.
Under a mesh the reference's anchors (``dist.sharding.constrain``) place
the hidden states, the gathered table and the vocab-sharded logits;
without one they are the identity.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..dist.sharding import constrain

Tensor = torch.Tensor


def _chunk_nll(hidden_c: Tensor, labels_c: Tensor, table: Tensor,
               z_weight: float):
    """hidden (B, C, D), labels (B, C) -> (sum nll, sum z, sum correct):
    the table cast to the hidden states' dtype, both widened so the
    product accumulates and stays in fp32 (the reference's
    ``preferred_element_type``)."""
    hidden_c = constrain(hidden_c, ("batch", None, "embed"))
    # the fsdp-sharded table gathered before the product (reference
    # losses.py:29-33)
    table_g = constrain(table.to(hidden_c.dtype), ("vocab", None))
    logits = hidden_c.to(torch.float32) @ table_g.to(torch.float32).T
    logits = constrain(logits, ("batch", None, "vocab"))
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels_c.long()[..., None])[..., 0]
    nll = torch.sum(lse - tgt)
    z = torch.sum(torch.square(lse)) * z_weight
    # argmax-free accuracy, as the reference counts it
    correct = torch.sum(tgt >= torch.amax(logits, dim=-1))
    return nll, z, correct


def chunked_cross_entropy(hidden: Tensor, labels: Tensor, table: Tensor, *,
                          chunk: int = 512, z_weight: float = 0.0):
    """Mean token NLL (plus the z-loss) via sequence-chunked logits.

    Returns (loss, metrics) with metrics {nll, z_loss, accuracy}, each a
    0-dim fp32 tensor."""
    b, s, _ = hidden.shape
    hidden = constrain(hidden, ("batch", "seq", "embed"))
    chunk = min(chunk, s)
    body = functools.partial(_chunk_nll, z_weight=z_weight)
    nll = 0.0
    zl = 0.0
    ncorrect = 0
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        # a chunk draws no random numbers: no RNG state to keep
        n, z, corr = checkpoint(body, hidden[:, c0:c1], labels[:, c0:c1],
                                table, use_reentrant=False,
                                preserve_rng_state=False)
        nll = nll + n
        zl = zl + z
        ncorrect = ncorrect + corr
    denom = b * s
    loss = (nll + zl) / denom
    return loss, {"nll": nll / denom, "z_loss": zl / denom,
                  "accuracy": ncorrect / denom}
