"""kNN-LM over a Bregman datastore (port of ``repro.serve.knnlm``).

A datastore maps LM hidden states h_t to the token that FOLLOWED them in a
reference corpus (Khandelwal et al. 2020).  At every sampling step the
current hidden states query the store's k nearest keys and the LM
distribution is interpolated with the kNN distribution:

    p(y) = (1 - lam) * p_LM(y) + lam * softmax_over_knn(-D(h, h_i) / T)

``build_datastore`` runs the teacher-forced forward over a corpus (kernel
#10 in every layer) and indexes the (hidden, next token) pairs with
``build_index``; ``KNNLMHook`` plugs into serve/engine.py's
``logits_hook`` and runs the exact batched search (``knn_batch``: kernels
#1, #3 and #7) once per sampling step.

Not ported yet, each listed in ROADMAP queue 1: ``Datastore.grow`` /
``evict`` (the mutable ``SegmentedForest``, item 6, raise here); the
approximate hook (``approx_p``, ``target_recall``, item 5) and the
retrieval-service route (``service``, item 9), absent here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import search as bp_search
from ..core.index import BallForest, build_index
from ..core.tiered import resolve_prefetch_depth, resolve_resident_bytes

Tensor = torch.Tensor

# Corpus sequences a forward micro-batch of build_datastore takes.
FORWARD_BATCH = 8


@dataclasses.dataclass
class Datastore:
    """kNN-LM key/value store over a BrePartition index; ``next_tokens``
    is indexed by the keys' original point ids."""

    index: BallForest
    next_tokens: np.ndarray     # (n,) int32 — token following each key
    hidden_dim: int
    # Streaming block size for searches over this store (the port's
    # resolve_block_rows value: 4096 until the autotuner is ported).
    block_rows: int | None = None
    # Out-of-core residency (core/tiered.py): with a byte budget, lookups
    # run against a TieredPointStore over the index.  None keeps the store
    # resident on the index's device.
    resident_bytes: int | None = None
    prefetch_depth: int | None = None
    _tiered: object = dataclasses.field(default=None, init=False,
                                        repr=False)

    def search_index(self):
        """The object lookups search: the index itself, or — with a
        ``resident_bytes`` budget — a TieredPointStore over it, made once."""
        if self.resident_bytes is None:
            return self.index
        if self._tiered is None:
            from ..core.tiered import TieredPointStore
            self._tiered = TieredPointStore.from_index(
                self.index, resident_bytes=self.resident_bytes,
                prefetch_depth=self.prefetch_depth,
                block_rows=self.block_rows)
        return self._tiered

    def grow(self, keys, next_tokens):
        raise NotImplementedError(
            "Datastore.grow needs the mutable SegmentedForest, not ported "
            "yet (ROADMAP queue 1 item 6)")

    def evict(self, ids):
        raise NotImplementedError(
            "Datastore.evict needs the mutable SegmentedForest, not ported "
            "yet (ROADMAP queue 1 item 6)")


def _forward_keys(bundle, params, corpus: np.ndarray) -> Tensor:
    """Hidden states at every position but the last, (num*(s-1), d) fp32,
    the forward run over ``FORWARD_BATCH`` sequences at a time."""
    num, s = corpus.shape
    keys = []
    with torch.inference_mode():
        for b0 in range(0, num, FORWARD_BATCH):
            toks = torch.as_tensor(corpus[b0:b0 + FORWARD_BATCH],
                                   dtype=torch.int32, device=bundle.device)
            pos = torch.arange(s, dtype=torch.int32, device=bundle.device)
            hidden, _ = bundle.forward_train(
                params, {"tokens": toks,
                         "positions": pos[None].expand(toks.shape[0], s)})
            keys.append(hidden[:, :-1].to(torch.float32)
                        .reshape(-1, hidden.shape[-1]))
    return torch.cat(keys)


def build_datastore(bundle, params, corpus_tokens: np.ndarray, *,
                    family: str = "squared_euclidean",
                    m: int | None = None, quantize: bool = False,
                    block_rows: int | None = None,
                    resident_bytes: int | None = None,
                    prefetch_depth: int | None = None,
                    seed: int = 0) -> Datastore:
    """Teacher-forced pass over (num_seqs, seq_len) tokens -> datastore.

    Keys: hidden state at position t; values: token at t+1.  The forward
    runs over ``FORWARD_BATCH`` sequences at a time, so the activations on
    the card stay bounded whatever the corpus size; the keys gather into
    one fp32 table.  The index is built on the bundle's device with
    ``build_index`` (``m=None``: Theorem-4 M*, PCCP over numpy float64
    correlations as in the reference; ``quantize=True``: the int8 tier).
    ``block_rows=None`` takes ``resolve_block_rows``'s value.
    """
    resident_bytes = resolve_resident_bytes(resident_bytes)
    prefetch_depth = resolve_prefetch_depth(prefetch_depth)
    corpus = np.asarray(corpus_tokens)
    if corpus.ndim != 2 or corpus.shape[1] < 2:
        raise ValueError(f"corpus must be (num_seqs, seq_len >= 2), got "
                         f"{corpus.shape}")
    keys = _forward_keys(bundle, params, corpus)
    vals = corpus[:, 1:].reshape(-1).astype(np.int32)
    index = build_index(keys, family, m=m, quantize=quantize, seed=seed,
                        device=bundle.device)
    return Datastore(index=index, next_tokens=vals,
                     hidden_dim=int(keys.shape[-1]),
                     block_rows=bp_search.resolve_block_rows(block_rows,
                                                             index.n),
                     resident_bytes=resident_bytes,
                     prefetch_depth=prefetch_depth)


@dataclasses.dataclass
class KNNLMHook:
    """``logits_hook`` for serve.engine.Engine: exact Bregman-kNN
    interpolation.

    The engine passes the sampled slots' rows (logits (A, V), hidden
    (A, D)); the hook retrieves each row's k nearest datastore keys with
    one ``knn_batch`` call and mixes the neighbours' next-token
    distribution into the LM distribution.  ``last_result`` keeps the last
    call's ``SearchResult`` (ids are the keys' original ids).
    """

    store: Datastore
    k: int = 8
    lam: float = 0.25
    temperature: float = 1.0
    budget: int | None = None       # pinned refine budget, grows only
    block_rows: int | None = None   # streaming block size (None -> store's)
    queries_served: int = 0
    # Budget-retry telemetry: escalations taken, full-scan fallbacks, and
    # the budget the most recent search ran with.
    escalations: int = 0
    scan_fallbacks: int = 0
    budget_final: int = 0
    last_result: object = dataclasses.field(default=None, repr=False)
    _next_dev: Tensor | None = dataclasses.field(default=None, init=False,
                                                 repr=False)

    @torch.inference_mode()
    def __call__(self, logits: Tensor, hidden: Tensor | None) -> Tensor:
        if hidden is None or self.store.index.n < self.k:
            return logits
        index = self.store.index
        h = hidden.to(torch.float32)
        res, stats = bp_search.knn_batch(
            self.store.search_index(), h, self.k, budget=self.budget,
            block_rows=(self.block_rows or self.store.block_rows),
            return_stats=True, device=index.device)
        self.last_result = res
        self.queries_served += int(h.shape[0])
        self.escalations += stats.escalations
        self.scan_fallbacks += int(stats.escalated_to_scan)
        self.budget_final = stats.budget_final
        # Grow-only budget pin: only when this step's unions outgrew the
        # effective budget, sized by fitted_budget and capped at 8x the
        # default so one pathological row cannot inflate every later
        # refine to the whole store.
        default = bp_search.resolve_budget(None, index.n, self.k)
        needed = int(res.num_candidates.max())
        current = self.budget or default
        if needed > current:
            cap = bp_search.fitted_budget(index, self.k, 8 * default)
            fitted = bp_search.fitted_budget(index, self.k, needed)
            self.budget = max(current, min(fitted, cap))  # never shrink
        # An inexact row's neighbours are an arbitrary union prefix: it
        # serves the pure LM distribution instead of a biased mixture.
        if self._next_dev is None:
            self._next_dev = torch.as_tensor(self.store.next_tokens,
                                             dtype=torch.long,
                                             device=logits.device)
        ids = res.ids.to(logits.device).long()
        knn_tokens = self._next_dev[ids]                        # (A, k)
        w = torch.softmax(-res.dists.to(logits.device) / self.temperature,
                          dim=-1)                               # (A, k)
        p_knn = torch.zeros(logits.shape, dtype=torch.float32,
                            device=logits.device).scatter_add_(
            1, knn_tokens, w)
        p_lm = torch.softmax(logits.to(torch.float32), dim=-1)
        mix = (1.0 - self.lam) * p_lm + self.lam * p_knn
        mix = torch.where(res.exact.to(logits.device)[:, None], mix, p_lm)
        return torch.log(torch.clamp(mix, min=1e-30))
