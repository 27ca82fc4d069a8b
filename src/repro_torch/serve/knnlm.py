"""kNN-LM over a Bregman datastore (port of ``repro.serve.knnlm``).

A datastore maps LM hidden states h_t to the token that FOLLOWED them in a
reference corpus (Khandelwal et al. 2020).  At every sampling step the
current hidden states query the store's k nearest keys and the LM
distribution is interpolated with the kNN distribution:

    p(y) = (1 - lam) * p_LM(y) + lam * softmax_over_knn(-D(h, h_i) / T)

``build_datastore`` runs the teacher-forced forward over a corpus (kernel
#10 in every layer) and indexes the (hidden, next token) pairs with
``build_index`` (``calibrate=True`` fits the recall curve the hook's
``target_recall`` inverts); ``KNNLMHook`` plugs into serve/engine.py's
``logits_hook`` and runs the batched search (``knn_batch``: kernels #1,
#3 and #7) once per sampling step: exact, or the §8 approximate search
at ``approx_p`` or ``target_recall``.  With ``service`` set, every lookup
goes through a :class:`~repro_torch.serve.retrieval.RetrievalService`
(admission, deadlines, the degradation ladder): rows the service
answered exact or approx are mixed, the rest serve the pure LM.

``Datastore.grow`` / ``evict`` change the store online through the
mutable index (core/segments.py): the first mutation wraps the forest in a
``SegmentedForest``, and ids are never reused, so ``next_tokens`` only
grows.  The hook adds the neighbours' weights into the vocabulary one
neighbour column at a time, so the mixture repeats bit for bit on the
card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import search as bp_search
from ..core.index import BallForest, build_index
from ..core.segments import SegmentedForest
from ..core.tiered import resolve_prefetch_depth, resolve_resident_bytes
from ..models.registry import model_inputs

Tensor = torch.Tensor

# Corpus sequences a forward micro-batch of build_datastore takes.
FORWARD_BATCH = 8


@dataclasses.dataclass
class Datastore:
    """kNN-LM key/value store over a BrePartition index.

    ``index`` is a BallForest, or after the first :meth:`grow` /
    :meth:`evict` the mutable SegmentedForest.  ``next_tokens`` is indexed
    by the keys' original point ids; ids are never reused (tombstones keep
    theirs, compaction keeps them), so the table only grows.
    """

    index: BallForest | SegmentedForest
    next_tokens: np.ndarray     # (next_id,) int32 — token following each key
    hidden_dim: int
    version: int = 0            # moves on every mutation
    # Streaming block size for searches over this store, pinned at build
    # time from the autotuner table (launch/autotune.py; the default
    # 4096 on a miss).  Hooks read it as their default.
    block_rows: int | None = None
    # A mutation that crosses the index's stale-fraction threshold
    # compacts inside grow / evict; False leaves compaction to the caller
    # (index.compact()).
    auto_compact: bool = True
    # Out-of-core residency (core/tiered.py): with a byte budget, lookups
    # run against a TieredPointStore over the index.  None keeps the store
    # resident on the index's device.
    resident_bytes: int | None = None
    prefetch_depth: int | None = None
    _tiered: object = dataclasses.field(default=None, init=False,
                                        repr=False)
    _tiered_version: int = dataclasses.field(default=-1, init=False,
                                             repr=False)

    @property
    def storage(self) -> str:
        """Key-table storage tier ("f32" | "int8", see build_datastore)."""
        return self.index.storage

    def search_index(self):
        """The object lookups search: the index itself, or — with a
        ``resident_bytes`` budget — a TieredPointStore over it, made again
        (the old one closed) whenever :attr:`version` moves, since a store
        freezes its snapshot."""
        if self.resident_bytes is None:
            return self.index
        if self._tiered is None or self._tiered_version != self.version:
            from ..core.tiered import TieredPointStore
            old, self._tiered = self._tiered, None
            if old is not None:
                old.close()
            self._tiered = TieredPointStore.from_index(
                self.index, resident_bytes=self.resident_bytes,
                prefetch_depth=self.prefetch_depth,
                block_rows=self.block_rows)
            self._tiered_version = self.version
        return self._tiered

    def _mutable(self) -> SegmentedForest:
        if not isinstance(self.index, SegmentedForest):
            self.index = SegmentedForest.from_forest(self.index)
        return self.index

    def grow(self, keys, next_tokens) -> np.ndarray:
        """Append (hidden, next-token) pairs; returns their ids.  One
        nearest-centre pass against the sealed index; the keys are found
        by the next hook call."""
        if isinstance(keys, torch.Tensor):
            keys = keys.detach().to(torch.float32)
        else:
            keys = np.asarray(keys, np.float32)
        toks = np.asarray(next_tokens, np.int32)
        if keys.ndim != 2 or keys.shape[1] != self.hidden_dim:
            raise ValueError(f"expected (a, {self.hidden_dim}) keys, got "
                             f"{tuple(keys.shape)}")
        if toks.shape != (keys.shape[0],):
            raise ValueError("one next-token per key required")
        store = self._mutable()
        if store.next_id != self.next_tokens.shape[0]:
            raise ValueError("datastore ids out of sync with value table")
        ids = store.insert(keys, auto_compact=self.auto_compact)
        self.next_tokens = np.concatenate([self.next_tokens, toks])
        self.version += 1
        return ids

    def evict(self, ids) -> int:
        """Retire keys by tombstone; returns how many were live."""
        removed = self._mutable().delete(ids, auto_compact=self.auto_compact)
        if removed:
            self.version += 1
        return removed


def _forward_keys(bundle, params, corpus: np.ndarray) -> Tensor:
    """Hidden states at every position but the last, (num*(s-1), d) fp32,
    the forward run over ``FORWARD_BATCH`` sequences at a time, with
    M-RoPE positions and zero extra inputs where the model takes them
    (``models.registry.model_inputs``), as the reference's build does."""
    num, s = corpus.shape
    keys = []
    with torch.inference_mode():
        for b0 in range(0, num, FORWARD_BATCH):
            toks = torch.as_tensor(corpus[b0:b0 + FORWARD_BATCH],
                                   dtype=torch.int32, device=bundle.device)
            pos = torch.arange(s, dtype=torch.int32, device=bundle.device)
            hidden, _ = bundle.forward_train(params, model_inputs(
                bundle, toks, pos[None].expand(toks.shape[0], s)))
            keys.append(hidden[:, :-1].to(torch.float32)
                        .reshape(-1, hidden.shape[-1]))
    return torch.cat(keys)


def build_datastore(bundle, params, corpus_tokens: np.ndarray, *,
                    family: str = "squared_euclidean",
                    m: int | None = None, quantize: bool = False,
                    block_rows: int | None = None,
                    calibrate: bool = False, calibrate_k: int = 8,
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
    ``calibrate=True`` fits the recall-calibration curve over held-out
    jittered keys at build time (core/calibrate.py), enabling
    ``KNNLMHook(target_recall=...)``; ``calibrate_k`` should match the
    hook's ``k``.  ``block_rows=None`` pins the autotuned block size for
    this store (the lookup keyed on n, a decode tick's 8 rows, the
    storage tier and the device), 4096 on a table miss.
    """
    resident_bytes = resolve_resident_bytes(resident_bytes)
    prefetch_depth = resolve_prefetch_depth(prefetch_depth)
    corpus = np.asarray(corpus_tokens)
    if corpus.ndim != 2 or corpus.shape[1] < 2:
        raise ValueError(f"corpus must be (num_seqs, seq_len >= 2), got "
                         f"{corpus.shape}")
    keys = _forward_keys(bundle, params, corpus)
    vals = corpus[:, 1:].reshape(-1).astype(np.int32)
    index = build_index(keys, family, m=m, quantize=quantize,
                        calibrate=calibrate, calibrate_k=calibrate_k,
                        seed=seed, device=bundle.device)
    return Datastore(index=index, next_tokens=vals,
                     hidden_dim=int(keys.shape[-1]),
                     block_rows=bp_search.resolve_block_rows(
                         block_rows, index.n, q=8, storage=index.storage,
                         device=index.device),
                     resident_bytes=resident_bytes,
                     prefetch_depth=prefetch_depth)


def knn_distribution(tokens: Tensor, w: Tensor, vocab: int) -> Tensor:
    """(A, vocab) fp32: each row's neighbour weights ``w`` (A, k) added at
    their tokens (A, k), column j = 0 ... k - 1 in turn, as the
    reference's serial scatter adds them.  Within one column a row has a
    single index, so no add races: one ``scatter_add_`` over all k columns
    adds a repeated token's weights with atomics in no fixed order on the
    card."""
    p = torch.zeros((tokens.shape[0], vocab), dtype=torch.float32,
                    device=tokens.device)
    for j in range(tokens.shape[1]):
        p.scatter_add_(1, tokens[:, j:j + 1], w[:, j:j + 1])
    return p


@dataclasses.dataclass
class KNNLMHook:
    """``logits_hook`` for serve.engine.Engine: Bregman-kNN interpolation.

    The engine passes the sampled slots' rows (logits (A, V), hidden
    (A, D)); the hook retrieves each row's k nearest datastore keys with
    one ``knn_batch`` call and mixes the neighbours' next-token
    distribution into the LM distribution.  ``last_result`` keeps the last
    call's ``SearchResult`` (ids are the keys' original ids), or on the
    service route its ``RetrievalResponse``.
    """

    store: Datastore
    k: int = 8
    lam: float = 0.25
    temperature: float = 1.0
    approx_p: float | None = None   # paper §8 approximate mode (raw knob)
    # Calibrated alternative to approx_p: retrieve at a MEASURED recall
    # level by inverting the datastore's calibration curve (fit it with
    # build_datastore(calibrate=True)).  Mutually exclusive with approx_p;
    # an uncalibrated store falls back to p = target_recall with a
    # one-time warning (core/calibrate.py).
    target_recall: float | None = None
    budget: int | None = None       # pinned refine budget, grows only
    block_rows: int | None = None   # streaming block size (None -> store's)
    # Optional robustness front end (serve/retrieval.py).  When set, every
    # lookup routes through the service's admission gate and degradation
    # ladder under ``deadline_s``: the store is (re-)registered as tenant
    # ``service_tenant`` whenever ``store.version`` moves, and rows the
    # service degraded past approx (partial / shed) serve the pure LM
    # distribution: a slow or faulty datastore costs retrieval quality,
    # never decode liveness.
    service: object = None          # RetrievalService | None
    service_tenant: str = "knnlm"
    deadline_s: float | None = None
    queries_served: int = 0
    # Budget-retry telemetry: escalations taken, full-scan fallbacks, and
    # the budget the most recent search ran with.
    escalations: int = 0
    scan_fallbacks: int = 0
    budget_final: int = 0
    last_result: object = dataclasses.field(default=None, repr=False)
    # next_tokens on the logits' device, uploaded again when the store's
    # version moves.
    _next_dev: Tensor | None = dataclasses.field(default=None, init=False,
                                                 repr=False)
    _next_version: int = dataclasses.field(default=-1, init=False,
                                           repr=False)
    _svc_version: int = dataclasses.field(default=-1, init=False,
                                          repr=False)

    def _service_lookup(self, h: Tensor):
        """Route one lookup through the retrieval service.

        Returns ``(ids, dists, use_rows)`` as host arrays, or None for
        "serve the pure LM".  ``use_rows`` keeps exact and approx rows;
        partial and shed rows serve the LM distribution (a truncated
        neighbour set would bias the mixture, the same policy as the
        inexact-row gate of the direct route).
        """
        svc = self.service
        name = self.service_tenant
        if name not in svc.tenants or self._svc_version != self.store.version:
            # (Re-)register on every store mutation: the service revalidates
            # the live rows and refreshes its tenant record.  approx_p is
            # the tenant's raw §8 knob; target_recall rides each request and
            # inverts the store's calibration curve service-side.
            svc.register_tenant(name, self.store.index,
                                p_guarantee=self.approx_p,
                                resident_bytes=self.store.resident_bytes,
                                prefetch_depth=self.store.prefetch_depth)
            self._svc_version = self.store.version
        resp = svc.search_sync(name, h, self.k, deadline_s=self.deadline_s,
                               target_recall=self.target_recall)
        self.last_result = resp
        use = np.array([q in ("exact", "approx") for q in resp.row_quality])
        if not use.any():
            return None
        return resp.ids, resp.dists, use

    @torch.inference_mode()
    def __call__(self, logits: Tensor, hidden: Tensor | None) -> Tensor:
        # Eviction can leave fewer than k live keys: serve the LM alone.
        if hidden is None or getattr(self.store.index, "live_n",
                                     self.store.index.n) < self.k:
            return logits
        index = self.store.index
        h = hidden.to(torch.float32)
        dev = logits.device
        if self.service is not None:
            out = self._service_lookup(h)
            self.queries_served += int(h.shape[0])
            if out is None:
                return logits
            ids, dists, use = out
            ids = torch.as_tensor(np.maximum(ids, 0), device=dev).long()
            dists = torch.as_tensor(np.where(use[:, None], dists, 0.0)
                                    .astype(np.float32), device=dev)
            use = torch.as_tensor(use, device=dev)
        else:
            res, stats = bp_search.knn_batch(
                self.store.search_index(), h, self.k, budget=self.budget,
                approx_p=self.approx_p, target_recall=self.target_recall,
                block_rows=(self.block_rows or self.store.block_rows),
                return_stats=True, device=index.device)
            self.last_result = res
            self.queries_served += int(h.shape[0])
            self.escalations += stats.escalations
            self.scan_fallbacks += int(stats.escalated_to_scan)
            self.budget_final = stats.budget_final
            # Grow-only budget pin: only when this step's unions outgrew
            # the effective budget, sized by fitted_budget and capped at 8x
            # the default so one pathological row cannot inflate every
            # later refine to the whole store.
            default = bp_search.resolve_budget(None, index.n, self.k)
            needed = int(res.num_candidates.max())
            current = self.budget or default
            if needed > current:
                cap = bp_search.fitted_budget(index, self.k, 8 * default)
                fitted = bp_search.fitted_budget(index, self.k, needed)
                self.budget = max(current, min(fitted, cap))  # never shrink
            # An inexact row's neighbours are an arbitrary union prefix: it
            # serves the pure LM distribution instead of a biased mixture.
            ids = res.ids.to(dev).long()
            dists = res.dists.to(dev)
            use = res.exact.to(dev)
        if self._next_dev is None or self._next_version != self.store.version:
            self._next_dev = torch.as_tensor(self.store.next_tokens,
                                             dtype=torch.long, device=dev)
            self._next_version = self.store.version
        knn_tokens = self._next_dev[ids]                        # (A, k)
        w = torch.softmax(-dists / self.temperature, dim=-1)    # (A, k)
        p_knn = knn_distribution(knn_tokens, w, logits.shape[-1])
        p_lm = torch.softmax(logits.to(torch.float32), dim=-1)
        mix = (1.0 - self.lam) * p_lm + self.lam * p_knn
        mix = torch.where(use[:, None], mix, p_lm)
        return torch.log(torch.clamp(mix, min=1e-30))
