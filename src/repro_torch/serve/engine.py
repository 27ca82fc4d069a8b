"""Batched serving engine: continuous prefill/decode over a fixed slot pool
(port of ``repro.serve.engine``).

A pool of B sequence slots, each with its own cache region and length
counter.  New requests prefill into free slots; every engine tick runs ONE
decode step for all slots (continuous batching with a fixed batch shape).

Padding policy: prompts are RIGHT-padded to ``prefill_len``.  Attention
caches tolerate trailing garbage (decode masks ``ki < length``).

Slot isolation: the batched prefill writes every slot's cache region in
place, so the engine copies the rows of the slots it does not admit before
the prefill and writes them back after (the reference selects between the
old and the new cache per slot): active sequences are never perturbed.

Logits hooks: ``logits_hook(logits (A, V), hidden (A, D))`` is invoked
once per sampling step with the rows of the slots being sampled — every
ACTIVE slot on a decode tick, every ADMITTED slot on the prefill sampling
path — and never with a dead slot's row (serve/knnlm.py retrieves on
them).

Termination: a request finishes as soon as its output hits
``max_new_tokens``, its sampled token equals ``cfg.eos_token``, or its
cache fills — checked after EVERY sampled token, including the one the
prefill path samples at admission.

Sampling: greedy is ``argmax`` (ties to the lowest id); otherwise
``torch.multinomial`` draws from the engine's own ``torch.Generator``
seeded with ``seed``, whose bits differ from the reference's
``jax.random`` draws for the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (prompt_len,) int
    max_new_tokens: int
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    slots: int                    # max concurrent sequences (batch size)
    max_seq: int                  # cache capacity per slot
    prefill_len: int              # static prompt padding length
    eos_token: int = -1           # -1: never stop on a token
    greedy: bool = True
    temperature: float = 1.0


class Engine:
    """Host-side slot manager around the bundle's prefill and decode."""

    def __init__(self, bundle, params, cfg: EngineConfig,
                 logits_hook: Callable | None = None, seed: int = 0):
        self.bundle = bundle
        self.params = params
        self.cfg = cfg
        self.device = bundle.device
        self.logits_hook = logits_hook      # e.g. kNN-LM interpolation
        self.caches = bundle.init_cache(cfg.slots, cfg.max_seq)
        self.lengths = np.zeros((cfg.slots,), np.int32)
        self.slot_req: list[Request | None] = [None] * cfg.slots
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.ticks = 0

    # -- request lifecycle ----------------------------------------------------
    def submit(self, req: Request):
        if len(req.prompt) > self.cfg.prefill_len:
            raise ValueError("prompt longer than prefill_len")
        self.queue.append(req)

    def _tensor(self, a: np.ndarray) -> Tensor:
        return torch.as_tensor(a, device=self.device)

    def _cache_rows(self, rows: Tensor) -> list:
        return [(c["mixer"].k[rows].clone(), c["mixer"].v[rows].clone())
                for c in self.caches]

    def _restore_rows(self, rows: Tensor, saved: list) -> None:
        for c, (k, v) in zip(self.caches, saved, strict=True):
            c["mixer"].k[rows] = k
            c["mixer"].v[rows] = v

    @torch.inference_mode()
    def _admit(self):
        """Prefill queued requests into free slots (one batched prefill)."""
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        if not free or not self.queue:
            return
        take = min(len(free), len(self.queue))
        slots = free[:take]
        reqs = [self.queue.pop(0) for _ in range(take)]
        b, pl = self.cfg.slots, self.cfg.prefill_len
        tokens = np.zeros((b, pl), np.int32)
        admitted = np.zeros((b,), bool)
        for s, r in zip(slots, reqs, strict=True):
            tokens[s, : len(r.prompt)] = r.prompt      # right-pad
            admitted[s] = True
            self.slot_req[s] = r
        pos = np.arange(pl, dtype=np.int32)[None, :].repeat(b, 0)
        batch = {"tokens": self._tensor(tokens),
                 "positions": self._tensor(pos)}
        # non-admitted slots keep their previous cache (slot isolation)
        keep = self._tensor(np.flatnonzero(~admitted))
        saved = self._cache_rows(keep) if keep.numel() else None
        hidden, self.caches = self.bundle.prefill(
            self.params, batch, self.caches,
            self._tensor(np.zeros((b,), np.int32)))
        if saved is not None:
            self._restore_rows(keep, saved)
        # Sample ONLY the admitted slots, each at its true last-prompt
        # position; the other rows are garbage the hook must not see.
        last_idx = np.array([len(r.prompt) - 1 for r in reqs])
        last_hidden = hidden[self._tensor(np.array(slots)),
                             self._tensor(last_idx)]
        logits = self.bundle.logits(self.params, last_hidden)
        first = self._sample(logits, last_hidden)
        for j, (s, r) in enumerate(zip(slots, reqs, strict=True)):
            r.output.append(int(first[j]))
            self.lengths[s] = len(r.prompt)
            self._finish_if_done(s, at_admit=True)

    def _sample(self, logits: Tensor, hidden: Tensor | None = None
                ) -> np.ndarray:
        """Sample the given rows (already restricted to live slots)."""
        if self.logits_hook is not None:
            logits = self.logits_hook(logits, hidden)
        if self.cfg.greedy:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        probs = torch.softmax(logits.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0] \
            .cpu().numpy()

    def _finish_if_done(self, i: int, at_admit: bool = False) -> bool:
        """Retire slot ``i`` if its newest token terminates the request:
        budget, EOS or cache capacity, for every sampled token.  Capacity
        keeps the decode path's one-slot margin (``lengths + 1 >=
        max_seq``); at admission the margin is zero, since a prompt of
        length ``max_seq - 1`` still has room for its one decode write."""
        r = self.slot_req[i]
        hit_eos = r.output[-1] == self.cfg.eos_token
        margin = 0 if at_admit else 1
        full = (len(r.output) >= r.max_new_tokens
                or self.lengths[i] + margin >= self.cfg.max_seq)
        if hit_eos or full:
            r.done = True
            self.finished.append(r)
            self.slot_req[i] = None
            self.lengths[i] = 0
            return True
        return False

    @torch.inference_mode()
    def step(self) -> bool:
        """One engine tick: admit, then one decode step for active slots."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return False
        self.ticks += 1
        last = np.zeros((self.cfg.slots, 1), np.int32)
        for i in active:
            last[i, 0] = self.slot_req[i].output[-1]
        logits, hidden, self.caches = self.bundle.decode_step(
            self.params, self._tensor(last),
            self._tensor(self.lengths[:, None].copy()), self.caches,
            self._tensor(self.lengths.copy()))
        # Free slots decode garbage rows (the batch is slot-shaped); drop
        # them before sampling so hooks only ever see live sequences.
        rows = self._tensor(np.array(active))
        nxt = self._sample(logits[rows], hidden[rows])
        for j, i in enumerate(active):
            self.slot_req[i].output.append(int(nxt[j]))
            self.lengths[i] += 1
            self._finish_if_done(i)
        return True

    def run(self, max_ticks: int = 1000):
        """Drive until queue + slots drain (or tick budget)."""
        for _ in range(max_ticks):
            if not self.step() and not self.queue:
                break
        return self.finished
