"""Straggler detection and its mitigation policy (port of
``repro.train.straggler``, pure Python).

The monitor tracks each step's wall time (per host where a multi-host run
gathers them; one process has one host, and tests pass simulated host
times), flags a host whose step exceeds ``median * tolerance`` over a
sliding window, and trips a mitigation once ``patience`` consecutive flags
accumulate.  Mitigations are callables:

* ``checkpoint_and_shrink`` -- save, drop the slow host, and resume on the
  rest (``train/checkpoint.py`` restores onto another device and shard
  count);
* ``rebalance`` -- shrink the slow host's data shard;
* ``alert`` -- record only.

A monitor made without a config takes the defaults (the reference's
constructor reads the window from its ``cfg`` argument, so ``None``
fails there).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable


@dataclasses.dataclass
class StragglerConfig:
    window: int = 50              # sliding window of step times
    tolerance: float = 1.5        # flag if > tolerance * median
    patience: int = 5             # consecutive flags before mitigation
    warmup_steps: int = 10        # ignore compile/cache-warm steps


@dataclasses.dataclass
class StragglerEvent:
    step: int
    host: int
    step_time: float
    median: float
    action: str


class StragglerMonitor:
    def __init__(self, cfg: StragglerConfig | None = None,
                 num_hosts: int = 1,
                 mitigation: Callable[[StragglerEvent], None] | None = None):
        self.cfg = cfg if cfg is not None else StragglerConfig()
        self.num_hosts = num_hosts
        self.mitigation = mitigation
        self.times: list[deque] = [deque(maxlen=self.cfg.window)
                                   for _ in range(num_hosts)]
        self.flags = [0] * num_hosts
        self.events: list[StragglerEvent] = []
        self._step = 0
        self._t0 = None

    # -- wall-clock convenience for the training loop ------------------------
    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self, host_times: list[float] | None = None):
        """Record a step.  ``host_times`` overrides wall time per host
        (multi-host runs gather them; tests inject simulated values)."""
        elapsed = time.perf_counter() - self._t0 if self._t0 else 0.0
        if host_times is None:
            host_times = [elapsed] * self.num_hosts
        self._step += 1
        if self._step <= self.cfg.warmup_steps:
            return []
        fired = []
        for h, t in enumerate(host_times):
            self.times[h].append(t)
            med = _median(self.times[h])
            if len(self.times[h]) >= 5 and t > self.cfg.tolerance * med:
                self.flags[h] += 1
            else:
                self.flags[h] = 0
            if self.flags[h] >= self.cfg.patience:
                ev = StragglerEvent(step=self._step, host=h, step_time=t,
                                    median=med, action="mitigate")
                self.events.append(ev)
                self.flags[h] = 0
                if self.mitigation is not None:
                    self.mitigation(ev)
                fired.append(ev)
        return fired

    def summary(self) -> dict:
        med = [_median(t) if t else 0.0 for t in self.times]
        p99 = [_quantile(t, 0.99) if t else 0.0 for t in self.times]
        return {"median": med, "p99": p99,
                "events": len(self.events), "steps": self._step}


def _median(xs) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _quantile(xs, q: float) -> float:
    s = sorted(xs)
    i = min(len(s) - 1, int(q * len(s)))
    return s[i]
