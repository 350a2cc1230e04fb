"""Fault-tolerance utilities: straggler detection and failure-injection
hooks for testing checkpoint/restart behaviour in-process.

On a real 1000+-node fleet the per-step barrier makes one slow host
drag the whole job; the detector below is the policy engine (who is
slow, for how long) — the *action* (evict + elastic restart from the
last checkpoint) is wired in launch/train.py.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional


@dataclasses.dataclass
class StragglerReport:
    host: int
    ratio: float         # host EMA / fleet median EMA
    consecutive: int


class StragglerDetector:
    """Tracks per-host step-time EMAs; flags hosts persistently slower
    than ``threshold`` x the fleet median for ``patience`` steps."""

    def __init__(self, num_hosts: int, alpha: float = 0.2,
                 threshold: float = 1.8, patience: int = 5):
        self.num_hosts = num_hosts
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.ema = [None] * num_hosts  # type: List[Optional[float]]
        self.strikes = [0] * num_hosts

    def record(self, host: int, step_time: float) -> None:
        prev = self.ema[host]
        self.ema[host] = (step_time if prev is None
                          else self.alpha * step_time + (1 - self.alpha) * prev)

    def check(self) -> List[StragglerReport]:
        known = [e for e in self.ema if e is not None]
        if len(known) < max(2, self.num_hosts // 2):
            return []
        med = sorted(known)[len(known) // 2]
        reports = []
        for h, e in enumerate(self.ema):
            if e is None:
                continue
            ratio = e / max(med, 1e-9)
            if ratio > self.threshold:
                self.strikes[h] += 1
            else:
                self.strikes[h] = 0
            if self.strikes[h] >= self.patience:
                reports.append(StragglerReport(h, ratio, self.strikes[h]))
        return reports


class SimulatedFailure(RuntimeError):
    """Raised by FailureInjector to emulate a host crash mid-run."""


class FailureInjector:
    """Deterministically kills the run at given steps — the test fixture
    for checkpoint/auto-resume."""

    def __init__(self, fail_at_steps: List[int]):
        self.fail_at = set(fail_at_steps)
        self.fired: set = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


class StepTimer:
    """Wall-clock per-step timing with percentile summaries."""

    def __init__(self, window: int = 200):
        self.times: Deque[float] = collections.deque(maxlen=window)
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        s = sorted(self.times)
        n = len(s)
        return {"p50": s[n // 2], "p90": s[int(n * 0.9)], "max": s[-1],
                "mean": sum(s) / n}
