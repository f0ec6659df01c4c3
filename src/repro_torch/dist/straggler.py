"""Straggler watchdog: per-step wall-time anomaly policy — the port's
own copy of ``repro/dist/straggler.py`` (numpy only).

A step is *slow* when it exceeds ``quantile(history) * slack``.  One slow
step is tolerated (RETRY — could be a GC pause, a preemption warning, a
checkpoint flush); ``escalate_after`` CONSECUTIVE slow steps escalate to
REJOIN (leave the job and re-enter through the elastic restart path).  Any
healthy step resets the suspicion counter, giving the hysteresis the tests
pin down.  Only healthy steps enter the history, so a stuck worker cannot
poison its own baseline into normality.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

OK = "ok"
RETRY = "retry"
REJOIN = "rejoin"


@dataclasses.dataclass(frozen=True)
class StragglerConfig:
    quantile: float = 0.5        # history quantile used as the baseline
    slack: float = 3.0           # slow = dt > baseline * slack
    escalate_after: int = 3      # consecutive slow steps before REJOIN
    min_history: int = 8         # observations before judging at all
    max_history: int = 256       # rolling window of healthy step times


class StragglerWatchdog:
    def __init__(self, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self._history: deque[float] = deque(maxlen=cfg.max_history)
        self._slow_streak = 0

    @property
    def baseline(self) -> float | None:
        if len(self._history) < self.cfg.min_history:
            return None
        return float(np.quantile(np.asarray(self._history),
                                 self.cfg.quantile))

    def observe(self, step_seconds: float) -> str:
        base = self.baseline
        if base is not None and step_seconds > base * self.cfg.slack:
            self._slow_streak += 1
            if self._slow_streak >= self.cfg.escalate_after:
                self._slow_streak = 0
                return REJOIN
            return RETRY
        self._slow_streak = 0
        self._history.append(step_seconds)
        return OK
