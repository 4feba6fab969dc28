"""Straggler detection over observed step durations (port of
``repro.ft.straggler.StragglerMonitor``): a median baseline over a
window, a threshold ratio and consecutive-hit debouncing, with a
pluggable callback.  ``ReplicaHeartbeat`` comes with the fleet
(ROADMAP.md queue 1, item 13)."""

from __future__ import annotations

import collections
from typing import Callable, Optional

__all__ = ["StragglerMonitor"]


class StragglerMonitor:
    def __init__(self, *, window: int = 32, ratio: float = 1.5,
                 patience: int = 3,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.window = window
        self.ratio = ratio
        self.patience = patience
        self.on_straggler = on_straggler
        self.times = collections.deque(maxlen=window)
        self.hits = 0
        self.events = []

    def record(self, step: int, duration: float) -> bool:
        """Feed one step duration; returns True when mitigation fires."""
        if len(self.times) >= max(4, self.window // 4):
            baseline = sorted(self.times)[len(self.times) // 2]  # median
            if duration > self.ratio * baseline:
                self.hits += 1
                if self.hits >= self.patience:
                    self.events.append((step, duration))
                    self.hits = 0
                    if self.on_straggler is not None:
                        self.on_straggler(step, duration)
                    return True
            else:
                self.hits = 0
        self.times.append(duration)
        return False
