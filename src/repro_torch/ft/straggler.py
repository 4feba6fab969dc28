"""Straggler detection over observed step durations (port of
``repro.ft.straggler.StragglerMonitor``): a median baseline over a
window, a threshold ratio and consecutive-hit debouncing, with a
pluggable callback), and the fleet's failure detector for one replica
(``ReplicaHeartbeat``: alive -> suspect -> dead with hysteresis)."""

from __future__ import annotations

import collections
from typing import Callable, Optional

__all__ = ["StragglerMonitor", "ReplicaHeartbeat"]


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


class ReplicaHeartbeat:
    """alive → suspect → dead escalation with hysteresis over per-block
    health beats (the fleet's failure detector for one replica).

    The fleet feeds one beat per replica per fleet round: *healthy*
    means the replica made block progress (or was idle) and its block
    time was not flagged by its :class:`StragglerMonitor`.
    ``suspect_after`` consecutive unhealthy beats mark the replica
    SUSPECT (routing avoids it; its in-flight work stays put);
    ``dead_after`` mark it DEAD — terminal, its requests re-dispatch.
    Hysteresis both ways: a suspect returns to ALIVE only after
    ``recover_after`` consecutive healthy beats (one lucky block must
    not flap a struggling replica back into the routing set), and the
    unhealthy streak is only forgiven by a full recovery, so a replica
    alternating good and bad blocks still converges to DEAD instead of
    hovering at the suspect threshold forever.
    """

    def __init__(self, *, suspect_after: int = 2, dead_after: int = 4,
                 recover_after: int = 2):
        if (int(suspect_after) <= 0 or int(dead_after) <= 0
                or int(recover_after) <= 0):
            raise ValueError(
                f"heartbeat thresholds must be positive (got "
                f"suspect_after={suspect_after}, dead_after={dead_after}, "
                f"recover_after={recover_after}); a zero threshold would "
                f"declare a healthy replica suspect or dead on no evidence")
        if int(dead_after) <= int(suspect_after):
            raise ValueError(
                f"dead_after ({dead_after}) must exceed suspect_after "
                f"({suspect_after}): death must escalate from suspicion, "
                f"never race it")
        self.suspect_after = int(suspect_after)
        self.dead_after = int(dead_after)
        self.recover_after = int(recover_after)
        self.state = "alive"
        self._bad = 0
        self._good = 0

    def beat(self, healthy: bool) -> str:
        """Feed one health observation; returns the (possibly new)
        state, one of ``"alive"``/``"suspect"``/``"dead"``.  DEAD is
        terminal — a dead replica's journal may already be re-owned by
        a survivor, so it may never silently rejoin."""
        if self.state == "dead":
            return self.state
        if healthy:
            self._good += 1
            # one healthy beat forgives nothing — only ``recover_after``
            # consecutive ones clear the unhealthy streak (and, for a
            # suspect, restore routing eligibility)
            if self._good >= self.recover_after:
                self.state, self._bad, self._good = "alive", 0, 0
        else:
            self._bad += 1
            self._good = 0
            if self._bad >= self.dead_after:
                self.state = "dead"
            elif self._bad >= self.suspect_after:
                self.state = "suspect"
        return self.state
