"""Deterministic fault injection for the serving engine (port of
``repro.ft.serving.ServingFaultInjector``).

The schedule is keyed by the engine's decode-block round, so a chaos run
is exactly reproducible, and each scheduled ``(round, kind)`` fires once:
a restored-and-replayed block runs clean.  Kinds:

* ``"raise"`` -- :class:`InjectedFault` before the block; the engine
  replays it from its pre-block snapshot.
* ``"nan"`` -- every float leaf of the serving cache is filled with NaN
  before the block; the block's fault lane flags the slots whose logits
  went non-finite.
* ``"corrupt"`` -- the float leaves are filled with 1e30 before the
  block, and :class:`PageCorruptionError` is raised after it (a delayed
  integrity report: finite garbage does not show in the logits).
* ``"slow"`` -- a straggler block: the injector sleeps ``slow_s``, or
  with ``slow_s`` 0 the engine adds a synthetic penalty to the block's
  time, which its :class:`~repro_torch.ft.straggler.StragglerMonitor`
  flags.

The reference's ``"crash"`` kind (process death, recovered from the
durable journal) is refused: the journal is ROADMAP.md queue 1, item
12b.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Tuple, Union

__all__ = ["ServingFaultInjector", "InjectedFault", "PageCorruptionError",
           "FAULT_KINDS"]

FAULT_KINDS = ("raise", "nan", "corrupt", "slow")


class InjectedFault(RuntimeError):
    """A scheduled step exception (transient worker failure)."""


class PageCorruptionError(RuntimeError):
    """Delayed integrity report for finite page-pool corruption."""


class ServingFaultInjector:
    """Fault schedule over decode-block rounds: ``schedule`` maps a
    1-based round to a kind, or is an iterable of ``(round, kind)``
    pairs.  The engine calls :meth:`before_block` and :meth:`after_block`
    around every block."""

    def __init__(self, schedule: Union[Dict[int, str],
                                       Iterable[Tuple[int, str]]],
                 *, slow_s: float = 0.0):
        items = (schedule.items() if isinstance(schedule, dict)
                 else list(schedule))
        self.schedule = {}
        for rnd, kind in items:
            if kind == "crash":
                raise NotImplementedError(
                    "fault kind 'crash': process death is recovered from "
                    "the durable journal, which is not ported yet "
                    "(ROADMAP.md queue 1, item 12b)")
            if kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r} "
                                 f"(have {FAULT_KINDS})")
            self.schedule.setdefault(int(rnd), []).append(kind)
        self.slow_s = float(slow_s)
        self.fired = set()
        #: (round, kind) of every fault injected
        self.events = []
        self._pending_corruption = None

    def before_block(self, rnd: int, engine) -> None:
        """Before the round's block: may poison the cache or raise."""
        for kind in list(self.schedule.get(rnd, ())):
            key = (rnd, kind)
            if key in self.fired:
                continue
            if kind in ("nan", "corrupt") and not engine.live.any():
                # with nothing decoding no logits carry the poison to the
                # fault lane, and it would outlive the snapshot: defer
                self.schedule[rnd].remove(kind)
                self.schedule.setdefault(rnd + 1, []).append(kind)
                continue
            self.fired.add(key)
            self.events.append(key)
            if kind == "raise":
                raise InjectedFault(f"injected step fault at block {rnd}")
            if kind == "slow":
                if self.slow_s > 0:
                    time.sleep(self.slow_s)
                # slow_s == 0: the engine makes the block *appear* slow
                engine._injected_slow = True
            elif kind == "nan":
                engine._poison_cache(float("nan"))
            elif kind == "corrupt":
                engine._poison_cache(1e30)
                self._pending_corruption = rnd

    def after_block(self, rnd: int, engine) -> None:
        """After the block: the delayed report of finite corruption."""
        if self._pending_corruption == rnd:
            self._pending_corruption = None
            raise PageCorruptionError(
                f"page-pool integrity check failed after block {rnd}")
