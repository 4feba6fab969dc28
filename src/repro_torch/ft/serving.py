"""Deterministic fault injection for the serving engine and the fleet
(port of ``repro.ft.serving``).

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
* ``"crash"`` -- process death: :class:`InjectedCrash`, a
  ``BaseException`` so that no ``except Exception`` (and no in-process
  replay) catches it, raised before the block after the doomed engine is
  released (``Engine.release``: its journal handle closed, its graphs,
  cache and params given back).  Recovery is a fresh Engine and
  ``Engine.recover`` from the durable journal and snapshot directory.

:class:`FleetFaultInjector` schedules ``(round, replica, kind)`` faults
of the fleet (:data:`FLEET_FAULT_KINDS`): a replica killed (``"kill"``,
the same crash), the standby's journal apply suppressed for a round
(``"lag"``) or a replica that makes no progress for a round
(``"stall"``).
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Tuple, Union

__all__ = ["ServingFaultInjector", "FleetFaultInjector", "InjectedFault",
           "InjectedCrash", "PageCorruptionError", "FAULT_KINDS",
           "CRASH_KIND", "FLEET_FAULT_KINDS"]

#: the kinds recovered in process (restore and replay)
FAULT_KINDS = ("raise", "nan", "corrupt", "slow")
#: recovered across processes (``Engine.recover``), not by replay
CRASH_KIND = "crash"
#: fleet kinds (:class:`FleetFaultInjector`; keyed by round and replica)
FLEET_FAULT_KINDS = ("kill", "lag", "stall")


class InjectedFault(RuntimeError):
    """A scheduled step exception (transient worker failure)."""


class InjectedCrash(BaseException):
    """Scheduled process death.  A ``BaseException`` on purpose: nothing
    in the engine or in a caller's ``except Exception`` may swallow it;
    the only way past it is a fresh Engine and ``Engine.recover``."""


def _release(engine) -> None:
    # the doomed engine dies in this process: the rebuilt engine reopens
    # the same journal file, so its append handle must not linger on it,
    # and its graphs, cache and params give their device memory back
    engine.release()


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
            if kind not in FAULT_KINDS + (CRASH_KIND,):
                raise ValueError(f"unknown fault kind {kind!r} "
                                 f"(have {FAULT_KINDS + (CRASH_KIND,)})")
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
            if kind == CRASH_KIND:
                _release(engine)
                raise InjectedCrash(f"injected process death at block {rnd}")
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


class FleetFaultInjector:
    """Fleet fault schedule: ``(round, replica, kind)`` triples, or a
    dict ``{round: (replica, kind)}``; rounds are 1-based fleet rounds
    and each triple fires once.  ``"kill"`` raises
    :class:`InjectedCrash` out of the replica's step (the replica
    released first), which the fleet detects as a death; ``"lag"``
    suppresses the standby's journal apply for the round (replica
    ignored); ``"stall"`` makes the replica skip the round and penalizes
    its block report."""

    def __init__(self, schedule):
        items = (((rnd,) + tuple(v) for rnd, v in schedule.items())
                 if isinstance(schedule, dict) else list(schedule))
        self.schedule: Dict[int, list] = {}
        for rnd, replica, kind in items:
            if kind not in FLEET_FAULT_KINDS:
                raise ValueError(f"unknown fleet fault kind {kind!r} "
                                 f"(have {FLEET_FAULT_KINDS})")
            self.schedule.setdefault(int(rnd), []).append(
                (None if replica is None else int(replica), kind))
        self.fired = set()
        #: (round, replica, kind) of every fault injected
        self.events = []

    def lag_injected(self, rnd: int) -> bool:
        """True (and marked fired) when a ``"lag"`` fault is scheduled
        for ``rnd``; the fleet asks before the standby's sync."""
        for replica, kind in self.schedule.get(rnd, ()):
            key = (rnd, replica, kind)
            if kind == "lag" and key not in self.fired:
                self.fired.add(key)
                self.events.append(key)
                return True
        return False

    def before_step(self, rnd: int, replica: int, engine) -> tuple:
        """Fire ``rnd``'s faults against ``replica``: returns the kinds
        that do not kill (``"stall"``), or raises for a kill."""
        kinds = []
        for rep, kind in self.schedule.get(rnd, ()):
            if kind == "lag" or rep != replica:
                continue
            key = (rnd, rep, kind)
            if key in self.fired:
                continue
            self.fired.add(key)
            self.events.append(key)
            if kind == "kill":
                _release(engine)
                raise InjectedCrash(
                    f"injected death of replica {replica} at fleet "
                    f"round {rnd}")
            kinds.append(kind)
        return tuple(kinds)
