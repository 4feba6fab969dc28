"""Fleet: N engine replicas behind one submit / step / results surface
(port of ``repro.launch.fleet``).

* **A journal-shipped hot standby.**  The primary journals every
  transition (``Engine(durable_dir=...)``, an fsync'd write-ahead log); a
  standby Engine, built the same way, tails the journal through
  ``BlobLog.follow`` and applies each record through the replay path
  recovery uses, within ``max_standby_lag`` records.  When the primary
  dies (its step raises under the fleet, or its heartbeat escalates to
  dead), :meth:`Fleet.promote` finishes the tail and installs the standby
  as the primary: block records are written ahead and greedy decode is
  deterministic, so every stream resumes exactly.
* **Routing by least pressure, with failure detection.**  ``submit``
  routes a request to the replica with the least class-aware pressure
  (queued work at or above its class, lane and page occupancy, TTFT risk
  against its class's target).  A :class:`~repro_torch.ft.ReplicaHeartbeat`
  per replica, fed by block progress and a ``StragglerMonitor`` of block
  times, escalates alive -> suspect -> dead; suspects are avoided, and a
  death re-dispatches the replica's unfinished requests to survivors
  exactly once (the ledger kept at submit is the record).
* **Class isolation**: the page pools' class quotas hold on every replica,
  and re-dispatch after a death resumes REALTIME victims first.

The fleet is in process: replicas are Engine objects (each, like every
Engine, on the card unless the factory names a device), the journal file
is the channel between primary and standby, and a death is an exception
out of a replica's step (:class:`~repro_torch.ft.FleetFaultInjector`
schedules them).  A dead replica's device state is released
(``Engine.release``).  All replicas share one card and one stream here:
the standby replays every block the primary runs.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np

from ..checkpoint.store import BlobLog
from ..ft.serving import InjectedCrash
from ..ft.straggler import ReplicaHeartbeat, StragglerMonitor
from .lifecycle import coerce_priority

__all__ = ["Fleet"]


class Fleet:
    """N replicas, one serving surface, supervised failure handling.

    ``make_engine`` is a zero-argument factory (keyword overrides
    allowed) building one fresh engine; the fleet owns replica
    construction so a promotion can mint the standby's successor the
    same way.  With ``standby_dir`` set, replica 0 (the primary)
    journals under it and a hot standby tails that journal; without it
    a primary death is handled like any secondary's — survivors absorb
    the re-dispatched work.

    ``max_standby_lag`` bounds how many journal records the standby
    may trail the primary by before the fleet forces a catch-up drain
    (an injected lag spike may defer *one* sync, never the bound).
    The heartbeat thresholds mirror :class:`ReplicaHeartbeat`.
    """

    def __init__(self, make_engine: Callable, n_replicas: int, *,
                 standby_dir: Optional[str] = None,
                 max_standby_lag: int = 64,
                 suspect_after: int = 2, dead_after: int = 4,
                 recover_after: int = 2,
                 fault_injector=None, clock=None):
        if int(n_replicas) <= 0:
            raise ValueError(
                f"n_replicas must be positive (got {n_replicas}): a fleet "
                f"with no replicas can serve nothing")
        if int(max_standby_lag) < 0:
            raise ValueError(
                f"max_standby_lag must be >= 0 (got {max_standby_lag}): "
                f"the standby can never be ahead of the journal, so a "
                f"negative lag bound is unsatisfiable")
        self.n_replicas = int(n_replicas)
        self.max_standby_lag = int(max_standby_lag)
        self._standby_dir = None if standby_dir is None else str(standby_dir)
        self._make_engine = make_engine
        self.fault_injector = fault_injector
        self._hb_kw = dict(suspect_after=suspect_after,
                           dead_after=dead_after,
                           recover_after=recover_after)

        self.replicas: List = []
        for r in range(self.n_replicas):
            if r == 0 and self._standby_dir is not None:
                self.replicas.append(make_engine(
                    durable_dir=self._standby_dir))
            else:
                self.replicas.append(make_engine())
        self.clock = clock if clock is not None else self.replicas[0].clock

        self.standby = None
        self._follower = None
        self._journal_path = None
        if self._standby_dir is not None:
            # the standby replays the primary's journal, so it must be
            # built identically — same factory, no durable_dir (its
            # journal handle arrives at promotion, exactly like a cold
            # Engine.recover)
            self.standby = make_engine()
            self._journal_path = os.path.join(self._standby_dir,
                                              "journal.log")
            if getattr(self.replicas[0], "_journal", None) is None:
                raise RuntimeError(
                    "standby_dir set but the primary is not journaling: "
                    "make_engine must thread durable_dir through to the "
                    "engine")
            self._follower = self.replicas[0]._journal.follow()

        # validate the heartbeat thresholds once, loudly, before any
        # replica depends on them
        self.state = ["alive"] * self.n_replicas
        self.heartbeats = [ReplicaHeartbeat(**self._hb_kw)
                           for _ in range(self.n_replicas)]
        self.monitors = [StragglerMonitor(window=16, patience=1)
                         for _ in range(self.n_replicas)]
        self._dead_handled = set()
        self._round = 0
        self._lag_pending = False

        #: fleet id -> routing ledger entry: where the request went,
        #: its local id there, the full re-submittable spec, and
        #: whether it was already re-dispatched (exactly-once guard)
        self._ledger: Dict[int, dict] = {}
        self._by_local: Dict[tuple, int] = {}
        self._next_fid = 0
        #: fleet id -> terminal {"status", "tokens"} (harvested)
        self.results: Dict[int, dict] = {}
        self.counters = {"routed": 0, "deaths": 0, "promotions": 0,
                         "redispatched": 0, "suspects": 0,
                         "time_to_promote_s": None,
                         "journal_lag_records": 0}

    # -- routing -------------------------------------------------------------
    def _routable(self) -> List[int]:
        """Replicas submit may target: alive first, suspects only when
        nothing is alive (a suspect is avoided, not abandoned)."""
        alive = [r for r in range(self.n_replicas)
                 if self.state[r] == "alive"]
        if alive:
            return alive
        suspect = [r for r in range(self.n_replicas)
                   if self.state[r] == "suspect"]
        if suspect:
            return suspect
        raise RuntimeError("no live replicas: the whole fleet is dead")

    def _pressure(self, r: int, cls) -> tuple:
        """Class-aware pressure score for replica ``r`` (lower routes
        first).  Components mirror :meth:`Engine.stats`: queued work at
        or above the request's class, lane occupancy, page-pool
        occupancy, and TTFT risk against the class's SLO target."""
        eng = self.replicas[r]
        ahead = sum(1 for q in eng.waiting
                    if coerce_priority(q.get("priority")) <= cls)
        running = int(np.asarray(eng.live).sum())
        lanes = running / max(1, eng.batch)
        pool = 0.0
        if eng.paged:
            a = eng.allocator
            pool = 1.0 - a.free_pages / max(1, a.num_pages)
        risk = 0.0
        tgt = (eng.slo_targets or {}).get(cls, {}).get("ttft_s")
        if tgt:
            now = self.clock()
            waits = [now - q["t_submit"] for q in eng.waiting
                     if coerce_priority(q.get("priority")) == cls
                     and q.get("t_submit") is not None]
            if waits:
                risk = max(waits) / float(tgt)
        # suspects score after every alive replica at equal pressure;
        # the replica index breaks exact ties deterministically
        return (ahead + running + lanes + pool + risk,
                0 if self.state[r] == "alive" else 1, r)

    def submit(self, prompt, *, gen_len=None, temperature: float = 0.0,
               top_k: int = 0, deadline_s=None, priority=None) -> int:
        """Route one request to the least-pressure live replica;
        returns a *fleet* id (stable across re-dispatch and promotion —
        the per-replica id is an implementation detail)."""
        cls = coerce_priority(priority)
        r = min(self._routable(), key=lambda i: self._pressure(i, cls))
        local = self.replicas[r].submit(
            prompt, gen_len=gen_len, temperature=temperature,
            top_k=top_k, deadline_s=deadline_s, priority=priority)
        fid = self._next_fid
        self._next_fid += 1
        self._ledger[fid] = {
            "replica": r, "local_id": local, "priority": cls,
            "spec": {"prompt": np.array(prompt, np.int32, copy=True),
                     "gen_len": gen_len, "temperature": temperature,
                     "top_k": top_k, "deadline_s": deadline_s,
                     "priority": priority},
            "redispatched": False}
        self._by_local[(r, local)] = fid
        self.counters["routed"] += 1
        return fid

    def status(self, fid: int):
        """Terminal status if harvested, else the owning replica's
        live status (None = unknown fleet id)."""
        if fid in self.results:
            return self.results[fid]["status"]
        ent = self._ledger.get(fid)
        if ent is None:
            return None
        if self.state[ent["replica"]] == "dead":
            return None
        return self.replicas[ent["replica"]].status(ent["local_id"])

    def try_admit(self) -> int:
        n = 0
        for r in range(self.n_replicas):
            if self.state[r] != "dead":
                n += self.replicas[r].try_admit()
        # the admission sweep journals on the primary even when idle;
        # sync here too or a drive loop that admits after stepping
        # leaves the standby perpetually one record behind (and
        # ``busy()`` never clears).  An injected lag spike from the
        # current round still defers, same as in step_many.
        self._sync_standby(lag_fault=self._lag_pending)
        return n

    # -- the supervised step loop -------------------------------------------
    def step_many(self, n: int) -> None:
        """One fleet round: every non-dead replica runs one ``n``-token
        block under supervision (chaos hooks, straggler timing, death
        detection, harvest, heartbeat), then the standby syncs."""
        self._round += 1
        inj = self.fault_injector
        lag_fault = inj.lag_injected(self._round) if inj else False
        self._lag_pending = lag_fault
        try:
            for r in range(self.n_replicas):
                if self.state[r] == "dead":
                    continue
                eng = self.replicas[r]
                before = int(eng.counters["gen_tokens"])
                had_work = bool(np.asarray(eng.live).any()) or bool(
                    eng.waiting)
                stalled = False
                t0 = self.clock()
                try:
                    kinds = (inj.before_step(self._round, r, eng)
                             if inj else ())
                    if "stall" in kinds:
                        # a hung worker: no step, no progress, and the
                        # round still charges it a full block of time
                        stalled = True
                    else:
                        eng.step_many(n)
                        eng.retire_finished()
                except InjectedCrash:
                    self._on_death(r)
                    continue
                duration = (self.clock() - t0) + (1.0 if stalled else 0.0)
                flagged = self.monitors[r].record(self._round, duration)
                progressed = (not stalled and (
                    int(eng.counters["gen_tokens"]) > before
                    or not had_work))
                # harvest BEFORE the beat: a replica's last good block
                # must land even if this beat kills it
                self._harvest(r)
                self._beat(r, healthy=progressed and not flagged)
        finally:
            self._sync_standby(lag_fault=lag_fault)

    def _beat(self, r: int, healthy: bool) -> None:
        if self.state[r] == "dead":
            return
        prev = self.state[r]
        state = self.heartbeats[r].beat(healthy)
        self.state[r] = state
        if state == "suspect" and prev == "alive":
            self.counters["suspects"] += 1
        if state == "dead":
            self._on_death(r)

    def _harvest(self, r: int) -> None:
        """Copy newly terminal results from replica ``r`` into the
        fleet's result map, keyed by fleet id."""
        eng = self.replicas[r]
        for local, res in eng.results.items():
            fid = self._by_local.get((r, local))
            if fid is None or fid in self.results:
                continue
            if self._ledger[fid]["replica"] != r:
                # stale mapping from before a re-dispatch — the entry
                # now lives elsewhere; only the current owner reports
                continue
            self.results[fid] = {"status": res["status"],
                                 "tokens": list(res["tokens"])}

    # -- death, promotion, re-dispatch --------------------------------------
    def _on_death(self, r: int) -> None:
        """A replica died under us (its step raised, or the heartbeat
        escalated it to dead).  Idempotent."""
        if r in self._dead_handled:
            return
        self._dead_handled.add(r)
        self.state[r] = "dead"
        self.heartbeats[r].state = "dead"
        self.counters["deaths"] += 1
        # closes its journal and gives its graphs, cache and params back
        # (its results were harvested; re-dispatch reads only the ledger)
        self.replicas[r].release()
        if r == 0 and self.standby is not None:
            self.promote()
        else:
            self._redispatch(r)

    def promote(self) -> dict:
        """Finish the standby's tail replay and install it as the new
        primary, resuming every in-flight stream byte-identically.

        The journal is the whole story: the dead primary's snapshot
        directory is untouched, the standby replays every record the
        follower had not yet applied (write-ahead "block" records mean
        a death *mid-block* still replays that block), then reopens
        the journal for append — torn tail truncated — and takes over
        journaling.  Exactly-once for routed requests falls out of
        submit being journaled before it returns: anything the ledger
        knows about is in the journal, so the standby already has it.
        """
        if self.standby is None:
            raise RuntimeError(
                "promote() without a standby: construct the Fleet with "
                "standby_dir to run one")
        t0 = self.clock()
        self._apply_tail()
        sb, self.standby, self._follower = self.standby, None, None
        # reopen for append, a torn tail truncated
        sb._adopt_journal(BlobLog(self._journal_path), self._standby_dir)
        sb.counters["recoveries"] += 1
        sb.journal_lag_records = 0
        self.replicas[0] = sb
        self.state[0] = "alive"
        self._dead_handled.discard(0)
        self.heartbeats[0] = ReplicaHeartbeat(**self._hb_kw)
        self.monitors[0] = StragglerMonitor(window=16, patience=1)
        self.counters["promotions"] += 1
        self.counters["time_to_promote_s"] = float(self.clock() - t0)
        # belt and braces: anything routed to the primary that the
        # journal somehow does not know about (it should not exist —
        # submit journals before returning) re-dispatches like a
        # secondary's loss, exactly once
        for fid, ent in sorted(self._ledger.items(),
                               key=lambda kv: (int(kv[1]["priority"]),
                                               kv[0])):
            if (ent["replica"] == 0 and fid not in self.results
                    and not ent["redispatched"]
                    and sb.status(ent["local_id"]) is None):
                self._redispatch_one(fid)
        self._harvest(0)
        return {"time_to_promote_s": self.counters["time_to_promote_s"]}

    def _redispatch(self, r: int) -> None:
        """Re-dispatch every un-harvested request that was routed to
        the dead replica ``r`` — REALTIME victims first, FIFO within a
        class — to the surviving least-pressure replicas."""
        victims = sorted(
            (fid for fid, ent in self._ledger.items()
             if ent["replica"] == r and fid not in self.results),
            key=lambda fid: (int(self._ledger[fid]["priority"]), fid))
        for fid in victims:
            self._redispatch_one(fid)

    def _redispatch_one(self, fid: int) -> None:
        ent = self._ledger[fid]
        if ent["redispatched"]:
            raise RuntimeError(
                f"request {fid} re-dispatched twice — the exactly-once "
                f"ledger is broken")
        spec = ent["spec"]
        cls = ent["priority"]
        r = min(self._routable(), key=lambda i: self._pressure(i, cls))
        local = self.replicas[r].submit(
            spec["prompt"], gen_len=spec["gen_len"],
            temperature=spec["temperature"], top_k=spec["top_k"],
            deadline_s=spec["deadline_s"], priority=spec["priority"])
        ent["replica"], ent["local_id"] = r, local
        ent["redispatched"] = True
        self._by_local[(r, local)] = fid
        self.counters["redispatched"] += 1

    # -- standby sync --------------------------------------------------------
    def _sync_standby(self, lag_fault: bool = False) -> int:
        """Tail the primary's journal into the standby.  An injected
        lag spike may skip one sync — unless skipping would breach
        ``max_standby_lag``, in which case the bound wins and the
        standby drains anyway."""
        if self._follower is None:
            return 0
        primary = self.replicas[0]
        j = getattr(primary, "_journal", None)
        total = j.count if j is not None else self._follower.count
        if lag_fault:
            lag = total - self._follower.count
            if lag <= self.max_standby_lag:
                self.counters["journal_lag_records"] = lag
                if self.state[0] != "dead":
                    primary.journal_lag_records = lag
                return 0
        applied = self._apply_tail()
        lag = total - self._follower.count
        self.counters["journal_lag_records"] = lag
        if self.state[0] != "dead":
            primary.journal_lag_records = lag
        return applied

    def _apply_tail(self) -> int:
        """Apply every complete journal record the standby has not yet
        seen, through the same muted replay path recovery uses."""
        sb = self.standby
        recs = self._follower.poll()
        if not recs:
            return 0
        sb._jmute += 1
        try:
            for rec in recs:
                sb._replay_event(rec)
        finally:
            sb._jmute -= 1
        return len(recs)

    # -- drive helpers -------------------------------------------------------
    def busy(self) -> bool:
        """Any non-dead replica with queued or running work, or a
        standby still behind the journal."""
        for r in range(self.n_replicas):
            if self.state[r] == "dead":
                continue
            eng = self.replicas[r]
            if bool(np.asarray(eng.live).any()) or eng.waiting:
                return True
        if self._follower is not None:
            j = getattr(self.replicas[0], "_journal", None)
            if j is not None and self._follower.count < j.count:
                return True
        return False

    def drain(self, block: int = 4, max_rounds: int = 10_000) -> None:
        """Step until every routed request is terminal (the serve CLI's
        fleet loop).  ``max_rounds`` is a runaway guard — hitting it
        means a request can neither run nor finish, which is a bug."""
        self.try_admit()
        rounds = 0
        while self.busy() or len(self.results) < len(self._ledger):
            self.step_many(block)
            self.try_admit()
            rounds += 1
            if rounds >= max_rounds:
                raise RuntimeError(
                    f"fleet failed to drain in {max_rounds} rounds: "
                    f"{len(self.results)}/{len(self._ledger)} terminal")

    def stats(self) -> dict:
        """Fleet-level telemetry plus each replica's engine stats
        (None for dead replicas — their engines are gone)."""
        out = dict(self.counters)
        out["replicas"] = self.n_replicas
        out["states"] = list(self.state)
        out["round"] = self._round
        out["results"] = len(self.results)
        out["routed_open"] = len(self._ledger) - len(self.results)
        out["standby"] = self.standby is not None
        out["per_replica"] = [
            self.replicas[r].stats() if self.state[r] != "dead" else None
            for r in range(self.n_replicas)]
        return out
