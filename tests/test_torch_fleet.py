"""The fleet, class quotas and the replica heartbeat on the port, held
against the JAX package.

The cells of ``tests/test_fleet.py`` for the ``lm`` family, on gemma-2b
smoke (``torch_parity.lifecycle_makers``): boundary validation; the
allocator's class quotas (the reference's cases on both allocators, and
random op sequences with equal ``state()``); heartbeat hysteresis;
routing; the primary killed at every fleet round, promoted from the
journal-tailing standby (dense and paged); a secondary's death with
exactly-once re-dispatch; a stalled replica escalating to dead; standby
lag; a BATCH flood against a REALTIME floor; stats.  Every scenario runs
on the JAX fleet (inside ``use_mesh(auto_mesh())``) and the port's CPU
fleet from the same numpy weights; results and counters must be equal.
The fleets' heartbeat monitors read ``torch_parity.FakeClock``, so no
verdict depends on the host's load.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from torch_parity import (FakeClock, auto_mesh, drain,  # noqa: E402
                          lifecycle_makers, rand_prompts)

from repro.dist.constrain import use_mesh  # noqa: E402

PAGED = dict(paged=True, page_size=4, num_pages=16)
PRIOS = ("batch", "realtime", None, "standard")
#: the counters both fleets must agree on (time_to_promote_s reads the
#: fake clock: 0.0 on both)
COUNTERS = ("routed", "deaths", "promotions", "redispatched", "suspects",
            "time_to_promote_s", "journal_lag_records")


def _pkg(pkg):
    """The fleet-side names of ``pkg``."""
    if pkg == "jax":
        from repro.ft import FleetFaultInjector
        from repro.launch.fleet import Fleet
    else:
        from repro_torch.ft import FleetFaultInjector
        from repro_torch.launch.fleet import Fleet
    return dict(Fleet=Fleet, Injector=FleetFaultInjector)


def _both(scenario, tmp_path=None, mode="none"):
    """``scenario(make, pkg, cfg, directory)`` on the JAX package and the
    port; the results must be equal.  Returns the port's."""
    cfg, make = lifecycle_makers(mode)
    with use_mesh(auto_mesh()):
        want = scenario(make["jax"], "jax", cfg,
                        None if tmp_path is None else tmp_path / "jax")
    got = scenario(make["torch"], "torch", cfg,
                   None if tmp_path is None else tmp_path / "torch")
    assert got == want
    return got


def _factory(make, **base):
    base.setdefault("batch", 2)
    base.setdefault("max_len", 32)

    def make_engine(**over):
        return make(clock=FakeClock(), **dict(base, **over))

    return make_engine


def _run_fleet(make, pkg, prompts, prios, *, n=1, standby_dir=None,
               inj=None, gen_len=6, block=4, fleet_kw=None, **eng_kw):
    fl = _pkg(pkg)["Fleet"](
        _factory(make, **eng_kw), n,
        standby_dir=None if standby_dir is None else str(standby_dir),
        fault_injector=inj, clock=FakeClock(), **(fleet_kw or {}))
    fids = [fl.submit(p, gen_len=gen_len, priority=prios[i])
            for i, p in enumerate(prompts)]
    fl.drain(block=block)
    return fl, fids


def _view(fl):
    """What both fleets must agree on: results, counters, states."""
    return ({f: (r["status"].value, r["tokens"])
             for f, r in sorted(fl.results.items())},
            {k: fl.counters[k] for k in COUNTERS}, list(fl.state),
            fl._round)


# ===========================================================================
class TestBoundaryValidation:
    @pytest.mark.parametrize("n", [0, -1])
    def test_non_positive_replicas(self, n):
        from repro_torch.launch.fleet import Fleet
        with pytest.raises(ValueError, match="n_replicas"):
            Fleet(lambda **kw: None, n)

    def test_negative_standby_lag(self):
        from repro_torch.launch.fleet import Fleet
        with pytest.raises(ValueError, match="max_standby_lag"):
            Fleet(lambda **kw: None, 1, max_standby_lag=-1)

    @pytest.mark.parametrize("quota,match", [
        ({"realtime": {"floor": 0.0}}, r"\(0, 1\]"),
        ({"realtime": {"floor": -0.25}}, r"\(0, 1\]"),
        ({"realtime": {"floor": 1.5}}, r"\(0, 1\]"),
        ({"realtime": {"ceiling": 0.5}}, "unknown class-quota keys"),
        ({"batch": {"floor": 0.8, "cap": 0.5}}, "floor"),
        ({"realtime": {"floor": 0.7}, "batch": {"floor": 0.7}}, "floor"),
        ({"realtime": {"floor": 0.2}, 0: {"floor": 0.2}}, "duplicate"),
    ])
    def test_quota_validation_matches_reference(self, quota, match):
        from repro.launch.lifecycle import normalize_class_quotas as jnorm
        from repro_torch.launch.lifecycle import normalize_class_quotas
        msgs = []
        for fn in (jnorm, normalize_class_quotas):
            with pytest.raises(ValueError, match=match) as e:
                fn(quota)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]

    def test_heartbeat_thresholds(self):
        from repro_torch.ft import ReplicaHeartbeat
        with pytest.raises(ValueError, match="positive"):
            ReplicaHeartbeat(suspect_after=0)
        with pytest.raises(ValueError, match="dead_after"):
            ReplicaHeartbeat(suspect_after=3, dead_after=3)

    def test_fleet_fault_kinds(self):
        from repro_torch.ft import FLEET_FAULT_KINDS, FleetFaultInjector
        assert FLEET_FAULT_KINDS == ("kill", "lag", "stall")
        inj = FleetFaultInjector({2: (1, "kill")})
        assert inj.schedule == {2: [(1, "kill")]}
        with pytest.raises(ValueError, match="unknown fleet fault kind"):
            FleetFaultInjector([(1, 0, "melt")])

    def test_engine_boundaries(self):
        cfg, make = lifecycle_makers()
        mk = _factory(make["torch"])
        with pytest.raises(ValueError, match="snapshot_every"):
            mk(snapshot_every=-1)
        with pytest.raises(ValueError, match="paged"):
            mk(class_quotas={"batch": {"cap": 0.5}})
        eng = mk(**PAGED, class_quotas={"batch": {"cap": 0.25}})
        with pytest.raises(ValueError, match="capped"):
            eng.submit(rand_prompts(cfg.vocab, (9,), seed=1)[0], gen_len=20,
                       priority="batch")

    def test_cli_quota_spec_parsing(self):
        from repro.launch.serve import _parse_class_quotas as jparse
        from repro_torch.launch.lifecycle import PriorityClass
        from repro_torch.launch.serve import _parse_class_quotas
        assert _parse_class_quotas(None) is None
        specs = ["realtime:floor=0.25", "batch:cap=0.5"]
        q = _parse_class_quotas(specs)
        assert q[PriorityClass.REALTIME]["floor"] == 0.25
        assert q[PriorityClass.BATCH]["cap"] == 0.5
        assert {c.name: v for c, v in q.items()} == \
            {c.name: v for c, v in jparse(specs).items()}
        for bad in ["realtime=0.25", "realtime:floor", "rt:floor=x"]:
            with pytest.raises(SystemExit):
                _parse_class_quotas([bad])


# ===========================================================================
def _alloc_case(A):
    """The reference's allocator-quota cases; returns what they observed."""
    out = []
    a = A(10, 4, class_quotas={"realtime": {"floor": 0.25},
                               "batch": {"cap": 0.05}})
    out.append((a.floor_pages("realtime"), a.cap_pages("batch"),
                a.cap_pages("realtime"), a.floor_pages("batch")))
    a = A(8, 4)
    pages = a.alloc(3, owner=0, cls="batch")
    out.append((a.class_used("batch"), a.can_alloc(5, cls="realtime")))
    a.free(pages)
    a = A(8, 4, class_quotas={"realtime": {"floor": 0.5}})
    pages = a.alloc(2, owner=0, cls="realtime")
    seen = [a.class_used("realtime")]
    a.share(pages)
    a.transfer(pages, "__prefix__")
    seen.append(a.class_used("realtime"))
    a.free(pages)
    seen.append(a.class_used("realtime"))
    a.free(pages)
    seen.append(a.class_used("realtime"))
    out.append(seen)
    a = A(8, 4, class_quotas={"realtime": {"floor": 0.5}})
    out.append((a.can_alloc(5, cls="batch"), a.can_alloc(4, cls="batch"),
                a.can_alloc(8, cls="realtime")))
    with pytest.raises(MemoryError, match="reserved"):
        a.alloc(5, owner=0, cls="batch")
    a = A(8, 4, class_quotas={"batch": {"cap": 0.5}})
    a.alloc(4, owner=0, cls="batch")
    with pytest.raises(MemoryError, match="batch over its page cap"):
        a.alloc(1, owner=1, cls="batch")
    out.append(a.can_alloc(4, cls="standard"))
    a = A(8, 4, class_quotas={"batch": {"cap": 0.5}})
    want = [a.quota_evict_want("batch", 2)]
    a.alloc(3, owner=0, cls="batch")
    want += [a.quota_evict_want("batch", 3), a.quota_evict_want("standard", 3),
             A(8, 4).quota_evict_want("batch", 99)]
    out.append(want)
    a = A(8, 4, class_quotas={"realtime": {"floor": 0.5}})
    a.alloc(2, owner=0, cls="realtime")
    a.alloc(1, owner=1, cls="batch")
    b = A(8, 4, class_quotas={"realtime": {"floor": 0.5}})
    b.load_state(a.state())
    out.append((b.class_used("realtime"), b.class_used("batch"), b.state()))
    a = A(8, 4)
    a.alloc(2, owner=0)
    st_ = a.state()
    st_.pop("cls", None)                        # a state without charges
    b = A(8, 4, class_quotas={"realtime": {"floor": 0.25}})
    b.load_state(st_)
    out.append((b.class_used("standard"), b.release_credit([0, 1, 5])))
    return out


def test_allocator_quotas_match_reference():
    from repro.launch.paging import PageAllocator as JAlloc
    from repro_torch.launch.paging import PageAllocator
    got = _alloc_case(PageAllocator)
    assert got == _alloc_case(JAlloc)
    assert got[0] == (3, 1, None, 0)            # ceil(2.5); max(1, 0.5)
    assert got[2] == [2, 2, 2, 0]               # the charge lives with the page
    assert got[3] == (False, True, True)
    assert got[5] == [0, 2, 0, 0]
    assert got[7][0] == 0                        # legacy state: uncharged


QUOTA_OPS = st.lists(st.tuples(
    st.sampled_from(["alloc", "share", "free", "transfer", "spill", "adopt",
                     "can_alloc", "violation", "evict_want"]),
    st.integers(0, 2 ** 16)), min_size=1, max_size=40)
QUOTAS = [{"realtime": {"floor": 0.25}, "batch": {"cap": 0.5}},
          {"standard": {"floor": 0.5, "cap": 0.75}},
          {"realtime": {"floor": 0.3}, "batch": {"floor": 0.2, "cap": 0.4}}]


@settings(max_examples=40, deadline=None)
@given(st.integers(2, 24), st.integers(0, len(QUOTAS) - 1), QUOTA_OPS)
def test_quota_allocator_matches_reference_ops(num_pages, qi, ops):
    """The same random op sequence, classes included, on both allocators
    with the same quotas: equal results, refusals, charges and states."""
    from repro.launch.paging import PageAllocator as JAlloc
    from repro_torch.launch.paging import PageAllocator
    ja = JAlloc(num_pages, 4, class_quotas=QUOTAS[qi])
    ta = PageAllocator(num_pages, 4, class_quotas=QUOTAS[qi])
    owners = [0, 1, "__prefix__"]
    classes = [None, "realtime", "standard", "batch"]
    for op, seed in ops:
        rs = np.random.RandomState(seed)
        held = sorted(ja._owner)
        owner = owners[rs.randint(len(owners))]
        cls = classes[rs.randint(len(classes))]
        n = int(rs.randint(1, num_pages + 1))
        if op == "alloc":
            args, kw = (n,), {"owner": owner, "cls": cls}
        elif op in ("share", "free", "transfer"):
            pick = [p for p in held if rs.rand() < 0.5]
            args, kw = ((pick, owner) if op == "transfer" else (pick,)), {}
        elif op == "spill":
            args, kw = (owner,), {}
        elif op == "adopt":
            args = ([p for p in sorted(ja._free) if rs.rand() < 0.3],)
            kw = {"owner": owner, "cls": cls}
        elif op == "can_alloc":
            args, kw = (n,), {"cls": cls}
        elif op == "violation":
            op, args, kw = "quota_violation", ({cls: n},), {}
        else:
            op, args, kw = "quota_evict_want", (cls, n), {}
        outs = []
        for a in (ja, ta):
            try:
                outs.append(("ok", getattr(a, op)(*args, **kw)))
            except (MemoryError, ValueError) as e:
                outs.append((type(e).__name__, str(e)))
        assert outs[0] == outs[1], (op, args, kw)
        assert ta.state() == ja.state()
        for c in classes[1:]:
            assert ta.class_used(c) == ja.class_used(c)
    clone = PageAllocator(num_pages, 4, class_quotas=QUOTAS[qi])
    clone.load_state(ja.state())
    assert clone.state() == ja.state()


# ===========================================================================
@pytest.mark.parametrize("beats", [
    (False, False, False, False, True),
    (False, False, True, True, False),
    (False, True, False, True, False, True, False),
    (False, False, True, False, True, True, False, False, False, False),
])
def test_heartbeat_hysteresis_matches_reference(beats):
    from repro.ft import ReplicaHeartbeat as JBeat
    from repro_torch.ft import ReplicaHeartbeat
    kw = dict(suspect_after=2, dead_after=4, recover_after=2)
    ja, ta = JBeat(**kw), ReplicaHeartbeat(**kw)
    got = [ta.beat(b) for b in beats]
    assert got == [ja.beat(b) for b in beats]
    if beats[:4] == (False,) * 4:
        assert got == ["alive", "suspect", "suspect", "dead", "dead"]


# ===========================================================================
def test_routing_spreads_load_and_avoids_suspects():
    def scenario(make, pkg, cfg, _):
        Fleet = _pkg(pkg)["Fleet"]
        prompts = rand_prompts(cfg.vocab, (9, 5, 12, 3), seed=41)
        fl = Fleet(_factory(make), 2, clock=FakeClock())
        fids = [fl.submit(p, gen_len=4) for p in prompts]
        homes = [fl._ledger[f]["replica"] for f in fids]
        assert sorted(homes) == [0, 0, 1, 1]
        fl.drain(block=4)
        fl2 = Fleet(_factory(make), 2, clock=FakeClock())
        fl2.state[1] = "suspect"
        pinned = [fl2._ledger[fl2.submit(p, gen_len=4)]["replica"]
                  for p in prompts[:2]]
        fl2.state[0] = "dead"
        last = fl2._ledger[fl2.submit(prompts[2], gen_len=4)]["replica"]
        fl2.state = ["dead", "dead"]
        with pytest.raises(RuntimeError, match="no live replicas"):
            fl2.submit(prompts[3], gen_len=4)
        return homes, _view(fl), pinned, last

    homes, _, pinned, last = _both(scenario)
    assert pinned == [0, 0] and last == 1


# ===========================================================================
PROMOTION_CELLS = [("dense", {}), ("paged", dict(PAGED))]


@pytest.mark.parametrize("cache,kw", PROMOTION_CELLS,
                         ids=[c for c, _ in PROMOTION_CELLS])
def test_kill_primary_at_every_round(tmp_path, cache, kw):
    """The primary killed at every fleet round: one promotion, and every
    stream equals the fault-free fleet's, exactly once."""
    def scenario(make, pkg, cfg, directory):
        Injector = _pkg(pkg)["Injector"]
        prompts = rand_prompts(cfg.vocab, (9, 5, 12, 3), seed=31)
        clean, fids = _run_fleet(make, pkg, prompts, PRIOS,
                                 standby_dir=directory / "clean", **kw)
        assert clean._round >= 3 and clean.counters["deaths"] == 0
        views = [_view(clean)]
        for rnd in range(1, clean._round + 1):
            inj = Injector([(rnd, 0, "kill")])
            fl, _ = _run_fleet(make, pkg, prompts, PRIOS,
                               standby_dir=directory / str(rnd), inj=inj,
                               **kw)
            assert fl.counters["promotions"] == 1
            assert set(fl.results) == set(fids), f"lost a stream @ {rnd}"
            for f in fids:
                assert fl.results[f] == clean.results[f], f"round {rnd}"
            assert fl.replicas[0].stats()["recoveries"] == 1
            views.append(_view(fl))
        return views

    _both(scenario, tmp_path)


def test_promote_without_standby_is_refused():
    from repro_torch.launch.fleet import Fleet
    cfg, make = lifecycle_makers()
    fl = Fleet(_factory(make["torch"]), 2, clock=FakeClock())
    with pytest.raises(RuntimeError, match="standby"):
        fl.promote()


# ===========================================================================
def test_secondary_death_redispatches_exactly_once():
    def scenario(make, pkg, cfg, _):
        Injector = _pkg(pkg)["Injector"]
        prompts = rand_prompts(cfg.vocab, (9, 5, 12, 3, 7, 8), seed=31)
        prios = ("batch", "realtime", None, "standard", "realtime", "batch")
        clean, fids = _run_fleet(make, pkg, prompts, prios, n=2)
        fl, _ = _run_fleet(make, pkg, prompts, prios, n=2,
                           inj=Injector([(1, 1, "kill")]))
        assert fl.counters["deaths"] == 1
        assert fl.counters["redispatched"] >= 1
        assert set(fl.results) == set(fids)
        for f in fids:
            assert fl.results[f]["tokens"] == clean.results[f]["tokens"]
        assert all(not e["redispatched"] or e["replica"] == 0
                   for e in fl._ledger.values())
        assert fl.replicas[1].cache is None or pkg == "jax"
        st = fl.stats()
        assert st["states"][1] == "dead" and st["per_replica"][1] is None
        assert st["results"] == len(fids) and st["routed_open"] == 0
        return _view(clean), _view(fl)

    _both(scenario)


def test_realtime_victims_redispatch_first():
    def scenario(make, pkg, cfg, _):
        fl = _pkg(pkg)["Fleet"](_factory(make), 2, clock=FakeClock())
        fl.state[0] = "suspect"                # pin three to replica 1
        prompts = rand_prompts(cfg.vocab, (9, 5, 7), seed=45)
        for p, prio in zip(prompts, ("batch", "realtime", "standard")):
            fl.submit(p, gen_len=4, priority=prio)
        fl.state[0] = "alive"
        order = []
        orig = fl.replicas[0].submit

        def spy(prompt, **kw):
            order.append(kw.get("priority"))
            return orig(prompt, **kw)

        fl.replicas[0].submit = spy
        fl._on_death(1)
        fl.drain(block=4)
        return order, _view(fl)

    order, view = _both(scenario)
    assert order == ["realtime", "standard", "batch"]
    assert len(view[0]) == 3


def test_stalled_replica_escalates_to_dead_and_work_moves():
    def scenario(make, pkg, cfg, _):
        Injector = _pkg(pkg)["Injector"]
        prompts = rand_prompts(cfg.vocab, (9, 5, 12, 3), seed=31)
        clean, fids = _run_fleet(make, pkg, prompts, PRIOS, n=2)
        fl, _ = _run_fleet(make, pkg, prompts, PRIOS, n=2,
                           inj=Injector([(r, 1, "stall")
                                         for r in range(1, 30)]))
        assert fl.state[1] == "dead" and fl.counters["suspects"] == 1
        for f in fids:
            assert fl.results[f]["tokens"] == clean.results[f]["tokens"]
        return _view(fl)

    _both(scenario)


# ===========================================================================
def test_standby_lag(tmp_path):
    """A lag spike defers one sync within the bound (then the primary
    dies and the standby catches up); a fault-free standby fleet drains
    caught up; a zero bound forces every sync."""
    def scenario(make, pkg, cfg, directory):
        Injector = _pkg(pkg)["Injector"]
        prompts = rand_prompts(cfg.vocab, (9, 5, 12, 3), seed=31)
        clean, fids = _run_fleet(make, pkg, prompts, PRIOS,
                                 standby_dir=directory / "clean")
        inj = Injector([(2, None, "lag"), (3, 0, "kill")])
        fl, _ = _run_fleet(make, pkg, prompts, PRIOS,
                           standby_dir=directory / "lag", inj=inj)
        assert "lag" in {k for (_, _, k) in inj.events}
        for f in fids:
            assert fl.results[f]["tokens"] == clean.results[f]["tokens"]
        two = rand_prompts(cfg.vocab, (9, 5), seed=52)
        calm, cf = _run_fleet(make, pkg, two, (None, "realtime"),
                              standby_dir=directory / "calm",
                              fleet_kw=dict(suspect_after=64,
                                            dead_after=128))
        assert calm.counters["deaths"] == calm.counters["promotions"] == 0
        assert calm.counters["journal_lag_records"] == 0 and not calm.busy()
        assert calm.replicas[0].stats()["journal_lag_records"] == 0
        inj0 = Injector([(r, None, "lag") for r in range(1, 20)])
        tight, _ = _run_fleet(make, pkg, two, (None, None),
                              standby_dir=directory / "tight", inj=inj0,
                              fleet_kw=dict(max_standby_lag=0))
        assert tight.counters["journal_lag_records"] == 0
        return _view(clean), _view(fl), _view(calm), _view(tight)

    _both(scenario, tmp_path)


# ===========================================================================
def test_batch_flood_cannot_take_realtime_floor_or_prefix():
    """A REALTIME request publishes its prompt pages; a flood of BATCH
    requests churns the pool under a REALTIME floor and a BATCH cap; the
    REALTIME pages survive, BATCH stays under its cap, the next REALTIME
    request hits; admissions per class are equal on both Engines."""
    def scenario(make, pkg, cfg, _):
        eng = _factory(make)(
            paged=True, page_size=4, num_pages=16, prefix_cache=True,
            class_quotas={"realtime": {"floor": 0.25},
                          "batch": {"cap": 0.5}})
        rs = np.random.RandomState(7)
        pre = rs.randint(0, cfg.vocab, (8,))
        cap_seen = []

        def run():
            eng.try_admit()
            while eng.live.any() or eng.waiting:
                eng.step_many(4)
                cap_seen.append(eng.allocator.class_used("batch"))
            eng.retire_finished()

        eng.submit(np.concatenate([pre, rs.randint(0, cfg.vocab, (3,))]),
                   gen_len=4, priority="realtime")
        run()
        rt_pages = set(eng.prefix_index.pages())
        assert rt_pages
        for i in range(8):
            eng.submit(rand_prompts(cfg.vocab, (9,), seed=100 + i)[0],
                       gen_len=6, priority="batch")
        run()
        assert rt_pages <= set(eng.prefix_index.pages())
        assert max(cap_seen) <= eng.allocator.cap_pages("batch")
        hits = eng.counters["prefix_hits"]
        eng.submit(np.concatenate([pre, rs.randint(0, cfg.vocab, (3,))]),
                   gen_len=4, priority="realtime")
        run()
        assert eng.counters["prefix_hits"] > hits
        admitted = {c.name.lower(): row["admitted"]
                    for c, row in eng.class_counters.items()}
        return eng.done, admitted, cap_seen, sorted(rt_pages)

    _, admitted, _, _ = _both(scenario)
    assert admitted == {"realtime": 2, "standard": 0, "batch": 8}


def test_flood_evicts_its_own_published_pages_to_stay_live():
    def scenario(make, pkg, cfg, _):
        eng = _factory(make)(paged=True, page_size=4, num_pages=16,
                             prefix_cache=True,
                             class_quotas={"batch": {"cap": 0.5}})
        for i in range(6):
            eng.submit(rand_prompts(cfg.vocab, (9,), seed=200 + i)[0],
                       gen_len=6, priority="batch")
        eng.try_admit()
        rounds = 0
        while eng.live.any() or eng.waiting:
            eng.step_many(4)
            rounds += 1
            assert rounds < 200, "admission deadlocked under the cap"
        eng.retire_finished()
        assert len(eng.done) == 6
        return eng.done, rounds

    _both(scenario)


def test_quota_snapshot_round_trips_charges():
    """Snapshot and restore (in memory and through a durable snapshot)
    carry the allocator's class charges."""
    cfg, make = lifecycle_makers()
    eng = _factory(make["torch"])(
        **PAGED, class_quotas={"realtime": {"floor": 0.25}})
    for p, c in zip(rand_prompts(cfg.vocab, (9, 5), seed=3),
                    ("realtime", "batch")):
        eng.submit(p, gen_len=6, priority=c)
    eng.try_admit()
    eng.step_many(2)
    snap = eng.snapshot()
    used = (eng.allocator.class_used("realtime"),
            eng.allocator.class_used("batch"))
    assert used[0] > 0 and used[1] > 0
    eng.step_many(4)
    eng.retire_finished()
    eng.restore(snap)
    assert (eng.allocator.class_used("realtime"),
            eng.allocator.class_used("batch")) == used


# ===========================================================================
def test_engine_and_fleet_stats(tmp_path):
    def scenario(make, pkg, cfg, directory):
        Injector = _pkg(pkg)["Injector"]
        st = _factory(make)().stats()
        assert st["uptime_s"] >= 0.0 and st["recoveries"] == 0
        assert st["journal_lag_records"] is None
        prompts = rand_prompts(cfg.vocab, (9, 5), seed=49)
        fl, _ = _run_fleet(make, pkg, prompts, (None, None),
                           standby_dir=directory,
                           inj=Injector([(1, 0, "kill")]))
        rst = fl.replicas[0].stats()
        fst = fl.stats()
        return (st["recoveries"], rst["recoveries"],
                rst["journal_lag_records"], fst["replicas"], fst["states"],
                fst["standby"], fst["results"], fst["routed_open"],
                _view(fl))

    got = _both(scenario, tmp_path)
    assert got[1] == 1 and got[5] is False


def test_realtime_head_is_admitted_inside_its_floor():
    """Where the port departs from the reference (ROADMAP.md, reference
    hazards): with free pages that the REALTIME floor reserves, a REALTIME
    head is admitted by the port; the reference's admission sweep checks
    the head with ``can_alloc`` and no class (STANDARD under quotas), so
    its own floor keeps it queued until the flood's pages come back."""
    def scenario(make, pkg, cfg, _):
        eng = _factory(make)(batch=4, **PAGED, class_quotas={
            "realtime": {"floor": 0.25}, "batch": {"cap": 0.75}})
        for p in rand_prompts(cfg.vocab, (9,) * 4, seed=300):
            eng.submit(p, gen_len=6, priority="batch")
        eng.try_admit()
        eng.step_many(1)
        rt = eng.submit(rand_prompts(cfg.vocab, (9,), seed=301)[0],
                        gen_len=6, priority="realtime")
        eng.try_admit()
        running = sorted(m["priority"].name for m in eng._req_meta.values())
        used = {c: eng.allocator.class_used(c) for c in ("realtime", "batch")}
        drain(eng, 4)
        return running, used, eng.results[rt]["tokens"]

    cfg, make = lifecycle_makers()
    with use_mesh(auto_mesh()):
        j_running, j_used, j_tokens = scenario(make["jax"], "jax", cfg, None)
    running, used, tokens = scenario(make["torch"], "torch", cfg, None)
    assert j_running == ["BATCH"] * 3 and j_used == {"realtime": 0,
                                                     "batch": 12}
    assert running == ["BATCH"] * 3 + ["REALTIME"]
    assert used == {"realtime": 4, "batch": 12}
    assert tokens == j_tokens          # the class changes when, not what
