"""Chaos on the port's Engine, held against the JAX Engine.

The cells of ``tests/test_chaos.py`` without the ``crash`` kind (its
recovery is the durable journal, ROADMAP.md queue 1, item 12b), on
gemma-2b smoke: under a fault schedule (``raise``, ``nan``, ``corrupt``,
``slow``) the port's streams equal its fault-free run's and the JAX
Engine's under the same schedule, with equal replay counts and injected
events; each kind alone; seeded random schedules; int8 weights; the
in-memory and on-disk snapshot round trips; the paths without recovery
(fault-lane slots finish FAILED, host faults propagate); and preempt and
spill over an overcommitted pool, byte-identical to an uncontended run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (auto_mesh, drain, lifecycle_makers,  # noqa: E402
                          rand_prompts, serve_engine)
# every reference Engine of the module reuses the XLA executables of
# the ones before it (torch_parity.reuse_xla_executables)
from torch_parity import reuse_executables  # noqa: E402,F401

from repro.dist.constrain import use_mesh  # noqa: E402

FULL_SCHEDULE = {1: "raise", 2: "nan", 3: "corrupt", 4: "slow"}
KINDS = ("raise", "nan", "corrupt", "slow")


def _injector(pkg, schedule):
    if pkg == "jax":
        from repro.ft import ServingFaultInjector
    else:
        from repro_torch.ft import ServingFaultInjector
    return ServingFaultInjector(schedule)


def _statuses(eng):
    return {k: v["status"].value for k, v in eng.results.items()}


def _both(scenario, mode="none"):
    """``scenario(make, pkg, cfg)`` on the JAX Engine and on the port's;
    results must be equal.  Returns the port's."""
    cfg, make = lifecycle_makers(mode)
    with use_mesh(auto_mesh()):
        want = scenario(make["jax"], "jax", cfg)
    got = scenario(make["torch"], "torch", cfg)
    assert got == want
    return got


# ===========================================================================
@pytest.mark.parametrize("cache,spec", [("dense", False), ("paged", False),
                                        ("paged", True), ("dense", True)])
def test_faulted_run_matches_fault_free(cache, spec):
    kw = dict(spec=spec)
    if cache == "paged":
        kw.update(paged=True, page_size=8)
    block = 1 if spec else 2

    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (9, 5, 12, 3))
        clean = serve_engine(make, prompts, gen_len=6, block=block, **kw)
        inj = _injector(pkg, FULL_SCHEDULE)
        chaos = serve_engine(make, prompts, gen_len=6, block=block,
                             fault_injector=inj, **kw)
        return (clean.done, chaos.done, _statuses(chaos),
                chaos.counters["replays"], sorted(k for _, k in inj.events))

    clean, chaos, statuses, replays, kinds = _both(scenario)
    assert chaos == clean
    assert set(statuses.values()) == {"completed"}
    assert replays == 3                     # raise, nan, corrupt: one each
    assert kinds == sorted(KINDS)


def test_each_kind_alone_is_invisible():
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (9, 5), seed=8)
        kw = dict(gen_len=6, block=2, paged=True, page_size=8)
        out = [serve_engine(make, prompts, **kw).done]
        for kind in KINDS:
            inj = _injector(pkg, {2: kind})
            eng = serve_engine(make, prompts, fault_injector=inj, **kw)
            out.append((eng.done, inj.events, eng.counters["replays"]))
        return out

    clean, *runs = _both(scenario)
    for kind, (done, events, replays) in zip(KINDS, runs):
        assert done == clean, kind
        assert events == [(2, kind)]
        assert replays == (0 if kind == "slow" else 1)


def test_randomized_seeded_schedules_conform():
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (9, 5, 12, 3), seed=9)
        kw = dict(gen_len=6, block=2, paged=True, page_size=8)
        out = [serve_engine(make, prompts, **kw).done]
        for seed in range(3):
            rs = np.random.RandomState(seed)
            sched = [(int(rs.randint(1, 9)), KINDS[rs.randint(len(KINDS))])
                     for _ in range(rs.randint(2, 5))]
            sched = list({rk: None for rk in sched})
            eng = serve_engine(make, prompts, fault_injector=_injector(
                pkg, sched), **kw)
            out.append((sched, eng.done, eng.counters["replays"]))
        return out

    clean, *runs = _both(scenario)
    for sched, done, _ in runs:
        assert done == clean, sched


def test_int8_weights_chaos():
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (9, 5), seed=10)
        kw = dict(gen_len=6, block=2, paged=True, page_size=8)
        clean = serve_engine(make, prompts, **kw)
        chaos = serve_engine(make, prompts, fault_injector=_injector(
            pkg, FULL_SCHEDULE), **kw)
        return clean.done, chaos.done, chaos.counters["replays"]

    clean, chaos, replays = _both(scenario, mode="int8")
    assert chaos == clean and replays == 3


def test_crash_kind_is_refused():
    """``crash`` is a fault kind (recovered across Engines from the
    durable journal, ``test_torch_warm_restart.py``); an unknown kind is
    still refused by name."""
    from repro_torch.ft import (CRASH_KIND, InjectedCrash,
                                ServingFaultInjector)
    inj = ServingFaultInjector({1: "crash"})
    assert inj.schedule == {1: [CRASH_KIND]}
    assert issubclass(InjectedCrash, BaseException)
    assert not issubclass(InjectedCrash, Exception)
    with pytest.raises(ValueError, match="unknown fault kind"):
        ServingFaultInjector({1: "melt"})


# ===========================================================================
def test_in_memory_round_trip_replays_identically():
    """snapshot, decode on, restore, decode again: both futures are equal,
    allocator free-list order and block tables included."""
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (9, 5, 12), seed=11)
        eng = make(batch=2, max_len=24, paged=True, page_size=4,
                   recover=True)
        for p in prompts:
            eng.submit(p, gen_len=6)
        eng.try_admit()
        eng.step_many(2)
        snap = eng.snapshot()

        def run_out():
            drain(eng, 2)
            return (list(eng.done),
                    {k: (v["status"].value, tuple(v["tokens"]))
                     for k, v in eng.results.items()},
                    eng.allocator.state(), eng.block_tables.tolist(),
                    eng.pos.tolist(), eng._gen_step)

        first = run_out()
        eng.restore(snap)
        rewound = (eng.pos.tolist() == snap["pos"].tolist(),
                   eng.allocator.state() == snap["allocator"],
                   len(eng.waiting) == len(snap["waiting"]))
        return first, rewound, run_out()

    first, rewound, second = _both(scenario)
    assert rewound == (True, True, True)
    assert first == second


def test_disk_snapshot_resumes_in_fresh_engine(tmp_path):
    """save_snapshot mid-stream, load it into a new Engine of the same
    arguments: the continuation is the original's."""
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (9, 5, 12), seed=12)
        kw = dict(batch=2, max_len=24, paged=True, page_size=4)
        d = str(tmp_path / pkg)
        eng = make(**kw)
        for p in prompts:
            eng.submit(p, gen_len=6)
        eng.try_admit()
        eng.step_many(2)
        eng.save_snapshot(d, step=7)
        drain(eng, 2)
        eng2 = make(**kw)
        eng2.load_snapshot(d)                 # the newest: step 7
        drain(eng2, 2)
        return (eng.done, eng2.done,
                {k: v["tokens"] for k, v in eng2.results.items()},
                {k: v["tokens"] for k, v in eng.results.items()},
                eng2.allocator.used_pages)

    done, done2, res2, res, used = _both(scenario)
    assert done2 == done and res2 == res and used == 0


def test_load_snapshot_missing_raises(tmp_path):
    def scenario(make, pkg, cfg):
        eng = make(batch=2, max_len=24)
        with pytest.raises(FileNotFoundError):
            eng.load_snapshot(str(tmp_path / "nope"))
        return True

    _both(scenario)


# ===========================================================================
def test_device_fault_fails_slots_with_partial_output():
    """recover=False: a NaN-poisoned block freezes the slots on the device
    and they finish FAILED with their valid prefix, no exception."""
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (9, 5), seed=13)
        eng = make(batch=2, max_len=24,
                   fault_injector=_injector(pkg, {2: "nan"}), recover=False)
        ids = [eng.submit(p, gen_len=6) for p in prompts]
        eng.try_admit()
        eng.step_many(2)
        eng.step_many(2)
        return ([eng.status(r).value for r in ids],
                [eng.results[r]["tokens"] for r in ids],
                eng.counters["failures"], eng.counters["replays"])

    statuses, tokens, failures, replays = _both(scenario)
    assert statuses == ["failed", "failed"]
    assert [len(t) for t in tokens] == [2, 2]
    assert failures == 2 and replays == 0


@pytest.mark.parametrize("kind,error", [("raise", "InjectedFault"),
                                        ("corrupt", "PageCorruptionError")])
def test_host_fault_propagates_without_recovery(kind, error):
    def scenario(make, pkg, cfg):
        eng = make(batch=2, max_len=24,
                   fault_injector=_injector(pkg, {1: kind}), recover=False)
        eng.submit(rand_prompts(cfg.vocab, (6,))[0], gen_len=4)
        eng.try_admit()
        with pytest.raises(RuntimeError) as e:
            eng.step_many(2)
        return type(e.value).__name__

    assert _both(scenario) == error


# ===========================================================================
def test_seed_path_raises_where_preempt_completes():
    """Direct admission onto an exhausted pool raises MemoryError without
    preemption; with it a victim spills, the newcomer runs, the victim
    resumes, and every stream matches an uncontended pool's."""
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (10, 10, 10), seed=14)
        kw = dict(batch=3, max_len=24, paged=True, page_size=4, num_pages=8)
        seed_eng = make(**kw)
        seed_eng.add_requests({0: prompts[0], 1: prompts[1]}, gen_len=6)
        with pytest.raises(MemoryError, match="exhausted"):
            seed_eng.add_requests({2: prompts[2]}, gen_len=6)
        eng = make(preempt=True, **kw)
        eng.add_requests({0: prompts[0], 1: prompts[1]}, gen_len=6)
        eng.add_requests({2: prompts[2]}, gen_len=6)
        mid = (eng.counters["preemptions"], len(eng.waiting))
        drain(eng, 2)
        ample = serve_engine(make, prompts, gen_len=6, max_len=24, batch=3,
                             paged=True, page_size=4, num_pages=12, block=2)
        return (mid, sorted(map(tuple, eng.done)),
                sorted(map(tuple, ample.done)), _statuses(eng),
                eng.allocator.used_pages)

    mid, done, ample, statuses, used = _both(scenario)
    assert mid == (1, 1) and done == ample and used == 0
    assert set(statuses.values()) == {"completed"}


def test_bursty_overcommit_streams_are_byte_identical():
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (10, 10, 10, 10), seed=15)
        eng = make(batch=3, max_len=24, paged=True, page_size=4,
                   num_pages=8, preempt=True, preempt_after=2)
        ids = [eng.submit(p, gen_len=6) for p in prompts]
        eng.try_admit()
        seen = set()
        while eng.live.any() or eng.waiting:
            eng.step_many(2)
            seen.update(eng.status(i).value for i in ids)
        eng.retire_finished()
        ref = serve_engine(make, prompts, gen_len=6, max_len=24, batch=3,
                           paged=True, page_size=4, num_pages=16, block=2)
        return ([eng.results[r]["tokens"] for r in ids],
                [ref.results[r]["tokens"] for r in ids],
                eng.counters["preemptions"], eng.counters["spilled_pages"],
                "preempted" in seen,
                [eng.status(i).value for i in ids])

    got, ref, pre, spilled, seen, statuses = _both(scenario)
    assert got == ref and pre > 0 and spilled > 0 and seen
    assert statuses == ["completed"] * 4


def test_preempt_requires_paged():
    def scenario(make, pkg, cfg):
        with pytest.raises(ValueError, match="paged"):
            make(batch=2, max_len=24, preempt=True)
        with pytest.raises(ValueError, match="paged"):
            make(batch=2, max_len=24, prefix_cache=True)
        return True

    _both(scenario)


def test_preempt_under_chaos_still_conforms():
    """Spills and replays in one run; streams equal the uncontended
    fault-free run's."""
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (10, 10, 10, 10), seed=16)
        eng = make(batch=3, max_len=24, paged=True, page_size=4,
                   num_pages=8, preempt=True, preempt_after=2,
                   fault_injector=_injector(pkg, {2: "raise", 3: "nan"}))
        ids = [eng.submit(p, gen_len=6) for p in prompts]
        eng.try_admit()
        drain(eng, 2)
        ref = serve_engine(make, prompts, gen_len=6, max_len=24, batch=3,
                           paged=True, page_size=4, num_pages=16, block=2)
        return ([eng.results[r]["tokens"] for r in ids],
                [ref.results[r]["tokens"] for r in ids],
                eng.counters["replays"], eng.counters["preemptions"])

    got, ref, replays, pre = _both(scenario)
    assert got == ref and replays == 2 and pre > 0


def test_engine_refuses_journal_and_quotas(tmp_path):
    """The durable journal and class quotas are accepted; their bad
    values are refused by name (a negative snapshot period, quotas on a
    dense cache, a floor over its cap)."""
    from repro_torch.launch.paging import PageAllocator
    cfg, make = lifecycle_makers()
    eng = make["torch"](batch=2, max_len=24, durable_dir=str(tmp_path),
                        snapshot_every=2)
    assert eng._journal is not None and eng.snapshot_every == 2
    eng = make["torch"](batch=2, max_len=24, paged=True,
                        class_quotas={"realtime": {"floor": 0.5}})
    assert eng.allocator.class_quotas
    assert PageAllocator(8, 4, class_quotas={
        "realtime": {"floor": 0.5}}).floor_pages("realtime") == 4
    with pytest.raises(ValueError, match="snapshot_every"):
        make["torch"](batch=2, max_len=24, snapshot_every=-1)
    with pytest.raises(ValueError, match="paged"):
        make["torch"](batch=2, max_len=24,
                      class_quotas={"realtime": {"floor": 0.5}})
    with pytest.raises(ValueError, match="floor"):
        PageAllocator(8, 4, class_quotas={
            "batch": {"floor": 0.8, "cap": 0.5}})
