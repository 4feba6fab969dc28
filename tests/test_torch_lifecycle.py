"""The request lifecycle on the port's Engine, held against the JAX Engine.

The cells of ``tests/test_serving_lifecycle.py`` and
``tests/test_priority.py`` on gemma-2b smoke: request validation, status
and results, cancel, deadlines on a fake clock, the straggler monitor,
pressure shedding, the blocked-head escalation counter, throughput rows,
priority classes (admission order, victim order and class floor, the
TTFT escalation), SLO shedding and the per-class stats.  Each scenario
runs on the JAX Engine (on an Auto mesh) and on the port's Engine on the
CPU; the statuses, streams and lifecycle counters must be equal.  Times
are compared only where the scenario fixes them: the straggler cells run
on a fake clock that ticks per read, so every block takes the same time on
both Engines and only the injected slow block stands out.
"""

import enum

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (FakeClock, auto_mesh, drain,  # noqa: E402
                          lifecycle_makers, rand_prompts, serve_engine)
# every reference Engine of the module reuses the XLA executables of
# the ones before it (torch_parity.reuse_xla_executables)
from torch_parity import reuse_executables  # noqa: E402,F401

from repro.dist.constrain import use_mesh  # noqa: E402

#: compared after every scenario (straggler counts only on fake clocks:
#: on the wall clock they follow the host's load)
LIFECYCLE_KEYS = ("admitted", "gen_tokens", "preemptions", "cancellations",
                  "timeouts", "failures", "replays", "spilled_pages",
                  "shed_spec_rounds")
PAGED = dict(paged=True, page_size=4, prefill_chunk=5)


def _plain(x):
    """Enums as their values, containers recursively (both packages'
    statuses and classes compare as plain values)."""
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _both(scenario, *args, mode="none"):
    """Run ``scenario(make, pkg, *args)`` on the JAX Engine and on the
    port's (``pkg`` is the package's module namespace); their plain
    results must be equal.  Returns the port's."""
    cfg, make = lifecycle_makers(mode)
    with use_mesh(auto_mesh()):
        want = _plain(scenario(make["jax"], _pkg("repro"), cfg, *args))
    got = _plain(scenario(make["torch"], _pkg("repro_torch"), cfg, *args))
    assert got == want
    return got


def _pkg(name):
    """The lifecycle names of ``repro`` or ``repro_torch``."""
    import importlib
    lc = importlib.import_module(f"{name}.launch.lifecycle")
    ft = importlib.import_module(f"{name}.ft")
    return type("Pkg", (), dict(
        RequestStatus=lc.RequestStatus, PriorityClass=lc.PriorityClass,
        ServingFaultInjector=ft.ServingFaultInjector,
        StragglerMonitor=ft.StragglerMonitor))


def _counters(eng):
    return {k: eng.counters[k] for k in LIFECYCLE_KEYS}


# ===========================================================================
BAD_SUBMITS = {
    "negative temperature": ((4,), dict(temperature=-0.5), "temperature"),
    "negative top_k": ((4,), dict(top_k=-3), "top_k"),
    "non-integer ids": (np.array([1.0, 2.5, 3.0]), {}, "integer"),
    "id == vocab": ("vocab", {}, "vocab"),
    "negative id": (np.array([-1, 0], np.int32), {}, "vocab"),
    "zero deadline": ((4,), dict(deadline_s=0.0), "deadline"),
    "unknown class": ((4,), dict(priority="urgent"), "priority"),
    "class out of range": ((4,), dict(priority=-1), "out of range"),
}


@pytest.mark.parametrize("case", list(BAD_SUBMITS))
def test_rejects_malformed_submit(case):
    """Each rejection class raises at submit() on both Engines and leaves
    the queue empty."""
    prompt, kw, match = BAD_SUBMITS[case]

    def scenario(make, pkg, cfg):
        p = prompt
        if isinstance(p, tuple):
            p = rand_prompts(cfg.vocab, p)[0]
        elif isinstance(p, str):
            p = np.array([0, cfg.vocab], np.int32)
        eng = make(batch=2, max_len=24)
        with pytest.raises(ValueError, match=match):
            eng.submit(p, **kw)
        return len(eng.waiting)

    assert _both(scenario) == 0


@pytest.mark.parametrize("targets,match", [
    ({"realtime": {"ttft_s": 0.0}}, "positive"),
    ({"realtime": {"latency": 1.0}}, "unknown SLO target"),
    ({"urgent": {"ttft_s": 1.0}}, "priority"),
    ({"realtime": 0.5}, "must be a dict")])
def test_rejects_bad_slo_targets(targets, match):
    def scenario(make, pkg, cfg):
        with pytest.raises(ValueError, match=match):
            make(batch=2, max_len=24, slo_targets=targets)
        return True

    _both(scenario)


def test_validation_functions_match_reference():
    """``validate_request``, ``coerce_priority`` and
    ``normalize_slo_targets`` agree with the reference's on accepted and
    refused inputs alike."""
    from repro.launch import lifecycle as jl
    from repro_torch.launch import lifecycle as tl
    out = tl.validate_request([3, 1, 4], vocab=10, temperature=0.7,
                              top_k=5, deadline_s=1.0)
    assert out.dtype == np.int32 and out.tolist() == [3, 1, 4]
    for kw in (dict(temperature={0: 0.5, 1: -1.0}),
               dict(deadline_s={0: 1.0, 1: -2.0}),
               dict(priority={0: "batch", 1: "nope"})):
        for lc in (jl, tl):
            with pytest.raises(ValueError):
                lc.validate_request([1], vocab=10, **kw)
    tl.validate_request([], vocab=64, deadline_s={0: 1.0, 1: None})
    for v in (None, "batch", "ReAlTiMe", 1, np.int64(2), jl.PriorityClass.BATCH,
              tl.PriorityClass.REALTIME, "urgent", 3, -1, True, 1.5, [0],
              {"cls": 0}):
        outs = []
        for lc in (jl, tl):
            try:
                outs.append(int(lc.coerce_priority(v)))
            except ValueError as e:
                outs.append(str(e))
        assert outs[0] == outs[1], v
    assert tl.PriorityClass.REALTIME < tl.PriorityClass.STANDARD \
        < tl.PriorityClass.BATCH
    for t in (None, {"realtime": None}, {"realtime": {"ttft_s": None}},
              {"realtime": {"ttft_s": 0.5}, 2: {"tok_per_s": 3}}):
        assert _plain(tl.normalize_slo_targets(t)) \
            == _plain(jl.normalize_slo_targets(t))
    row = tl.request_row(ttft_s=1.0, gen_tokens=3, decode_s=0.0,
                         status=tl.RequestStatus.COMPLETED, priority="batch")
    assert row == _plain(jl.request_row(
        ttft_s=1.0, gen_tokens=3, decode_s=0.0,
        status=jl.RequestStatus.COMPLETED, priority="batch"))
    assert row["tok_per_s"] is None


def test_direct_add_requests_validates_too():
    def scenario(make, pkg, cfg):
        eng = make(batch=2, max_len=24)
        with pytest.raises(ValueError, match="vocab"):
            eng.add_requests({0: np.array([cfg.vocab], np.int32)},
                             gen_len=2)
        return bool(eng.live.any())

    assert _both(scenario) is False


# ===========================================================================
def test_lifecycle_queued_running_completed():
    def scenario(make, pkg, cfg):
        eng = make(batch=2, max_len=24)
        ids = [eng.submit(p, gen_len=4)
               for p in rand_prompts(cfg.vocab, (6, 6, 6))]
        seen = [[eng.status(i) for i in ids]]
        eng.try_admit()
        seen.append([eng.status(i) for i in ids])
        drain(eng)
        seen.append([eng.status(i) for i in ids])
        return (ids, seen, [eng.results[i]["tokens"] for i in ids],
                eng.done, eng.status(999), _counters(eng))

    ids, seen, tokens, done, unknown, _ = _both(scenario)
    assert ids == [0, 1, 2]
    assert seen == [["queued"] * 3, ["running", "running", "queued"],
                    ["completed"] * 3]
    assert tokens == done and unknown is None


def test_stats_surface_lifecycle_counters():
    def scenario(make, pkg, cfg):
        eng = make(batch=2, max_len=24, clock=FakeClock(tick=1e-3))
        eng.submit(rand_prompts(cfg.vocab, (4,))[0], gen_len=2)
        drain(eng, 2)
        st = eng.stats()
        keys = ("queued", "preemptions", "cancellations", "timeouts",
                "failures", "replays", "spilled_pages", "shed_spec_rounds",
                "straggler_blocks", "straggler_events")
        return {k: st[k] for k in keys}

    assert _both(scenario)["queued"] == 0


# ===========================================================================
def test_cancel_queued_request():
    def scenario(make, pkg, cfg):
        eng = make(batch=2, max_len=24)
        rid = eng.submit(rand_prompts(cfg.vocab, (4,))[0], gen_len=4)
        ok = eng.cancel(rid)
        return (ok, len(eng.waiting), eng.status(rid),
                eng.results[rid]["tokens"], eng.cancel(rid), _counters(eng))

    ok, waiting, status, tokens, again, c = _both(scenario)
    assert (ok, waiting, status, tokens, again) == \
        (True, 0, "cancelled", [], False)
    assert c["cancellations"] == 1


def test_cancel_running_keeps_partial_output_and_recycles_lane():
    """A cancelled lane serves the next request as a fresh engine would."""
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (8, 8), seed=4)
        eng = make(batch=1, max_len=24)
        rid0 = eng.submit(prompts[0], gen_len=12)
        rid1 = eng.submit(prompts[1], gen_len=6)
        eng.try_admit()
        eng.step_many(3)
        ok = eng.cancel(rid0)
        mid = (eng.status(rid0), list(eng.results[rid0]["tokens"]))
        drain(eng)
        solo = make(batch=1, max_len=24)
        solo.submit(prompts[1], gen_len=6)
        drain(solo)
        return ok, mid, eng.results[rid1]["tokens"], solo.done[0], \
            eng.status(rid1)

    ok, (status, partial), tokens, solo, status1 = _both(scenario)
    assert ok and status == "cancelled" and len(partial) == 3
    assert tokens == solo and status1 == "completed"


def test_cancel_running_paged_frees_pages():
    def scenario(make, pkg, cfg):
        eng = make(batch=2, max_len=24, num_pages=12, **PAGED)
        rid = eng.submit(rand_prompts(cfg.vocab, (8,))[0], gen_len=8)
        eng.try_admit()
        used = eng.allocator.used_pages
        eng.step_many(2)
        return used, eng.cancel(rid), eng.allocator.used_pages, \
            eng.cancel(123)

    used, ok, after, unknown = _both(scenario)
    assert used > 0 and ok and after == 0 and not unknown


# ===========================================================================
def test_queued_request_times_out_without_a_lane():
    def scenario(make, pkg, cfg):
        clock = FakeClock()
        prompts = rand_prompts(cfg.vocab, (6, 6), seed=5)
        eng = make(batch=1, max_len=24, clock=clock)
        rid0 = eng.submit(prompts[0], gen_len=8)
        rid1 = eng.submit(prompts[1], gen_len=4, deadline_s=5.0)
        eng.try_admit()
        clock.advance(10.0)
        eng.step_many(2)
        return (eng.status(rid1), eng.results[rid1]["tokens"],
                eng.status(rid0), _counters(eng))

    status1, tokens1, status0, c = _both(scenario)
    assert (status1, tokens1, status0) == ("timed_out", [], "running")
    assert c["timeouts"] == 1


def test_running_request_times_out_with_partial_output():
    def scenario(make, pkg, cfg):
        clock = FakeClock()
        eng = make(batch=2, max_len=24, clock=clock)
        rid = eng.submit(rand_prompts(cfg.vocab, (6,))[0], gen_len=16,
                         deadline_s=5.0)
        eng.try_admit()
        eng.step_many(3)
        clock.advance(10.0)
        eng.step_many(1)
        return eng.status(rid), eng.results[rid]["tokens"], _counters(eng)

    status, tokens, c = _both(scenario)
    assert status == "timed_out" and len(tokens) == 3
    assert c["timeouts"] == 1


def test_dict_deadlines_apply_per_request():
    def scenario(make, pkg, cfg):
        clock = FakeClock()
        prompts = rand_prompts(cfg.vocab, (6, 6), seed=7)
        eng = make(batch=2, max_len=24, clock=clock)
        eng.add_requests({0: prompts[0], 1: prompts[1]}, gen_len=8,
                         deadline_s={0: 5.0, 1: None})
        eng.step_many(2)
        clock.advance(10.0)
        drain(eng, 2)
        return sorted((r["status"], r["tokens"])
                      for r in eng.results.values()), _counters(eng)

    rows, c = _both(scenario)
    by_status = dict(rows)
    assert c["timeouts"] == 1
    assert 0 < len(by_status["timed_out"]) < 8
    assert len(by_status["completed"]) == 8


def test_no_deadline_and_finished_unretired_slot():
    """No deadline, no timeout; a slot whose generation ended before its
    TTL passed finishes COMPLETED although it retires later."""
    def scenario(make, pkg, cfg):
        clock = FakeClock()
        eng = make(batch=2, max_len=24, clock=clock)
        rid = eng.submit(rand_prompts(cfg.vocab, (6,))[0], gen_len=4)
        clock.advance(1e6)
        drain(eng, 2)
        eng2 = make(batch=2, max_len=24, clock=clock)
        rid2 = eng2.submit(rand_prompts(cfg.vocab, (6,))[0], gen_len=2,
                           deadline_s=50.0)
        eng2.try_admit()
        eng2.step_many(4)
        live = bool(eng2.live.any())
        clock.advance(100.0)
        eng2.step_many(1)
        eng2.retire_finished()
        return eng.status(rid), live, eng2.status(rid2)

    assert _both(scenario) == ("completed", False, "completed")


# ===========================================================================
def test_injected_slow_block_is_flagged():
    def scenario(make, pkg, cfg):
        eng = make(batch=2, max_len=24, clock=FakeClock(tick=1e-3),
                   fault_injector=pkg.ServingFaultInjector({8: "slow"}),
                   straggler=pkg.StragglerMonitor(window=8, ratio=1.5,
                                                  patience=1))
        eng.submit(rand_prompts(cfg.vocab, (4,))[0], gen_len=12)
        eng.try_admit()
        for _ in range(12):
            if not (eng.live.any() or eng.waiting):
                break
            eng.step_many(1)
        st = eng.stats()
        return (eng.fault_injector.events, st["straggler_blocks"] >= 1,
                bool(st["straggler_events"]),
                8 in [r for r, _ in eng.straggler.events], eng.done)

    events, flagged, has_events, eight, _ = _both(scenario)
    assert events == [(8, "slow")] and flagged and has_events and eight


def test_clean_run_flags_nothing():
    def scenario(make, pkg, cfg):
        eng = make(batch=2, max_len=24, clock=FakeClock(tick=1e-3),
                   straggler=pkg.StragglerMonitor(window=8, ratio=100.0,
                                                  patience=1))
        eng.submit(rand_prompts(cfg.vocab, (4,))[0], gen_len=10)
        drain(eng, 1)
        return eng.stats()["straggler_blocks"], eng.straggler.events

    assert _both(scenario) == (0, [])


# ===========================================================================
def test_shed_blocks_keep_streams_identical():
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (8, 6, 9), seed=6)
        kw = dict(gen_len=6, max_len=24, num_pages=12, **PAGED)
        base = serve_engine(make, prompts, **kw)
        shed = serve_engine(make, prompts, shed_threshold=0.25, **kw)
        return base.done, shed.done, _counters(shed)

    base, shed, _ = _both(scenario)
    assert shed == base


def test_shed_drops_speculation_under_pressure():
    """Shed spec rounds run as plain blocks, which feed the drafting
    history on the host; streams stay the plain dense Engine's."""
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (8, 8), seed=7)
        dense = serve_engine(make, prompts, gen_len=6, max_len=24)
        shed = serve_engine(make, prompts, gen_len=6, max_len=24,
                            num_pages=8, spec=True, shed_threshold=0.1,
                            **PAGED)
        return dense.done, shed.done, _counters(shed), shed.hist.tolist()

    dense, shed, c, _ = _both(scenario)
    assert shed == dense and c["shed_spec_rounds"] > 0


def test_interleaved_pop_does_not_reset_blocked_head():
    """The escalation counter tracks one head per class; popping another
    record leaves it, and escalation fires on schedule."""
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (10, 12, 3), seed=8)
        eng = make(batch=2, clock=FakeClock(), num_pages=8, max_len=24,
                   preempt=True, preempt_after=3, **PAGED)
        trail = []
        rid_a = eng.submit(prompts[0], gen_len=6)
        eng.try_admit()
        rid_b = eng.submit(prompts[1], gen_len=8)
        eng.try_admit()
        trail.append(dict(eng._head_blocked))
        rid_c = eng.submit(prompts[2], gen_len=2)
        eng.waiting.appendleft(eng.waiting.pop())
        eng.try_admit()
        trail.append((eng.status(rid_c), dict(eng._head_blocked)))
        eng.cancel(rid_c)
        eng.try_admit()
        trail.append((dict(eng._head_blocked), eng.counters["preemptions"]))
        eng.try_admit()
        trail.append((eng.counters["preemptions"], eng.status(rid_a),
                      eng.status(rid_b), dict(eng._head_blocked)))
        drain(eng)
        return trail, eng.status(rid_a), eng.status(rid_b), \
            [eng.results[r]["tokens"] for r in (rid_a, rid_b)]

    trail, a, b, _ = _both(scenario)
    std = 1
    assert trail[0] == {std: (1, 1)}
    assert trail[1] == ("running", {std: (1, 1)})
    assert trail[2] == ({std: (1, 2)}, 0)
    assert trail[3] == (1, "preempted", "running", {std: (0, 1)})
    assert (a, b) == ("completed", "completed")


def test_throughput_rows_on_fake_clocks():
    """``tok_per_s`` is None, not 0.0, when the decode interval is not
    measurable; the aggregates skip such rows."""
    def scenario(make, pkg, cfg):
        clock = FakeClock()
        eng = make(batch=2, max_len=24, clock=clock)
        eng.submit(rand_prompts(cfg.vocab, (4,))[0], gen_len=3)
        drain(eng, 3)
        st0 = eng.stats()
        clock.tick = 0.05
        eng.submit(rand_prompts(cfg.vocab, (5,))[0], gen_len=3)
        drain(eng, 3)
        frozen, ticking = eng.request_log
        return (frozen["decode_s"], frozen["tok_per_s"],
                ticking["tok_per_s"] > 0, st0["decode_tok_per_s"],
                st0["gen_tokens"])

    assert _both(scenario) == (0.0, None, True, None, 3)


# ===========================================================================
def test_realtime_overtakes_fifo():
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (5, 5, 5), seed=11)
        eng = make(batch=1, max_len=24)
        rid_b = eng.submit(prompts[0], gen_len=2, priority="batch")
        rid_s = eng.submit(prompts[1], gen_len=2)
        rid_r = eng.submit(prompts[2], gen_len=2, priority="realtime")
        eng.try_admit()
        mid = (eng.status(rid_r), eng.status(rid_s))
        drain(eng, 2)
        return mid, [eng.results[r]["tokens"] for r in (rid_r, rid_s, rid_b)], \
            eng.done

    mid, order, done = _both(scenario)
    assert mid == ("running", "queued") and order == done


def test_fifo_within_class_and_single_class_queue():
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (5, 5, 5), seed=12)
        eng = make(batch=1, max_len=24)
        ids = [eng.submit(p, gen_len=2, priority="batch") for p in prompts]
        drain(eng, 2)
        runs = [[eng.results[r]["tokens"] for r in ids], eng.done]
        prompts = rand_prompts(cfg.vocab, (9, 5, 12, 3), seed=0)
        for prio in (None, "realtime", "batch"):
            e = make(batch=2, max_len=32)
            for p in prompts:
                e.submit(p, gen_len=6, priority=prio)
            runs.append(drain(e).done)
        return runs

    runs = _both(scenario)
    assert runs[0] == runs[1] and runs[2] == runs[3] == runs[4]


def test_blocked_head_blocks_lower_classes():
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (10, 3), seed=13)
        eng = make(batch=3, max_len=24, num_pages=6, **PAGED)
        rid_live = eng.submit(rand_prompts(cfg.vocab, (6,), seed=9)[0],
                              gen_len=4)
        eng.try_admit()
        rid_rt = eng.submit(prompts[0], gen_len=8, priority="realtime")
        rid_bat = eng.submit(prompts[1], gen_len=2, priority="batch")
        eng.try_admit()
        mid = [eng.status(r) for r in (rid_live, rid_rt, rid_bat)]
        drain(eng)
        return mid, [eng.status(r) for r in (rid_live, rid_rt, rid_bat)], \
            eng.done

    mid, end, _ = _both(scenario)
    assert mid == ["running", "queued", "queued"]
    assert end == ["completed"] * 3


def test_mixed_classes_keep_stream_content():
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (9, 5, 12, 3), seed=0)
        base = serve_engine(make, prompts)
        pri = make(batch=2, max_len=32)
        for p, cls in zip(prompts, ("batch", "realtime", "standard",
                                    "batch")):
            pri.submit(p, gen_len=6, priority=cls)
        drain(pri)
        return base.done, pri.done

    base, pri = _both(scenario)
    assert sorted(pri) == sorted(base)


# ===========================================================================
def _pressure(make, **kw):
    kw = dict(dict(num_pages=8, preempt=True, preempt_after=1, max_len=24,
                   **PAGED), **kw)
    return make(**kw)


def test_batch_spills_before_realtime():
    def scenario(make, pkg, cfg):
        eng = _pressure(make, batch=3)
        rid_bat = eng.submit(rand_prompts(cfg.vocab, (8,), seed=14)[0],
                             gen_len=6, priority="batch")
        rid_rt = eng.submit(rand_prompts(cfg.vocab, (8,), seed=15)[0],
                            gen_len=6, priority="realtime")
        eng.try_admit()
        rid_std = eng.submit(rand_prompts(cfg.vocab, (10,), seed=16)[0],
                             gen_len=6, priority="standard")
        eng.try_admit()
        mid = [eng.status(r) for r in (rid_bat, rid_rt, rid_std)]
        rows = {int(c): dict(r) for c, r in eng.class_counters.items()}
        drain(eng)
        return mid, rows, [eng.status(r) for r in (rid_bat, rid_rt, rid_std)], \
            [eng.results[r]["tokens"] for r in (rid_bat, rid_rt, rid_std)]

    mid, rows, end, _ = _both(scenario)
    assert mid == ["preempted", "running", "running"]
    assert rows[2]["preemptions"] == 1 and rows[0]["preemptions"] == 0
    assert end == ["completed"] * 3


def test_class_floor_lower_head_cannot_spill_higher():
    def scenario(make, pkg, cfg):
        eng = _pressure(make, batch=3)
        rid_rt = eng.submit(rand_prompts(cfg.vocab, (8,), seed=17)[0],
                            gen_len=6, priority="realtime")
        rid_std = eng.submit(rand_prompts(cfg.vocab, (8,), seed=18)[0],
                             gen_len=6)
        eng.try_admit()
        rid_bat = eng.submit(rand_prompts(cfg.vocab, (10,), seed=19)[0],
                             gen_len=6, priority="batch")
        for _ in range(4):
            eng.try_admit()
        mid = ([eng.status(r) for r in (rid_bat, rid_rt, rid_std)],
               eng.counters["preemptions"])
        drain(eng)
        return mid, [eng.status(r) for r in (rid_rt, rid_std, rid_bat)]

    (mid, pre), end = _both(scenario)
    assert mid == ["queued", "running", "running"] and pre == 0
    assert end == ["completed"] * 3


def test_ttft_slo_escalates_immediately():
    def scenario(make, pkg, cfg):
        clock = FakeClock()
        eng = _pressure(make, batch=2, preempt_after=50, clock=clock,
                        slo_targets={"realtime": {"ttft_s": 5.0}})
        rid_bat = eng.submit(rand_prompts(cfg.vocab, (8,), seed=20)[0],
                             gen_len=8, priority="batch")
        eng.try_admit()
        rid_rt = eng.submit(rand_prompts(cfg.vocab, (12,), seed=21)[0],
                            gen_len=8, priority="realtime")
        clock.advance(10.0)
        eng.try_admit()
        mid = (eng.status(rid_rt), eng.status(rid_bat))
        drain(eng)
        return mid, eng.status(rid_rt), eng.status(rid_bat), \
            _counters(eng), eng.done

    mid, rt, bat, c, _ = _both(scenario)
    assert mid == ("running", "preempted")
    assert rt == bat == "completed" and c["preemptions"] == 1


# ===========================================================================
def test_ttft_risk_sheds_speculation_not_streams():
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (8, 8, 8), seed=22)

        def serve(**kw):
            clock = kw.pop("clock", None)
            eng = make(batch=1, max_len=24, spec=True, clock=clock, **kw)
            eng.submit(prompts[0], gen_len=6)
            eng.try_admit()
            eng.submit(prompts[1], gen_len=6)
            eng.submit(prompts[2], gen_len=6, priority="realtime")
            if clock is not None:
                clock.advance(60.0)
            return drain(eng)

        base = serve()
        shed = serve(clock=FakeClock(),
                     slo_targets={"realtime": {"ttft_s": 1.0}})
        return (base.done, shed.done, _counters(shed),
                {int(c): r["shed_rounds"]
                 for c, r in shed.class_counters.items()})

    base, shed, c, shed_rounds = _both(scenario)
    assert sorted(shed) == sorted(base)
    assert c["shed_spec_rounds"] > 0 and shed_rounds[0] > 0


def test_no_risk_no_shed():
    def scenario(make, pkg, cfg):
        eng = make(batch=2, max_len=24, spec=True,
                   slo_targets={"realtime": {"ttft_s": 1e6}})
        eng.submit(rand_prompts(cfg.vocab, (6,))[0], gen_len=4,
                   priority="realtime")
        drain(eng)
        return (eng.counters["shed_spec_rounds"],
                eng.class_counters[pkg.PriorityClass.REALTIME]["shed_rounds"],
                eng.done)

    shed, rt, _ = _both(scenario)
    assert shed == rt == 0


# ===========================================================================
def test_stats_rows_counters_and_percentiles():
    def scenario(make, pkg, cfg):
        prompts = rand_prompts(cfg.vocab, (6, 6, 6), seed=23)
        eng = make(batch=2, max_len=24, clock=FakeClock(tick=0.01))
        for p, cls in zip(prompts, ("realtime", "batch", "batch")):
            eng.submit(p, gen_len=3, priority=cls)
        drain(eng, 3)
        classes = eng.stats()["classes"]
        return ({k: {f: v[f] for f in ("requests", "queued", "admitted",
                                       "completed")}
                 for k, v in classes.items()},
                all(v["ttft_p50_s"] <= v["ttft_p99_s"]
                    for v in classes.values()),
                sorted(r["priority"] for r in eng.request_log))

    classes, ordered, prios = _both(scenario)
    assert classes["realtime"]["requests"] == 1
    assert classes["batch"]["requests"] == 2 and "standard" not in classes
    assert ordered and prios == ["batch", "batch", "realtime"]


def test_slo_targets_surface_in_stats():
    def scenario(make, pkg, cfg):
        eng = make(batch=2, max_len=24,
                   slo_targets={"realtime": {"ttft_s": 0.25}})
        eng.submit(rand_prompts(cfg.vocab, (4,))[0], gen_len=2,
                   priority="realtime")
        drain(eng, 2)
        return eng.stats()["slo_targets"]

    assert _both(scenario) == {"realtime": {"ttft_s": 0.25}}


def test_straggler_blocks_attribute_to_running_classes():
    def scenario(make, pkg, cfg):
        eng = make(batch=1, max_len=24, clock=FakeClock(tick=1e-3),
                   fault_injector=pkg.ServingFaultInjector({8: "slow"}),
                   straggler=pkg.StragglerMonitor(window=8, ratio=50.0,
                                                  patience=1))
        eng.submit(rand_prompts(cfg.vocab, (4,), seed=24)[0], gen_len=12,
                   priority="realtime")
        eng.submit(rand_prompts(cfg.vocab, (4,), seed=25)[0], gen_len=2,
                   priority="batch")
        eng.try_admit()
        for _ in range(20):
            if not (eng.live.any() or eng.waiting):
                break
            eng.step_many(1)
        eng.retire_finished()
        rows = {int(c): r["straggler_blocks"]
                for c, r in eng.class_counters.items()}
        return eng.fault_injector.events, rows, \
            eng.stats()["straggler_blocks"] >= 1, eng.done

    events, rows, total, _ = _both(scenario)
    assert events == [(8, "slow")]
    assert rows[0] >= 1 and rows[2] == 0 and total


def test_cli_lifecycle_flags(capsys):
    """The lifecycle flags reach the Engine through the CLI; every request
    completes (a generous deadline, a realtime class with a loose TTFT
    target, prefix caching and preemption over a tight pool)."""
    from repro_torch.launch.serve import main
    done = main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                 "--paged", "--page-size", "4", "--prefill-chunk", "5",
                 "--num-pages", "8", "--prefix-cache", "--preempt",
                 "--shed-threshold", "0.9", "--deadline-s", "1000",
                 "--priority-class", "realtime", "--slo-ttft-s", "100",
                 "--requests", "4", "--batch", "2", "--prompt-len", "13",
                 "--gen-len", "6"])
    assert len(done) == 4 and all(len(t) == 6 for t in done)
    out = capsys.readouterr().out
    assert "served 4 requests" in out and "prefix-cache preempt" in out
    assert '"realtime"' in out
