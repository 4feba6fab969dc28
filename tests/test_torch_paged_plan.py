"""The Hopper paged kernel's plan (``paged_plan``): how
``csrc/paged_attention.cu``'s ``paged_hopper_kernel`` cuts a call into
blocks, and a torch model of its schedule.

The plan is plain Python of the shape, the reference's partitions and the
SM count, so it is held here on the CPU at chip_smoke's paged cases (shapes
only; every knob point it checks) and the Engine's geometries, on an
H100's 132 SMs: shared memory within 227 KB (the merge's weights too),
every query row in one row tile, every table entry in one block of pages
(so every visible page is walked once per row tile), one ticket per
(batch, KV head, row tile), and a grid that fills one wave of resident
blocks wherever the table has the entries for it.  The control (the first
port's kernel) is chosen exactly for pages of more than 16 rows.

The schedule model (``_warp_schedule`` with one warp and the plan's rows
and entries a block) is held at ``TOL`` against the Pallas kernels in
interpret mode and the plain versions, at narrow widths on a small card
(so that partitions are cut into several blocks and rows into several
tiles).  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, chip_smoke phase 3).
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (PAGED_DECODE_GROUPS,
                                                 PAGED_DECODE_MIN_PER,
                                                 PAGED_DECODE_S, PAGED_KEYS,
                                                 PAGED_MAX_WARPS, PAGED_SMEM,
                                                 _resolve_knobs, paged_plan,
                                                 paged_stages)
from repro_torch.launch import autotune

H100_SMS = 132


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _partitions(np_, t, split):
    """The reference's (span, split) for knobs (t, split) on a table of
    ``np_`` entries, as the wrappers clamp them."""
    t = max(1, min(t, np_))
    tiles = -(-np_ // t)
    split = max(1, min(split, tiles))
    return -(-tiles // split) * t, split


def _smoke_calls():
    """(label, B, Hkv, rows, D, ps, table, knobs, S) of every launch
    chip_smoke phase 3 checks: (1, 1), the auto knobs and the fitted
    autotuner's."""
    fitted = autotune.load_estimator("fitted")
    calls = []
    for label, b, s, _, _, width_tokens, (hq, hkv, d) in \
            _smoke().attention_cases():
        np_ = -(-width_tokens // 16)
        auto = _resolve_knobs(np_, 16, hkv, b, None, None)
        fk = autotune.resolve(autotune.WorkloadShape(
            pages=np_, page_size=16, hkv=hkv, batch=b), fitted)
        fk = _resolve_knobs(np_, 16, hkv, b, fk.kv_split, fk.pages_per_step)
        for knobs in dict.fromkeys(((1, 1), auto, fk)):
            calls.append((label, b, hkv, hq // hkv * s, d, 16, np_, knobs, s))
    return calls


#: the Engine's paged geometries on the paths (batch 8, 16-row pages):
#: gemma-2b's decode, verify and prefill chunk on a 12-entry table, the
#: recurrent paths' 7-entry table, a long table; and the CPU suites'
#: (batch 2-3, 4-row pages, a prefill chunk of 5); (B, Hkv, rows, D, ps,
#: table, S)
ENGINE = [(8, 1, 8, 256, 16, 12, 1), (8, 1, 40, 256, 16, 12, 5),
          (8, 1, 128, 256, 16, 12, 16), (8, 32, 1, 64, 16, 7, 1),
          (8, 32, 5, 64, 16, 7, 5), (8, 1, 8, 256, 16, 257, 1),
          (2, 2, 2, 64, 4, 13, 1), (3, 1, 40, 64, 4, 13, 5),
          (2, 4, 15, 128, 8, 9, 5)]
CALLS = _smoke_calls() + [
    (f"engine B={b} Hkv={hkv} rows={rows} D={d} ps={ps} table={np_}", b,
     hkv, rows, d, ps, np_, knobs, s)
    for b, hkv, rows, d, ps, np_, s in ENGINE
    for knobs in dict.fromkeys(((1, 1), _resolve_knobs(np_, ps, hkv, b, None,
                                                       None)))]


def test_the_calls_include_every_smoke_case_and_knob_point():
    labels = {c[0] for c in CALLS}
    assert {"decode", "prefill", "verify", "decode-4096", "glm4 prefill",
            "olmoe decode", "zamba2 verify"} <= labels
    assert any(c[7] == (1, 1) for c in CALLS)
    assert any(c[7][1] > 1 for c in CALLS)


@pytest.mark.parametrize("call", CALLS, ids=lambda c: f"{c[0]} {c[7]}")
def test_plan_covers_rows_and_entries_once_and_fills_the_card(call):
    _, b, hkv, rows, d, ps, np_, (t, split), s = call
    span, split = _partitions(np_, t, split)
    plan = paged_plan(b, hkv, rows, d, ps, np_, span, split, sms=H100_SMS,
                      s=s)
    if plan.instance == "control":      # a prefill chunk on a small grid
        assert s > PAGED_DECODE_S and b * hkv * -(-rows // 8) * split \
            <= H100_SMS
        return
    assert plan.instance == "hopper"
    assert 1 <= plan.rw <= 8 and plan.warps <= PAGED_MAX_WARPS
    assert 1 <= plan.groups <= plan.per
    assert plan.stages % plan.groups == 0 and plan.stages <= plan.ring
    assert plan.stages == paged_stages(plan.ring, plan.per, plan.groups)
    # shared memory: header, q, ring; the groups' states in the ring, the
    # merge's weights behind the header (what the launcher checks)
    assert plan.smem_bytes <= PAGED_SMEM and plan.fits()
    # every row in exactly one row tile
    cover = np.zeros(rows, dtype=np.int64)
    for tile in range(plan.row_tiles):
        cover[tile * plan.rows_per_block:(tile + 1) * plan.rows_per_block] \
            += 1
    assert (cover == 1).all()
    assert (plan.row_tiles - 1) * plan.rows_per_block < rows
    # every table entry (so every visible page) in exactly one block of
    # pages, inside its partition
    walked = [e for c in range(plan.chunks) for e in plan.entries(c)]
    assert walked == list(range(np_))
    for c in range(plan.chunks):
        e = plan.entries(c)
        if len(e):
            assert e[0] // span == (e[-1]) // span == c // plan.cpp
            assert len(e) <= plan.per
    # one ticket per (batch, KV head, row tile): the kernel's index
    tickets = sorted(z * plan.row_tiles + y for z in range(b * hkv)
                     for y in range(plan.row_tiles))
    assert tickets == list(range(b * hkv * plan.row_tiles))
    # one wave of blocks, one an SM (unless the partitions alone outgrow
    # it), and no shorter block of pages above the floor would keep that
    # wave (and the merge's weights within shared memory); a decode-like
    # call counts its rows as one tile
    decode = s <= PAGED_DECODE_S
    base = b * hkv * (1 if decode else plan.row_tiles) * split
    if base <= H100_SMS:
        assert plan.cpp * base <= H100_SMS
    else:                           # more partitions than a wave holds
        assert plan.cpp == 1
    # (a decode-like block walks at least PAGED_DECODE_MIN_PER entries)
    floor = min(span, PAGED_DECODE_MIN_PER) if decode else 1
    assert plan.per >= floor
    if plan.per > floor:
        shorter = dataclasses.replace(plan, per=plan.per - 1, groups=1,
                                      stages=1,
                                      rw=8 if decode else plan.rw)
        assert shorter.cpp * base > H100_SMS or not shorter.fits(), plan
    if decode:                      # groups from the entries alone
        assert plan.groups == min(plan.per, PAGED_DECODE_GROUPS)
        return
    # as many groups as the entries and 16 consumer warps allow
    g = plan.groups + 1
    assert plan.groups == min(plan.per, (PAGED_MAX_WARPS - 1) // plan.rw,
                              plan.ring) \
        or not dataclasses.replace(
            plan, groups=g, stages=paged_stages(plan.ring, plan.per, g)
        ).fits()


@pytest.mark.parametrize("call", [c for c in CALLS if c[8] > 1],
                         ids=lambda c: f"{c[0]} {c[7]}")
def test_verify_cuts_pages_as_decode(call):
    """A call of up to 8 positions a lane (a verify pass) takes the page
    cut, groups and merges of the decode call on the same table, so its
    rows round as decode's, bit for bit (tests/test_torch_cuda.py::
    test_verify_logits_equal_decode_logits on the card)."""
    _, b, hkv, rows, d, ps, np_, (t, split), s = call
    if s > PAGED_DECODE_S:
        return
    span, split = _partitions(np_, t, split)
    verify = paged_plan(b, hkv, rows, d, ps, np_, span, split, sms=H100_SMS,
                        s=s)
    decode = paged_plan(b, hkv, rows // s, d, ps, np_, span, split,
                        sms=H100_SMS, s=1)
    assert (verify.instance, verify.per, verify.cpp, verify.groups) == \
        (decode.instance, decode.per, decode.cpp, decode.groups)


def test_control_exactly_where_the_hopper_kernel_cannot_go_or_loses():
    assert paged_plan(2, 1, 8, 64, PAGED_KEYS + 1, 12, 12, 1,
                      sms=H100_SMS).instance == "control"
    assert paged_plan(2, 1, 8, 64, PAGED_KEYS, 12, 12, 1,
                      sms=H100_SMS).instance == "hopper"
    # gemma-2b's prefill chunk: 8 lanes x 16 8-row tiles, unsplit, one
    # wave of the control's blocks; split in two, two waves
    assert paged_plan(8, 1, 128, 256, 16, 12, 12, 1, sms=H100_SMS,
                      s=16).instance == "control"
    assert paged_plan(8, 1, 128, 256, 16, 12, 8, 2, sms=H100_SMS,
                      s=16).instance == "hopper"
    assert paged_plan(8, 1, 64, 256, 16, 12, 12, 1, sms=H100_SMS,
                      s=8).instance == "hopper"
    ctl = paged_plan(2, 1, 8, 64, 16, 12, 6, 2, sms=H100_SMS,
                     instance="control")
    assert (ctl.rows_per_block, ctl.chunks, ctl.blocks) == (8, 2, 4)
    with pytest.raises(ValueError, match="at most 16 rows"):
        paged_plan(2, 1, 8, 64, 32, 12, 12, 1, sms=H100_SMS,
                   instance="hopper")


# -- the Hopper kernel's schedule, modelled in torch -------------------------
from test_torch_paged_attention import (TOL, _case, _j, _t,  # noqa: E402
                                        _warp_schedule, jfa, tref)

#: (b, hq, hkv, s, d, ps, num_pages, width, qpos, knobs, sms): decode at
#: group 8 with partitions cut into several blocks, a verify pass of 40
#: rows, a prefill chunk of 128 rows in row tiles, each on a small card;
#: qpos from the start of the table (blocks that see nothing) to its end
MODEL = [
    (2, 8, 1, 1, 16, 4, 40, 36, [70, 141], (1, 1), 16),
    (2, 8, 1, 1, 16, 4, 40, 36, [3, 130], (1, 4), 24),
    (2, 8, 1, 5, 16, 4, 40, 36, [40, 130], (2, 2), 12),
    (2, 8, 1, 16, 16, 16, 20, 9, [0, 120], (1, 1), 8),
]


def _model_vs_references(q, kp, vp, bt, qpos, knobs, sms):
    b, hq, s, d = q.shape
    _, hkv, ps, _ = kp.shape
    np_ = bt.shape[1]
    t, split = knobs
    span, split = _partitions(np_, t, split)
    plan = paged_plan(b, hkv, hq // hkv * s, d, ps, np_, span, split,
                      sms=sms, s=s)
    got = _warp_schedule(*_t(q, kp, vp, bt, qpos), warps=plan.groups,
                         rows_per_block=plan.rows_per_block,
                         kv_split=split, pages_per_step=t,
                         pages_per_block=plan.per).numpy()
    if knobs == (1, 1):
        want = tref.paged_attention_ref(*_t(q, kp, vp, bt, qpos)).numpy()
        pal = jfa._paged_attention_unsplit(*_j(q, kp, vp, bt, qpos),
                                           interpret=True)
    else:
        want = tref.paged_attention_split_ref(
            *_t(q, kp, vp, bt, qpos), kv_split=split,
            pages_per_step=t).numpy()
        pal = jfa.paged_attention_pallas(*_j(q, kp, vp, bt, qpos),
                                         kv_split=split, pages_per_step=t,
                                         interpret=True)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.asarray(pal), **TOL)
    return plan, got


@pytest.mark.parametrize("geom", MODEL, ids=lambda g: f"s{g[3]}{g[9]}")
def test_hopper_schedule_matches_reference_and_pallas(geom):
    b, hq, hkv, s, d, ps, npg, w, qpos, knobs, sms = geom
    q, kp, vp, bt = _case(b, hq, hkv, s, d, ps, npg, w, seed=sum(geom[:8]))
    plan, _ = _model_vs_references(q, kp, vp, bt,
                                   np.asarray(qpos, np.int32), knobs, sms)
    # the model walks what the kernel walks: several blocks of pages a
    # partition or groups walking a block's pages, and the rows of a
    # prefill chunk in several tiles
    assert plan.cpp > 1 or plan.row_tiles > 1
    assert plan.groups > 1 or plan.cpp > 1


def test_hopper_schedule_dead_lane_and_poisoned_rows():
    """Blocks of two entries, two groups: a dead lane (all trash, qpos 0)
    on a poisoned trash page and NaN in every row past the live lane's visible
    prefix: the live lane is unmoved, the dead lane finite, both match
    Pallas."""
    ps, width, npg = 4, 12, 19
    trash = npg - 1
    q, kp, vp, _ = _case(2, 8, 1, 1, 8, ps, npg, width, seed=35)
    bt = np.stack([np.arange(width), np.full(width, trash)]).astype(np.int32)
    qpos = np.asarray([25, 0], np.int32)
    plan, clean = _model_vs_references(q, kp, vp, bt, qpos, (1, 2), 12)
    assert (plan.per, plan.groups) == (2, 2)
    kp[trash], vp[trash] = 1e4, -1e4
    _, poisoned = _model_vs_references(q, kp, vp, bt, qpos, (1, 2), 12)
    np.testing.assert_array_equal(poisoned[0], clean[0])
    assert np.isfinite(poisoned[1]).all()
    for t in range(int(qpos[0]) + 1, width * ps):
        kp[bt[0, t // ps], :, t % ps] = np.nan
        vp[bt[0, t // ps], :, t % ps] = np.nan
    nan_rows = _warp_schedule(*_t(q, kp, vp, bt, qpos), warps=plan.groups,
                              rows_per_block=plan.rows_per_block,
                              kv_split=2, pages_per_block=plan.per).numpy()
    np.testing.assert_array_equal(nan_rows[0], clean[0])
    assert torch.isfinite(torch.from_numpy(nan_rows)).all()
