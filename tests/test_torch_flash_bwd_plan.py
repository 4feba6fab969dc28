"""The flash backward's split plan (``flash_bwd_plan``): how the dk/dv
grid of ``csrc/flash_attention_bwd.cu`` cuts a shape's work across blocks.

The plan is plain Python of the shape and the SM count, so it is held
here on the CPU: at chip_smoke's FLASH_BWD_CASES (shapes only) and at
path 14's gemma-2b microbatch (B 4) it fills an H100's 132 SMs (bf16:
the most items a block with 1.2 dk/dv blocks an SM; f32: the fewest
within two an SM), covers
every (KV tile, query head, Q step) that sees a key exactly once, and
sizes its workspace as PERF.md states.  One small shape then sums the
split partials, computed with the plain formulas in f32, in the plan's
order and matches ``flash_attention_bwd_plain`` within 1e-6 relative L2.
The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
chip_smoke phase 3).
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (FLASH_BWD_Q_ROWS,
                                                 flash_bwd_plan)
from repro_torch.kernels.ref import (flash_attention_bwd_plain,
                                     flash_attention_lse_plain,
                                     flash_attention_plain)

H100_SMS = 132


def _smoke_cases():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [(label, shape, dt) for label, *shape, dtypes, _ in
            mod.FLASH_BWD_CASES for dt in dtypes]


CASES = _smoke_cases()


def test_the_cases_include_path_14s_microbatch():
    shapes = {(label, tuple(shape[:7])) for label, shape, _ in CASES}
    assert ("h gemma-train B4", (4, 8, 1, 256, 256, 256, True)) in shapes


def _visible_steps(plan, kv_tile):
    """(query head of the group, Q step) pairs with at least one visible
    (query row, key) pair in the KV tile, by brute force."""
    q_off = plan.skv - plan.sq
    keys = range(kv_tile * plan.kv_rows,
                 min(plan.skv, (kv_tile + 1) * plan.kv_rows))
    steps = set()
    for r in range(plan.sq):
        if any(not plan.causal or q_off + r >= kpos for kpos in keys):
            steps.add(r // FLASH_BWD_Q_ROWS)
    return {(hh, st) for hh in range(plan.hq // plan.hkv) for st in steps}


@pytest.mark.parametrize("label,shape,dtype", CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in CASES])
def test_plan_fills_the_card_and_covers_each_item_once(label, shape, dtype):
    b, hq, hkv, sq, skv, d, causal = shape
    plan = flash_bwd_plan(b, hq, hkv, sq, skv, d, causal=causal,
                          bf16=dtype == "bf16", sms=H100_SMS)
    if "ragged" not in label:
        assert plan.blocks >= H100_SMS, (label, dtype, plan)
    most = len(plan.tile_items(0))
    bigger = dataclasses.replace(plan, per=plan.per + 1)
    smaller = dataclasses.replace(plan, per=max(1, plan.per - 1))
    if dtype == "bf16":     # the most items a block with 1.2 blocks an SM
        want = -(-6 * H100_SMS // 5)
        assert plan.blocks >= want or plan.per == 1
        assert bigger.blocks < want or plan.per == most
    else:                   # the fewest within two blocks an SM
        assert plan.blocks <= 2 * H100_SMS or plan.per == most
        assert smaller.blocks > 2 * H100_SMS or plan.per == 1
    assert plan.blocks == sum(plan.splits(t) for t in range(plan.kv_tiles)) \
        * plan.chunks * hkv * b
    for t in range(plan.kv_tiles):
        runs = [plan.split_items(t, s) for s in range(plan.splits(t))]
        assert all(0 < len(run) <= plan.per for run in runs) or \
            runs == [[]]
        flat = [item for run in runs for item in run]
        # contiguous runs, in order, each item once; every item that sees
        # a key is in some run
        assert flat == plan.tile_items(t)
        assert len(set(flat)) == len(flat)
        assert _visible_steps(plan, t) <= set(flat)
    assert plan.workspace_bytes == (
        0 if plan.nsplit == 1 else 2 * plan.nsplit * b * hkv * skv * d * 4)


def test_plan_numbers_as_perf_md_states():
    """PERF.md section 6's splits and workspaces at 132 SMs."""
    got = {(label, dt): (p.nsplit, p.blocks, p.workspace_bytes)
           for label, shape, dt in CASES
           for p in [flash_bwd_plan(*shape[:6], causal=shape[6],
                                    bf16=dt == "bf16", sms=H100_SMS)]}
    assert got[("h gemma-train", "bf16")] == (4, 160, 16777216)
    assert got[("h gemma-train", "f32")] == (7, 256, 29360128)
    assert got[("h gemma-train B4", "bf16")] == (8, 160, 16777216)
    assert got[("h gemma-train B4", "f32")] == (13, 244, 27262976)
    assert got[("h whisper-encoder", "bf16")] == (1, 1536, 0)
    assert got[("h glm4 D128 group16", "bf16")] == (9, 176, 9437184)
    assert got[("h deepseek MLA", "bf16")] == (1, 2048, 0)
    assert got[("h ragged causal", "bf16")] == (8, 176, 5455872)
    plan = flash_bwd_plan(8, 8, 1, 256, 256, 256, causal=True, bf16=True,
                          sms=H100_SMS)
    assert plan.per == 21
    assert [plan.splits(t) for t in range(plan.kv_tiles)] == [4, 3, 2, 1]


@pytest.mark.parametrize("shape,bf16,splits", [
    ((1, 16, 1, 100, 128, 64, True), True, [64, 48]),
    ((4, 8, 1, 128, 128, 256, True), True, [16, 8]),
    ((2, 6, 2, 70, 70, 48, True), True, [9, 3]),
    ((2, 6, 2, 70, 70, 48, True), False, [9, 6, 3])])
def test_card_test_shapes_split(shape, bf16, splits):
    """The card test's split shapes (test_torch_cuda.py) split their KV
    tiles unevenly, one of them into odd counts."""
    plan = flash_bwd_plan(*shape[:6], causal=shape[6], bf16=bf16,
                          sms=H100_SMS)
    assert [plan.splits(t) for t in range(plan.kv_tiles)] == splits


def test_split_partials_sum_to_the_plain_backward():
    """dk and dv as the kernel forms them: per (KV tile, split) the plain
    formulas over the block's (head, Q step) items in f32, the partials
    of each tile summed in split order; against
    flash_attention_bwd_plain."""
    b, hq, hkv, sq, skv, d = 1, 6, 2, 70, 90, 40
    rng = np.random.default_rng(0)
    q, do = (torch.from_numpy(rng.standard_normal((b, hq, sq, d),
                                                  dtype=np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, hkv, skv, d),
                                                 dtype=np.float32))
            for _ in range(2))
    o = flash_attention_plain(q, k, v, causal=True)
    lse = flash_attention_lse_plain(q, k, causal=True)
    _, want_dk, want_dv = flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                    causal=True)
    plan = flash_bwd_plan(b, hq, hkv, sq, skv, d, causal=True, bf16=True,
                          sms=H100_SMS)
    assert plan.nsplit == 9
    scale = d ** -0.5
    q_off, group, rows = skv - sq, hq // hkv, FLASH_BWD_Q_ROWS
    part_k = torch.zeros((plan.nsplit, b, hkv, skv, d))
    part_v = torch.zeros_like(part_k)
    for bb in range(b):
        for hk in range(hkv):
            for t in range(plan.kv_tiles):
                k0 = t * plan.kv_rows
                kt = slice(k0, min(skv, k0 + plan.kv_rows))
                kpos = torch.arange(kt.start, kt.stop)
                for s in range(plan.splits(t)):
                    for hh, st in plan.split_items(t, s):
                        h = hk * group + hh
                        qr = torch.arange(st * rows, min(sq, st * rows + rows))
                        qs = q[bb, h, qr] * scale
                        sc = qs @ k[bb, hk, kt].T
                        vis = q_off + qr[:, None] >= kpos[None, :]
                        p = torch.where(vis, torch.exp(
                            sc - lse[bb, h, qr][:, None]), 0.0)
                        delta = (do[bb, h, qr] * o[bb, h, qr]).sum(-1)
                        dp = do[bb, h, qr] @ v[bb, hk, kt].T
                        ds = p * (dp - delta[:, None])
                        part_v[s, bb, hk, kt] += p.T @ do[bb, h, qr]
                        part_k[s, bb, hk, kt] += ds.T @ qs
    dk, dv = part_k[0].clone(), part_v[0].clone()
    for t in range(plan.kv_tiles):
        kt = slice(t * plan.kv_rows, (t + 1) * plan.kv_rows)
        for s in range(1, plan.splits(t)):
            dk[:, :, kt] += part_k[s, :, :, kt]
            dv[:, :, kt] += part_v[s, :, :, kt]

    def rel(a, w):
        return float((a.double() - w.double()).norm() / w.double().norm())
    assert rel(dk, want_dk) <= 1e-6
    assert rel(dv, want_dv) <= 1e-6
