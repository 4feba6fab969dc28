"""The flash forward's grid (``flash_fwd_plan``): how the TMA kernel of
``csrc/flash_attention.cu`` (``fa3::flash_fwd_wgmma_kernel``) cuts a shape
into blocks of one, two or three consumer warpgroups.

The plan is plain Python of the shape and the SM count, so it is held
here on the CPU at chip_smoke's bf16 FLASH_CASES (shapes only): every
(query head, row) is covered exactly once, the items of a block read one
KV head, causal blocks come longest first, and the choices and block
counts at an H100's 132 SMs are the ones PERF.md states.  An f32
simulation of the plan's tiling (its items, 64-row K/V tiles up to the
block's extent, the online softmax, a fresh P.V sum joined per tile)
then matches ``flash_attention_plain`` within 1e-6.  The kernel itself
runs only on the card (``tests/test_torch_cuda.py``, chip_smoke phase 3).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (FLASH_FWD_ROWS,
                                                 FlashFwdPlan,
                                                 flash_fwd_plan)
from repro_torch.kernels.ref import flash_attention_plain

H100_SMS = 132


def _smoke_cases():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [(label, tuple(shape)) for label, *shape, dtypes, _ in
            mod.FLASH_CASES if "bf16" in dtypes and shape[5] % 8 == 0]


CASES = _smoke_cases()


def _plan(shape):
    b, hq, hkv, sq, skv, d, causal = shape
    return flash_fwd_plan(b, hq, hkv, sq, skv, d, causal=causal,
                          sms=H100_SMS)


def test_the_cases_include_the_training_forward():
    assert ("b gemma-train fwd", (8, 8, 1, 256, 256, 256, True)) in CASES


@pytest.mark.parametrize("label,shape", CASES, ids=[c[0] for c in CASES])
def test_plan_covers_each_row_once_longest_first(label, shape):
    plan = _plan(shape)
    b, hq, hkv, sq, skv, d, causal = shape
    group = hq // hkv
    seen = np.zeros((b, hq, -(-sq // FLASH_FWD_ROWS)), dtype=np.int64)
    extents = []
    for blk in range(plan.blocks):
        items = plan.items(blk)
        assert len(items) == plan.wgs
        assert len({(bb, h // group) for bb, h, _ in items}) == 1
        if plan.pack_heads:     # two heads of a group at the same rows
            assert items[0][1] + 1 == items[1][1] and items[0][1] % 2 == 0
            assert items[0][2] == items[1][2]
        else:                   # consecutive 64-row steps of one head
            assert [r0 for _, _, r0 in items] == [
                items[0][2] + FLASH_FWD_ROWS * c for c in range(plan.wgs)]
        for bb, h, row0 in items:
            assert row0 % FLASH_FWD_ROWS == 0
            if row0 < sq:
                seen[bb, h, row0 // FLASH_FWD_ROWS] += 1
            else:               # a block's later 64 rows past Sq
                assert plan.item_tiles(row0) == 0
        extents.append(plan.block_tiles(blk))
    assert (seen == 1).all()
    if causal:                  # blocks in launch order, longest first
        assert extents == sorted(extents, reverse=True)


def test_plan_choices_as_perf_md_states():
    """PERF.md section 6: consumers a block, packing and blocks at 132
    SMs."""
    got = {label: (p.wgs, p.pack_heads, p.blocks)
           for label, shape in CASES for p in [_plan(shape)]}
    assert got == {
        "a whisper-encoder": (3, False, 512),
        "b gemma-prefill": (1, False, 128),
        "b gemma-train fwd": (2, True, 128),
        "c ragged Sq<Skv causal": (1, False, 32),
        "c ragged Sq>Skv": (1, False, 64),
        "c MLA-width": (1, False, 64),
        "e glm4 D128 group16": (1, False, 256),
        "e deepseek MLA": (2, False, 512),
        "f zamba2 forward": (1, False, 2048),
        "g vlm forward": (1, False, 1024),
    }


def _simulate(q, k, v, plan, scale):
    """The kernel's walk in f32: per block, its items over the block's
    64-row K/V tiles (an item's tiles past its own extent skipped), the
    online softmax, each tile's P.V in a fresh sum joined to O."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    group = hq // k.shape[1]
    q_off = skv - sq
    out = torch.full_like(q, float("nan"))
    for blk in range(plan.blocks):
        for bb, h, row0 in plan.items(blk):
            if row0 >= sq:
                continue
            rows = torch.arange(row0, min(sq, row0 + FLASH_FWD_ROWS))
            qs = q[bb, h, rows]
            m = torch.full((len(rows),), -1e30)
            l = torch.zeros(len(rows))
            o = torch.zeros(len(rows), d)
            for t in range(plan.item_tiles(row0)):
                keys = torch.arange(t * FLASH_FWD_ROWS,
                                    min(skv, (t + 1) * FLASH_FWD_ROWS))
                x = qs @ k[bb, h // group, keys].T * scale
                vis = torch.ones_like(x, dtype=torch.bool)
                if plan.causal:
                    vis = q_off + rows[:, None] >= keys[None, :]
                x = torch.where(vis, x, torch.tensor(-1e30))
                m_new = torch.maximum(m, x.max(dim=1).values)
                p = torch.where(vis, torch.exp(x - m_new[:, None]), 0.0)
                alpha = torch.exp(m - m_new)
                l = alpha * l + p.sum(dim=1)
                o = alpha[:, None] * o + p @ v[bb, h // group, keys]
                m = m_new
            out[bb, h, rows] = o / torch.clamp(l, min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("shape,wgs,pack", [
    ((2, 4, 2, 150, 190, 40, True), 2, True),
    ((1, 3, 1, 200, 70, 24, True), 2, False),
    ((1, 2, 1, 250, 230, 24, True), 3, False),
    ((2, 4, 2, 100, 130, 16, False), 1, False)])
def test_plan_tiling_matches_the_plain_version(shape, wgs, pack):
    b, hq, hkv, sq, skv, d, causal = shape
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((b, hq, sq, d),
                                             dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, hkv, skv, d),
                                                 dtype=np.float32))
            for _ in range(2))
    plan = FlashFwdPlan(b, hq, hkv, sq, skv, d, causal, wgs, pack)
    got = _simulate(q, k, v, plan, d ** -0.5)
    want = flash_attention_plain(q, k, v, causal=causal)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
