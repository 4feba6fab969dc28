"""qmatmul's plan (``qmatmul_plan``): how the kernels of
``csrc/qmatmul.cu`` cut an (M, K) x (K, N) call into blocks.

The plan is plain Python of the shape and the SM count, so it is held
here on the CPU at chip_smoke's qmatmul shapes (shapes only) and an
H100's 132 SMs: the block tiles cover every output once, the split
ranges are disjoint and cover K (none empty on the TMA instances), one
ticket per tile, the ring fits a block's shared memory, the control
(the parent kernel) is chosen exactly where K or N is not a multiple of
16 (what TMA cannot address) or a call of at most 16 rows has a K of at
most 4 stages (where it measured faster), and the narrow wgmma tile
exactly where M > 64 has N and K of at most 64 (the jet's layers).  A numpy simulation of the plan's split
partial sums (exact int32, added tile by tile as the kernels' atomics
do) plus the epilogue is then bitwise ``qmatmul_plain``.  The kernels
themselves run only on the card (``tests/test_torch_cuda.py``, chip_smoke
phase 3).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.qmatmul import (BK, BOX, NARROW, NARROW_ROWS,
                                         SHORT_K, STREAM_ROWS, WGMMA_ROWS,
                                         qmatmul_plain, qmatmul_plan)
from repro_torch.kernels.ref import fma_f32

H100_SMS = 132
#: shared memory a block may take (227 KB)
SMEM_MAX = 232448


def _smoke_shapes():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return sorted({(m, k, n) for m, _, k, n, *_ in mod.qmatmul_cases()})


SHAPES = _smoke_shapes()


def test_the_shapes_include_decode_verify_the_edges_and_the_jet():
    for shape in [(8, 2048, 16384), (40, 16384, 2048), (64, 2048, 2048),
                  (65, 2048, 2048), (16384, 16, 64), (16384, 32, 5),
                  (12000, 512, 2048), (12808, 4096, 1024)]:
        assert shape in SHAPES


@pytest.mark.parametrize("m,k,n", SHAPES, ids=str)
def test_plan_covers_each_output_and_k_once(m, k, n):
    plan = qmatmul_plan(m, n, k, H100_SMS)
    tma = n % 16 == 0 and k % 16 == 0
    short = m <= 16 and k <= SHORT_K
    assert plan.instance == ("control" if not tma or short else
                             "stream" if m <= 64 else "wgmma")
    assert (plan.m, plan.n, plan.k) == (m, n, k)
    # the grid (N tiles, M tiles): every row and column in one tile
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(n, dtype=np.int64)
    for y in range(plan.m_tiles):
        rows[y * plan.rows:(y + 1) * plan.rows] += 1
    for x in range(plan.n_tiles):
        cols[x * plan.cols:(x + 1) * plan.cols] += 1
    assert (rows == 1).all() and (cols == 1).all()
    assert (plan.m_tiles - 1) * plan.rows < m
    assert (plan.n_tiles - 1) * plan.cols < n
    # one ticket a tile: the kernels' index y * N tiles + x
    tickets = sorted(y * plan.n_tiles + x for y in range(plan.m_tiles)
                     for x in range(plan.n_tiles))
    assert tickets == list(range(plan.tiles))
    # the splits: contiguous, disjoint, covering K in whole stages
    ranges = [plan.split_range(z) for z in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(r0[1] == r1[0] for r0, r1 in zip(ranges, ranges[1:]))
    assert all(k0 % plan.bk == 0 for k0, _ in ranges)
    assert 1 <= plan.splits <= plan.k_stages
    if plan.instance == "control":
        assert (plan.rows, plan.cols) == ((16, 128) if m <= 16
                                          else (128, 128))
        return
    assert all(k1 > k0 for k0, k1 in ranges)
    # what the kernel instantiates, and a ring that fits with a table
    narrow = plan.instance == "wgmma" and n <= NARROW and k <= NARROW
    if plan.instance == "stream":
        assert plan.rows in STREAM_ROWS and plan.rows >= m
        assert plan.cols == BOX
    elif narrow:
        # one 64-column tile, the whole K in one stage of k32 steps
        assert (plan.cols, plan.splits, plan.stages) == (NARROW, 1, 1)
        assert plan.rows in NARROW_ROWS and plan.bk in (32, 64)
        assert plan.bk >= k and plan.k_stages == 1
    else:
        # two boxes only where N has two
        assert plan.rows in WGMMA_ROWS and plan.cols in (BOX, 2 * BOX)
        assert plan.cols == BOX or n > BOX
    # a stage holds whole TMA boxes: 128 k rows of 128 columns a box
    stage = max(plan.cols, BOX) * BK + plan.rows * BK
    assert 1 <= plan.stages <= -(-plan.k_stages // plan.splits)
    assert plan.stages * stage + 16 * plan.stages + 16 <= SMEM_MAX
    # the splits' atomics stay under a sixteenth of the weight bytes
    if plan.splits > 1:
        assert m * n * plan.splits * 16 <= k * n


def test_plan_choices_as_perf_md_states():
    """PERF.md section 6: instance, block tile, split and ring at
    the main path's shapes and 132 SMs."""
    def name(p):
        return (p.instance, p.cols, p.rows, p.splits, p.stages, p.blocks)
    got = {shape: name(qmatmul_plan(*shape, H100_SMS)) for shape in [
        (8, 16384, 2048), (8, 2048, 16384), (8, 2048, 2048),
        (40, 2048, 2048), (40, 16384, 2048), (40, 2048, 16384),
        (8, 2048, 512),
        (128, 2048, 2048), (12000, 2048, 512), (16384, 64, 16),
        (16384, 5, 32), (1, 64, 16), (128, 64, 16)]}      # (M, N, K)
    assert got == {
        (8, 16384, 2048): ("stream", 128, 8, 1, 11, 128),
        (8, 2048, 16384): ("stream", 128, 8, 8, 11, 128),
        (8, 2048, 2048): ("stream", 128, 8, 8, 2, 128),
        (40, 2048, 2048): ("stream", 128, 64, 3, 6, 48),
        (40, 16384, 2048): ("stream", 128, 64, 1, 8, 128),
        (40, 2048, 16384): ("stream", 128, 64, 8, 8, 128),
        (8, 2048, 512): ("control", 128, 16, 1, 6, 16),
        (128, 2048, 2048): ("wgmma", 128, 64, 1, 8, 32),
        (12000, 2048, 512): ("wgmma", 256, 128, 1, 4, 752),
        (16384, 64, 16): ("wgmma", 64, 64, 1, 1, 256),
        (128, 64, 16): ("wgmma", 64, 32, 1, 1, 4),
        (16384, 5, 32): ("control", 128, 128, 1, 4, 128),
        (1, 64, 16): ("control", 128, 16, 1, 6, 1),
    }


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        qmatmul_plan(8, 5, 2048, H100_SMS, "stream")       # N 5: no TMA
    with pytest.raises(ValueError):
        qmatmul_plan(65, 2048, 2048, H100_SMS, "stream")   # rows <= 64
    with pytest.raises(ValueError):
        qmatmul_plan(8, 2048, 2048, H100_SMS, "tiles")


def _simulate(a, b, sa, sb, bias, out_dtype, plan):
    """The kernels' sums in numpy: each block's exact partial sum of its
    tile over its split's K range, added into an int32 workspace (the
    atomics; integer addition, so any order), then the epilogue on the
    totals as the kernels apply it."""
    # float64 products of int8 values: every partial sum is an integer
    # below 2**53, so exact
    an, bn = a.numpy().astype(np.float64), b.numpy().astype(np.float64)
    ws = np.zeros((plan.m, plan.n), dtype=np.float64)
    for z in range(plan.splits):
        k0, k1 = plan.split_range(z)
        for y in range(plan.m_tiles):
            r = slice(y * plan.rows, (y + 1) * plan.rows)
            for x in range(plan.n_tiles):
                c = slice(x * plan.cols, (x + 1) * plan.cols)
                ws[r, c] += an[r, k0:k1] @ bn[k0:k1, c]
    assert np.abs(ws).max() < 2 ** 31
    acc = torch.from_numpy(ws.astype(np.int32))
    y = acc.to(torch.float32) * sa
    y = y * sb if bias is None else fma_f32(y, sb, bias.reshape(1, -1))
    return y.to(out_dtype)


@pytest.mark.parametrize("m,k,n,sms,instance,split", [
    (8, 2048, 512, 16, None, True),         # stream, split 4
    (40, 4096, 256, 64, None, True),        # stream, 64 rows, split
    (5, 640, 96, 132, None, True),          # stream, one ragged box
    (17, 1152, 160, 132, None, True),       # stream, 32 rows, the K edge
    (65, 8192, 256, 16, None, True),        # wgmma, 64 rows, split
    (130, 512, 288, 4, None, False),        # wgmma, two M tiles
    (200, 1024, 512, 132, "wgmma", False),  # wgmma, unsplit
    (130, 48, 64, 132, None, False),        # the narrow tile, the M edge
    (12, 1200, 70, 16, None, True),         # control (K and N off 16)
    (8, 2048, 40, 132, "control", True),    # control, split 16 ways
    (130, 8192, 24, 132, "control", True),  # control, 128-row tiles split
])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_split_sums_and_epilogue_are_qmatmul_plain(m, k, n, sms, instance,
                                                   split, out):
    plan = qmatmul_plan(m, n, k, sms, instance)
    assert (plan.splits > 1) == split
    rng = np.random.default_rng(m * 1000 + n)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
    sa = torch.from_numpy(rng.uniform(1e-4, 1e-3, (m, 1)).astype(np.float32))
    sb = torch.from_numpy(rng.uniform(1e-4, 1e-3, (1, n)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    dt = getattr(torch, out)
    for bb in (None, bias):
        got = _simulate(a, b, sa, sb, bb, dt, plan)
        want = qmatmul_plain(a, b, sa, sb, bb, dt)
        assert torch.equal(got.view(torch.int16 if dt == torch.bfloat16
                                    else torch.int32),
                           want.view(torch.int16 if dt == torch.bfloat16
                                     else torch.int32))
