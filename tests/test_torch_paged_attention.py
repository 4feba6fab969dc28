"""Paged attention parity: the port's plain unsplit, split and combine
versions (and the kernel wrappers on CPU tensors) against
``repro.kernels.ref`` and the Pallas kernels in interpret mode, plus the
knob resolvers against the reference's.

Tolerance: f32 atol = rtol = 2e-5, the reference kernel suite's own
(test_split_kv.py / test_paged_attention.py): both sides run the same
formulas, in another association order.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _case(b, hq, hkv, s, d, ps, num_pages, table_width, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, hq, s, d).astype(np.float32)
    kp = rs.randn(num_pages, hkv, ps, d).astype(np.float32)
    vp = rs.randn(num_pages, hkv, ps, d).astype(np.float32)
    bt = np.stack([rs.permutation(num_pages)[:table_width]
                   for _ in range(b)]).astype(np.int32)
    return q, kp, vp, bt


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


# (b, hq, hkv, s, d, ps, num_pages, width, qpos): S = 1 and S > 1, group 1,
# 2 and 4, ragged last page, qpos from empty to the end of the table
GEOMS = [
    (2, 2, 2, 1, 16, 4, 12, 5, [3, 19]),        # group 1, decode
    (3, 4, 2, 1, 16, 4, 12, 5, [0, 7, 19]),     # group 2, decode
    (2, 4, 1, 1, 32, 8, 10, 4, [5, 31]),        # group 4 (MQA), decode
    (3, 4, 2, 2, 8, 4, 16, 8, [0, 9, 21]),      # group 2, S = 2
    (2, 8, 2, 5, 8, 4, 14, 6, [4, 18]),         # group 4, S = 5
    (2, 4, 1, 16, 32, 8, 12, 5, [0, 16]),       # prefill chunk of 16
]
KNOBS = [(1, 1), (2, 1), (3, 2), (2, 2), (4, 1), (None, None)]


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: f"b{g[0]}h{g[1]}/{g[2]}s{g[3]}")
def test_unsplit_matches_reference_and_pallas(geom):
    b, hq, hkv, s, d, ps, npg, w, qpos = geom
    q, kp, vp, bt = _case(b, hq, hkv, s, d, ps, npg, w, seed=sum(geom[:8]))
    qpos = np.asarray(qpos, np.int32)
    got = tref.paged_attention_ref(*_t(q, kp, vp, bt, qpos)).numpy()
    want = np.asarray(jref.paged_attention_ref(*_j(q, kp, vp, bt, qpos)))
    np.testing.assert_allclose(got, want, **TOL)
    pal = np.asarray(jfa._paged_attention_unsplit(*_j(q, kp, vp, bt, qpos),
                                                  interpret=True))
    np.testing.assert_allclose(got, pal, **TOL)
    wrapped = tfa.paged_attention_unsplit(*_t(q, kp, vp, bt, qpos)).numpy()
    np.testing.assert_array_equal(wrapped, got)


#: every geometry at a split with single-page tiles and at a split with
#: multi-page tiles (ragged last partition), plus the other knob points
SPLIT_CASES = ([(g, 2, 1) for g in GEOMS[1:]] + [(g, 3, 2) for g in GEOMS[1:]]
               + [(GEOMS[3], 2, 2), (GEOMS[4], 4, 1)])


@pytest.mark.parametrize("geom,split,tile", SPLIT_CASES,
                         ids=lambda v: (f"b{v[0]}h{v[1]}/{v[2]}s{v[3]}"
                                        if isinstance(v, tuple) else str(v)))
def test_split_matches_reference_and_pallas(geom, split, tile):
    b, hq, hkv, s, d, ps, npg, w, qpos = geom
    q, kp, vp, bt = _case(b, hq, hkv, s, d, ps, npg, w, seed=split + tile)
    qpos = np.asarray(qpos, np.int32)
    got = tref.paged_attention_split_ref(*_t(q, kp, vp, bt, qpos),
                                         kv_split=split,
                                         pages_per_step=tile).numpy()
    want = np.asarray(jref.paged_attention_split_ref(
        *_j(q, kp, vp, bt, qpos), kv_split=split, pages_per_step=tile))
    np.testing.assert_allclose(got, want, **TOL)
    pal = np.asarray(jfa.paged_attention_pallas(
        *_j(q, kp, vp, bt, qpos), kv_split=split, pages_per_step=tile,
        interpret=True))
    np.testing.assert_allclose(got, pal, **TOL)
    wrapped = tfa.paged_attention_split(*_t(q, kp, vp, bt, qpos),
                                        kv_split=split,
                                        pages_per_step=tile).numpy()
    np.testing.assert_array_equal(wrapped, got)


@pytest.mark.parametrize("split,tile", KNOBS)
def test_dispatcher_matches_pallas_dispatcher(split, tile):
    """Both dispatchers resolve the same knobs and route (1, 1) to the
    unsplit kernel; results agree at every knob point."""
    q, kp, vp, bt = _case(2, 4, 2, 3, 16, 4, 20, 9, seed=5)
    qpos = np.asarray([6, 30], np.int32)
    kw = dict(kv_split=split, pages_per_step=tile)
    got = ops.paged_attention(*_t(q, kp, vp, bt, qpos), **kw).numpy()
    pal = np.asarray(jfa.paged_attention_pallas(*_j(q, kp, vp, bt, qpos),
                                                interpret=True, **kw))
    np.testing.assert_allclose(got, pal, **TOL)
    ref = ops.paged_attention(*_t(q, kp, vp, bt, qpos), backend="ref",
                              **kw).numpy()
    np.testing.assert_allclose(ref, got, **TOL)


@pytest.mark.parametrize("split,tile", [(1, 1), (2, 1), (3, 2), (4, 1)])
def test_poisoned_rows_never_leak(split, tile):
    """Garbage in every row past each lane's visible prefix (recycled
    pages, unwritten tails) must not move the output at all."""
    ps, width, s = 4, 5, 2
    q, kp, vp, _ = _case(2, 4, 2, s, 8, ps, 10, width, seed=7)
    bt = np.random.RandomState(8).permutation(10).reshape(2, width) \
        .astype(np.int32)
    qpos = np.asarray([5, 9], np.int32)
    kw = dict(kv_split=split, pages_per_step=tile)
    want = ops.paged_attention(*_t(q, kp, vp, bt, qpos), **kw).numpy()
    kp2, vp2 = kp.copy(), vp.copy()
    for b in range(2):
        for t in range(int(qpos[b]) + s, width * ps):
            pg, row = bt[b, t // ps], t % ps
            kp2[pg, :, row] = 1e4
            vp2[pg, :, row] = -1e4
    got = ops.paged_attention(*_t(q, kp2, vp2, bt, qpos), **kw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("split", [1, 2, 4])
def test_dead_lane_on_poisoned_trash_page(split):
    """A dead lane (table all trash, qpos 0) beside a live one: a poisoned
    trash page moves neither, and the dead lane stays finite."""
    ps, width, npg = 4, 4, 9
    trash = npg - 1
    q, kp, vp, _ = _case(2, 4, 2, 1, 8, ps, npg, width, seed=9)
    bt = np.stack([np.arange(width), np.full(width, trash)]).astype(np.int32)
    qpos = np.asarray([11, 0], np.int32)
    want = ops.paged_attention(*_t(q, kp, vp, bt, qpos), kv_split=split).numpy()
    kp[trash], vp[trash] = 1e4, -1e4
    got = ops.paged_attention(*_t(q, kp, vp, bt, qpos), kv_split=split).numpy()
    np.testing.assert_array_equal(got[0], want[0])
    assert np.all(np.isfinite(got[1]))
    pal = np.asarray(jfa.paged_attention_pallas(*_j(q, kp, vp, bt, qpos),
                                                kv_split=split,
                                                interpret=True))
    np.testing.assert_allclose(got, pal, **TOL)


def test_bf16_query_keeps_its_dtype():
    q, kp, vp, bt = _case(2, 4, 1, 1, 32, 8, 10, 4, seed=3)
    qpos = np.asarray([5, 20], np.int32)
    qt, kt, vt, btt, qpt = _t(q, kp, vp, bt, qpos)
    for split in (1, 2):
        out = ops.paged_attention(qt.to(torch.bfloat16), kt, vt, btt, qpt,
                                  kv_split=split)
        assert out.dtype == torch.bfloat16
        ref = ops.paged_attention(qt.to(torch.bfloat16).float(), kt, vt, btt,
                                  qpt, kv_split=split)
        np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                                   rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("split", [1, 2, 3, 5])
def test_combine_splits_matches(split):
    rs = np.random.RandomState(split)
    acc = rs.randn(split, 2, 3, 4, 8).astype(np.float32)
    m = rs.randn(split, 2, 3, 4, 1).astype(np.float32) * 3
    l = rs.rand(split, 2, 3, 4, 1).astype(np.float32) + 0.5
    m[0, 0] = -1e30                    # a dead partition
    l[0, 0] = 0.0
    acc[0, 0] = 0.0
    got = tref.combine_splits(*_t(acc, m, l))
    want = jfa.combine_splits(*_j(acc, m, l))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_all_dead_partitions_yield_zero():
    acc = torch.zeros((3, 1, 2, 4))
    m = torch.full((3, 1, 2, 1), -1e30)
    l = torch.zeros((3, 1, 2, 1))
    a, _, l_star = tref.combine_splits(acc, m, l)
    out = a / torch.clamp_min(l_star, 1e-30)
    assert torch.equal(out, torch.zeros_like(out))


# -- knob resolution ------------------------------------------------------
# the shape grid of tests/test_split_kv.py (table widths 1..64+, pages of
# 1..256 rows, batch up to the occupancy boundary) crossed with the knob
# values the engine and the suites pass
_NP = [1, 2, 3, 4, 5, 7, 8, 9, 12, 16, 33, 64, 257]
_PS = [1, 2, 4, 8, 16, 256]
_HKV = [1, 2, 8]
_BATCH = [1, 2, 4, 8, 511, 512, 4096]
_SPLIT = [None, 1, 2, 3, 4, 8]
_TILE = [None, 1, 2, 3, 8, 16]


def test_resolve_knobs_equal_over_grid():
    n = 0
    for np_, ps, hkv, batch, split, tile in itertools.product(
            _NP, _PS, _HKV, _BATCH, _SPLIT, _TILE):
        assert tfa._resolve_knobs(np_, ps, hkv, batch, split, tile) == \
            jfa._resolve_knobs(np_, ps, hkv, batch, split, tile), \
            (np_, ps, hkv, batch, split, tile)
        n += 1
    assert n > 10000


def test_choose_kv_split_and_auto_tile_equal_over_grid():
    for np_, ps, hkv, batch, tile in itertools.product(
            _NP, _PS, _HKV, _BATCH, [1, 2, 4, 8, 16]):
        assert tfa.choose_kv_split(np_ * ps, np_, hkv, batch=batch,
                                   pages_per_step=tile) == \
            jfa.choose_kv_split(np_ * ps, np_, hkv, batch=batch,
                                pages_per_step=tile)
        assert tfa.auto_pages_per_step(ps, np_) == \
            jfa.auto_pages_per_step(ps, np_)


def test_cost_constants_round_trip():
    """Installed constants re-rank both cost models the same way."""
    try:
        for consts in ({"tile_cost": 1.0, "combine_cost": 3.0},
                       {"target_lanes": 8.0}, {}):
            assert tfa.set_cost_constants(**consts) == \
                jfa.set_cost_constants(**consts)
            for np_, batch in itertools.product([8, 33, 64, 257], [1, 8, 64]):
                assert tfa.choose_kv_split(np_ * 16, np_, 1, batch=batch) == \
                    jfa.choose_kv_split(np_ * 16, np_, 1, batch=batch)
    finally:
        tfa.set_cost_constants()
        jfa.set_cost_constants()
    assert tfa.get_cost_constants() == jfa.get_cost_constants()


# -- the CUDA kernel's schedule, modelled in torch --------------------------
def _warp_schedule(q, kp, vp, bt, qpos, *, warps=8, rows_per_block=8,
                   kv_split=1, pages_per_step=1):
    """The paged kernel's schedule (csrc/paged_attention.cu) in f32: per
    (batch, KV head, 8-row tile) and partition -- the reference's entries
    ``[sp * nt * t, (sp + 1) * nt * t)`` -- the partition's entries up to
    the last visible position dealt round-robin to ``warps`` warps; each
    warp runs its own online softmax page by page (rows past the last
    visible position of any row of the block never read, out-of-range
    page ids skipped, a p of 0 multiplies nothing); the warps merge with
    ``combine_splits`` into the partition's (acc, m, l), and the
    partitions merge with ``combine_splits`` again.  One partition
    (``kv_split=1``) is the unsplit route."""
    b, hq, s, d = q.shape
    n_pages, hkv, ps, _ = kp.shape
    np_ = bt.shape[1]
    t = max(1, min(pages_per_step, np_))
    tiles = -(-np_ // t)
    split = max(1, min(kv_split, tiles))
    span = -(-tiles // split) * t
    qf = tref._fold(q, hkv).to(torch.float32) * float(1.0 / np.sqrt(d))
    rows = qf.shape[2]
    out = torch.zeros_like(qf)
    for bi in range(b):
        last = int(qpos[bi]) + s - 1
        npages = min(np_, last // ps + 1)
        qp = int(qpos[bi]) + torch.arange(rows) % s
        for h in range(hkv):
            for r0 in range(0, rows, rows_per_block):
                qt, qpt = qf[bi, h, r0:r0 + rows_per_block], \
                    qp[r0:r0 + rows_per_block, None]
                parts = []
                for sp in range(split):
                    e1 = min(npages, (sp + 1) * span)
                    states = []
                    for w in range(warps):
                        m = torch.full((qt.shape[0], 1), -1e30)
                        l = torch.zeros_like(m)
                        acc = torch.zeros_like(qt)
                        for e in range(sp * span + w, e1, warps):
                            pg = int(bt[bi, e])
                            if not 0 <= pg < n_pages:
                                continue
                            nc = min(ps, last - e * ps + 1)
                            kk = kp[pg, h, :nc].to(torch.float32)
                            vv = vp[pg, h, :nc].to(torch.float32)
                            vis = e * ps + torch.arange(nc)[None] <= qpt
                            logits = torch.where(vis, qt @ kk.T, -1e30)
                            m_new = torch.maximum(
                                m, logits.amax(-1, keepdim=True))
                            p = torch.where(vis, torch.exp(logits - m_new),
                                            0.0)
                            alpha = torch.exp(m - m_new)
                            l = alpha * l + p.sum(-1, keepdim=True)
                            pv = torch.where(p[..., None] != 0,
                                             p[..., None] * vv[None], 0.0)
                            acc = alpha * acc + pv.sum(1)
                            m = m_new
                        states.append((acc, m, l))
                    parts.append(tref.combine_splits(
                        *(torch.stack(x) for x in zip(*states))))
                a, _, l_star = tref.combine_splits(
                    *(torch.stack(x) for x in zip(*parts)))
                out[bi, h, r0:r0 + rows_per_block] = \
                    a / torch.clamp_min(l_star, 1e-30)
    return out.reshape(b, hkv, hq // hkv, s, d).reshape(b, hq, s, d) \
        .to(q.dtype)


def _unsplit_schedule(q, kp, vp, bt, qpos, *, warps=8, rows_per_block=8):
    """The unsplit route: the whole table as one partition."""
    return _warp_schedule(q, kp, vp, bt, qpos, warps=warps,
                          rows_per_block=rows_per_block)


def _schedule_vs_references(q, kp, vp, bt, qpos, **kw):
    got = _unsplit_schedule(*_t(q, kp, vp, bt, qpos), **kw).numpy()
    want = tref.paged_attention_ref(*_t(q, kp, vp, bt, qpos)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    pal = np.asarray(jfa._paged_attention_unsplit(*_j(q, kp, vp, bt, qpos),
                                                  interpret=True))
    np.testing.assert_allclose(got, pal, **TOL)
    return got


@pytest.mark.parametrize("warps", [8, 3])
@pytest.mark.parametrize("geom", GEOMS,
                         ids=lambda g: f"b{g[0]}h{g[1]}/{g[2]}s{g[3]}")
def test_unsplit_schedule_matches_reference_and_pallas(geom, warps):
    """Tables of 4-8 entries on 8 warps leave warps with no page (they
    must weigh 0); on 3 warps some warps take two or three pages."""
    b, hq, hkv, s, d, ps, npg, w, qpos = geom
    q, kp, vp, bt = _case(b, hq, hkv, s, d, ps, npg, w, seed=sum(geom[:8]))
    _schedule_vs_references(q, kp, vp, bt, np.asarray(qpos, np.int32),
                            warps=warps)


def test_unsplit_schedule_long_table_rows_beyond_one_block():
    """20 entries over 8 warps (two or three pages each), 16 folded rows
    (two row tiles), qpos at the end of the table and near its start."""
    q, kp, vp, bt = _case(2, 8, 2, 4, 16, 4, 45, 20, seed=21)
    _schedule_vs_references(q, kp, vp, bt, np.asarray([76, 6], np.int32))


def test_unsplit_schedule_one_page_table():
    q, kp, vp, bt = _case(3, 4, 1, 1, 32, 8, 5, 1, seed=22)
    _schedule_vs_references(q, kp, vp, bt, np.asarray([0, 3, 7], np.int32))


def test_unsplit_schedule_dead_lane_and_poisoned_rows():
    """A dead lane (all trash, qpos 0) beside a live one, a poisoned trash
    page and NaN in every row past the live lane's visible prefix: the
    live lane is unmoved, the dead lane finite, both match Pallas."""
    ps, width, npg = 4, 6, 13
    trash = npg - 1
    q, kp, vp, _ = _case(2, 4, 2, 1, 8, ps, npg, width, seed=23)
    bt = np.stack([np.arange(width), np.full(width, trash)]).astype(np.int32)
    qpos = np.asarray([17, 0], np.int32)
    clean = _schedule_vs_references(q, kp, vp, bt, qpos)
    kp[trash], vp[trash] = 1e4, -1e4
    poisoned = _schedule_vs_references(q, kp, vp, bt, qpos)
    np.testing.assert_array_equal(poisoned[0], clean[0])
    assert np.isfinite(poisoned[1]).all()
    for t in range(int(qpos[0]) + 1, width * ps):
        kp[bt[0, t // ps], :, t % ps] = np.nan
        vp[bt[0, t // ps], :, t % ps] = np.nan
    nan_rows = _unsplit_schedule(*_t(q, kp, vp, bt, qpos)).numpy()
    np.testing.assert_array_equal(nan_rows[0], clean[0])


# -- the split route: partitions walked by 8 warps each, then combined -----
def _split_vs_references(q, kp, vp, bt, qpos, kv_split, pages_per_step):
    knobs = dict(kv_split=kv_split, pages_per_step=pages_per_step)
    got = _warp_schedule(*_t(q, kp, vp, bt, qpos), **knobs).numpy()
    want = tref.paged_attention_split_ref(*_t(q, kp, vp, bt, qpos),
                                          **knobs).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    pal = np.asarray(jfa.paged_attention_pallas(*_j(q, kp, vp, bt, qpos),
                                                interpret=True, **knobs))
    np.testing.assert_allclose(got, pal, **TOL)
    return got


# (b, hq, hkv, s, d, ps, num_pages, width, qpos): group 1 and 8, S 1 and
# 16 (a prefill chunk: 128 folded rows, 16 row tiles at group 8), tables
# of 36 entries, so 8 partitions of 1-8 tiles each; qpos from the start
# of the table (later partitions see nothing) to its end
SPLIT_GEOMS = [
    (2, 2, 2, 1, 16, 4, 40, 36, [70, 141]),     # group 1, decode
    (2, 8, 1, 1, 16, 4, 40, 36, [3, 130]),      # group 8 (MQA), decode
    (2, 8, 1, 16, 16, 4, 40, 36, [0, 120]),     # group 8, prefill chunk
    (2, 2, 2, 16, 16, 4, 40, 36, [50, 128]),    # group 1, S 16
]


@pytest.mark.parametrize("tile", [1, 2, 8])
@pytest.mark.parametrize("split", [2, 4, 8])
@pytest.mark.parametrize("geom", SPLIT_GEOMS,
                         ids=lambda g: f"b{g[0]}h{g[1]}/{g[2]}s{g[3]}")
def test_split_schedule_matches_reference_and_pallas(geom, split, tile):
    b, hq, hkv, s, d, ps, npg, w, qpos = geom
    q, kp, vp, bt = _case(b, hq, hkv, s, d, ps, npg, w,
                          seed=sum(geom[:8]) + 10 * split + tile)
    _split_vs_references(q, kp, vp, bt, np.asarray(qpos, np.int32), split,
                         tile)


def test_split_schedule_partition_without_a_page():
    """qpos 5 at 4-row pages: two visible pages, both in partition 0 of
    four (nine entries each); partitions 1-3 see nothing and weigh 0."""
    q, kp, vp, bt = _case(2, 8, 1, 1, 16, 4, 40, 36, seed=31)
    qpos = np.asarray([5, 140], np.int32)
    got = _split_vs_references(q, kp, vp, bt, qpos, 4, 1)
    unsplit = tref.paged_attention_ref(*_t(q, kp, vp, bt, qpos)).numpy()
    np.testing.assert_allclose(got, unsplit, **TOL)


def test_split_schedule_one_page_partitions():
    """Eight partitions of one page each (table of 8), and a last
    partition holding a single visible page of a longer table."""
    q, kp, vp, bt = _case(2, 8, 1, 1, 16, 4, 12, 8, seed=32)
    _split_vs_references(q, kp, vp, bt, np.asarray([31, 17], np.int32), 8, 1)
    q, kp, vp, bt = _case(2, 4, 2, 1, 16, 4, 20, 9, seed=33)
    _split_vs_references(q, kp, vp, bt, np.asarray([33, 32], np.int32), 2, 4)


def test_split_schedule_dead_lane_and_poisoned_rows():
    """The split route with a dead lane (all trash, qpos 0) on a poisoned
    trash page and NaN in every row past the live lane's visible prefix:
    the live lane is unmoved, the dead lane finite, both match Pallas."""
    ps, width, npg = 4, 12, 19
    trash = npg - 1
    q, kp, vp, _ = _case(2, 8, 1, 1, 8, ps, npg, width, seed=34)
    bt = np.stack([np.arange(width), np.full(width, trash)]).astype(np.int32)
    qpos = np.asarray([25, 0], np.int32)
    for split, tile in ((2, 1), (4, 2), (8, 1)):
        kp_, vp_ = kp.copy(), vp.copy()
        clean = _split_vs_references(q, kp_, vp_, bt, qpos, split, tile)
        kp_[trash], vp_[trash] = 1e4, -1e4
        poisoned = _split_vs_references(q, kp_, vp_, bt, qpos, split, tile)
        np.testing.assert_array_equal(poisoned[0], clean[0])
        assert np.isfinite(poisoned[1]).all()
        for t in range(int(qpos[0]) + 1, width * ps):
            kp_[bt[0, t // ps], :, t % ps] = np.nan
            vp_[bt[0, t // ps], :, t % ps] = np.nan
        nan_rows = _warp_schedule(*_t(q, kp_, vp_, bt, qpos), kv_split=split,
                                  pages_per_step=tile).numpy()
        np.testing.assert_array_equal(nan_rows[0], clean[0])
