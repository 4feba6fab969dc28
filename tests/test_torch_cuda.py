"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need an NVIDIA GPU and ``nvcc`` (the kernels are
compiled from ``src/repro_torch/kernels/csrc`` at first use) and skip
elsewhere.  Run them on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("mkn", [(8, 2048, 256), (128, 2048, 2048),
                                 (130, 300, 70), (7, 13, 5), (1, 1024, 1)])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_qmatmul_kernel_matches_plain(card, mkn, out_dtype):
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_plain
    m, k, n = mkn
    dt = getattr(torch, out_dtype)
    a = torch.randint(-128, 128, (m, k), generator=card, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=card, device="cuda",
                      dtype=torch.int8)
    sa = torch.rand((m, 1), generator=card, device="cuda") + 0.1
    sb = torch.rand((1, n), generator=card, device="cuda") + 0.1
    before = _cuda.LAUNCHES["qmatmul"]
    got = qmatmul(a, b, sa, sb, out_dtype=dt)
    want = qmatmul_plain(a, b, sa, sb, out_dtype=dt)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["qmatmul"] == before + 1
    assert got.dtype == dt
    # exact int32 accumulation, same epilogue op order: bitwise equal
    assert torch.equal(got, want)


@pytest.mark.parametrize("indexing", ["trunc", "nearest", "interp"])
@pytest.mark.parametrize("gated", [False, True])
def test_qmatmul_fused_epilogue_matches_plain(card, indexing, gated):
    _fused_epilogue_case(card, indexing, gated, (-8.0, 8.0))


@pytest.mark.parametrize("indexing", ["trunc", "nearest", "interp"])
@pytest.mark.parametrize("gated", [False, True])
def test_qmatmul_fused_epilogue_non_power_of_two_step(card, indexing, gated):
    """A table step of 20/1024: the plain version indexes as the kernel
    does, ``(y - lo) * step_inv``, so the two still agree bit for bit."""
    _fused_epilogue_case(card, indexing, gated, (-10.0, 10.0))


def _fused_epilogue_case(card, indexing, gated, domain):
    from repro_torch.core.tables import TableSpec
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_plain
    a = torch.randint(-127, 128, (32, 128), generator=card, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (128, 64), generator=card, device="cuda",
                      dtype=torch.int8)
    sa = (torch.rand((32, 1), generator=card, device="cuda") + 0.1) * 5e-3
    sb = (torch.rand((1, 64), generator=card, device="cuda") + 0.1) * 5e-3
    bias = torch.randn((64,), generator=card, device="cuda")
    # the same indexing and the same single-rounded operations: bitwise
    spec = TableSpec("silu_gate" if gated else "sigmoid", 1024, *domain,
                     None, indexing)
    got = qmatmul(a, b, sa, sb, bias, act_spec=spec, act_gated=gated)
    want = qmatmul_plain(a, b, sa, sb, bias, act_spec=spec, act_gated=gated)
    assert torch.equal(got, want)


#: (S, query group, D, table entries): S 1, 5 and 16 at groups 1, 8 and
#: 16, each at D 64, 128 and 256 (the widest rows: 16 x 16 = 256 rows of
#: 256), S 3 at group 2 (6 rows), then a long table (70 entries of 16
#: rows)
PAGED_GEOMS = ([(s, group, d, 7) for d in (64, 128, 256) for s in (1, 5, 16)
                for group in (1, 8, 16)] + [(3, 2, 64, 7)]
               + [(s, group, d, 70) for d in (64, 128, 256)
                  for s, group in ((1, 8), (16, 8))])


@pytest.mark.parametrize("instance", ["hopper", "control"])
@pytest.mark.parametrize("knobs", [(1, 1), (2, 1), (3, 2), (2, 8), (4, 1),
                                   (16, 1), (32, 1)])
@pytest.mark.parametrize("geom", PAGED_GEOMS,
                         ids=lambda g: "s{}g{}d{}w{}".format(*g))
def test_paged_attention_kernels_match_plain(card, geom, knobs, instance):
    """(split, tile) pairs: the reference's points, and the one-page tiles
    with 4 to 32 partitions that the fitted autotuner picks; a table wider
    than the split, so that no split is clamped away; both kernels (the
    Hopper kernel on its plan's grid, the control), each counted by its
    launch count; a dead lane on the trash page, and garbage past each
    live lane's visible prefix that must never leak; and the op layer
    (its knob resolution and the plan's own routing) against its
    ``backend="ref"``."""
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels.flash_attention import (_resolve_knobs,
                                                     paged_attention_split,
                                                     paged_attention_unsplit,
                                                     paged_call_plan)
    from repro_torch.kernels.ref import (paged_attention_ref,
                                         paged_attention_split_ref)
    s, group, d, width0 = geom
    split, tile = knobs
    b, hkv, ps = 3, 2, 16
    width = max(width0, split + 3)
    npg = max(30, b * width + 1)
    q = torch.randn((b, hkv * group, s, d), generator=card, device="cuda")
    kp = torch.randn((npg, hkv, ps, d), generator=card, device="cuda")
    vp = torch.randn((npg, hkv, ps, d), generator=card, device="cuda")
    bt = torch.randperm(npg - 1, generator=card, device="cuda")[:b * width] \
        .reshape(b, width).to(torch.int32)
    bt[2] = npg - 1                         # a dead lane on the trash page
    qpos = torch.tensor([5, width * ps - s, 0], dtype=torch.int32,
                        device="cuda")
    t, split = _resolve_knobs(width, ps, hkv, b, split, tile)
    plan = paged_call_plan(q, kp, vp, bt, kv_split=split, pages_per_step=t,
                           instance=instance)
    unsplit = (t, split) == (1, 1)
    name = ("paged_attention_control" if instance == "control" else
            "paged_attention_unsplit" if unsplit else
            "paged_attention_split")

    def run(kp, vp):
        if unsplit:
            return paged_attention_unsplit(q, kp, vp, bt, qpos, plan=plan)
        return paged_attention_split(q, kp, vp, bt, qpos, kv_split=split,
                                     pages_per_step=t, plan=plan)
    before = _cuda.LAUNCHES[name]
    got = run(kp, vp)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[name] == before + 1
    want = (paged_attention_ref(q, kp, vp, bt, qpos) if unsplit else
            paged_attention_split_ref(q, kp, vp, bt, qpos, kv_split=split,
                                      pages_per_step=t))
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    if instance == "hopper":
        torch.testing.assert_close(
            ops.paged_attention(q, kp, vp, bt, qpos, kv_split=knobs[0],
                                pages_per_step=tile),
            ops.paged_attention(q, kp, vp, bt, qpos, kv_split=knobs[0],
                                pages_per_step=tile, backend="ref"),
            rtol=2e-5, atol=2e-5)
        if knobs == (1, 1):         # once a geometry: the auto knobs
            torch.testing.assert_close(
                ops.paged_attention(q, kp, vp, bt, qpos),
                ops.paged_attention(q, kp, vp, bt, qpos, backend="ref"),
                rtol=2e-5, atol=2e-5)
    # garbage past each lane's visible prefix never leaks
    kp2, vp2 = kp.clone(), vp.clone()
    for lane in range(2):
        lo = int(qpos[lane]) + s
        for e in range(lo // ps, width):
            rows = slice(lo - e * ps if e == lo // ps else 0, ps)
            pg = int(bt[lane, e])
            kp2[pg, :, rows] = 1e4
            vp2[pg, :, rows] = float("nan")
    again = run(kp2, vp2)
    assert torch.equal(again[:2], got[:2])


@pytest.mark.parametrize("shape", [(8, 16384), (128, 16384), (3, 1001),
                                   (7,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("indexing", ["trunc", "nearest", "interp"])
@pytest.mark.parametrize("table", [("gelu_gate", -8.0, 8.0),
                                   ("silu_gate", -10.0, 10.0)])
def test_lut_activation_kernel_matches_plain(card, shape, dtype, indexing,
                                             table):
    """Bitwise: the kernel and its plain version compute every f32
    operation with one rounding, in the same order, and both round the
    same f32 value to bf16.  (3, 1001) and (7,) leave a scalar tail; a
    view at offset 1 is not 16-byte aligned and takes the scalar path."""
    from repro_torch.core.tables import TableSpec
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.lut_activation import (lut_activation,
                                                    lut_activation_plain)
    dt = getattr(torch, dtype)
    spec = TableSpec(table[0], 1024, table[1], table[2], None, indexing)
    x = (torch.randn(shape, generator=card, device="cuda") * 6).to(dt)
    before = _cuda.LAUNCHES["lut_activation"]
    got = lut_activation(x, spec)
    want = lut_activation_plain(x, spec)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["lut_activation"] == before + 1
    assert got.dtype == dt and got.shape == x.shape
    assert torch.equal(got, want)
    flat = x.reshape(-1)
    if flat.numel() > 1:
        assert torch.equal(lut_activation(flat[1:], spec),
                           lut_activation_plain(flat[1:], spec))


def test_lut_activation_kernel_refuses(card):
    from repro_torch.core.tables import TableSpec
    from repro_torch.kernels.lut_activation import lut_activation
    x = torch.randn((4, 8), generator=card, device="cuda")
    with pytest.raises(ValueError, match="exceeds"):
        lut_activation(x, TableSpec("gelu_gate", 8192))
    with pytest.raises(TypeError, match="f32 or bf16"):
        lut_activation(x.half(), TableSpec("gelu_gate"))


@pytest.mark.parametrize("m,k,n", [(8, 2048, 256), (130, 300, 70)])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_qmatmul_bias_epilogue_matches_plain(card, m, k, n, out_dtype):
    """With a bias the kernel rounds ``fma(acc * sa, sb, bias)`` once, as
    the plain version does (and XLA compiles the reference): bitwise."""
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_plain
    dt = getattr(torch, out_dtype)
    a = torch.randint(-127, 128, (m, k), generator=card, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=card, device="cuda",
                      dtype=torch.int8)
    sa = (torch.rand((m, 1), generator=card, device="cuda") + 0.1) * 5e-3
    sb = (torch.rand((1, n), generator=card, device="cuda") + 0.1) * 5e-3
    bias = torch.randn((n,), generator=card, device="cuda")
    assert torch.equal(qmatmul(a, b, sa, sb, bias, dt),
                       qmatmul_plain(a, b, sa, sb, bias, dt))


def _flash_close(got, want):
    """bf16: one bf16 ulp of the output plus 2e-5 (f32 sums in another
    order); f32: atol = rtol = 2e-5."""
    gf, wf = got.float(), want.float()
    assert torch.isfinite(gf).all()
    if got.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(
            wf.abs().clamp_min(2.0 ** -126))) - 7)
        assert ((gf - wf).abs() <= ulp + 2e-5).all(), \
            (gf - wf).abs().max().item()
    else:
        torch.testing.assert_close(gf, wf, atol=2e-5, rtol=2e-5)


# (B, Hq, Hkv, Sq, Skv, D, causal): the whisper encoder's head shape,
# gemma's MQA at D 256, ragged Sq < Skv and Sq > Skv, the MLA width, a
# causal case whose first query rows see no key, single rows
FLASH_SHAPES = [(2, 8, 8, 150, 150, 64, False), (2, 8, 1, 100, 100, 256, True),
                (2, 8, 2, 77, 200, 64, True), (2, 8, 2, 200, 77, 64, False),
                (1, 4, 4, 70, 70, 192, True), (1, 4, 2, 90, 20, 32, True),
                (3, 2, 2, 1, 1, 16, False), (1, 2, 1, 1, 130, 128, True)]


@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(card, shape, dtype):
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    b, hq, hkv, sq, skv, d, causal = shape
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((b, h, s, d), generator=card, device="cuda").to(dt)
               for h, s in ((hq, sq), (hkv, skv), (hkv, skv)))
    before = _cuda.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, softmax_scale=0.2)
    want = flash_attention_plain(q, k, v, causal=causal, softmax_scale=0.2)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dt and got.shape == q.shape
    _flash_close(got, want)
    if causal and sq > skv:         # rows that see no key are 0, not NaN
        assert (got[:, :, :sq - skv] == 0).all()


def test_flash_attention_kernel_never_reads_past_skv(card):
    """K/V are views into buffers whose rows past Skv hold NaN: nothing
    past Skv is read or multiplied."""
    from repro_torch.kernels.flash_attention import flash_attention
    sq, skv, d = 70, 100, 64
    q = torch.randn((1, 2, sq, d), generator=card, device="cuda")
    bufs = [torch.full((1, 1, skv + 37, d), float("nan"), device="cuda")
            for _ in range(2)]
    for buf in bufs:
        buf[:, :, :skv] = torch.randn((1, 1, skv, d), generator=card,
                                      device="cuda")
    k, v = (buf[:, :, :skv] for buf in bufs)
    assert k.is_contiguous() and v.is_contiguous()
    for causal in (False, True):
        got = flash_attention(q, k, v, causal=causal)
        assert torch.isfinite(got).all()
        assert torch.equal(got, flash_attention(q, k.clone(), v.clone(),
                                                causal=causal))


# (B, Hq, Hkv, Sq, Skv, D, causal) for the tensor-core kernels: Sq and Skv
# off the 64-row tiles and the 128-row mark, a single query row, Sq > Skv
# causal (the first rows see no key), every instance (D 32/64 -> 64, 128,
# 192, 256), groups 1, 2 and 8, and a head dim that is not a multiple of 8
# (the mma.sync kernel, which stages it with plain loads); then shapes
# whose flash_fwd_plan packs two query heads of a GQA group a block (a
# group of 4 at D 192; gemma-2b's MQA at D 256, its training shape), and
# one where it takes 64-row blocks of one consumer (gemma-2b's prefill
# at B 2)
FLASH_BF16_EDGES = [(1, 8, 8, 129, 191, 64, True), (2, 8, 1, 1, 300, 256, True),
                    (2, 4, 2, 1, 1, 32, False), (1, 8, 1, 200, 70, 64, True),
                    (1, 2, 1, 65, 130, 192, True), (1, 4, 4, 127, 63, 128,
                                                    False),
                    (2, 8, 1, 100, 257, 256, False), (1, 2, 2, 40, 90, 20,
                                                      True),
                    (2, 16, 4, 300, 300, 192, True),
                    (8, 8, 1, 256, 256, 256, True),
                    (2, 8, 1, 512, 512, 256, True)]


@pytest.mark.parametrize("shape", FLASH_BF16_EDGES,
                         ids=lambda s: "-".join(map(str, s)))
def test_flash_attention_bf16_edge_shapes(card, shape):
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention import FLASH_FWD_ROUTES
    b, hq, hkv, sq, skv, d, causal = shape
    q, k, v = (torch.randn((b, h, s, d), generator=card,
                           device="cuda").bfloat16()
               for h, s in ((hq, sq), (hkv, skv), (hkv, skv)))
    before = _cuda.LAUNCHES["flash_attention"]
    route = "wgmma" if d % 8 == 0 else "mma"
    routed = FLASH_FWD_ROUTES[route]
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention"] == before + 1
    assert FLASH_FWD_ROUTES[route] == routed + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _flash_close(got, want)
    if causal and sq > skv:         # rows that see no key are exactly 0
        assert (got[:, :, :sq - skv] == 0).all()
        assert (got[:, :, sq - skv:] != 0).any()


def test_flash_attention_bf16_unaligned_view(card):
    """An operand view that is not 16-byte aligned stages with plain
    loads, with the same result."""
    from repro_torch.kernels.flash_attention import flash_attention
    d = 64
    q, k, v = (torch.randn((1, 2, 70, d), generator=card,
                           device="cuda").bfloat16() for _ in range(3))
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device="cuda")
    view = flat[1:].view(q.shape)
    view.copy_(q)
    assert view.data_ptr() % 16 and view.is_contiguous()
    assert torch.equal(flash_attention(view, k, v, causal=True),
                       flash_attention(q, k, v, causal=True))


# (B, Hq, Hkv, Sq, Skv, causal) for every grid of the TMA kernel at every
# instance: ragged Sq and Skv, Sq > Skv causal (rows that see no key, an
# item whose 64 rows see fewer tiles than its block's other item), and
# one KV head whose K/V are views into buffers that hold NaN past Skv
FLASH_PLAN_SHAPES = [(2, 4, 2, 130, 200, True), (1, 4, 2, 200, 70, True),
                     (2, 4, 2, 100, 150, False), (1, 4, 1, 150, 190, True)]


#: (grid, D): every grid at every instance (three consumers are built
#: for D <= 64 only)
FLASH_GRIDS = [(grid, d) for d in (32, 64, 128, 192, 256)
               for grid in ("one", "two-rows", "two-heads", "three")
               if grid != "three" or d <= 64]


@pytest.mark.parametrize("grid,d", FLASH_GRIDS,
                         ids=[f"{g}-{d}" for g, d in FLASH_GRIDS])
@pytest.mark.parametrize("shape", FLASH_PLAN_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_flash_attention_bf16_every_grid(card, shape, grid, d):
    """The TMA kernel on each grid that flash_fwd_plan can choose, its
    output and log-sum-exp against the plain versions, and the output
    bitwise the same with and without the log-sum-exp."""
    from repro_torch.kernels.flash_attention import (FlashFwdPlan,
                                                     _flash_fwd_launch,
                                                     flash_attention_plain)
    from repro_torch.kernels.ref import flash_attention_lse_plain
    b, hq, hkv, sq, skv, causal = shape
    q = torch.randn((b, hq, sq, d), generator=card, device="cuda").bfloat16()
    kv = []
    for _ in range(2):
        buf = torch.full((b, hkv, skv + 37, d), float("nan"), device="cuda",
                         dtype=torch.bfloat16)
        buf[:, :, :skv] = torch.randn((b, hkv, skv, d), generator=card,
                                      device="cuda").bfloat16()
        kv.append(buf[:, :, :skv] if b * hkv == 1 else
                  buf[:, :, :skv].contiguous())
    k, v = kv
    assert k.is_contiguous() and v.is_contiguous()
    wgs = {"one": 1, "two-rows": 2, "two-heads": 2, "three": 3}[grid]
    plan = FlashFwdPlan(b, hq, hkv, sq, skv, d, causal, wgs,
                        grid == "two-heads")
    got, lse = _flash_fwd_launch(q, k, v, causal, 0.2, True, plan)
    out, _ = _flash_fwd_launch(q, k, v, causal, 0.2, False, plan)
    want = flash_attention_plain(q, k, v, causal=causal, softmax_scale=0.2)
    lse_p = flash_attention_lse_plain(q, k, causal=causal, softmax_scale=0.2)
    torch.cuda.synchronize()
    _flash_close(got, want)
    assert torch.equal(got.view(torch.int16), out.view(torch.int16))
    fin = torch.isfinite(lse_p)
    assert torch.equal(fin, torch.isfinite(lse))
    torch.testing.assert_close(lse[fin], lse_p[fin], atol=1e-4, rtol=1e-5)
    if causal and sq > skv:
        assert (got[:, :, :sq - skv] == 0).all()


def test_flash_attention_bf16_never_reads_past_skv(card):
    """bf16 K/V views into buffers whose rows past Skv hold NaN: the
    tensor-core kernel zero-fills them and never reads them."""
    from repro_torch.kernels.flash_attention import flash_attention
    sq, skv, d = 70, 100, 64
    q = torch.randn((1, 2, sq, d), generator=card, device="cuda").bfloat16()
    bufs = [torch.full((1, 1, skv + 37, d), float("nan"), device="cuda",
                       dtype=torch.bfloat16) for _ in range(2)]
    for buf in bufs:
        buf[:, :, :skv] = torch.randn((1, 1, skv, d), generator=card,
                                      device="cuda").bfloat16()
    k, v = (buf[:, :, :skv] for buf in bufs)
    assert k.is_contiguous() and v.is_contiguous()
    for causal in (False, True):
        got = flash_attention(q, k, v, causal=causal)
        assert torch.isfinite(got.float()).all()
        assert torch.equal(got, flash_attention(q, k.clone(), v.clone(),
                                                causal=causal))


def _unsplit_case(card, visible_pages, q_dtype, s=1):
    """gemma-2b's heads (8 q on 1 KV, D 256), 16-row pages, three lanes:
    lane 0 sees ``visible_pages`` pages, lane 1 one row fewer, lane 2 is
    dead (a table of trash pages, qpos 0); the trash page is last and
    poisoned with large finite values, as dead-lane writes leave it."""
    hq, hkv, d, ps, b = 8, 1, 256, 16, 3
    width = visible_pages + 2
    npg = 2 * width + 1
    trash = npg - 1
    kp = torch.randn((npg, hkv, ps, d), generator=card, device="cuda")
    vp = torch.randn((npg, hkv, ps, d), generator=card, device="cuda")
    kp[trash], vp[trash] = 1e4, -1e4
    bt = torch.randperm(npg - 1, generator=card, device="cuda")[:2 * width] \
        .reshape(2, width).to(torch.int32)
    bt = torch.cat([bt, torch.full((1, width), trash, dtype=torch.int32,
                                   device="cuda")])
    tokens = visible_pages * ps
    qpos = torch.tensor([tokens - s, tokens - s - 1, 0], dtype=torch.int32,
                        device="cuda")
    q = torch.randn((b, hq, s, d), generator=card, device="cuda").to(q_dtype)
    return q, kp, vp, bt, qpos


def _unsplit_close(got, want):
    if got.dtype == torch.bfloat16:
        # one bf16 ulp at |x| in [2, 4) + relative slack (chip_smoke's gate)
        torch.testing.assert_close(got.float(), want.float(), atol=2.0 ** -6,
                                   rtol=2.0 ** -8)
    else:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("visible_pages", [1, 5, 9, 257])
def test_paged_unsplit_kernel_pages(card, visible_pages, q_dtype):
    """1 and 5 pages leave warps without a page, 9 gives one warp two,
    257 is the decode-4096 table; the dead lane on the poisoned trash
    page stays finite, and NaN in every unwritten page row never leaks."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.flash_attention import paged_attention_unsplit
    from repro_torch.kernels.ref import paged_attention_ref
    q, kp, vp, bt, qpos = _unsplit_case(card, visible_pages,
                                        getattr(torch, q_dtype))
    before = _cuda.LAUNCHES["paged_attention_unsplit"]
    got = paged_attention_unsplit(q, kp, vp, bt, qpos)
    want = paged_attention_ref(q, kp, vp, bt, qpos)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["paged_attention_unsplit"] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    _unsplit_close(got[:2], want[:2])
    assert torch.isfinite(got[2].float()).all()
    # NaN in every row past each live lane's visible prefix
    kp2, vp2 = kp.clone(), vp.clone()
    ps = kp.shape[2]
    for lane in range(2):
        for t in range(int(qpos[lane]) + 1, bt.shape[1] * ps):
            pg = int(bt[lane, t // ps])
            kp2[pg, :, t % ps] = float("nan")
            vp2[pg, :, t % ps] = float("nan")
    again = paged_attention_unsplit(q, kp2, vp2, bt, qpos)
    assert torch.equal(again[:2], got[:2])


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_paged_unsplit_kernel_prefill_chunk(card, q_dtype):
    """A 16-row prefill chunk (128 folded rows, 16 row tiles) against the
    plain version, with NaN past the chunk's last position."""
    from repro_torch.kernels.flash_attention import paged_attention_unsplit
    from repro_torch.kernels.ref import paged_attention_ref
    q, kp, vp, bt, qpos = _unsplit_case(card, 9, getattr(torch, q_dtype),
                                        s=16)
    got = paged_attention_unsplit(q, kp, vp, bt, qpos)
    _unsplit_close(got[:2], paged_attention_ref(q, kp, vp, bt, qpos)[:2])
    kp2, vp2 = kp.clone(), vp.clone()
    ps = kp.shape[2]
    for lane in range(2):
        for t in range(int(qpos[lane]) + 16, bt.shape[1] * ps):
            pg = int(bt[lane, t // ps])
            kp2[pg, :, t % ps] = float("nan")
            vp2[pg, :, t % ps] = float("nan")
    assert torch.equal(paged_attention_unsplit(q, kp2, vp2, bt, qpos)[:2],
                       got[:2])


def test_paged_unsplit_kernel_refuses(card):
    from repro_torch.kernels.flash_attention import paged_attention_unsplit
    q = torch.randn((1, 2, 1, 30), device="cuda")
    kp = torch.randn((3, 1, 4, 30), device="cuda")
    bt = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    qpos = torch.zeros((1,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        paged_attention_unsplit(q, kp, kp, bt, qpos)


def test_flash_attention_kernel_refuses(card):
    from repro_torch.kernels.flash_attention import flash_attention
    x = torch.randn((1, 2, 4, 320), generator=card, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(x, x, x)
    y = torch.randn((1, 2, 4, 64), generator=card, device="cuda")
    with pytest.raises(TypeError, match="f32 or bf16"):
        flash_attention(y.half(), y.half(), y.half())
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(y, y.bfloat16(), y)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        flash_attention(torch.randn((1, 3, 4, 64), device="cuda"), y, y)


# -- the tensor-core qmatmul at its tilings' edges ---------------------------
# M: decode's one and two n8 token tiles (1, 8 / 15, 16), the first 128-row
# tile (17, 127) and a ragged second one (129); K: one mma step, a K that
# is not a multiple of 16 (byte-staged rows), gemma's 2048 and 16384; N: one
# n8 tile, a ragged 12, whisper/gemma's 256 and an odd 2049 (byte-staged B)
QMM_M = [1, 8, 15, 16, 17, 127, 129]
QMM_K = [32, 36, 2048, 16384]
QMM_N = [8, 12, 256, 2049]


def _qmm_operands(card, m, k, n):
    a = torch.randint(-128, 128, (m, k), generator=card, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=card, device="cuda",
                      dtype=torch.int8)
    sa = (torch.rand((m, 1), generator=card, device="cuda") + 0.1) * 1e-3
    sb = (torch.rand((1, n), generator=card, device="cuda") + 0.1) * 1e-3
    return a, b, sa, sb


@pytest.mark.parametrize("n", QMM_N)
@pytest.mark.parametrize("k", QMM_K)
@pytest.mark.parametrize("m", QMM_M)
def test_qmatmul_tiling_edges_bitwise(card, m, k, n):
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_plain
    a, b, sa, sb = _qmm_operands(card, m, k, n)
    bias = torch.randn((n,), generator=card, device="cuda")
    dt = torch.bfloat16 if (m + k + n) % 2 else torch.float32
    before = _cuda.LAUNCHES["qmatmul"]
    got = qmatmul(a, b, sa, sb, bias if m % 2 else None, dt)
    want = qmatmul_plain(a, b, sa, sb, bias if m % 2 else None, dt)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["qmatmul"] == before + 1
    assert got.dtype == dt and got.shape == (m, n)
    assert torch.equal(got, want)


#: the plan's instances at their edges: the weight stream's row counts
#: (M 16/17, 64, verify's 40), the wgmma instance's first rows (65) and
#: its 128-row tiles (128/129); K 256 (2 stages) and 16384; the jet's
#: four layers at M 16384 (fc3's N 5 on the control); N 5 at decode; the
#: narrow tile at the M edges, K in one or two k32 steps
QMM_PLAN_CASES = ([(m, k, 2048) for m in (16, 17, 40, 64, 65, 128, 129)
                   for k in (256, 16384)]
                  + [(16384, 16, 64), (16384, 64, 32), (16384, 32, 32),
                     (16384, 32, 5), (8, 2048, 5), (65, 16, 64),
                     (129, 48, 48)])


@pytest.mark.parametrize("mkn", QMM_PLAN_CASES, ids=str)
def test_qmatmul_plan_instances_bitwise(card, mkn):
    """The planned instance, the control (the parent kernel) and the TMA
    instance of the row count unsplit and split three ways (the narrow
    tile: at each of its row counts): each one counted launch, each
    ``torch.equal`` the plain version."""
    import dataclasses

    from repro_torch.kernels import _cuda
    from repro_torch.kernels.qmatmul import (NARROW, NARROW_ROWS, qmatmul,
                                             qmatmul_plain, qmatmul_plan)
    m, k, n = mkn
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    a, b, sa, sb = _qmm_operands(card, m, k, n)
    bias = torch.randn((n,), generator=card, device="cuda")
    plan = qmatmul_plan(m, n, k, sms)
    plans = [plan, qmatmul_plan(m, n, k, sms, "control")]
    tma = "stream" if m <= 64 else "wgmma"
    if n % 16 == 0:
        p0 = qmatmul_plan(m, n, k, sms, tma)
        plans += ([dataclasses.replace(p0, rows=r) for r in NARROW_ROWS]
                  if p0.cols == NARROW else
                  [dataclasses.replace(p0, splits=s)
                   for s in sorted({1, min(3, -(-k // 128))})])
    assert plan.instance == ("control" if n % 16 or (m <= 16 and k <= 512)
                             else tma)
    for dt in (torch.float32, torch.bfloat16):
        want = qmatmul_plain(a, b, sa, sb, bias, dt)
        for p in plans:
            before = _cuda.LAUNCHES["qmatmul"]
            got = qmatmul(a, b, sa, sb, bias, dt, plan=p)
            torch.cuda.synchronize()
            assert _cuda.LAUNCHES["qmatmul"] == before + 1
            assert torch.equal(got, want), p


@pytest.mark.parametrize("m", [8, 16, 128])
@pytest.mark.parametrize("value", [-128, 127])
def test_qmatmul_extreme_operands_exact(card, m, value):
    """All -128 (or all 127) at K 16384: every sum is 128^2 (127^2) x
    16384, exact in int32; an f32 output of scales 1 shows it."""
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_plain
    k, n = 16384, 256
    a = torch.full((m, k), value, dtype=torch.int8, device="cuda")
    b = torch.full((k, n), value, dtype=torch.int8, device="cuda")
    got = qmatmul(a, b, 1.0, 1.0)
    assert torch.equal(got, qmatmul_plain(a, b, 1.0, 1.0))
    assert (got == float(value * value * k)).all()


@pytest.mark.parametrize("mkn", [(8, 2048, 256), (8, 16384, 2048),
                                 (16, 2048, 2048), (128, 16384, 2048)])
def test_qmatmul_split_k_twice_leaves_workspace_zeroed(card, mkn):
    """Split-K shapes (decode's N 256 and 2048, the down projection, a
    128-row chunk of the down projection) run twice in a row: the second
    launch finds the workspace and tickets zeroed, so both are bitwise the
    plain version."""
    from repro_torch.kernels import qmatmul as qmod
    m, k, n = mkn
    assert qmod.qmatmul_plan(m, n, k, torch.cuda.get_device_properties(
        0).multi_processor_count).splits > 1
    a, b, sa, sb = _qmm_operands(card, m, k, n)
    want = qmod.qmatmul_plain(a, b, sa, sb, out_dtype=torch.bfloat16)
    for _ in range(2):
        assert torch.equal(qmod.qmatmul(a, b, sa, sb,
                                        out_dtype=torch.bfloat16), want)
    ws, tickets = (_stream_scratch(name, a.device) for name in (
        "qmatmul_workspace", "qmatmul_tickets"))
    torch.cuda.synchronize()
    assert not ws.any() and not tickets.any()


def _stream_scratch(name, device):
    """The current stream's zeroed scratch buffer ``name`` (None before
    its first split launch)."""
    from repro_torch.kernels import _cuda
    return _cuda.SCRATCH.get((name, device,
                              torch.cuda.current_stream(device).cuda_stream))


@pytest.mark.parametrize("m", [8, 128])
def test_qmatmul_unaligned_view_of_a(card, m):
    """A view of A one byte into its buffer is not 16-byte aligned: its
    rows stage with byte loads, with the same result."""
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_plain
    k, n = 2048, 256
    a, b, sa, sb = _qmm_operands(card, m, k, n)
    flat = torch.empty(m * k + 1, dtype=torch.int8, device="cuda")
    view = flat[1:].view(m, k)
    view.copy_(a)
    assert view.data_ptr() % 16 and view.is_contiguous()
    got = qmatmul(view, b, sa, sb)
    assert torch.equal(got, qmatmul_plain(a, b, sa, sb))
    assert torch.equal(got, qmatmul(a, b, sa, sb))


# -- the split route of the paged kernel -------------------------------------
@pytest.mark.parametrize("split", [2, 4, 8])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("visible_pages", [1, 5, 9, 257])
def test_paged_split_kernel_pages(card, visible_pages, q_dtype, split):
    """The split route against its plain version at 1, 5, 9 and 257
    visible pages (a table two entries wider), so some partitions see no
    page; the dead lane on the poisoned trash page stays finite, NaN in
    every unwritten row never leaks, and a second launch (tickets left
    zeroed) is identical."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.flash_attention import paged_attention_split
    from repro_torch.kernels.ref import paged_attention_split_ref
    q, kp, vp, bt, qpos = _unsplit_case(card, visible_pages,
                                        getattr(torch, q_dtype))
    before = _cuda.LAUNCHES["paged_attention_split"]
    got = paged_attention_split(q, kp, vp, bt, qpos, kv_split=split)
    want = paged_attention_split_ref(q, kp, vp, bt, qpos, kv_split=split)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["paged_attention_split"] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    _unsplit_close(got[:2], want[:2])
    assert torch.isfinite(got[2].float()).all()
    kp2, vp2 = kp.clone(), vp.clone()
    ps = kp.shape[2]
    for lane in range(2):
        for t in range(int(qpos[lane]) + 1, bt.shape[1] * ps):
            pg = int(bt[lane, t // ps])
            kp2[pg, :, t % ps] = float("nan")
            vp2[pg, :, t % ps] = float("nan")
    again = paged_attention_split(q, kp2, vp2, bt, qpos, kv_split=split)
    assert torch.equal(again[:2], got[:2])
    assert torch.equal(paged_attention_split(q, kp, vp, bt, qpos,
                                             kv_split=split), got)


@pytest.mark.parametrize("knobs", [(2, 1), (4, 2), (8, 8)])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_paged_split_kernel_prefill_chunk(card, knobs, q_dtype):
    """A 16-row prefill chunk (128 folded rows, 16 row tiles, each with
    its own tickets) on the split route, tiles of 1, 2 and 8 pages."""
    from repro_torch.kernels.flash_attention import paged_attention_split
    from repro_torch.kernels.ref import paged_attention_split_ref
    split, tile = knobs
    q, kp, vp, bt, qpos = _unsplit_case(card, 9, getattr(torch, q_dtype),
                                        s=16)
    kw = dict(kv_split=split, pages_per_step=tile)
    got = paged_attention_split(q, kp, vp, bt, qpos, **kw)
    _unsplit_close(got[:2],
                   paged_attention_split_ref(q, kp, vp, bt, qpos, **kw)[:2])
    assert torch.isfinite(got[2].float()).all()


def test_paged_split_kernel_refuses(card):
    from repro_torch.kernels.flash_attention import paged_attention_split
    q = torch.randn((1, 2, 1, 30), device="cuda")
    kp = torch.randn((3, 1, 4, 30), device="cuda")
    bt = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    qpos = torch.zeros((1,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        paged_attention_split(q, kp, kp, bt, qpos, kv_split=2)


# -- the per-row int8 activation quantizer -----------------------------------
def _quantize_input(card, rows, k, dtype, kind):
    """f32 rows over many decades, then: zero rows, half-way rows (a row
    max of 127 makes the scale exactly 1 and x / s = x), or a NaN row."""
    decades = 10.0 ** (torch.rand((rows, 1), generator=card,
                                  device="cuda") * 8 - 4)
    x = torch.randn((rows, k), generator=card, device="cuda") * decades
    if kind == "zero rows":
        x[::3] = 0.0
    elif kind == "half-way":
        x = torch.randint(-126, 126, (rows, k), generator=card,
                          device="cuda").float() + 0.5
        x[:, 0] = 127.0
        x[1::2, 0] = -127.0
    elif kind == "nan row":
        x[1, k // 2] = float("nan")
    return x.to(getattr(torch, dtype))


@pytest.mark.parametrize("kind", ["random", "zero rows", "half-way",
                                  "nan row"])
@pytest.mark.parametrize("rows,k", [(8, 2048), (8, 16384), (300, 512),
                                    (37, 2048), (5, 1001), (3, 40000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_kernel_matches_plain(card, rows, k, dtype, kind):
    """Bitwise: the same f32 max, one correctly rounded division for the
    scale and one per element, half-to-even rounding, NaN through the
    clamp and torch's cast.  Rows of a warp (K 512, 2048 bf16), of a
    block (K 16384, 2048 f32), a K that is no multiple of 8 and one past
    the registers (scalar loads), a ragged last block (300, 37 rows)."""
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.quantize_rows import (quantize_rows,
                                                   quantize_rows_plain)
    qt = FixedPointType(8, 4)
    x = _quantize_input(card, rows, k, dtype, kind)
    before = _cuda.LAUNCHES["quantize_rows"]
    q, s = quantize_rows(x, qt)
    wq, ws = quantize_rows_plain(x, qt)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["quantize_rows"] == before + 1
    assert q.dtype == torch.int8 and s.shape == (rows, 1)
    assert torch.equal(q, wq)
    nan = torch.isnan(ws)             # NaN where the plain version has it
    assert torch.equal(torch.isnan(s), nan)
    assert torch.equal(s[~nan].view(torch.int32), ws[~nan].view(torch.int32))
    if kind == "nan row":
        assert torch.isnan(s[1]).all() and not torch.isnan(s[0]).any()
    if kind == "half-way":
        assert (s == 1.0).all()
        assert torch.equal(q.float(), torch.round(x.float()).clamp(-128, 127))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_kernel_unaligned_view(card, dtype):
    """A view one element into its buffer is not 16-byte aligned: scalar
    loads, the same result."""
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.kernels.quantize_rows import (quantize_rows,
                                                   quantize_rows_plain)
    qt = FixedPointType(8, 4)
    x = _quantize_input(card, 8, 2048, dtype, "random")
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    view = flat[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 and view.is_contiguous()
    q, s = quantize_rows(view, qt)
    wq, ws = quantize_rows_plain(x, qt)
    assert torch.equal(q, wq) and torch.equal(s, ws)
    assert torch.equal(q, quantize_rows(x, qt)[0])
    q2, _ = quantize_rows(x[:, :1001], qt)      # a strided view: copied
    assert torch.equal(q2, quantize_rows_plain(x[:, :1001], qt)[0])


def test_quantize_rows_kernel_refuses(card):
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.kernels.quantize_rows import quantize_rows
    x = torch.randn((4, 8), device="cuda")
    with pytest.raises(TypeError, match="f32 or bf16"):
        quantize_rows(x.half(), FixedPointType(8, 4))
    with pytest.raises(TypeError, match="signed int8"):
        quantize_rows(x, FixedPointType(8, 4, signed=False))
    with pytest.raises(ValueError, match=r"\(T, K >= 1\)"):
        quantize_rows(x[None], FixedPointType(8, 4))


# -- the gated MLP's table pass ------------------------------------------------
@pytest.mark.parametrize("shape", [(8, 16384), (128, 16384), (3, 1001),
                                   (7,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("indexing", ["trunc", "nearest", "interp"])
@pytest.mark.parametrize("table", [("gelu_gate", -8.0, 8.0),
                                   ("silu_gate", -10.0, 10.0)])
def test_lut_gated_mul_kernel_matches_plain(card, shape, dtype, indexing,
                                            table):
    """Bitwise: the table in f32 rounded once to dt, each product one
    rounding in dt, as the three-launch chain; a scalar tail ((3, 1001),
    (7,)) and views at offset 1 (not 16-byte aligned, scalar path)."""
    from repro_torch.core.tables import TableSpec
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.lut_activation import (lut_gated_mul,
                                                    lut_gated_mul_plain)
    dt = getattr(torch, dtype)
    spec = TableSpec(table[0], 1024, table[1], table[2], None, indexing)
    g = (torch.randn(shape, generator=card, device="cuda") * 6).to(dt)
    up = (torch.randn(shape, generator=card, device="cuda") * 3).to(dt)
    before = _cuda.LAUNCHES["lut_gated_mul"]
    got = lut_gated_mul(g, up, spec)
    want = lut_gated_mul_plain(g, up, spec)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["lut_gated_mul"] == before + 1
    assert got.dtype == dt and got.shape == g.shape
    assert torch.equal(got, want)
    fg, fu = g.reshape(-1), up.reshape(-1)
    if fg.numel() > 1:
        assert torch.equal(lut_gated_mul(fg[1:], fu[1:], spec),
                           lut_gated_mul_plain(fg[1:], fu[1:], spec))
        assert torch.equal(lut_gated_mul(fg[1:], fu[:-1], spec),
                           lut_gated_mul_plain(fg[1:], fu[:-1], spec))


def test_lut_gated_mul_kernel_refuses(card):
    from repro_torch.core.tables import TableSpec
    from repro_torch.kernels.lut_activation import lut_gated_mul
    g = torch.randn((4, 8), generator=card, device="cuda")
    spec = TableSpec("gelu_gate")
    with pytest.raises(ValueError, match="exceeds"):
        lut_gated_mul(g, g, TableSpec("gelu_gate", 8192))
    with pytest.raises(TypeError, match="f32 or bf16"):
        lut_gated_mul(g.half(), g.half(), spec)
    with pytest.raises(ValueError, match="is not like g"):
        lut_gated_mul(g, g.bfloat16(), spec)
    with pytest.raises(ValueError, match="is not like g"):
        lut_gated_mul(g, g[:2], spec)


# -- split scratch: sized only when split, one per stream, safe to capture ----
def test_qmatmul_unsplit_call_leaves_workspace_alone(card):
    """A split decode call sizes the workspace; unsplit calls (whisper's
    M 12000 projections) keep no memory once their outputs are gone, and
    neither grow nor replace the workspace."""
    from repro_torch.kernels import qmatmul as qmod
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    m, k, n = 8, 16384, 2048
    assert qmod.qmatmul_plan(m, n, k, sms).splits > 1
    a, b, sa, sb = _qmm_operands(card, m, k, n)
    assert torch.equal(qmod.qmatmul(a, b, sa, sb),
                       qmod.qmatmul_plain(a, b, sa, sb))
    big = [_qmm_operands(card, 12000, k2, n2)
           for k2, n2 in ((512, 2048), (2048, 512))]
    for a2, b2, sa2, sb2 in big:
        assert qmod.qmatmul_plan(12000, b2.shape[1], b2.shape[0],
                                 sms).splits == 1
        want = qmod.qmatmul_plain(a2, b2, sa2, sb2)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        got = qmod.qmatmul(a2, b2, sa2, sb2)
        assert torch.equal(got, want)
        del got
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == before
    ws = _stream_scratch("qmatmul_workspace", a.device)
    qmod.qmatmul(*big[0])
    assert _stream_scratch("qmatmul_workspace", a.device) is ws


def _split_cases(card, live_pages=None):
    """A split-K qmatmul (decode's wk/wv projection, 16 K splits of 2
    tiles: 32 blocks) and a split paged attention (4 partitions of a
    259-page table, 12 blocks), each with its plain result: grids small
    enough that two streams' launches run side by side.  ``live_pages``
    shortens the live lanes' context so that only the first partition
    sees a page: its blocks take their tickets at once while another
    launch's blocks still walk."""
    from repro_torch.kernels.flash_attention import paged_attention_split
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_plain
    from repro_torch.kernels.ref import paged_attention_split_ref
    a, b, sa, sb = _qmm_operands(card, 8, 2048, 256)
    q, kp, vp, bt, qpos = _unsplit_case(card, 257, torch.float32)
    if live_pages is not None:
        qpos[:2] = torch.tensor([live_pages * 16 - 1, live_pages * 16 - 2])

    def qmm():
        return qmatmul(a, b, sa, sb, out_dtype=torch.bfloat16)

    def attn():
        return paged_attention_split(q, kp, vp, bt, qpos, kv_split=4)

    return [(qmm, qmatmul_plain(a, b, sa, sb, out_dtype=torch.bfloat16),
             torch.equal),
            (attn, paged_attention_split_ref(q, kp, vp, bt, qpos, kv_split=4),
             lambda got, want: _unsplit_close(got[:2], want[:2]) or True)]


#: GPU cycles of the spin that holds the streams (~20 ms): the host
#: enqueues every launch meanwhile
_HOLD_CYCLES = 40_000_000


def _release_together(streams):
    """Hold ``streams`` behind one event that a spin on another stream
    records, so that their next launches start at the same moment and run
    side by side (fed one by one by the host, launches on two streams
    start tens of microseconds apart and barely overlap)."""
    gate = torch.cuda.Stream()
    gate.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(gate):
        torch.cuda._sleep(_HOLD_CYCLES)
    released = torch.cuda.Event()
    released.record(gate)
    for st in streams:
        st.wait_event(released)


def test_split_kernels_on_two_streams(card):
    """Split-K qmatmul, then split paged attention, queued 30 times on
    each of two streams (on other operands; on the second stream only the
    first partition sees a page) and released together, so that the
    streams' launches run side by side: each stream has its own scratch,
    and every output equals the plain version (a shared workspace or
    ticket mixes the streams' partials)."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    cases = [_split_cases(card), _split_cases(card, live_pages=60)]
    for c in range(2):                       # qmatmul, then attention
        outs = [[], []]
        torch.cuda.synchronize()
        _release_together(streams)
        for _ in range(30):
            for i, st in enumerate(streams):
                with torch.cuda.stream(st):
                    outs[i].append(cases[i][c][0]())
        torch.cuda.synchronize()
        for i in range(2):
            _, want, same = cases[i][c]
            for j, got in enumerate(outs[i]):
                assert same(got, want), (c, i, j)


def test_split_kernels_capture_and_replay(card):
    """One split-K qmatmul and one split paged attention captured in a
    CUDA graph: replayed alone; replayed while eager calls of both run on
    another stream (released together, so they overlap); and replayed
    after larger eager calls grew (and freed) that stream's scratch and
    the freed memory was refilled with garbage.  Every replay equals the
    plain versions: the graph's scratch is its own and is never freed."""
    (qmm, q_want, q_same), (attn, a_want, a_same) = _split_cases(card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm up: build, configure
        qmm(), attn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        q_out, a_out = qmm(), attn()

    def replay():
        # outputs poisoned first: a launch that finds its tickets or
        # workspace garbled leaves them unwritten or wrong
        q_out.fill_(float("nan")), a_out.fill_(float("nan"))
        graph.replay()

    replay()
    torch.cuda.synchronize()
    assert q_same(q_out, q_want) and a_same(a_out, a_want)
    _release_together([torch.cuda.current_stream(), side])
    with torch.cuda.stream(side):
        eager = [(qmm(), q_want, q_same), (attn(), a_want, a_same)]
    replay()
    torch.cuda.synchronize()
    assert q_same(q_out, q_want) and a_same(a_out, a_want)
    assert all(same(got, want) for got, want, same in eager)
    from repro_torch.kernels.flash_attention import paged_attention_split
    from repro_torch.kernels.qmatmul import qmatmul
    with torch.cuda.stream(side):
        for _ in range(2):
            a, b, sa, sb = _qmm_operands(card, 16, 16384, 8192)
            qmatmul(a, b, sa, sb)
            q, kp, vp, bt, qpos = _unsplit_case(card, 9, torch.float32,
                                                s=64)
            paged_attention_split(q, kp, vp, bt, qpos, kv_split=8)
        # reuse what the larger calls freed, at every size class
        junk = [torch.full((1 << i,), -1, dtype=torch.int32, device="cuda")
                for i in range(4, 22) for _ in range(8)]
    torch.cuda.synchronize()
    replay()
    torch.cuda.synchronize()
    assert q_same(q_out, q_want) and a_same(a_out, a_want)
    del junk


# -- the card's Engine held against the CPU's ----------------------------------
#: greedy streams of the card's Engine may part from the CPU's only where
#: the CPU's top-2 logit margin is below this bound.  In f32 compute
#: without TF32 the card sums matmuls and attention in other orders, a few
#: f32 ulps apart (~1e-6 of logits of order 1-10), which can flip an exact
#: or near tie, and through an int8 rounding step a little more; a wrong
#: kernel moves logits by order 1.  On the H100 all six cells below gave
#: identical streams over 16 tokens (PERF.md), so the bound only admits
#: a flip at a near-tie.
ENGINE_MARGIN_BOUND = 1e-3


def _greedy_streams(cfg, ctx, params, prompts, gen, device, kw):
    from repro_torch.launch.serve import Engine
    eng = Engine(cfg, ctx, params, device=device, batch=2, max_len=40,
                 prefill_chunk=5, **kw)
    ids = [eng.submit(p, gen_len=gen) for p in prompts]
    eng.try_admit()
    while eng.live.any() or eng.waiting:
        eng.step_many(4)
    eng.retire_finished()
    return [eng.results[i]["tokens"] for i in ids]


@pytest.mark.parametrize("cache", ["paged-auto", "paged-unsplit", "dense"])
@pytest.mark.parametrize("weights", ["f32", "int8"])
def test_card_engine_streams_match_cpu_engine(card, weights, cache):
    """gemma-2b smoke, f32 compute, the same weights on both sides: the
    card's greedy streams equal the CPU Engine's, or first part where the
    CPU's own top-2 logit margin is below ENGINE_MARGIN_BOUND."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.serve import quantize_for_serving
    from repro_torch.models import lm
    from repro_torch.nn.context import QuantContext
    assert torch.backends.cuda.matmul.allow_tf32 is False
    cfg = get_config("gemma-2b").smoke()
    ctx = QuantContext(
        mode="int8" if weights == "int8" else "none",
        policy=(PrecisionPolicy.uniform(FixedPointType(8, 4))
                if weights == "int8" else PrecisionPolicy()),
        compute_dtype=torch.float32)
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    if weights == "int8":
        params = quantize_for_serving(params, ctx)
    src = SyntheticLM(cfg.vocab, seed=0)
    prompts = [src.tokens(i, 1, 14)[0, :-1] for i in range(3)]
    kw = {"paged-auto": dict(paged=True, page_size=4),
          "paged-unsplit": dict(paged=True, page_size=4, kv_split=1,
                                pages_per_step=1),
          "dense": {}}[cache]
    gen = 16
    want = _greedy_streams(cfg, ctx, params, prompts, gen, "cpu", kw)
    got = _greedy_streams(cfg, ctx, params, prompts, gen, "cuda", kw)
    assert all(len(t) == gen for t in got)
    for prompt, w, g in zip(prompts, want, got):
        i = next((i for i, (x, y) in enumerate(zip(w, g)) if x != y), None)
        if i is None:
            continue
        tokens = torch.tensor(np.concatenate([prompt, w[:i]])[None],
                              dtype=torch.int32)
        logits, _, _ = lm.forward(params, tokens, cfg, ctx)
        top2 = logits[0, -1].float().topk(2).values
        margin = (top2[0] - top2[1]).item()
        print(f"{weights} {cache}: first differing token {i} of {gen}, CPU "
              f"top-2 margin {margin:.6g}")
        assert margin < ENGINE_MARGIN_BOUND, (i, margin)


# -- the decode block as a CUDA graph, and sampling on the card ----------------
def _smoke_int8(kv_bits=None):
    """gemma-2b smoke with int8 weights on the card (f32 compute): every
    projection through qmatmul and quantize_rows."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.serve import quantize_for_serving
    from repro_torch.models import lm
    from repro_torch.nn.context import QuantContext
    cfg = get_config("gemma-2b").smoke()
    ctx = QuantContext(mode="int8",
                       policy=PrecisionPolicy.uniform(FixedPointType(8, 4)),
                       compute_dtype=torch.float32)
    params = quantize_for_serving(
        lm.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                device="cuda"), ctx)
    src = SyntheticLM(cfg.vocab, seed=0)
    prompts = [src.tokens(i, 1, 14)[0, :-1] for i in range(4)]
    return cfg, ctx, params, prompts


GRAPH_CACHES = {"paged-auto": dict(paged=True, page_size=4),
                "paged-unsplit": dict(paged=True, page_size=4, kv_split=1,
                                      pages_per_step=1),
                "dense": {}, "int8-kv": dict(kv_bits=8)}
#: per-request (temperature, top_k): greedy, or sampled beside a greedy one
GRAPH_SAMPLING = {"greedy": [(0.0, 0)] * 4,
                  "sampled": [(0.8, 40), (0.0, 0), (1.3, 5), (0.8, 0)]}


def _engine_run(cfg, ctx, params, prompts, kw, sampling, *, graphs,
                gens=(16, 16, 16, 16), block=4):
    """Streams, launch counts (reset first) and stats of one Engine run:
    batch 2, so two requests are admitted after the first blocks."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import Engine
    eng = Engine(cfg, ctx, params, device="cuda", batch=2, max_len=40,
                 prefill_chunk=5, seed=7, graphs=graphs, **kw)
    reset_launch_counts()
    ids = [eng.submit(p, gen_len=g, temperature=t, top_k=k)
           for p, g, (t, k) in zip(prompts, gens, GRAPH_SAMPLING[sampling])]
    eng.try_admit()
    while eng.live.any() or eng.waiting:
        eng.step_many(block)
    eng.retire_finished()
    torch.cuda.synchronize()
    return ([eng.results[i]["tokens"] for i in ids], launch_counts(),
            eng.stats())


@pytest.mark.parametrize("sampling", list(GRAPH_SAMPLING))
@pytest.mark.parametrize("cache", list(GRAPH_CACHES))
def test_graphed_engine_streams_equal_eager(card, cache, sampling):
    """The same requests, graphs on and off: identical streams (greedy and
    sampled from one seed), identical kernel launch counts (a replay
    counts what it runs), and the graphed engine captured at most one
    graph per (block length, sampled)."""
    cfg, ctx, params, prompts = _smoke_int8()
    kw = GRAPH_CACHES[cache]
    eager, e_counts, e_st = _engine_run(cfg, ctx, params, prompts, kw,
                                        sampling, graphs=False)
    graphed, g_counts, g_st = _engine_run(cfg, ctx, params, prompts, kw,
                                          sampling, graphs=True)
    assert all(len(t) == 16 for t in graphed)
    assert graphed == eager
    assert g_counts == e_counts and g_counts["qmatmul"] > 0
    assert g_counts["quantize_rows"] == g_counts["qmatmul"]
    assert not e_st["graphs"] and e_st["graph_captures"] == 0
    # greedy: one block length, one graph; sampled: a graph for blocks
    # with a sampled lane, and one for all-greedy blocks if any occur
    assert g_st["graphs"] and g_st["graph_captures"] in \
        ((1, 2) if sampling == "sampled" else (1,))


def test_graph_replays_advance_launch_counts(card):
    """Each replay adds the launches its graph recorded: one block after
    the capture counts what an eager block of the same batch counts, and
    two count twice that."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import Engine
    cfg, ctx, params, prompts = _smoke_int8()
    counts = {}
    for graphs in (False, True):
        eng = Engine(cfg, ctx, params, device="cuda", batch=2, max_len=40,
                     paged=True, page_size=4, graphs=graphs)
        eng.add_requests({0: prompts[0], 1: prompts[1]}, gen_len=30)
        eng.step_many(4)                         # graphed: eager, capture
        reset_launch_counts()
        eng.step_many(4)
        one = launch_counts()
        eng.step_many(4)
        two = launch_counts()
        assert all(two[k] == 2 * one[k] for k in one)
        assert one["paged_attention_split"] + \
            one["paged_attention_unsplit"] == 4 * cfg.n_layers
        counts[graphs] = one
    assert counts[True] == counts[False]


def test_graph_replay_after_admission_equals_eager(card):
    """Requests of unequal budgets on a batch of 2: lanes retire and new
    requests are admitted (block tables rewritten in place, retired dense
    rows zeroed) long after the graph was captured; the graphed streams
    are the eager ones."""
    cfg, ctx, params, prompts = _smoke_int8()
    gens = (5, 19, 11, 16)
    for kw in (GRAPH_CACHES["paged-auto"], GRAPH_CACHES["dense"]):
        eager, _, _ = _engine_run(cfg, ctx, params, prompts, kw, "sampled",
                                  graphs=False, gens=gens, block=3)
        graphed, _, st = _engine_run(cfg, ctx, params, prompts, kw,
                                     "sampled", graphs=True, gens=gens,
                                     block=3)
        assert [len(t) for t in graphed] == list(gens)
        assert graphed == eager
        assert st["admitted"] == 4 and st["graph_captures"] <= 2


def test_sample_tokens_on_card_bitwise(card):
    """At (8, 256000): the card's threefry bits and fold_in are the CPU's,
    bitwise; ``sample_tokens_fused`` is ``sample_tokens_ref`` on the card
    (and on the CPU, with the card's logits), for every slot regime."""
    from repro_torch.kernels import prng
    from repro_torch.kernels.ref import sample_tokens_ref
    from repro_torch.kernels.sampling import sample_tokens_fused
    b, v = 8, 256000
    for step in (0, 1, 99):
        kc = prng.fold_in(prng.PRNGKey(5, "cuda"),
                          torch.tensor(step, dtype=torch.int32,
                                       device="cuda"))
        kh = prng.fold_in(prng.PRNGKey(5), step)
        assert torch.equal(kc.cpu(), kh)
        assert torch.equal(prng.random_bits(kc, (b, v)).cpu(),
                           prng.random_bits(kh, (b, v)))
        assert torch.equal(prng.uniform(kc, (b, v)).cpu(),
                           prng.uniform(kh, (b, v)))
        logits = torch.randn((b, v), generator=card, device="cuda") * 3
        logits[:, 10:20] = logits.max() + 1      # ties at the k-th rank
        temp = torch.tensor([0.8, 0.0, 1.3, -1.0, 0.8, 50.0, 0.5, 2.0],
                            device="cuda")
        top_k = torch.tensor([40, 0, 5, 3, 0, 5, v + 1, 1],
                             dtype=torch.int32, device="cuda")
        got = sample_tokens_fused(logits, temp, top_k, kc)
        want = sample_tokens_ref(logits, temp, top_k, kc)
        assert torch.equal(got, want)
        assert got[5].item() in range(10, 15)
        # the noise: the card's log rounds as it does, within the ulps the
        # CPU's noise keeps from JAX's (tests/test_torch_sampling.py)
        gc, gh = prng.gumbel(kc, (b, v)).cpu(), prng.gumbel(kh, (b, v))
        bound = 4 * torch.finfo(torch.float32).eps * gh.abs().clamp_min(1.0)
        assert ((gc - gh).abs() <= bound).all()


def test_graphs_follow_replaced_params(card):
    """The graphs hold the params' addresses: after the engine's params are
    replaced by other weights, the next block captures anew and serves the
    new weights, as an eager engine given the same swap does."""
    from repro_torch.launch.serve import (Engine, prepare_params,
                                         quantize_for_serving)
    from repro_torch.models import lm
    cfg, ctx, params, prompts = _smoke_int8()
    other = quantize_for_serving(
        lm.init(torch.Generator(device="cuda").manual_seed(1), cfg,
                device="cuda"), ctx)
    streams = {}
    for graphs in (False, True):
        eng = Engine(cfg, ctx, params, device="cuda", batch=2, max_len=40,
                     paged=True, page_size=4, graphs=graphs)
        eng.add_requests({0: prompts[0], 1: prompts[1]}, gen_len=20)
        eng.step_many(4)
        eng.step_many(4)                  # graphed: a replay
        eng.params = prepare_params(other, ctx, "cuda")
        while eng.live.any():
            eng.step_many(4)
        streams[graphs] = [list(o) for o in eng.outputs]
        if graphs:
            assert eng.stats()["graph_captures"] == 2
    assert streams[True] == streams[False]


# -- the jet MLP's qmatmul shapes and the speculative verify pass ------------
#: the jet-tagging MLP's layers (K x N): K 16 is half of one m16n8k32 step,
#: N 5 takes the byte-staged B and the scalar output path
JET_KN = [(16, 64), (64, 32), (32, 32), (32, 5)]


@pytest.mark.parametrize("n", QMM_N + [5])
@pytest.mark.parametrize("m", QMM_M)
def test_qmatmul_k16_tiling_edges_bitwise(card, m, n):
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_plain
    a, b, sa, sb = _qmm_operands(card, m, 16, n)
    bias = torch.randn((n,), generator=card, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        got = qmatmul(a, b, sa, sb, bias if m % 2 else None, dt)
        want = qmatmul_plain(a, b, sa, sb, bias if m % 2 else None, dt)
        assert torch.equal(got, want)


@pytest.mark.parametrize("kn", JET_KN, ids=str)
@pytest.mark.parametrize("m", [1, 128, 16384])
def test_qmatmul_jet_mlp_shapes_bitwise(card, m, kn):
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_plain
    a, b, sa, sb = _qmm_operands(card, m, *kn)
    bias = torch.randn((kn[1],), generator=card, device="cuda")
    got = qmatmul(a, b, sa, sb, bias, torch.float32)
    want = qmatmul_plain(a, b, sa, sb, bias, torch.float32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("weights", ["dynamic", "ptq"])
def test_jet_mlp_int8_forward_on_card_bitwise(card, weights):
    """The jet MLP's int8 forward through the kernels equals the plain
    versions' on the card, and the CPU's, bitwise; one quantize_rows per
    qmatmul, four each."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.core.quantize import ptq_params
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import _to
    from repro_torch.models import mlp
    from repro_torch.nn.context import QuantContext
    pol = PrecisionPolicy.uniform(FixedPointType(8, 4))
    ctx = QuantContext(mode="int8", policy=pol, compute_dtype=torch.float32)
    params = mlp.init(torch.Generator().manual_seed(0), device="cpu")
    if weights == "ptq":
        params = ptq_params(params, pol)
    x = torch.randn((1000, 16), generator=torch.Generator().manual_seed(1))
    want = mlp.forward(params, x, ctx)
    pc = _to(params, "cuda")
    reset_launch_counts()
    got = mlp.forward(pc, x.cuda(), ctx)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["qmatmul"] == counts["quantize_rows"] == 4
    plain = mlp.forward(pc, x.cuda(), QuantContext(
        mode="int8", policy=pol, compute_dtype=torch.float32, backend="ref"))
    assert torch.equal(got, plain) and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("knobs", [(1, 1), (2, 1), (4, 2)])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_paged_attention_verify_shape(card, knobs, q_dtype):
    """A verify pass's attention: S = k + 1 = 5 queries per lane, gemma's
    heads (8 on 1 KV head of 256), positions that cross a page and a lane
    whose last query lands on the trash page's table entries."""
    from repro_torch.kernels import ops
    b, hq, d, ps, width, npg, s = 4, 8, 256, 16, 12, 40, 5
    q = torch.randn((b, hq, s, d), generator=card, device="cuda") \
        .to(getattr(torch, q_dtype))
    kp = torch.randn((npg + 1, 1, ps, d), generator=card, device="cuda")
    vp = torch.randn((npg + 1, 1, ps, d), generator=card, device="cuda")
    bt = torch.full((b, width), npg, dtype=torch.int32, device="cuda")
    bt[:, :10] = torch.randperm(npg, generator=card, device="cuda")[:b * 10] \
        .reshape(b, 10).to(torch.int32)
    bt[3] = npg                              # a dead lane, all trash
    qpos = torch.tensor([13, 150, 157, 0], dtype=torch.int32, device="cuda")
    split, tile = knobs
    got = ops.paged_attention(q, kp, vp, bt, qpos, kv_split=split,
                              pages_per_step=tile)
    want = ops.paged_attention(q, kp, vp, bt, qpos, kv_split=split,
                               pages_per_step=tile, backend="ref")
    tol = (dict(atol=2.0 ** -6, rtol=2.0 ** -8) if q_dtype == "bfloat16"
           else dict(atol=2e-5, rtol=2e-5))
    torch.testing.assert_close(got.float(), want.float(), **tol)


SPEC_DRAFTERS = ("ngram", "model")


def _spec_run(cfg, ctx, params, prompts, kw, sampling, *, graphs, drafter,
              gens=(16, 16, 16, 16), block=2, device="cuda"):
    """Streams, launch counts (reset first) and stats of one spec Engine
    run (k 4): batch 2, so two requests are admitted after the first
    blocks."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import Engine
    if drafter == "model":
        kw = dict(kw, spec_draft=(cfg, params, ctx))
    eng = Engine(cfg, ctx, params, device=device, batch=2, max_len=48,
                 prefill_chunk=5, seed=7, graphs=graphs, spec=True, spec_k=4,
                 **kw)
    reset_launch_counts()
    ids = [eng.submit(p, gen_len=g, temperature=t, top_k=k)
           for p, g, (t, k) in zip(prompts, gens, GRAPH_SAMPLING[sampling])]
    eng.try_admit()
    while eng.live.any() or eng.waiting:
        eng.step_many(block)
    eng.retire_finished()
    if device == "cuda":
        torch.cuda.synchronize()
    return ([eng.results[i]["tokens"] for i in ids], launch_counts(),
            eng.stats())


@pytest.mark.parametrize("drafter", SPEC_DRAFTERS)
@pytest.mark.parametrize("sampling", list(GRAPH_SAMPLING))
@pytest.mark.parametrize("cache", ["paged-auto", "dense"])
def test_graphed_spec_streams_equal_eager(card, cache, sampling, drafter):
    """Speculative blocks, graphs on and off, after admissions (batch 2,
    four requests of unequal budgets): identical streams and launch
    counts; each (rounds, sampled) block is one graph."""
    cfg, ctx, params, prompts = _smoke_int8()
    kw = GRAPH_CACHES[cache]
    gens = (5, 19, 11, 16)
    eager, e_counts, e_st = _spec_run(cfg, ctx, params, prompts, kw,
                                      sampling, graphs=False,
                                      drafter=drafter, gens=gens)
    graphed, g_counts, g_st = _spec_run(cfg, ctx, params, prompts, kw,
                                        sampling, graphs=True,
                                        drafter=drafter, gens=gens)
    assert [len(t) for t in graphed] == list(gens)
    assert graphed == eager
    assert g_counts == e_counts and g_counts["qmatmul"] > 0
    assert g_counts["quantize_rows"] == g_counts["qmatmul"]
    assert g_st["graph_captures"] in ((1, 2) if sampling == "sampled"
                                      else (1,))
    assert g_st["verify_steps"] == e_st["verify_steps"] > 0
    if drafter == "model" and sampling == "greedy":
        assert g_st["accepted_per_step"] > 2.0


@pytest.mark.parametrize("drafter", SPEC_DRAFTERS)
@pytest.mark.parametrize("cache", ["paged-auto", "dense"])
@pytest.mark.parametrize("weights", ["f32", "int8"])
def test_card_spec_streams_match_cpu_spec_streams(card, weights, cache,
                                                  drafter):
    """gemma-2b smoke, f32 compute, spec k 4: the card's greedy spec streams
    equal the CPU's, or first part where the CPU's own top-2 logit margin
    is below ENGINE_MARGIN_BOUND (the verify pass runs its logits at M =
    2 x 5 rows, plain decode at 2)."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.serve import quantize_for_serving
    from repro_torch.models import lm
    from repro_torch.nn.context import QuantContext
    cfg = get_config("gemma-2b").smoke()
    ctx = QuantContext(
        mode="int8" if weights == "int8" else "none",
        policy=(PrecisionPolicy.uniform(FixedPointType(8, 4))
                if weights == "int8" else PrecisionPolicy()),
        compute_dtype=torch.float32)
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    if weights == "int8":
        params = quantize_for_serving(params, ctx)
    src = SyntheticLM(cfg.vocab, seed=0)
    prompts = [src.tokens(i, 1, 14)[0, :-1] for i in range(4)]
    kw = GRAPH_CACHES[cache]
    want, _, _ = _spec_run(cfg, ctx, params, prompts, kw, "greedy",
                           graphs=False, drafter=drafter, device="cpu")
    got, _, _ = _spec_run(cfg, ctx, params, prompts, kw, "greedy",
                          graphs=True, drafter=drafter)
    assert all(len(t) == 16 for t in got)
    for prompt, w, g in zip(prompts, want, got):
        i = next((i for i, (x, y) in enumerate(zip(w, g)) if x != y), None)
        if i is None:
            continue
        tokens = torch.tensor(np.concatenate([prompt, w[:i]])[None],
                              dtype=torch.int32)
        logits, _, _ = lm.forward(params, tokens, cfg, ctx)
        top2 = logits[0, -1].float().topk(2).values
        margin = (top2[0] - top2[1]).item()
        print(f"{weights} {cache} {drafter}: first differing token {i}, CPU "
              f"top-2 margin {margin:.6g}")
        assert margin < ENGINE_MARGIN_BOUND, (i, margin)


# -- the dense cache's verify pass against plain decode ------------------------
def _einsum_logits(q, k, cd):
    """The fused attention's first product (the logits), GQA folded."""
    b, hq, sq, dh = q.shape
    hkv = k.shape[1]

    def operand(t):
        return t.to(cd).to(torch.float32)
    qg = q.reshape(b, hkv, hq // hkv, sq, dh)
    return torch.einsum("bhgqd,bhkd->bhgqk", operand(qg), operand(k))


def test_dense_verify_attention_rows_equal_decode_rows(card):
    """gemma-2b at full width (depth cut to 1), int8 weights, bf16
    compute, a dense f32 cache of batch 8 and 177 rows (path 6's: max_len
    161 and a 16-row margin), a 128-token prompt: one verify call at S = 5
    and five decode calls at S = 1 over the same cache contents give the
    same layer-0 attention rows, bit for bit.  The verify call runs under
    the speculative loop's context (``per_position_attention``), the
    decode calls under the engine's.  The failure names the product that
    parts (the logits or P.V): fused, GQA folds the positions into the
    products' M (40 rows against 8), and cuBLAS picks its algorithm per
    shape."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.launch.serve import prepare_params, quantize_for_serving
    from repro_torch.models import lm
    from repro_torch.nn.attention import _fresh_kv_attention
    from repro_torch.nn.blocks import layer_slice, norm_apply
    from repro_torch.nn.context import QuantContext
    from repro_torch.nn.embedding import embed
    from repro_torch.nn.linear import linear
    cfg = dataclasses.replace(get_config("gemma-2b"), n_layers=1)
    ctx = QuantContext(mode="int8",
                       policy=PrecisionPolicy.uniform(FixedPointType(8, 4)),
                       compute_dtype=torch.bfloat16)
    params = prepare_params(quantize_for_serving(
        lm.init(card, cfg, device="cuda"), ctx), ctx, "cuda")
    b, plen, s, d = 8, 128, 5, cfg.attn_dims()
    toks = torch.randint(0, cfg.vocab, (b, plen + s), generator=card,
                         device="cuda", dtype=torch.int32)
    cache = lm.init_cache(cfg, b, 177, torch.float32, "cuda")
    lm.prefill(params, toks[:, :plen], cache, cfg, ctx,
               pos=torch.zeros((b,), dtype=torch.int32, device="cuda"))
    p0 = layer_slice(params["dense"], 0)
    rows = layer_slice(cache["dense"], 0)
    x = embed(params["embed"], toks[:, plen:], ctx,
              scale_by_dim=cfg.embed_scale)
    h = norm_apply(cfg, p0["ln1"], x)
    pos = torch.full((b,), plen, dtype=torch.int32, device="cuda")

    def attend(hh, cache_l, at, actx):
        q = linear(p0["attn"]["wq"], hh, actx, path="attn/wq")
        q = q.reshape(b, hh.shape[1], d.n_heads, d.head_dim).transpose(1, 2)
        return _fresh_kv_attention(p0["attn"], q, hh, d, actx, kv_input=None,
                                   cache=cache_l, cache_pos=at,
                                   path="attn"), q

    c5 = {k: v.clone() for k, v in rows.items()}
    c1 = {k: v.clone() for k, v in rows.items()}
    verify, q5 = attend(h, c5, pos,
                        dataclasses.replace(ctx, per_position_attention=True))
    decode = [attend(h[:, i:i + 1], c1, pos + i, ctx) for i in range(s)]
    torch.cuda.synchronize()
    parted = [i for i in range(s)
              if not torch.equal(verify[:, :, i], decode[i][0][:, :, 0])]
    if parted:
        i = parted[0]
        lg5 = _einsum_logits(q5, c5["k"], ctx.compute_dtype)[..., i, :]
        lg1 = _einsum_logits(decode[i][1], c1["k"],
                             ctx.compute_dtype)[..., 0, :]
        which = "P.V" if torch.equal(lg5, lg1) else "the logits"
        diff = (verify[:, :, i] - decode[i][0][:, :, 0]).abs().max().item()
        raise AssertionError(
            f"verify (S {s}) and decode (S 1) attention rows part at "
            f"positions {parted}, max |diff| {diff:.3g}; at position {i} "
            f"{which} einsum parts")
    assert torch.equal(c5["k"], c1["k"]) and torch.equal(c5["v"], c1["v"])


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_verify_logits_equal_decode_logits(card, kind):
    """gemma-2b at full width and depth (18 layers), int8 weights, bf16
    compute, an f32 cache of batch 8 (dense: 177 rows; paged: page 16, 12
    pages a lane), a 128-token prompt: one verify call at S = 5 under the
    speculative loop's context and five decode calls at S = 1 give the
    same logits, bit for bit.  Beside the attention, this holds the norms'
    row statistics (``nn/norms._row_mean``): ``torch.mean`` rounds a row
    otherwise in a call of 40 rows than in one of 8."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.launch.serve import prepare_params, quantize_for_serving
    from repro_torch.models import lm
    from repro_torch.nn.context import QuantContext
    cfg = get_config("gemma-2b")
    ctx = QuantContext(mode="int8",
                       policy=PrecisionPolicy.uniform(FixedPointType(8, 4)),
                       compute_dtype=torch.bfloat16)
    params = prepare_params(quantize_for_serving(
        lm.init(card, cfg, device="cuda"), ctx), ctx, "cuda")
    b, plen, s = 8, 128, 5
    toks = torch.randint(0, cfg.vocab, (b, plen + s), generator=card,
                         device="cuda", dtype=torch.int32)
    if kind == "dense":
        cache = lm.init_cache(cfg, b, 177, torch.float32, "cuda")
    else:
        cache = lm.init_paged_cache(cfg, b, b * 12, 16, 12, torch.float32,
                                    "cuda")
        cache["dense"]["block_table"][:] = torch.arange(
            b * 12, dtype=torch.int32, device="cuda").reshape(b, 12)
    lm.prefill(params, toks[:, :plen], cache, cfg, ctx,
               pos=torch.zeros((b,), dtype=torch.int32, device="cuda"))

    def clone(t):
        return ({k: clone(v) for k, v in t.items()} if isinstance(t, dict)
                else t.clone())
    c5, c1 = clone(cache), clone(cache)
    pos = torch.full((b,), plen, dtype=torch.int32, device="cuda")
    verify, _ = lm.decode_step(
        params, toks[:, plen:], c5, pos, cfg,
        dataclasses.replace(ctx, per_position_attention=True))
    decode = [lm.decode_step(params, toks[:, plen + i:plen + i + 1], c1,
                             pos + i, cfg, ctx)[0] for i in range(s)]
    torch.cuda.synchronize()
    parted = [i for i in range(s)
              if not torch.equal(verify[:, i], decode[i][:, 0])]
    diff = max((verify[:, i].float() - decode[i][:, 0].float()).abs().max()
               .item() for i in range(s))
    assert not parted, (f"{kind}: verify (S {s}) and decode (S 1) logits "
                        f"part at positions {parted}, max |diff| {diff:.3g}")


# -- the lifecycle on the card -------------------------------------------------
def test_copy_pages_and_payload_on_card_bitwise_cpu(card):
    """``copy_pages_fn`` and the spill payload's gather and scatter on the
    card equal the CPU's bitwise (f32 and int8 pages) and keep every
    cache tensor's address."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine
    from repro_torch.models import lm
    from repro_torch.models.api import copy_pages_fn, page_leaves
    from repro_torch.nn.context import QuantContext
    from repro_torch.train.graphs import _addresses
    cfg = get_config("gemma-2b").smoke()
    ctx = QuantContext(compute_dtype=torch.float32)
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    for kv_bits in (None, 8):
        engs = [Engine(cfg, ctx, params, device=dev, batch=2, max_len=24,
                       paged=True, page_size=4, kv_bits=kv_bits)
                for dev in ("cpu", "cuda")]
        g = torch.Generator().manual_seed(1)
        fill = [torch.randint(-127, 128, leaf.shape, generator=g).to(
                    leaf.dtype) if leaf.dtype == torch.int8 else
                torch.rand(leaf.shape, generator=g).to(leaf.dtype)
                for _, leaf in page_leaves(engs[0].cache)]
        for eng in engs:
            for (_, leaf), f in zip(page_leaves(eng.cache), fill):
                leaf.copy_(f)
        before = _addresses(engs[1].cache)
        for eng in engs:
            copy_pages_fn(eng.cache, [1, 5], [3, 0])
            eng._write_pages(eng._page_payload([2, 4]), [7, 1])
        torch.cuda.synchronize()
        assert _addresses(engs[1].cache) == before
        for (_, a), (_, b) in zip(page_leaves(engs[0].cache),
                                  page_leaves(engs[1].cache)):
            assert torch.equal(a, b.cpu())


def _lifecycle_run(cfg, ctx, params, device, case, graphs=None):
    """One lifecycle scenario on ``device``: (streams, counters, stats)."""
    from repro_torch.ft import ServingFaultInjector
    from repro_torch.launch.serve import Engine
    rs = np.random.RandomState(0)
    if case == "prefix":
        pre = rs.randint(0, cfg.vocab, (12,))
        prompts = [np.concatenate([pre, rs.randint(0, cfg.vocab, (n,))])
                   for n in (5, 3, 7, 9)]
        kw = dict(batch=2, paged=True, page_size=4, prefix_cache=True)
    elif case == "preempt":
        prompts = [rs.randint(0, cfg.vocab, (10,)) for _ in range(4)]
        kw = dict(batch=3, paged=True, page_size=4, num_pages=8,
                  preempt=True, preempt_after=2)
    else:
        prompts = [rs.randint(0, cfg.vocab, (n,)) for n in (9, 5, 12, 3)]
        kw = dict(batch=2, paged=True, page_size=8)
        if case == "chaos":
            kw["fault_injector"] = ServingFaultInjector(
                {1: "raise", 2: "nan", 3: "corrupt", 4: "slow"})
    eng = Engine(cfg, ctx, params, device=device, max_len=32,
                 prefill_chunk=5, graphs=graphs, **kw)
    ids = [eng.submit(p, gen_len=6) for p in prompts]
    eng.try_admit()
    while eng.live.any() or eng.waiting:
        eng.step_many(2)
    eng.retire_finished()
    keys = ("preemptions", "spilled_pages", "replays", "prefix_hits",
            "prefix_tokens_saved", "cow_copies")
    return (prompts, [eng.results[i]["tokens"] for i in ids],
            {k: eng.counters[k] for k in keys}, eng.stats())


@pytest.mark.parametrize("case", ["prefix", "preempt", "chaos"])
def test_card_lifecycle_streams_match_cpu_engine(card, case):
    """gemma-2b smoke, f32 compute, graphs on: prefix caching, preempt and
    spill over an 8-page pool, and a fault schedule with recovery give the
    CPU Engine's streams (or first part where the CPU's top-2 margin is
    below ENGINE_MARGIN_BOUND) and its lifecycle counters."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.nn.context import QuantContext
    cfg = get_config("gemma-2b").smoke()
    ctx = QuantContext(compute_dtype=torch.float32)
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompts, want, cw, _ = _lifecycle_run(cfg, ctx, params, "cpu", case)
    _, got, cg, st = _lifecycle_run(cfg, ctx, params, "cuda", case)
    assert st["graphs"] and st["graph_captures"] > 0
    assert cg == cw
    assert {"prefix": cg["prefix_hits"], "preempt": cg["preemptions"],
            "chaos": cg["replays"]}[case] > 0
    for prompt, w, g in zip(prompts, want, got):
        i = next((i for i, (x, y) in enumerate(zip(w, g)) if x != y), None)
        if i is None:
            continue
        tokens = torch.tensor(np.concatenate([prompt, w[:i]])[None],
                              dtype=torch.int32)
        logits, _, _ = lm.forward(params, tokens, cfg, ctx)
        top2 = logits[0, -1].float().topk(2).values
        margin = (top2[0] - top2[1]).item()
        print(f"{case}: first differing token {i}, CPU top-2 margin "
              f"{margin:.6g}")
        assert margin < ENGINE_MARGIN_BOUND, (i, margin)


def test_restore_and_replay_keep_graph_captures(card):
    """A fault schedule (raise, nan, corrupt, slow) with recovery on the
    card: three restores and replays, streams bitwise the fault-free
    card run's, and as many CUDA graphs captured as that run: restore and
    the poison write into the cache's tensors, so no graph is captured
    again."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.nn.context import QuantContext
    cfg = get_config("gemma-2b").smoke()
    ctx = QuantContext(compute_dtype=torch.float32)
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    _, clean, cc, sc = _lifecycle_run(cfg, ctx, params, "cuda", "clean")
    _, chaos, ch, sh = _lifecycle_run(cfg, ctx, params, "cuda", "chaos")
    assert ch["replays"] == 3 and cc["replays"] == 0
    assert chaos == clean
    assert sh["graph_captures"] == sc["graph_captures"] > 0


def _int8_smoke():
    """gemma-2b smoke with int8 weights, f32 compute, on the card."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.launch.serve import quantize_for_serving
    from repro_torch.models import lm
    from repro_torch.nn.context import QuantContext
    cfg = get_config("gemma-2b").smoke()
    ctx = QuantContext(mode="int8",
                       policy=PrecisionPolicy.uniform(FixedPointType(8, 4)),
                       compute_dtype=torch.float32)
    params = quantize_for_serving(
        lm.init(torch.Generator().manual_seed(0), cfg, device="cpu"), ctx)
    rs = np.random.RandomState(31)
    prompts = [rs.randint(0, cfg.vocab, (n,)) for n in (9, 5, 12, 3)]
    return cfg, ctx, params, prompts


#: the card suites' durable geometry: paged, graphs on (the card default)
DURABLE_KW = dict(batch=2, max_len=32, paged=True, page_size=4,
                  num_pages=16, prefill_chunk=5, device="cuda")
DURABLE_PRIOS = ("batch", "realtime", None, "standard")


def _durable_drive(eng, prompts):
    ids = [eng.submit(p, gen_len=6, priority=c)
           for p, c in zip(prompts, DURABLE_PRIOS)]
    eng.try_admit()
    while eng.live.any() or eng.waiting:
        eng.step_many(4)
    eng.retire_finished()
    return ids


def test_crash_at_every_round_recovers_bitwise_on_card(card, tmp_path):
    """int8 weights, paged, graphs on: a crash at every block round,
    recovered into a fresh card Engine, gives the uninterrupted streams
    and ``done`` order bit for bit."""
    from repro_torch.ft import InjectedCrash, ServingFaultInjector
    from repro_torch.launch.serve import Engine
    cfg, ctx, params, prompts = _int8_smoke()
    clean = Engine(cfg, ctx, params, **DURABLE_KW)
    ids = _durable_drive(clean, prompts)
    assert clean.stats()["graph_captures"] > 0 and clean._round >= 3
    for rnd in range(1, clean._round + 1):
        d = str(tmp_path / str(rnd))
        dead = Engine(cfg, ctx, params, durable_dir=d, snapshot_every=2,
                      fault_injector=ServingFaultInjector({rnd: "crash"}),
                      **DURABLE_KW)
        with pytest.raises(InjectedCrash):
            _durable_drive(dead, prompts)
        rec = Engine(cfg, ctx, params, **DURABLE_KW)
        rec.recover(d)
        while rec.live.any() or rec.waiting:
            rec.step_many(4)
        rec.retire_finished()
        assert dead.cache is None              # released at the crash
        assert rec.done == clean.done, f"crash at round {rnd}"
        assert [rec.results[i]["tokens"] for i in ids] == \
            [clean.results[i]["tokens"] for i in ids]


def test_promotion_at_every_round_on_card(card, tmp_path):
    """Two replicas and a hot standby on the card: the primary killed at
    every fleet round gives the fault-free fleet's streams.  The heartbeat
    keeps the reference's thresholds.  The fault-free fleet reads the
    wall clock, where eager prefill and graph-capture blocks are slow, and
    must end with no death and no re-dispatch; the killed fleets read a
    clock that stands still, so that only the kill can kill."""
    from repro_torch.ft import FleetFaultInjector
    from repro_torch.launch.fleet import Fleet
    from repro_torch.launch.serve import Engine
    cfg, ctx, params, prompts = _int8_smoke()

    def run(tag, inj=None, clock=None):
        fl = Fleet(lambda **kw: Engine(cfg, ctx, params,
                                       **dict(DURABLE_KW, **kw)), 2,
                   standby_dir=str(tmp_path / tag), fault_injector=inj,
                   clock=clock)
        fids = [fl.submit(p, gen_len=6, priority=c)
                for p, c in zip(prompts, DURABLE_PRIOS)]
        fl.drain(block=4)
        return fl, fids

    clean, fids = run("clean")
    assert clean.counters["deaths"] == 0
    assert clean.counters["redispatched"] == 0
    for rnd in range(1, clean._round + 1):
        fl, _ = run(str(rnd), FleetFaultInjector([(rnd, 0, "kill")]),
                    clock=lambda: 0.0)
        assert fl.counters["promotions"] == 1
        assert {f: fl.results[f] for f in fids} == \
            {f: clean.results[f] for f in fids}, f"round {rnd}"


def test_durable_snapshot_restores_in_place_on_card(card, tmp_path):
    """A durable snapshot written by one card Engine, recovered into
    another that has already captured its decode graph: no tensor address
    of the cache changes, no graph is captured again for the same block,
    and the streams are the uninterrupted ones."""
    from repro_torch.ft import InjectedCrash, ServingFaultInjector
    from repro_torch.launch.serve import Engine
    from repro_torch.train.graphs import _addresses
    cfg, ctx, params, prompts = _int8_smoke()
    clean = Engine(cfg, ctx, params, **DURABLE_KW)
    ids = _durable_drive(clean, prompts)
    d = str(tmp_path / "d")
    dead = Engine(cfg, ctx, params, durable_dir=d, snapshot_every=1,
                  fault_injector=ServingFaultInjector({4: "crash"}),
                  **DURABLE_KW)
    with pytest.raises(InjectedCrash):
        _durable_drive(dead, prompts)
    rec = Engine(cfg, ctx, params, **DURABLE_KW)
    warm = rec.submit(prompts[0], gen_len=6)
    rec.try_admit()
    while rec.live.any():
        rec.step_many(4)
    rec.retire_finished()
    assert warm in rec.results
    before, captures = _addresses(rec.cache), rec.blocks.captures
    info = rec.recover(d)
    assert info["snapshot_step"] is not None
    assert _addresses(rec.cache) == before
    while rec.live.any() or rec.waiting:
        rec.step_many(4)
    rec.retire_finished()
    assert _addresses(rec.cache) == before
    assert rec.blocks.captures == captures
    assert [rec.results[i]["tokens"] for i in ids] == \
        [clean.results[i]["tokens"] for i in ids]


def test_calibration_sweep_on_card(card, tmp_path):
    """A 4-shape sweep of the paged-attention kernel: finite positive
    rows on every admissible grid point and a fit with nonnegative
    weights, written with the card's name."""
    import math
    from repro_torch.launch import autotune, calibrate
    rows = calibrate.sweep(calibrate.SHAPES[:4], reps=5)
    want = sum(len(autotune.kv_candidates(autotune.WorkloadShape(
        pages=p, page_size=ps, hkv=h, batch=b)))
        for p, ps, _, h, b, _ in calibrate.SHAPES[:4])
    assert len(rows) == want
    assert all(math.isfinite(r["us_per_call"]) and r["us_per_call"] > 0
               for r in rows)
    est, gates = calibrate.fit_and_gate(rows)
    assert all(w >= 0 for w in est.weights) and math.isfinite(est.residual)
    p = autotune.save_artifact(est, tmp_path / "a.json",
                               device=calibrate.device_info(), rows=rows)
    back = autotune.load_estimator("fitted", path=p)
    assert back.source == "artifact"
    print(f"calibration: {len(rows)} rows, gates {gates}, weights "
          f"{est.weights}")


def test_capture_survives_a_dead_graph_in_a_reference_cycle(card):
    """A captured graph that only the cyclic collector frees (a dead
    Engine's) must not be destroyed while another graph is captured: the
    destruction is refused during a capture and invalidates it.  Here the
    holder of a graph dies during the next capture, and the collector runs
    there whenever it is on (as it may at any allocation)."""
    import gc
    from repro_torch.train.graphs import BlockGraph
    x = torch.ones(4096, device="cuda")

    def body():
        y = x
        for _ in range(64):
            y = y * 1.0001 + 0.5
        return y

    want = body()
    for _ in range(3):
        keep = []
        holder = {"graph": BlockGraph(body)}
        holder["self"] = holder              # freed by the collector only
        keep.append(holder)
        del holder

        def fn():
            keep.clear()                     # the holder dies mid-capture
            if gc.isenabled():
                gc.collect()
            return body()

        g = BlockGraph(fn)
        out = g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


# -- the rest of the lm family: the kernels at its shapes, and its Engine ------
#: (K, N, bias) of the int8 projections the family adds: the untied heads
#: at N = vocab (yi, glm4, deepseek, olmoe), command-r's MLP, glm4's q/k/v
#: with their bias, deepseek's MLA projections
FAMILY_QMM = {"yi-head": (4096, 64000, False),
              "glm4-head": (4096, 151552, False),
              "deepseek-head": (5120, 102400, False),
              "olmoe-head": (2048, 50304, False),
              "command-r-up": (8192, 22528, False),
              "command-r-down": (22528, 8192, False),
              "glm4-wq-bias": (4096, 4096, True),
              "glm4-wkv-bias": (4096, 256, True),
              "mla-wq_b": (1536, 24576, False),
              "mla-wkv_a": (5120, 576, False)}


@pytest.mark.parametrize("m", [8, 128])
@pytest.mark.parametrize("proj", list(FAMILY_QMM))
def test_qmatmul_family_shapes_bitwise(card, proj, m):
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_plain
    k, n, with_bias = FAMILY_QMM[proj]
    a = torch.randint(-127, 128, (m, k), generator=card, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=card, device="cuda",
                      dtype=torch.int8)
    sa = (torch.rand((m, 1), generator=card, device="cuda") + 0.1) * 1e-3
    sb = (torch.rand((1, n), generator=card, device="cuda") + 0.1) * 1e-3
    bias = (torch.randn((n,), generator=card, device="cuda")
            if with_bias else None)
    got = qmatmul(a, b, sa, sb, bias, torch.bfloat16)
    want = qmatmul_plain(a, b, sa, sb, bias, torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("knobs", [(1, 1), None], ids=["unsplit", "auto"])
@pytest.mark.parametrize("s", [1, 16])
@pytest.mark.parametrize("heads", [(32, 4), (32, 2), (16, 16)],
                         ids=["group8", "group16", "group1"])
def test_paged_attention_d128_groups(card, heads, s, knobs):
    """Head dim 128 with query groups of 8 (yi, command-r), 16 (glm4) and
    1 (olmoe), decode and a 16-row prefill chunk, both routes; the trash
    page is poisoned with large finite values (dead-lane writes), the dead
    lane stays finite, NaN past the live lanes' visible rows never leaks."""
    from repro_torch.kernels import ops
    hq, hkv = heads
    b, d, ps, width = 3, 128, 16, 11
    npg = 2 * width + 1
    trash = npg - 1
    kp = torch.randn((npg, hkv, ps, d), generator=card, device="cuda")
    vp = torch.randn((npg, hkv, ps, d), generator=card, device="cuda")
    kp[trash], vp[trash] = 1e4, -1e4
    bt = torch.randperm(npg - 1, generator=card, device="cuda")[:2 * width] \
        .reshape(2, width).to(torch.int32)
    bt = torch.cat([bt, torch.full((1, width), trash, dtype=torch.int32,
                                   device="cuda")])
    qpos = torch.tensor([134 - s, 120 - s, 0], dtype=torch.int32,
                        device="cuda")
    q = torch.randn((b, hq, s, d), generator=card, device="cuda") \
        .to(torch.bfloat16)
    kw = {} if knobs is None else dict(kv_split=knobs[0],
                                       pages_per_step=knobs[1])
    got = ops.paged_attention(q, kp, vp, bt, qpos, **kw)
    want = ops.paged_attention(q, kp, vp, bt, qpos, backend="ref", **kw)
    torch.cuda.synchronize()
    _unsplit_close(got[:2], want[:2])
    assert torch.isfinite(got[2].float()).all()
    kp2, vp2 = kp.clone(), vp.clone()
    for lane in range(2):
        for t in range(int(qpos[lane]) + s, width * ps):
            pg = int(bt[lane, t // ps])
            kp2[pg, :, t % ps] = float("nan")
            vp2[pg, :, t % ps] = float("nan")
    again = ops.paged_attention(q, kp2, vp2, bt, qpos, **kw)
    assert torch.equal(again[:2], got[:2])


@pytest.mark.parametrize("s", [77, 512])
def test_flash_attention_mla_padded_v_bf16(card, s):
    """deepseek's naive MLA form: D 192, V zero-padded from 128; the
    padded columns come out 0 and the rest as the plain version's."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q, k, v = (torch.randn((1, 16, s, 192), generator=card, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    v[..., 128:] = 0
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_plain(q, k, v, causal=True)
    _flash_close(got, want)
    assert (got[..., 128:] == 0).all()


@pytest.mark.parametrize("cap", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lut_activation_expert_shape(card, cap, dtype):
    """olmoe's experts' SiLU table under --lut: (8, 64, cap, 1024), a
    decode step's and a 16-token chunk's capacity; bitwise."""
    from repro_torch.core.tables import TableSpec
    from repro_torch.kernels.lut_activation import (lut_activation,
                                                    lut_activation_plain)
    spec = TableSpec("silu_gate", 1024, -10.0, 10.0, None, "interp")
    x = (torch.randn((8, 64, cap, 1024), generator=card, device="cuda")
         * 4).to(getattr(torch, dtype))
    assert torch.equal(lut_activation(x, spec), lut_activation_plain(x, spec))


FAMILY_ARCHS = ["yi-6b", "glm4-9b", "command-r-35b", "olmoe-1b-7b",
                "deepseek-v2-236b"]


@pytest.mark.parametrize("weights", ["f32", "int8"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_card_engine_streams_match_cpu_engine(card, arch, weights):
    """The family's smoke configs, paged at the auto knobs, f32 compute,
    graphed on the card: greedy streams equal the CPU Engine's, or first
    part where the CPU's own top-2 margin is below ENGINE_MARGIN_BOUND."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.serve import quantize_for_serving
    from repro_torch.models import lm
    from repro_torch.nn.context import QuantContext
    cfg = get_config(arch).smoke()
    ctx = QuantContext(
        mode="int8" if weights == "int8" else "none",
        policy=(PrecisionPolicy.uniform(FixedPointType(8, 4))
                if weights == "int8" else PrecisionPolicy()),
        compute_dtype=torch.float32)
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    if weights == "int8":
        params = quantize_for_serving(params, ctx)
    src = SyntheticLM(cfg.vocab, seed=0)
    prompts = [src.tokens(i, 1, 14)[0, :-1] for i in range(3)]
    kw, gen = dict(paged=True, page_size=4), 16
    want = _greedy_streams(cfg, ctx, params, prompts, gen, "cpu", kw)
    got = _greedy_streams(cfg, ctx, params, prompts, gen, "cuda", kw)
    assert all(len(t) == gen for t in got)
    for prompt, w, g in zip(prompts, want, got):
        i = next((i for i, (x, y) in enumerate(zip(w, g)) if x != y), None)
        if i is None:
            continue
        tokens = torch.tensor(np.concatenate([prompt, w[:i]])[None],
                              dtype=torch.int32)
        # through a cache: MoE serving capacity (dropless), as the Engine
        cache = lm.init_cache(cfg, 1, tokens.shape[1], torch.float32,
                              device="cpu")
        logits, _ = lm.prefill(params, tokens, cache, cfg, ctx)
        top2 = logits[0, -1].float().topk(2).values
        margin = (top2[0] - top2[1]).item()
        print(f"{arch} {weights}: first differing token {i} of {gen}, CPU "
              f"top-2 margin {margin:.6g}")
        assert margin < ENGINE_MARGIN_BOUND, (i, margin)



def test_block_graphs_share_one_pool(card):
    """Two graphs captured into one pool hold one copy of a temporary
    that each frees inside its capture (deepseek's dequantized expert
    banks, one per block length otherwise), and replay correctly."""
    from repro_torch.train.graphs import BlockGraph
    n = 256 << 20                              # 1 GiB of f32
    x = torch.randn(16, device="cuda", generator=card)

    def body(scale):
        def fn():
            tmp = torch.empty(n, device="cuda")
            tmp[:16].copy_(x * scale)
            return tmp[:16].sum()[None].clone()
        return fn

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pool = torch.cuda.graph_pool_handle()
    before = torch.cuda.memory_reserved()
    graphs = [BlockGraph(body(s), pool=pool) for s in (2.0, 3.0)]
    grown = torch.cuda.memory_reserved() - before
    assert grown < 1.5 * 4 * n, grown          # one temporary, not two
    x.copy_(torch.arange(16, dtype=torch.float32, device="cuda"))
    outs = [g.replay().item() for g in graphs]
    assert outs == [2.0 * 120, 3.0 * 120]


RECURRENT_ARCHS = ["mamba2-370m", "zamba2-1.2b"]


def _recurrent_engine(arch, weights, device, **kw):
    """The smoke config's Engine on ``device`` (f32 compute, pages of 4;
    the same seeded CPU weights on both devices)."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.launch.serve import Engine, quantize_for_serving
    from repro_torch.models.api import get_family
    from repro_torch.nn.context import QuantContext
    cfg = get_config(arch).smoke()
    ctx = QuantContext(
        mode="int8" if weights == "int8" else "none",
        policy=(PrecisionPolicy.uniform(FixedPointType(8, 4))
                if weights == "int8" else PrecisionPolicy()),
        compute_dtype=torch.float32)
    params = get_family(cfg).init(torch.Generator().manual_seed(0), cfg,
                                  device="cpu")
    if weights == "int8":
        params = quantize_for_serving(params, ctx)
    return Engine(cfg, ctx, params, batch=2, max_len=32, page_size=4,
                  device=device, **kw)


def _recurrent_streams(eng, gen=12):
    from repro_torch.data.pipeline import SyntheticLM
    src = SyntheticLM(eng.cfg.vocab, seed=0)
    ids = [eng.submit(src.tokens(i, 1, 14)[0, :-1], gen_len=gen)
           for i in range(3)]
    eng.try_admit()
    while eng.live.any() or eng.waiting:
        eng.step_many(4)
    eng.retire_finished()
    return [eng.results[i]["tokens"] for i in ids]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("weights", ["f32", "int8"])
@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_graphed_streams_equal_eager(card, arch, weights, paged):
    """The recurrent families' decode blocks as CUDA graphs: the looped
    prefill and the merges write the state in place between replays, and
    the streams equal the eager engine's on the card, one graph per
    (steps, sampled)."""
    graphed = _recurrent_engine(arch, weights, "cuda", paged=paged)
    got = _recurrent_streams(graphed)
    want = _recurrent_streams(_recurrent_engine(arch, weights, "cuda",
                                                paged=paged, graphs=False))
    assert got == want
    assert graphed.blocks.captures == 1


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_spec_graphed_streams_equal_plain(card, arch):
    """n-gram speculation (k 3) graphed on the card: the per-position
    checkpoints are captured in the graph and the rollback writes the
    state in place; the streams equal the plain graphed engine's."""
    spec = _recurrent_engine(arch, "f32", "cuda", paged=True, spec=True,
                             spec_k=3)
    plain = _recurrent_engine(arch, "f32", "cuda", paged=True)
    assert _recurrent_streams(spec) == _recurrent_streams(plain)
    assert spec.counters["verify_steps"] > 0


def test_recurrent_state_written_in_place_under_a_replay(card):
    """A replayed mamba2 decode block advances the very state tensors the
    engine holds: after a looped prefill into the graph's tensors, a
    replay changes their values and keeps their addresses."""
    from repro_torch.train.graphs import _addresses
    eng = _recurrent_engine("mamba2-370m", "f32", "cuda")
    addrs = _addresses(eng.cache)
    _recurrent_streams(eng, gen=12)                   # captures the graph
    assert eng.blocks.captures == 1
    assert _addresses(eng.cache) == addrs
    before = {k: v.clone() for k, v in eng.cache.items()}
    eng.submit(np.arange(5, dtype=np.int32), gen_len=9)
    eng.try_admit()
    mid = {k: v.clone() for k, v in eng.cache.items()}
    eng.step_many(4)                                  # a replay
    assert _addresses(eng.cache) == addrs
    assert not torch.equal(mid["ssm"], eng.cache["ssm"])
    assert not torch.equal(before["ssm"], mid["ssm"])


VLM_ARCH = "llama-3.2-vision-11b"


def _vlm_smoke(weights, device):
    """llama-3.2-vision's smoke config (f32 compute) with seeded CPU
    weights moved to ``device``, its gates drawn nonzero (at init they
    are 0 and the cross layers add nothing), and a prompt of 6 tokens
    with the stub image from ``make_batch``."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.serve import prepare_params, quantize_for_serving
    from repro_torch.models import vlm
    from repro_torch.nn.context import QuantContext
    cfg = get_config(VLM_ARCH).smoke()
    ctx = QuantContext(
        mode="int8" if weights == "int8" else "none",
        policy=(PrecisionPolicy.uniform(FixedPointType(8, 4))
                if weights == "int8" else PrecisionPolicy()),
        compute_dtype=torch.float32)
    params = vlm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    for name in ("gate_attn", "gate_mlp"):
        shape = params["cross"][name].shape
        params["cross"][name] = ((torch.rand(shape, generator=g) * 0.7 + 0.3)
                                 * (torch.randint(0, 2, shape, generator=g)
                                    * 2 - 1))
    if weights == "int8":
        params = quantize_for_serving(params, ctx)
    nb = make_batch(cfg, 0, 2, 6)
    batch = {k: torch.from_numpy(nb[k]).to(device)
             for k in ("tokens", "img_embed")}
    return cfg, ctx, prepare_params(params, ctx, device), batch


@pytest.mark.parametrize("weights", ["f32", "int8"])
def test_vlm_prefill_and_decode_kernels_match_plain(card, weights):
    """The smoke VLM's prefill (the image's cross K/V projected into the
    cache) and 3 teacher-forced decode steps through the kernels against
    the plain versions on the card: int8 launches qmatmul 7 times per
    self layer and per cross layer at prefill, 5 per cross layer at
    decode, one quantize_rows each, and no attention kernel (the dense
    cache and the cached cross K/V attend with einsums)."""
    import dataclasses
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import vlm
    cfg, ctx, params, batch = _vlm_smoke(weights, "cuda")
    n_groups, k_self = vlm._group_structure(cfg)
    plain_ctx = dataclasses.replace(ctx, backend="ref")
    caches = {c: vlm.init_cache(cfg, 2, 12, torch.float32, "cuda")
              for c in ("kernels", "plain")}
    reset_launch_counts()
    got, _ = vlm.prefill(params, batch, caches["kernels"], cfg, ctx,
                         full_logits=True)
    counts = launch_counts()
    want, _ = vlm.prefill(params, batch, caches["plain"], cfg, plain_ctx,
                          full_logits=True)
    q = 7 * n_groups * (k_self + 1) if weights == "int8" else 0
    assert counts["qmatmul"] == counts["quantize_rows"] == q
    assert sum(counts.values()) == 2 * q
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(caches["kernels"]["cross_kv"]["k"],
                               caches["plain"]["cross_kv"]["k"], rtol=0,
                               atol=1e-4)
    pos = torch.full((2,), 6, dtype=torch.int32, device="cuda")
    for _ in range(3):
        tok = want[:, -1].argmax(-1).to(torch.int32)[:, None]
        reset_launch_counts()
        got, _ = vlm.decode_step(params, tok, caches["kernels"], pos, cfg,
                                 ctx)
        counts = launch_counts()
        want, _ = vlm.decode_step(params, tok, caches["plain"], pos, cfg,
                                  plain_ctx)
        q = n_groups * (7 * k_self + 5) if weights == "int8" else 0
        assert counts["qmatmul"] == counts["quantize_rows"] == q
        assert sum(counts.values()) == 2 * q
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        pos = pos + 1


def test_vlm_text_only_forward_through_flash(card):
    """The cache-free text-only forward: flash once per self layer
    (causal) and once per cross layer (the text attending to itself,
    non-causal), against the plain versions."""
    import dataclasses
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import vlm
    cfg, ctx, params, batch = _vlm_smoke("f32", "cuda")
    reset_launch_counts()
    got, _ = vlm.forward(params, batch["tokens"], None, cfg, ctx)
    assert launch_counts()["flash_attention"] == cfg.n_layers
    want, _ = vlm.forward(params, batch["tokens"], None, cfg,
                          dataclasses.replace(ctx, backend="ref"))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_vlm_graphed_blocks_survive_a_second_prefill(card):
    """A prefill copies the cross K/V into the cache's own buffers: the
    decode graph captured after the first image serves a second image
    prefilled into the same cache without a new capture, and both
    images' graphed streams equal the eager blocks'."""
    import numpy as np
    from repro_torch.models import vlm
    from repro_torch.train.graphs import DecodeBlocks, _addresses
    cfg, ctx, params, batch = _vlm_smoke("int8", "cuda")
    second = dict(batch, img_embed=batch["img_embed"].flip(1) * 2)

    def streams(blocks, cache, b):
        logits, _ = vlm.prefill(params, b, cache, cfg, ctx)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None].cpu().numpy()
        pos, live = np.full((2,), 6, np.int32), np.ones((2,), bool)
        out = []
        for i in range(2):
            state = blocks.pack(tok, pos, live, np.full((2,), 14, np.int32),
                                np.zeros((2,), np.float32),
                                np.zeros((2,), np.int32), i * 4, -1)
            block, _, tok, pos, live, fault = blocks.unpack(
                blocks(params, cache, state, None, 4), 4)
            assert not fault.any()
            out.append(block)
        return np.concatenate(out).T

    cache = vlm.init_cache(cfg, 2, 14, torch.float32, "cuda")
    addrs = _addresses(cache)
    graphed = DecodeBlocks(cfg, ctx, 2, "cuda", graphs=True)
    eager = DecodeBlocks(cfg, ctx, 2, "cuda", graphs=False)
    for b in (batch, second):
        want = streams(eager, vlm.init_cache(cfg, 2, 14, torch.float32,
                                             "cuda"), b)
        assert (streams(graphed, cache, b) == want).all()
    assert graphed.captures == 1 and _addresses(cache) == addrs


# -- the flash backward (training) ----------------------------------------------
def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


@pytest.mark.parametrize("shape", [(2, 8, 1, 64, 64, 256, True),
                                   (2, 4, 4, 77, 77, 64, False),
                                   (1, 8, 2, 100, 333, 64, True),
                                   (1, 4, 2, 50, 20, 32, True),
                                   (1, 4, 4, 40, 40, 192, True),
                                   (1, 2, 2, 33, 45, 24, False),
                                   # split dk/dv work (flash_bwd_plan): a
                                   # group of 16 over two KV tiles, MQA at
                                   # B 4 and D 256, odd split counts (9
                                   # and 3 blocks a tile)
                                   (1, 16, 1, 100, 128, 64, True),
                                   (4, 8, 1, 128, 128, 256, True),
                                   (2, 6, 2, 70, 70, 48, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_kernel_matches_plain(card, shape, dtype):
    """dq, dk, dv of the backward kernel against its plain version on the
    same inputs (the forward's o and lse): f32 relative L2 <= 1e-5, bf16
    <= 1e-3 (both round their f32 sums to bf16 once: in a tensor of ~2000
    elements one that lands on the other side of a rounding boundary
    moves the reading by ~1e-4, while a backward that rounds p and ds to
    bf16 before the products reads ~2.6e-3, chip_smoke phase 3's
    control); two launches give
    the same bits; a row that sees no key (Sq > Skv, causal) has gradient
    0; the forward's output with lse is bitwise the output without.  The
    last three shapes split the dk/dv work across blocks (a workspace and
    a reduction pass)."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd)
    from repro_torch.kernels.ref import flash_attention_lse_plain
    b, hq, hkv, sq, skv, d, causal = shape
    dt = getattr(torch, dtype)
    q = torch.randn((b, hq, sq, d), generator=card, device="cuda").to(dt)
    k, v = (torch.randn((b, hkv, skv, d), generator=card,
                        device="cuda").to(dt) for _ in range(2))
    do = torch.randn((b, hq, sq, d), generator=card, device="cuda").to(dt)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, with_lse=True)
    assert torch.equal(o, flash_attention_fwd(q, k, v, causal=causal)[0])
    want_lse = flash_attention_lse_plain(q, k, causal=causal)
    fin = torch.isfinite(want_lse)
    assert torch.equal(fin, torch.isfinite(lse))
    assert torch.allclose(lse[fin], want_lse[fin], rtol=1e-4, atol=1e-4)
    before = _cuda.LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention_bwd"] == before + 2
    tol = 1e-5 if dt == torch.float32 else 1e-3
    for x, y, w in zip(got, again, want):
        assert x.dtype == dt and torch.equal(x, y)
        assert torch.isfinite(x).all() and _rel(x, w) <= tol
    if causal and sq > skv:
        assert (got[0][:, :, :sq - skv] == 0).all()


def test_flash_attention_autograd_on_the_card(card):
    """``flash_attention`` under autograd on CUDA tensors runs the forward
    with lse and the backward kernel (one launch each), and its
    gradients match autograd of the plain forward (f32, relative L2 <=
    1e-5); without grad no backward is recorded."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_plain
    q = torch.randn((2, 8, 48, 64), generator=card, device="cuda")
    k, v = (torch.randn((2, 2, 48, 64), generator=card, device="cuda")
            for _ in range(2))
    do = torch.randn_like(q)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    c0 = _cuda.launch_counts()
    got = torch.autograd.grad(flash_attention(*leaves, causal=True),
                              leaves, do)
    c1 = _cuda.launch_counts()
    assert c1["flash_attention"] - c0["flash_attention"] == 1
    assert c1["flash_attention_bwd"] - c0["flash_attention_bwd"] == 1
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*plain, causal=True),
                               plain, do)
    for x, w in zip(got, want):
        assert _rel(x, w) <= 1e-5
    with torch.no_grad():
        assert not flash_attention(*leaves, causal=True).requires_grad


def test_train_step_on_the_card_matches_the_cpu(card):
    """gemma-2b smoke, f32 compute, two steps of ``build_train_step`` on
    the card (the flash forward and backward kernels) and on the CPU
    (the plain versions) from the same state: losses within rtol 1e-5,
    params within relative L2 1e-4 (AdamW's sign steps)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.nn.context import QuantContext
    from repro_torch.optim import cosine_warmup
    from repro_torch.train.step import build_train_step, init_state
    cfg = get_config("gemma-2b").smoke()
    ctx = QuantContext(compute_dtype=torch.float32)

    def lr(s):
        return cosine_warmup(s, peak=1e-3, warmup=1, total=4)
    cpu = init_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    gpu = _to(cpu, "cuda")
    steps = {d: build_train_step(cfg, ctx, lr_fn=lr) for d in ("cpu", "cuda")}
    for i in range(2):
        batch = make_batch(cfg, i, 4, 32)
        cpu, mc = steps["cpu"](cpu, batch)
        gpu, mg = steps["cuda"](gpu, batch)
        assert abs(float(mc["loss"]) - float(mg["loss"])) <= 1e-5 * abs(
            float(mc["loss"]))

    def leaves(t, p=""):
        if isinstance(t, dict):
            return [x for k, v in t.items() for x in leaves(v, p + "/" + k)]
        return [(p, t)]
    for (n, a), (_, b) in zip(leaves(cpu["params"]), leaves(gpu["params"])):
        assert _rel(b.cpu(), a) <= 1e-4, n


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# -- the backward kernels (training under --lut and --quant int8) -----------
@pytest.mark.parametrize("indexing", ["interp", "nearest", "trunc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 37), (64, 2048)])
def test_lut_backward_kernels_match_plain(card, shape, dtype, indexing):
    """lut_activation_bwd and lut_gated_mul_bwd bitwise their plain
    versions, the table's ends and the outside planted; one counted launch
    each; through the autograd functions on CUDA tensors too."""
    from repro_torch.core.tables import TableSpec
    from repro_torch.kernels import _cuda, ops, ref
    from repro_torch.kernels.lut_activation import (lut_activation_bwd,
                                                    lut_gated_mul_bwd)
    dt = getattr(torch, dtype)
    spec = TableSpec("gelu_gate", 1024, -8.0, 8.0, None, indexing)
    x = (torch.randn(shape, generator=card, device="cuda") * 4).to(dt)
    x.view(-1)[:5] = torch.tensor([-8.0, 8.0 - 1 / 64, 8.0, -9.0, 9.0],
                                  device="cuda")
    up = torch.randn(shape, generator=card, device="cuda").to(dt)
    dy = torch.randn(shape, generator=card, device="cuda").to(dt)
    before = dict(_cuda.LAUNCHES)
    dx = lut_activation_bwd(x, dy, spec)
    dg, du = lut_gated_mul_bwd(x, up, dy, spec)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["lut_activation_bwd"] == \
        before["lut_activation_bwd"] + 1
    assert _cuda.LAUNCHES["lut_gated_mul_bwd"] == \
        before["lut_gated_mul_bwd"] + 1
    assert torch.equal(dx, ref.lut_activation_bwd_plain(x, dy, spec))
    pg, pu = ref.lut_gated_mul_bwd_plain(x, up, dy, spec)
    assert torch.equal(dg, pg) and torch.equal(du, pu)
    xg = x.clone().requires_grad_(True)
    ug = up.clone().requires_grad_(True)
    ops.lut_gated_mul(xg, ug, spec).backward(dy)
    assert torch.equal(xg.grad, dg) and torch.equal(ug.grad, du)


@pytest.mark.parametrize("k", [40, 2048, 16384])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_backward_kernel_matches_plain(card, k, dtype):
    """Bitwise: ties split evenly, the 1e-12 floor halved, an all-zero row
    0; through the autograd function on CUDA tensors too."""
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.kernels import _cuda, ops, ref
    from repro_torch.kernels.quantize_rows import quantize_rows_bwd
    qt = FixedPointType(8, 4)
    x = torch.randn((37, k), generator=card, device="cuda") * 3
    x[0] = 0.0
    x[1] = 0.0
    x[1, 3] = 1e-12
    x[2, [4, 9]] = -(x[2].abs().max() + 1)
    x[2, 11] = -x[2, 4]
    x = x.to(getattr(torch, dtype))
    ds = torch.randn((37, 1), generator=card, device="cuda")
    before = _cuda.LAUNCHES["quantize_rows_bwd"]
    dx = quantize_rows_bwd(x, ds, qt)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["quantize_rows_bwd"] == before + 1
    assert torch.equal(dx, ref.quantize_rows_bwd_plain(x, ds, qt))
    assert not dx[0].any() and dx[2, 4] == dx[2, 9] == -dx[2, 11] != 0
    xg = x.clone().requires_grad_(True)
    _, s = ops.quantize_rows(xg, qt)
    s.backward(ds)
    assert torch.equal(xg.grad, dx)


@pytest.mark.parametrize("mkn", [(2048, 2048, 256), (130, 300, 70),
                                 (7, 13, 5)])
@pytest.mark.parametrize("epilogue", ["plain", "bias", "gated"])
def test_qmatmul_backward_kernel_matches_plain(card, mkn, epilogue):
    """dsa, dsb, dbias within 1e-5 of the plain version's largest
    magnitude (f32 sums in another order), bitwise across launches (no
    atomics), ragged tiles; through the autograd function too."""
    from repro_torch.core.tables import TableSpec
    from repro_torch.kernels import _cuda, ops, ref
    from repro_torch.kernels.qmatmul import qmatmul_bwd
    m, k, n = mkn
    a = torch.randint(-127, 128, (m, k), generator=card, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=card, device="cuda",
                      dtype=torch.int8)
    sa = torch.rand((m, 1), generator=card, device="cuda") * 0.02 / k ** 0.5
    sb = torch.rand((1, n), generator=card, device="cuda") * 0.02
    bias = (torch.randn(n, generator=card, device="cuda")
            if epilogue != "plain" else None)
    kw = {}
    if epilogue == "gated":
        kw = dict(act_spec=TableSpec("gelu_gate", 1024, -8.0, 8.0, None,
                                     "interp"), act_gated=True)
    dout = torch.randn((m, n), generator=card, device="cuda")
    before = _cuda.LAUNCHES["qmatmul_bwd"]
    got = qmatmul_bwd(a, b, sa, sb, bias, dout, **kw)
    again = qmatmul_bwd(a, b, sa, sb, bias, dout, **kw)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["qmatmul_bwd"] == before + 2
    want = ref.qmatmul_bwd_plain(a, b, sa, sb, bias, dout, **kw)
    for u, v, w in zip(got, again, want):
        if w is None:
            assert u is None
            continue
        assert torch.equal(u, v)
        assert (u - w).abs().max() <= 1e-5 * w.abs().max()
    sag, sbg = sa.clone().requires_grad_(True), sb.clone().requires_grad_(True)
    out = ops.qmatmul(a, b, sag, sbg, bias=bias, **kw)
    out.backward(dout)
    assert torch.equal(sag.grad.reshape(-1), got[0])
    assert torch.equal(sbg.grad.reshape(-1), got[1])
