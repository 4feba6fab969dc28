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


@pytest.mark.parametrize("knobs", [(1, 1), (2, 1), (3, 2), (2, 8)])
@pytest.mark.parametrize("s,group", [(1, 8), (16, 8), (3, 2), (1, 1)])
def test_paged_attention_kernels_match_plain(card, knobs, s, group):
    from repro_torch.kernels import ops
    b, hkv, d, ps, width, npg = 3, 2, 64, 16, 7, 30
    q = torch.randn((b, hkv * group, s, d), generator=card, device="cuda")
    kp = torch.randn((npg, hkv, ps, d), generator=card, device="cuda")
    vp = torch.randn((npg, hkv, ps, d), generator=card, device="cuda")
    bt = torch.randperm(npg - 1, generator=card, device="cuda")[:b * width] \
        .reshape(b, width).to(torch.int32)
    bt[2] = npg - 1                         # a dead lane on the trash page
    qpos = torch.tensor([5, width * ps - s, 0], dtype=torch.int32,
                        device="cuda")
    split, tile = knobs
    got = ops.paged_attention(q, kp, vp, bt, qpos, kv_split=split,
                              pages_per_step=tile)
    want = ops.paged_attention(q, kp, vp, bt, qpos, kv_split=split,
                               pages_per_step=tile, backend="ref")
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    # garbage past each lane's visible prefix never leaks
    kp2, vp2 = kp.clone(), vp.clone()
    for lane in range(2):
        for t in range(int(qpos[lane]) + s, width * ps):
            pg = int(bt[lane, t // ps])
            kp2[pg, :, t % ps] = 1e4
            vp2[pg, :, t % ps] = float("nan")
    again = ops.paged_attention(q, kp2, vp2, bt, qpos, kv_split=split,
                                pages_per_step=tile)
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


# (B, Hq, Hkv, Sq, Skv, D, causal) for the tensor-core kernel: Sq and Skv
# off the 64-row tiles and the 128-row mark, a single query row, Sq > Skv
# causal (the first rows see no key), every instance (D 32/64 -> 64, 128,
# 192, 256), groups 1, 2 and 8, and a head dim that is not a multiple of 8
# (the kernel stages it with plain loads)
FLASH_BF16_EDGES = [(1, 8, 8, 129, 191, 64, True), (2, 8, 1, 1, 300, 256, True),
                    (2, 4, 2, 1, 1, 32, False), (1, 8, 1, 200, 70, 64, True),
                    (1, 2, 1, 65, 130, 192, True), (1, 4, 4, 127, 63, 128,
                                                    False),
                    (2, 8, 1, 100, 257, 256, False), (1, 2, 2, 40, 90, 20,
                                                      True)]


@pytest.mark.parametrize("shape", FLASH_BF16_EDGES,
                         ids=lambda s: "-".join(map(str, s)))
def test_flash_attention_bf16_edge_shapes(card, shape):
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    b, hq, hkv, sq, skv, d, causal = shape
    q, k, v = (torch.randn((b, h, s, d), generator=card,
                           device="cuda").bfloat16()
               for h, s in ((hq, sq), (hkv, skv), (hkv, skv)))
    before = _cuda.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention"] == before + 1
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
    assert qmod._splitk_plan(m, n, k, torch.cuda.get_device_properties(
        0).multi_processor_count) > 1
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
    assert qmod._splitk_plan(m, n, k, sms) > 1
    a, b, sa, sb = _qmm_operands(card, m, k, n)
    assert torch.equal(qmod.qmatmul(a, b, sa, sb),
                       qmod.qmatmul_plain(a, b, sa, sb))
    big = [_qmm_operands(card, 12000, k2, n2)
           for k2, n2 in ((512, 2048), (2048, 512))]
    for a2, b2, sa2, sb2 in big:
        assert qmod._splitk_plan(12000, b2.shape[1], b2.shape[0], sms) == 1
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
