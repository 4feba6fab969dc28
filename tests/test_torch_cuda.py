"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need an NVIDIA GPU and ``nvcc`` (the kernels are
compiled from ``src/repro_torch/kernels/csrc`` at first use) and skip
elsewhere.  Run them on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

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
    ws, tickets = qmod._SPLITK[a.device]
    torch.cuda.synchronize()
    assert not ws.any() and not tickets.any()


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
