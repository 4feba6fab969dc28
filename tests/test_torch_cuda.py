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
