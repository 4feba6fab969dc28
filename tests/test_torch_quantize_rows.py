"""The per-row int8 activation quantizer, port vs ``repro``.

``quantize_rows`` replaces the chain that the reference runs before every
int8 projection (``repro.nn.linear._int8_matmul``: ``calibrate_scale``
over each row, then ``round`` / ``clip`` / ``astype``).  Its ``ref``
lowering and the kernel wrapper's CPU path (the plain version) are held
bitwise against that chain, on f32 inputs and on inputs that come from
bf16 (converted to f32 inside, as the reference converts before it),
with all-zero rows, rows that hit exact half-way points of ``x / s`` and
rows whose magnitudes span many decades.  The int8 projection then runs
through the op, still bitwise the reference's ``linear``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.qtypes import FixedPointType as JFixed  # noqa: E402
from repro.core.quantize import calibrate_scale as j_calibrate  # noqa: E402
from repro_torch.core.qtypes import FixedPointType  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.quantize_rows import quantize_rows  # noqa: E402

QT, JQT = FixedPointType(8, 4), JFixed(8, 4)


def _jax_chain(x):
    """The reference's activation quantization (linear.py:88-89) on the
    f32 widening of ``x``."""
    x2 = jnp.asarray(x).astype(jnp.float32)
    s = j_calibrate(x2, JQT, channel_axes=(0,))
    q = jnp.clip(jnp.round(x2 / s), JQT.int_min, JQT.int_max)
    return np.asarray(q.astype(JQT.dtype)), np.asarray(s)


def _rows(kind, t, k, seed):
    rs = np.random.RandomState(seed)
    decades = 10.0 ** rs.uniform(-4, 4, (t, 1))
    x = (rs.randn(t, k) * decades).astype(np.float32)
    if kind == "zero-rows":
        x[::2] = 0.0
    elif kind == "half-way":
        # a row max of 127 makes s exactly 1, so x / s = x: k + 1/2 values
        # round half to even (2.5 -> 2, -3.5 -> -4, 0.5 -> 0)
        x = rs.randint(-126, 126, (t, k)).astype(np.float32) + 0.5
        x[:, 0] = 127.0
        x[1::2, 0] = -127.0
    return x


@pytest.mark.parametrize("kind", ["random", "zero-rows", "half-way"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,k", [(8, 64), (5, 37), (3, 1000)])
def test_quantize_rows_matches_reference_chain(kind, dtype, t, k):
    x = _rows(kind, t, k, seed=t * k)
    tx = torch.from_numpy(x)
    if dtype == "bfloat16":
        tx = tx.to(torch.bfloat16)
        x = tx.float().numpy()          # the bf16 values, widened
    want_q, want_s = _jax_chain(x)
    for q, s in (ops.quantize_rows(tx, QT, backend="ref"),
                 ops.quantize_rows(tx, QT), quantize_rows(tx, QT)):
        assert q.dtype == torch.int8 and q.shape == (t, k)
        assert s.dtype == torch.float32 and s.shape == (t, 1)
        np.testing.assert_array_equal(q.numpy(), want_q)
        np.testing.assert_array_equal(s.numpy().view(np.int32),
                                      want_s.view(np.int32))


def test_quantize_rows_half_way_rounds_to_even():
    x = np.zeros((1, 8), np.float32)
    x[0, :5] = [127.0, 2.5, -3.5, 0.5, -0.5]
    q, s = quantize_rows(torch.from_numpy(x), QT)
    assert s.item() == 1.0
    assert q[0, :5].tolist() == [127, 2, -4, 0, 0]


def test_int8_linear_goes_through_quantize_rows(monkeypatch):
    """An int8 projection quantizes its activation through the op, once
    per call, in the input's own dtype (no f32 copy first), and the
    result is bitwise the reference's ``linear``."""
    from repro.core.precision import PrecisionPolicy as JPolicy
    from repro.nn.context import QuantContext as JCtx
    from repro.nn.linear import linear as j_linear
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.nn.context import QuantContext
    from repro_torch.nn.linear import linear
    seen = []
    real = ops.quantize_rows

    def spy(x, qtype, **kw):
        seen.append(x.dtype)
        return real(x, qtype, **kw)

    monkeypatch.setattr(ops, "quantize_rows", spy)
    rs = np.random.RandomState(3)
    x = rs.randn(2, 5, 48).astype(np.float32)
    w = (rs.randn(48, 40) * 0.2).astype(np.float32)
    b = rs.randn(40).astype(np.float32)
    ctx = QuantContext(mode="int8", policy=PrecisionPolicy.uniform(QT),
                       compute_dtype=torch.float32)
    # the reference's qmatmul kernel (interpret mode), whose bias epilogue
    # rounds once, as the port's plain version does
    jctx = JCtx(mode="int8", policy=JPolicy.uniform(JQT),
                compute_dtype=jnp.float32, backend="pallas")
    got = linear({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                 torch.from_numpy(x), ctx, path="mlp/up")
    want = j_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                    jnp.asarray(x), jctx, path="mlp/up")
    assert seen == [torch.float32]
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    seen.clear()
    linear({"w": torch.from_numpy(w)}, torch.from_numpy(x).bfloat16(),
           ctx, path="mlp/up")
    assert seen == [torch.bfloat16]


def test_reciprocal_quotient_is_the_correctly_rounded_division():
    """The kernel divides each element by its row's scale without a
    division: ``q0 = x * r`` with ``r = RN(1 / s)``, then ``fma(fma(-q0,
    s, x), r, q0)`` (Markstein's correction).  Emulated here with exact
    fmas, it equals the correctly rounded ``x / s`` on every input: scales
    over 16 decades, quotients next to half-way points, bf16 values."""
    from repro_torch.kernels.ref import fma_f32
    gen = torch.Generator().manual_seed(0)
    n = 1 << 17
    amax = (10.0 ** (torch.rand(n, generator=gen, dtype=torch.float64) * 16
                     - 8)).float()
    s = amax / torch.full_like(amax, 127.0)
    k = torch.randint(-127, 127, (n,), generator=gen).double() + 0.5
    half = (k * s.double()).float()
    xs = [((torch.rand(n, generator=gen, dtype=torch.float64) * 2 - 1)
           * amax.double()).float(), half,
          torch.nextafter(half, torch.full_like(half, float("inf"))),
          torch.nextafter(half, torch.full_like(half, float("-inf")))]
    xs.append(xs[0].bfloat16().float())
    r = torch.ones_like(s) / s
    for x in xs:
        q0 = x * r
        got = fma_f32(fma_f32(-q0, s, x), r, q0)
        want = x / s
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
