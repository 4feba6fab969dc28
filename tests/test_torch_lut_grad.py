"""The backward of the table pass, of ``quantize_rows`` and of qmatmul's
scales: the port's autograd functions on the CPU (the plain backward,
``kernels/ref.py``) against ``jax.grad`` of the reference.

* Tables: ``ops.lut_activation`` (the table alone) and ``ops.lut_gated_mul``
  (``((g * T(g)).to(dt)) * up``, the reference's ``nn/activations.py:41``
  then ``nn/blocks.py:72``) under ``interp``, ``nearest`` and ``trunc``,
  on plain and gated-form tables, with points planted at ``lo``, at the
  last entry (``pos == n - 1``), at ``hi`` and outside the domain:
  bitwise in f32 against ``jax.jit(jax.grad(...))`` of the reference
  kernels' ``apply_table`` (``src/repro/kernels/lut_activation.py:36``).
  ``jnp.clip``'s gradient is 0.5 at a bound (``torch.clamp``'s 1): the
  planted bounds show it; ``nearest``/``trunc`` are step functions (0).
* ``quantize_rows``: ``x``'s gradient from a cotangent of the row scale
  alone, bitwise against ``jax.grad`` of the reference's
  ``calibrate_scale`` / round / clip chain (``src/repro/nn/linear.py:88-
  89``), f32 and bf16, with tied rows (the gradient split evenly), an
  all-zero row and rows whose max is the 1e-12 floor exactly (0.5).
* qmatmul: the int8 linear chain (activations per row, weights per
  column, ``ops.qmatmul`` with a bias, an ungated or a gated table
  epilogue) against ``jax.grad`` of the reference's chain with the Pallas
  kernel's epilogue (``train_parity.jax_qmatmul_kernel_form``): the
  gradients of ``x``, ``w`` and the bias reach them through sums (of
  ``K`` or ``M`` terms) in another order, so they are held within
  relative 1e-5 of each leaf's largest magnitude (measured: <= 2e-7); no
  straight-through estimator: ``x`` and ``w`` get gradients only at
  their rows' and columns' arg-max-abs elements, on both sides.  Both
  sides run eagerly here: under ``jit`` XLA turns ``amax / 127`` into a
  product with ``1 / 127`` (an ulp away), which the port does not
  (``test_torch_train_quant.py`` holds the jitted step).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.qtypes import FixedPointType as JFixed  # noqa: E402
from repro.core.quantize import calibrate_scale as j_calibrate  # noqa: E402
from repro.core.tables import TableSpec as JSpec  # noqa: E402
from repro.core.tables import get_table as j_get_table  # noqa: E402
from repro.kernels.lut_activation import apply_table as j_apply  # noqa: E402
from repro_torch.core.qtypes import FixedPointType  # noqa: E402
from repro_torch.core.tables import TableSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.nn.linear import _quantize_weight  # noqa: E402
from train_parity import jax_qmatmul_kernel_form  # noqa: E402

#: (fn, n, lo, hi): plain and gated-form tables, power-of-two steps (the
#: reference's ``/ step`` and the kernels' ``* step_inv`` then agree)
TABLES = [("tanh", 64, -1.0, 1.0), ("sigmoid", 256, -4.0, 4.0),
          ("gelu_gate", 1024, -8.0, 8.0), ("silu_gate", 512, -8.0, 8.0)]
INDEXING = ["interp", "nearest", "trunc"]


def _points(lo, hi, n, rs, size=2048):
    """Uniform over the domain and beyond, with planted points."""
    step = (hi - lo) / n
    x = rs.uniform(lo - 1, hi + 1, size).astype(np.float32)
    x[:8] = [lo, lo + step, hi - step, hi, lo - 1, hi + 1, lo - step / 2,
             hi - step / 2]
    return x


@pytest.mark.parametrize("indexing", INDEXING)
@pytest.mark.parametrize("table", TABLES, ids=[t[0] for t in TABLES])
@pytest.mark.parametrize("gated", [False, True], ids=["table", "gated_mul"])
def test_table_grad_matches_jax(table, indexing, gated):
    fn, n, lo, hi = table
    spec = TableSpec(fn, n, lo, hi, None, indexing)
    t = jnp.asarray(j_get_table(JSpec(fn, n, lo, hi, None, indexing))
                    .np_values)
    step_inv = 1.0 / spec.step
    rs = np.random.RandomState(n)
    x = _points(lo, hi, n, rs)
    up = rs.randn(x.size).astype(np.float32)
    dy = rs.randn(x.size).astype(np.float32)

    def table_of(v):
        return j_apply(v, t, lo=lo, step_inv=step_inv, n=n,
                       indexing=indexing)

    xt = torch.tensor(x, requires_grad=True)
    if not gated:
        want = jax.jit(jax.grad(lambda v: jnp.sum(table_of(v) * dy)))(x)
        ops.lut_activation(xt, spec).backward(torch.tensor(dy))
        got = [xt.grad]
        want = [want]
    else:
        want = jax.jit(jax.grad(
            lambda g, u: jnp.sum((g * table_of(g)).astype(g.dtype) * u * dy),
            argnums=(0, 1)))(x, up)
        ut = torch.tensor(up, requires_grad=True)
        ops.lut_gated_mul(xt, ut, spec).backward(torch.tensor(dy))
        got = [xt.grad, ut.grad]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dx = got[0].numpy()
    if indexing != "interp" and not gated:
        assert not dx.any()            # a step function
    if indexing == "interp" and fn == "tanh" and not gated:
        # at lo the clip's gradient is 0.5: half the slope just inside
        slope = (float(t[1]) - float(t[0])) * step_inv
        assert dx[0] == pytest.approx(0.5 * slope * dy[0], rel=1e-5)
        assert dx[4] == dx[5] == 0.0   # outside the domain


def _quant_rows_input(rs, dtype):
    x = rs.randn(8, 40).astype(np.float32)
    x[1] = 0.0                                        # all zero
    x[2, [3, 7]] = -np.abs(x[2]).max() - 1            # tied, one sign
    x[2, 11] = -x[2, 3]                               # and the other
    x[3] = 0.0
    x[3, 5] = np.float32(1e-12)                       # max at the floor
    x[4] = 0.0
    x[4, [6, 9]] = -np.float32(1e-12)                 # tied at the floor
    x[5, [0, 39]] = np.abs(x[5]).max() + 0.5          # tied, both ends
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_grad_matches_jax(dtype):
    rs = np.random.RandomState(3)
    x = _quant_rows_input(rs, dtype)
    ds = rs.randn(8, 1).astype(np.float32)
    jqt, qt = JFixed(8, 4), FixedPointType(8, 4)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def chain(v):
        v2 = v.astype(jnp.float32)
        s = j_calibrate(v2, jqt, channel_axes=(0,))
        q = jnp.clip(jnp.round(v2 / s), jqt.int_min, jqt.int_max)
        return jnp.sum(s * ds) + 0.0 * jnp.sum(q.astype(jqt.dtype))

    want = np.asarray(jax.grad(chain)(jnp.asarray(x, jdt)).astype(
        jnp.float32))
    xt = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_(True)
    q, s = ops.quantize_rows(xt, qt)
    assert not q.requires_grad
    s.backward(torch.tensor(ds))
    got = xt.grad.to(torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[1].any()                           # below the floor
    assert got[2, 3] == got[2, 7] == -got[2, 11] != 0  # split three ways
    assert got[3, 5] != 0 and got[4, 6] == got[4, 9] != 0


def _float0(a):
    return np.zeros(a.shape, dtype=jax.dtypes.float0)


EPILOGUES = [None, ("tanh", False), ("gelu_gate", True)]


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("epilogue", EPILOGUES,
                         ids=["plain", "table", "gated"])
def test_qmatmul_grads_match_jax(epilogue, bias):
    rs = np.random.RandomState(7)
    m, k, n = 24, 48, 40
    x = rs.randn(m, k).astype(np.float32) * 2
    x[3, [1, 9]] = np.abs(x[3]).max() + 1               # a tied row
    w = (rs.randn(k, n) * 0.3).astype(np.float32)
    b = rs.randn(n).astype(np.float32) * 0.5
    dy = rs.randn(m, n).astype(np.float32)
    jqt, qt = JFixed(8, 4), FixedPointType(8, 4)
    spec = jspec = None
    gated = False
    if epilogue is not None:
        fn, gated = epilogue
        spec = TableSpec(fn, 1024, -8.0, 8.0, None, "interp")
        jspec = JSpec(fn, 1024, -8.0, 8.0, None, "interp")

    # the scales and codes eagerly (the reference's division), the
    # product's gradient jitted (XLA's fused epilogue and its transposes,
    # which the port's plain backward follows)
    def quant(v, axis):
        s = j_calibrate(v, jqt, channel_axes=(axis,))
        return jnp.clip(jnp.round(v / s), jqt.int_min,
                        jqt.int_max).astype(jqt.dtype), s

    def product(sx, sw, bv, xq, wq):
        y = jax_qmatmul_kernel_form(xq, wq, sx, sw, bv if bias else None,
                                    jnp.float32, act_spec=jspec,
                                    act_gated=gated)
        return jnp.sum(y * dy)

    (xq, sx), vjp_x = jax.vjp(lambda v: quant(v, 0), x)
    (wq, sw), vjp_w = jax.vjp(lambda v: quant(v, 1), w)
    dsx, dsw, db = jax.jit(jax.grad(product, argnums=(0, 1, 2)))(
        sx, sw, b, xq, wq)
    want = (vjp_x((_float0(xq), dsx))[0], vjp_w((_float0(wq), dsw))[0], db)
    xt, wt, bt = (torch.tensor(v, requires_grad=True) for v in (x, w, b))
    xq, sx = ops.quantize_rows(xt, qt)
    wq, sw = _quantize_weight(wt, qt)
    y = ops.qmatmul(xq, wq, sx, sw, bias=bt if bias else None,
                    act_spec=spec, act_gated=gated)
    y.backward(torch.tensor(dy))
    got = [xt.grad, wt.grad, bt.grad if bias else torch.zeros(n)]
    for name, g, wv in zip(("x", "w", "bias"), got, want):
        wv = np.asarray(wv) if name != "bias" or bias else np.zeros(n)
        g = g.numpy()
        # only the arg-max-abs elements carry a gradient, on both sides
        np.testing.assert_array_equal(g != 0, wv != 0, err_msg=name)
        err = np.abs(g - wv).max() / max(np.abs(wv).max(), 1e-30)
        assert err <= 1e-5, (name, err)
    gx = got[0].numpy()
    assert gx[3, 1] == gx[3, 9] != 0 and np.count_nonzero(gx[3]) == 2
    assert np.count_nonzero(gx) == m + 1      # one a row, two in the tie
