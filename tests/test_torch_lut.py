"""LUT parity: the paper's constant-table activations and softmax, port vs
``repro``.

* The softmax table policy and its tables, the functional
  ``lut_activation`` and ``lut_activation_ref`` are bitwise the
  reference's (the same NumPy tables, the same ``/ step`` indexing).
* The ``lut_activation`` kernel's plain version (what its wrapper runs on
  CPU tensors, and what the CUDA kernel is held against on the card) is
  bitwise ``lut_activation_pallas(interpret=True)``, also at a step that
  is not a power of two, where ``* step_inv`` and ``/ step`` part ways.
* ``table_softmax`` agrees with the reference's to f32 rounding: the row
  sum is reduced in another order (rtol 1e-6).
* The LUT ``act_fn`` equals the reference's on both backends, in f32 and
  bf16 (the plain version against Pallas interpret, ``ref`` against
  ``ref``), and an int8 projection fuses the table into qmatmul.
* The qmatmul epilogue's plain version indexes as the kernels do: bitwise
  ``qmatmul_pallas(interpret=True)`` with a silu table over (-10, 10).

The reference kernels' ``interp`` expression ``y0 * (1 - frac) + y1 *
frac`` runs as one fused multiply-add under XLA (interpret mode shows
it); the plain version computes that same single rounding.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import qtypes as jqt  # noqa: E402
from repro.core import tables as jt  # noqa: E402
from repro.kernels.lut_activation import lut_activation_pallas  # noqa: E402
from repro.kernels.qmatmul import qmatmul_pallas  # noqa: E402
from repro.kernels.ref import lut_activation_ref as j_lut_ref  # noqa: E402
from repro.nn import activations as jact  # noqa: E402
from repro.nn.context import QuantContext as JCtx  # noqa: E402
from repro_torch.core import qtypes as tqt  # noqa: E402
from repro_torch.core import tables as tt  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.lut_activation import lut_activation  # noqa: E402
from repro_torch.kernels.qmatmul import qmatmul_plain  # noqa: E402
from repro_torch.nn import activations as tact  # noqa: E402
from repro_torch.nn.context import QuantContext  # noqa: E402

RS = np.random.RandomState(0)


def _bits(a):
    """Float data as integer bit patterns (bf16 via its f32 widening)."""
    if isinstance(a, torch.Tensor):
        a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    else:
        a = np.asarray(a)
        if a.dtype == jnp.bfloat16:
            a = a.astype(np.float32)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bitwise(got, want):
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _qt(jq):
    return None if jq is None else tqt.FixedPointType(
        jq.width, jq.int_bits, jq.signed, jq.rounding, jq.overflow)


def _specs(fn, n, lo, hi, jq, indexing):
    return (tt.TableSpec(fn, n, lo, hi, _qt(jq), indexing),
            jt.TableSpec(fn, n, lo, hi, jq, indexing))


def _x(shape, scale, dtype="float32"):
    x = (RS.randn(*shape) * scale).astype(np.float32)
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if dtype == "bfloat16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    return tx, jx


# -- constants, policy and tables ---------------------------------------------
def test_canonical_qtypes_equal():
    for name in ("AC_FIXED_16_6", "AC_FIXED_18_8"):
        assert dataclasses.asdict(getattr(tqt, name)) == \
            dataclasses.asdict(getattr(jqt, name))


@pytest.mark.parametrize("respect_user_type", [False, True])
@pytest.mark.parametrize("exact_divide", [True, False])
@pytest.mark.parametrize("n,indexing", [(1024, "trunc"), (512, "interp")])
def test_softmax_policy_and_tables_bitwise(respect_user_type, exact_divide, n,
                                           indexing):
    jpol = jt.softmax_table_policy(jqt.AC_FIXED_16_6,
                                   respect_user_type=respect_user_type, n=n,
                                   exact_divide=exact_divide,
                                   indexing=indexing)
    tpol = tt.softmax_table_policy(tqt.AC_FIXED_16_6,
                                   respect_user_type=respect_user_type, n=n,
                                   exact_divide=exact_divide,
                                   indexing=indexing)
    assert dataclasses.asdict(tpol) == dataclasses.asdict(jpol)
    assert dataclasses.asdict(tt.SoftmaxTablePolicy()) == \
        dataclasses.asdict(jt.SoftmaxTablePolicy())
    for fn, lo, hi in (("exp", tpol.exp_lo, tpol.exp_hi),
                       ("invert", 1.0 / tpol.n, tpol.inv_hi)):
        ts, js = _specs(fn, tpol.n, lo, hi, jpol.qtype, tpol.indexing)
        np.testing.assert_array_equal(
            tt.get_table(ts).np_values.view(np.int32),
            jt.get_table(js).np_values.view(np.int32))


@pytest.mark.parametrize("exact_divide", [True, False])
@pytest.mark.parametrize("indexing", ["trunc", "interp"])
def test_table_softmax_matches_reference(exact_divide, indexing):
    """Attention-shaped f32 logits, masked entries at -1e30 as the
    attention paths write them; rows of 24 keep the invert table's domain
    (the row sum) inside (0, 64]."""
    logits = (RS.randn(2, 4, 3, 24) * 3).astype(np.float32)
    logits[..., 20:] = -1e30
    logits[0, 0, 0, 1:] = -1e30          # a row that sees one position
    kw = dict(n=1024, exact_divide=exact_divide, indexing=indexing)
    want = jt.table_softmax(jnp.asarray(logits), axis=-1,
                            policy=jt.softmax_table_policy(**kw))
    got = tt.table_softmax(torch.from_numpy(logits), axis=-1,
                           policy=tt.softmax_table_policy(**kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("spec", [("sigmoid", 512, -8.0, 8.0, None),
                                  ("silu_gate", 1024, -10.0, 10.0, None),
                                  ("exp", 1024, -16.0, 0.0, jqt.AC_FIXED_18_8),
                                  ("gelu_gate", 1024, -8.0, 8.0, None)])
@pytest.mark.parametrize("indexing", ["trunc", "nearest", "interp"])
def test_lut_activation_ref_bitwise(spec, indexing):
    ts, js = _specs(*spec, indexing)
    tx, jx = _x((300,), 6.0)
    _assert_bitwise(ops.lut_activation(tx, ts, backend="ref"),
                    j_lut_ref(jx, js))


@pytest.mark.parametrize("fn,gated", [("gelu", True), ("silu", True),
                                      ("softplus", True), ("tanh", False),
                                      ("silu", False)])
def test_functional_lut_activation_bitwise(fn, gated):
    tx, jx = _x((257,), 7.0)
    kw = dict(n=512, lo=-8.0, hi=8.0, indexing="interp", gated=gated)
    _assert_bitwise(tt.lut_activation(tx, fn, **kw),
                    jt.lut_activation(jx, fn, **kw))


# -- the kernel's plain version against the TPU kernel -------------------------
# the cases of tests/test_kernels.py::TestLutActivationKernel ...
KERNEL_CASES = (
    [(shape, ("sigmoid", 512, -8.0, 8.0, None), idx, "float32", 4.0)
     for shape in [(7,), (3, 5), (2, 130, 3), (1024,), (256, 128)]
     for idx in ("trunc", "nearest", "interp")]
    + [((64,), ("tanh", 256, -4.0, 4.0, None), "trunc", dt, 1.0)
       for dt in ("float32", "bfloat16")]
    + [((200,), ("exp", 1024, -16.0, 0.0, jqt.AC_FIXED_18_8), "trunc",
        "float32", -8.0)]
    # ... plus steps that are not powers of two: silu's gate table (20/1024)
    # and the qmatmul epilogue suite's sigmoid table (20/512)
    + [((8, 300), (fn, n, -10.0, 10.0, None), idx, dt, 6.0)
       for fn, n in (("silu_gate", 1024), ("sigmoid", 512))
       for idx in ("trunc", "nearest", "interp")
       for dt in ("float32", "bfloat16")])


@pytest.mark.parametrize("shape,spec,indexing,dtype,scale", KERNEL_CASES)
def test_plain_version_matches_pallas_interpret(shape, spec, indexing, dtype,
                                                scale):
    ts, js = _specs(*spec, indexing)
    if scale < 0:                              # exp table: x in (-16, 0]
        x = (-RS.rand(*shape) * 16).astype(np.float32)
        tx, jx = torch.from_numpy(x), jnp.asarray(x)
    else:
        tx, jx = _x(shape, scale, dtype)
    got = lut_activation(tx, ts)               # CPU tensor -> plain version
    want = lut_activation_pallas(jx, js, interpret=True)
    assert got.dtype == tx.dtype
    _assert_bitwise(got, want)
    _assert_bitwise(ops.lut_activation(tx, ts), want)


def test_plain_version_parts_from_reference_at_non_power_of_two_step():
    """Why the plain version exists beside ``lut_activation_ref``: at a
    step of 20/1024 the two indexings pick different interpolation
    weights for some inputs (and the plain version follows the kernel)."""
    ts, js = _specs("silu_gate", 1024, -10.0, 10.0, None, "interp")
    tx, jx = _x((4096,), 6.0)
    plain = lut_activation(tx, ts).numpy()
    ref = ops.lut_activation(tx, ts, backend="ref").numpy()
    assert (plain != ref).any()
    np.testing.assert_allclose(plain, ref, rtol=0, atol=1e-6)
    _assert_bitwise(lut_activation(tx, ts),
                    lut_activation_pallas(jx, js, interpret=True))


def test_ops_dispatch():
    ts, _ = _specs("gelu_gate", 1024, -8.0, 8.0, None, "interp")
    tx, _ = _x((5, 9), 3.0)
    want = lut_activation(tx, ts)
    for backend in (None, "cuda"):
        assert torch.equal(ops.lut_activation(tx, ts, backend=backend), want)


# -- act_fn and softmax under use_lut ------------------------------------------
@pytest.mark.parametrize("name", ["gelu", "silu", "softplus", "tanh",
                                  "sigmoid", "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", [None, "ref"])
def test_lut_act_fn_matches_reference(name, dtype, backend):
    """The port's default backend (the kernel's plain version on the CPU)
    against the reference's Pallas kernel in interpret mode; ``ref``
    against ``ref``.  Inputs reach past every table domain (softplus's
    asymptote, saturation)."""
    jbackend = "pallas" if backend is None else "ref"
    tx, jx = _x((4, 70), 7.0, dtype)
    got = tact.act_fn(name, tx, QuantContext(use_lut=True, backend=backend))
    want = jact.act_fn(name, jx, JCtx(use_lut=True, backend=jbackend))
    assert got.dtype == tx.dtype
    _assert_bitwise(got, want)


def test_lut_softmax_and_exact_paths():
    logits = (RS.randn(3, 17) * 4).astype(np.float32)
    for use_lut in (False, True):
        got = tact.softmax(torch.from_numpy(logits),
                           QuantContext(use_lut=use_lut))
        want = jact.softmax(jnp.asarray(logits), JCtx(use_lut=use_lut))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    x = torch.from_numpy(logits)
    assert torch.equal(tact.act_fn("gelu", x, QuantContext()),
                       torch.nn.functional.gelu(x, approximate="tanh"))


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_lut_route_through_linear(mode, monkeypatch):
    """int8 + LUT fuses the gate activation into qmatmul's epilogue and
    never calls the standalone op; float + LUT calls it once."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.kernels import ops as tops
    from repro_torch.nn.linear import linear
    calls = {"lut": 0, "qmm_table": 0}
    real_lut, real_qmm = tops.lut_activation, tops.qmatmul

    def spy_lut(*a, **k):
        calls["lut"] += 1
        return real_lut(*a, **k)

    def spy_qmm(*a, **k):
        calls["qmm_table"] += k.get("act_spec") is not None
        return real_qmm(*a, **k)

    monkeypatch.setattr(tops, "lut_activation", spy_lut)
    monkeypatch.setattr(tops, "qmatmul", spy_qmm)
    policy = (PrecisionPolicy.uniform(FixedPointType(8, 4)) if mode == "int8"
              else PrecisionPolicy())
    ctx = QuantContext(mode=mode, policy=policy, use_lut=True,
                       compute_dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    p = {"w": torch.randn((32, 48), generator=g) * 0.2}
    y = linear(p, torch.randn((5, 32), generator=g), ctx, path="mlp/gate",
               act="gelu")
    assert y.shape == (5, 48) and torch.isfinite(y).all()
    assert calls == ({"lut": 0, "qmm_table": 1} if mode == "int8"
                     else {"lut": 1, "qmm_table": 0})


# -- the qmatmul epilogue's plain version ---------------------------------------
@pytest.mark.parametrize("indexing", ["trunc", "nearest", "interp"])
@pytest.mark.parametrize("m,k,n", [(8, 256, 512), (37, 96, 130)])
def test_qmatmul_plain_epilogue_indexes_like_the_kernels(indexing, m, k, n):
    """silu's gate table over (-10, 10) has a step of 20/1024: the plain
    epilogue follows the TPU kernel's ``* step_inv`` bit for bit.  With a
    bias the reference kernel, as XLA compiles it, also fuses
    ``acc * sa * sb + bias`` into one multiply-add, and so does the
    port's epilogue: bitwise with and without a bias."""
    rs = np.random.RandomState(m + n)
    a = rs.randint(-127, 128, (m, k)).astype(np.int8)
    b = rs.randint(-127, 128, (k, n)).astype(np.int8)
    sa = ((rs.rand(m, 1) + 0.1) * 0.01).astype(np.float32)
    sb = ((rs.rand(1, n) + 0.1) * 0.01).astype(np.float32)
    bias = rs.randn(n).astype(np.float32)
    ts, js = _specs("silu_gate", 1024, -10.0, 10.0, None, indexing)
    for with_bias in (False, True):
        got = qmatmul_plain(*(torch.from_numpy(v) for v in (a, b, sa, sb)),
                            torch.from_numpy(bias) if with_bias else None,
                            act_spec=ts, act_gated=True)
        want = qmatmul_pallas(jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa),
                              jnp.asarray(sb),
                              jnp.asarray(bias) if with_bias else None,
                              act_spec=js, act_gated=True, interpret=True)
        _assert_bitwise(got, want)
