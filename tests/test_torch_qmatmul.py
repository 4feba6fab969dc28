"""qmatmul parity: the port's plain version (and its kernel wrapper on CPU
tensors) against ``repro.kernels.ref.qmatmul_ref`` and the Pallas kernel
in interpret mode.

Tolerances: the int32 accumulator is exact; the f32 epilogue runs the
same ops in the same order, so outputs agree within rtol 1e-6.  That
holds for the LUT cases against the Pallas kernel too, although it
indexes with ``(y - lo) * step_inv`` where the plain versions divide by
``step``: on these inputs no position lands within an ulp of a knot.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.tables import TableSpec as JSpec  # noqa: E402
from repro.kernels.qmatmul import qmatmul_pallas  # noqa: E402
from repro.kernels.ref import qmatmul_ref as jax_qmatmul_ref  # noqa: E402
from repro_torch.core.tables import TableSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.qmatmul import qmatmul, qmatmul_plain  # noqa: E402
from repro_torch.kernels.ref import int8_matmul_exact  # noqa: E402

TIGHT = dict(rtol=1e-6, atol=1e-6)


def _operands(m, k, n, seed, lo=-127, hi=128, scale=0.01):
    rs = np.random.RandomState(seed)
    a = rs.randint(lo, hi, (m, k)).astype(np.int8)
    b = rs.randint(lo, hi, (k, n)).astype(np.int8)
    sa = ((rs.rand(m, 1) + 0.1) * scale).astype(np.float32)
    sb = ((rs.rand(1, n) + 0.1) * scale).astype(np.float32)
    bias = rs.randn(n).astype(np.float32)
    return a, b, sa, sb, bias


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# cases of tests/test_kernels.py::TestQMatmulKernel (ragged and aligned),
# plus main-path-like decode / prefill shapes at smoke width
SHAPES = [(4, 8, 4), (128, 128, 128), (130, 300, 70), (256, 512, 384),
          (1, 1024, 1), (300, 200, 100), (8, 128, 256), (32, 256, 128),
          (7, 13, 5)]


@pytest.mark.parametrize("mkn", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_reference_and_pallas(mkn):
    m, k, n = mkn
    a, b, sa, sb, _ = _operands(m, k, n, seed=m + k + n)
    got = qmatmul_plain(_t(a), _t(b), _t(sa), _t(sb)).numpy()
    want = np.asarray(jax_qmatmul_ref(a, b, sa, sb))
    np.testing.assert_allclose(got, want, **TIGHT)
    pal = np.asarray(qmatmul_pallas(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(sa), jnp.asarray(sb),
                                    interpret=True))
    np.testing.assert_allclose(got, pal, **TIGHT)
    # the kernel wrapper on CPU tensors is the plain version
    np.testing.assert_array_equal(
        qmatmul(_t(a), _t(b), _t(sa), _t(sb)).numpy(), got)


@pytest.mark.parametrize("mkn", [(4, 8, 4), (130, 300, 70), (8, 1024, 16)])
def test_int32_part_exact(mkn):
    m, k, n = mkn
    a, b, _, _, _ = _operands(m, k, n, seed=7)
    acc = int8_matmul_exact(_t(a), _t(b)).numpy()
    assert acc.dtype == np.int32
    np.testing.assert_array_equal(acc, a.astype(np.int64) @ b.astype(np.int64))
    # unit scales: the f32 output is the accumulator itself
    got = qmatmul_plain(_t(a), _t(b), 1.0, 1.0).numpy()
    want = np.asarray(jax_qmatmul_ref(a, b, 1.0, 1.0))
    np.testing.assert_array_equal(got, want)


def test_int32_accumulation_does_not_saturate():
    a = np.full((8, 1024), 127, np.int8)
    b = np.full((1024, 8), 127, np.int8)
    out = qmatmul_plain(_t(a), _t(b), 1.0, 1.0)
    assert float(out[0, 0]) == 127.0 * 127.0 * 1024
    a[:] = -128
    acc = int8_matmul_exact(_t(a), _t(b))
    assert int(acc[0, 0]) == -128 * 127 * 1024


def test_scalar_scales():
    a, b, _, _, _ = _operands(32, 64, 16, seed=2)
    got = qmatmul_plain(_t(a), _t(b), 0.5, 2.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_qmatmul_ref(a, b, 0.5,
                                                                  2.0)))


@pytest.mark.parametrize("indexing", ["interp", "nearest", "trunc"])
@pytest.mark.parametrize("gated", [False, True])
def test_fused_epilogue(indexing, gated):
    """Cases of tests/test_fused_pipeline.py::TestFusedEpilogue."""
    a, b, sa, sb, bias = _operands(32, 128, 64, seed=11, scale=0.005)
    fn = "silu_gate" if gated else "sigmoid"
    args = (fn, 512, -10.0, 10.0, None, indexing)
    got = qmatmul_plain(_t(a), _t(b), _t(sa), _t(sb), _t(bias),
                        act_spec=TableSpec(*args), act_gated=gated).numpy()
    want = np.asarray(jax_qmatmul_ref(a, b, sa, sb, bias,
                                      act_spec=JSpec(*args), act_gated=gated))
    np.testing.assert_allclose(got, want, **TIGHT)
    pal = np.asarray(qmatmul_pallas(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa), jnp.asarray(sb),
        jnp.asarray(bias), act_spec=JSpec(*args), act_gated=gated,
        interpret=True))
    np.testing.assert_allclose(got, pal, **TIGHT)


def test_fused_epilogue_power_of_two_step_matches_pallas_tightly():
    """With a power-of-two table step, ``/ step`` and ``* step_inv`` are
    the same operation, so plain and Pallas agree to f32 precision."""
    a, b, sa, sb, bias = _operands(64, 256, 96, seed=12, scale=0.005)
    args = ("gelu_gate", 1024, -8.0, 8.0, None, "interp")
    got = qmatmul_plain(_t(a), _t(b), _t(sa), _t(sb), _t(bias),
                        act_spec=TableSpec(*args), act_gated=True).numpy()
    pal = np.asarray(qmatmul_pallas(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa), jnp.asarray(sb),
        jnp.asarray(bias), act_spec=JSpec(*args), act_gated=True,
        interpret=True))
    np.testing.assert_allclose(got, pal, **TIGHT)


def test_bias_only_epilogue():
    a, b, sa, sb, bias = _operands(32, 128, 64, seed=13, scale=0.005)
    got = qmatmul_plain(_t(a), _t(b), _t(sa), _t(sb), _t(bias)).numpy()
    want = np.asarray(jax_qmatmul_ref(a, b, sa, sb, bias))
    np.testing.assert_allclose(got, want, **TIGHT)
    pal = np.asarray(qmatmul_pallas(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(sa), jnp.asarray(sb),
                                    jnp.asarray(bias), interpret=True))
    np.testing.assert_allclose(got, pal, **TIGHT)


@pytest.mark.parametrize("mkn", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_bias_epilogue_bitwise_pallas(mkn, out_dtype):
    """With a bias, XLA compiles ``qmatmul_pallas``'s ``acc * sa * sb +
    bias`` as ``fma(acc * sa, sb, bias)``; the plain version (and the
    CUDA kernel) round the same way, so the outputs agree bit for bit."""
    m, k, n = mkn
    a, b, sa, sb, bias = _operands(m, k, n, seed=2 * (m + k + n), scale=0.005)
    got = qmatmul_plain(_t(a), _t(b), _t(sa), _t(sb), _t(bias),
                        getattr(torch, out_dtype))
    pal = qmatmul_pallas(jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa),
                         jnp.asarray(sb), jnp.asarray(bias),
                         out_dtype=getattr(jnp, out_dtype), interpret=True)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(pal.astype(jnp.float32)))


def test_bf16_output():
    a, b, sa, sb, _ = _operands(16, 64, 32, seed=14)
    got = qmatmul_plain(_t(a), _t(b), _t(sa), _t(sb),
                        out_dtype=torch.bfloat16)
    want = np.asarray(jax_qmatmul_ref(a, b, sa, sb, out_dtype=jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


def test_ops_dispatch():
    a, b, sa, sb, bias = _operands(8, 32, 16, seed=15)
    want = qmatmul_plain(_t(a), _t(b), _t(sa), _t(sb), _t(bias)).numpy()
    for backend in (None, "cuda", "ref"):
        got = ops.qmatmul(_t(a), _t(b), _t(sa), _t(sb), bias=_t(bias),
                          backend=backend).numpy()
        np.testing.assert_array_equal(got, want)
