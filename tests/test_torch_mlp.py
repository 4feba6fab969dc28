"""The paper's jet-tagging MLP (16 -> 64 -> 32 -> 32 -> 5), port vs ``repro``.

Both sides run ``repro.models.mlp.init(PRNGKey(0))``'s weights (converted
through numpy) on the same seeded inputs:

* f32: ``forward`` logits within atol 1e-5 (``torch.matmul`` and XLA's
  dot sum in their own orders), ``predict`` and ``loss`` likewise;
* int8, dynamic (float weights quantized per call) and PTQ (``QTensor``
  leaves): bitwise against the reference's qmatmul kernel in interpret
  mode (``backend="pallas"``), whose bias epilogue rounds once as the
  port's does; against the reference's default lowering (XLA rounds the
  bias epilogue twice) within 4 f32 ulps of the logits' scale;
* ``use_lut``: ``predict``'s table softmax (the 1024-entry, 18-bit
  override) within ``test_torch_lut.py``'s table-softmax tolerance
  (rtol 1e-6, atol 1e-7: the table values are bitwise, the row sum's
  order is XLA's or torch's), over the same logits and end to end on
  both weight kinds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import mlp as jmlp  # noqa: E402
from repro.nn.context import QuantContext as JCtx  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.nn.context import QuantContext  # noqa: E402
from torch_parity import int8_policies, jax_to_numpy  # noqa: E402

B = 257


def _inputs(seed=0, b=B):
    rs = np.random.RandomState(seed)
    x = (rs.randn(b, 16) * 1.5).astype(np.float32)
    y = rs.randint(0, 5, (b,)).astype(np.int32)
    return x, y


def _params(weights):
    """(JAX tree, port tree) of the reference's init; ``weights="ptq"``
    quantizes both with the reference's ``ptq_params``."""
    from repro.core.quantize import ptq_params as j_ptq
    jp = jmlp.init(jax.random.PRNGKey(0))
    qtype = None
    if weights == "ptq":
        jpol, _, qtype = int8_policies()
        jp = j_ptq(jp, jpol)
    return jp, params_from_numpy(jax_to_numpy(jp), qtype=qtype)


def _contexts(mode, **kw):
    from repro.core.precision import PrecisionPolicy as JPolicy
    from repro_torch.core.precision import PrecisionPolicy
    jpol, pol, _ = int8_policies() if mode == "int8" else (JPolicy(),
                                                           PrecisionPolicy(),
                                                           None)
    jkw = dict(kw)
    return (JCtx(mode=mode, policy=jpol, compute_dtype=jnp.float32, **jkw),
            QuantContext(mode=mode, policy=pol, compute_dtype=torch.float32,
                         **{k: v for k, v in kw.items() if k != "backend"}))


def test_config_and_init_shapes():
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs import jet_mlp
    assert "jet-mlp" in ARCH_IDS and get_config("jet-mlp").family == "mlp"
    assert (jet_mlp.HIDDEN, jet_mlp.N_FEATURES, jet_mlp.N_CLASSES) == \
        ((64, 32, 32), 16, 5)
    p = mlp.init(torch.Generator().manual_seed(0), device="cpu")
    jp = jmlp.init(jax.random.PRNGKey(0))
    assert sorted(p) == sorted(jp) == ["fc0", "fc1", "fc2", "fc3"]
    for name in p:
        for leaf in ("w", "b"):
            assert tuple(p[name][leaf].shape) == jp[name][leaf].shape
            assert p[name][leaf].dtype == torch.float32
    assert not p["fc0"]["b"].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_f32_forward_predict_loss(seed):
    jp, tp = _params("float")
    jctx, tctx = _contexts("none")
    x, y = _inputs(seed)
    want = np.asarray(jmlp.forward(jp, jnp.asarray(x), jctx))
    got = mlp.forward(tp, torch.from_numpy(x), tctx).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        mlp.predict(tp, torch.from_numpy(x), tctx).numpy(),
        np.asarray(jmlp.predict(jp, jnp.asarray(x), jctx)), atol=1e-6,
        rtol=0)
    jl, jm = jmlp.loss(jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jctx)
    tl, tm = mlp.loss(tp, {"x": torch.from_numpy(x),
                           "y": torch.from_numpy(y)}, tctx)
    assert not tl.requires_grad
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=0)
    assert tm["accuracy"].item() == float(jm["accuracy"])


@pytest.mark.parametrize("weights", ["float", "ptq"],
                         ids=["dynamic", "ptq"])
@pytest.mark.parametrize("b", [1, 16, B])
def test_int8_forward_bitwise(weights, b):
    """int8 weights: every layer through ``quantize_rows`` and ``qmatmul``
    (K = 16, 64, 32, 32; N = 64, 32, 32, 5)."""
    jp, tp = _params(weights)
    jctx, tctx = _contexts("int8", backend="pallas")
    x, _ = _inputs(2, b)
    got = mlp.forward(tp, torch.from_numpy(x), tctx).numpy()
    want = np.asarray(jmlp.forward(jp, jnp.asarray(x), jctx))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the reference's default (XLA) lowering rounds acc * sa * sb and the
    # bias add separately: a few ulps of the logits' scale at most
    jdef, _ = _contexts("int8")
    want_xla = np.asarray(jmlp.forward(jp, jnp.asarray(x), jdef))
    ulp = np.spacing(np.abs(want_xla).max())
    assert np.abs(got - want_xla).max() <= 4 * ulp


@pytest.mark.parametrize("weights", ["float", "ptq"],
                         ids=["dynamic", "ptq"])
def test_int8_loss_matches(weights):
    jp, tp = _params(weights)
    jctx, tctx = _contexts("int8", backend="pallas")
    x, y = _inputs(3)
    jl, jm = jmlp.loss(jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jctx)
    tl, tm = mlp.loss(tp, {"x": torch.from_numpy(x),
                           "y": torch.from_numpy(y)}, tctx)
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-6, rtol=0)
    assert tm["accuracy"].item() == float(jm["accuracy"])


@pytest.mark.parametrize("mode,weights", [("none", "float"),
                                          ("int8", "float"),
                                          ("int8", "ptq")],
                         ids=["f32", "int8-dynamic", "int8-ptq"])
def test_lut_predict(mode, weights):
    """``predict`` under ``use_lut``: the paper's table softmax with the
    18-bit, 1024-entry override, over the same logits and end to end (the
    int8 logits are bitwise, the f32 ones within 1e-5)."""
    from repro.nn.activations import softmax as j_softmax
    from repro_torch.nn.activations import softmax
    jp, tp = _params(weights)
    kw = {"backend": "pallas"} if mode == "int8" else {}
    jctx, tctx = _contexts(mode, use_lut=True, **kw)
    x, _ = _inputs(4)
    logits = np.array(jmlp.forward(jp, jnp.asarray(x), jctx))
    np.testing.assert_allclose(
        softmax(torch.from_numpy(logits), tctx).numpy(),
        np.asarray(j_softmax(jnp.asarray(logits), jctx)), rtol=1e-6,
        atol=1e-7)
    got = mlp.predict(tp, torch.from_numpy(x), tctx).numpy()
    want = np.asarray(jmlp.predict(jp, jnp.asarray(x), jctx))
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-7 if mode == "int8" else 1e-5)
    # a table softmax, not the exact one
    exact = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    assert np.abs(want - exact).max() > 0
