"""The paper's jet flow (``repro_torch.examples.train_jet_mlp``) against the
reference flow (``examples/train_jet_mlp.py``), on the CPU.

Both sides start from ``repro.models.mlp.init(PRNGKey(0))`` (converted
through numpy) and the reference example's ``jet_data``, and take its 400
full-batch SGD steps at lr 0.05 in f32 (the reference's jitted step, as
its ``main`` runs it).  Then:

* ``jet_data``: the port's features bitwise, labels equal;
* the accuracy table (f32 and the seven formats, weights and activations
  fake-quantized): each accuracy within 2 test rows of 4096 of the
  reference's.  The two trainings' weights part in their last f32 bits
  (``torch.matmul`` and XLA's dot sum in their own orders), which can flip
  a row on a decision boundary; the tables read equal when this was
  written.  The LUT softmax's largest deviation within rtol 1e-4;
* from the reference's trained weights, for each format, the port's
  ``mlp.forward`` of the 4096 test rows under
  ``PrecisionPolicy.uniform(qt, qt)``: logits within 4 f32 ulps of their
  largest magnitude and the same argmax on every row.  A hidden code that moved would move a logit by at least a
  quantum times a weight (2^-10 x ~0.1 at the finest format), far above
  that, so the bound also says that no activation code moved (every
  format read bitwise but E5M2, 3 rows at 1 ulp, from the last layer's
  unquantized sum);
* ``mlp.loss`` and its gradients (the straight-through gradient of both
  quantizers) against ``jax.value_and_grad(repro.models.mlp.loss)`` at
  the init, where training takes them: the loss within rtol 2e-6, each
  gradient leaf within relative L2 2e-5.  (At the trained weights every
  row is right with p ~ 1, the gradient is a sum of terms that nearly
  cancel, and the two packages' last bits read up to 4e-5 there.)
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import qtypes as jq  # noqa: E402
from repro.core.precision import PrecisionPolicy as JPolicy  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.nn.context import QuantContext as JCtx  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.precision import PrecisionPolicy  # noqa: E402
from repro_torch.examples import train_jet_mlp  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.nn.context import QuantContext  # noqa: E402
from torch_parity import jax_to_numpy  # noqa: E402
from train_parity import flat, rel_l2  # noqa: E402

STEPS = 400
ACC_ROWS = 2
JFORMATS = (jq.FixedPointType(16, 6), jq.FixedPointType(10, 4),
            jq.FixedPointType(8, 3), jq.FixedPointType(6, 2),
            jq.MiniFloatType(5, 2), jq.MiniFloatType(4, 3, ieee_inf=False),
            jq.MiniFloatType(3, 4))


def _reference_example():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "train_jet_mlp.py")
    spec = importlib.util.spec_from_file_location("ref_train_jet_mlp", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def flows():
    """The reference flow's trained weights, accuracy table and LUT
    deviation, and the port's ``main`` from the same init; run once."""
    ref = _reference_example()
    x, y = ref.jet_data(4096)
    xt, yt = ref.jet_data(4096, seed=9)
    init = jmlp.init(jax.random.PRNGKey(0))
    ctx32 = JCtx(compute_dtype=jnp.float32)

    @jax.jit
    def step(p):
        (_, m), g = jax.value_and_grad(jmlp.loss, has_aux=True)(
            p, {"x": x, "y": y}, ctx32)
        return jax.tree_util.tree_map(lambda a, b: a - 0.05 * b, p, g), m

    params = init
    for _ in range(STEPS):
        params, _ = step(params)

    def logits(ctx):
        return jax.jit(lambda p, x: jmlp.forward(p, x, ctx))(params, xt)

    def acc(lg):
        return float(jnp.mean(jnp.argmax(lg, -1) == yt))

    fake = {qt.short_name(): logits(JCtx(mode="fake",
                                         policy=JPolicy.uniform(qt, qt),
                                         compute_dtype=jnp.float32))
            for qt in JFORMATS}
    lut = JCtx(use_lut=True, compute_dtype=jnp.float32)
    lut_dp = float(jnp.abs(jmlp.predict(params, xt[:8], lut)
                           - jmlp.predict(params, xt[:8], ctx32)).max())
    port = train_jet_mlp.main(
        ["--steps", str(STEPS), "--device", "cpu"],
        params=params_from_numpy(jax_to_numpy(init)))
    return {"ref": ref, "init": init, "params": params,
            "acc_fp32": acc(logits(ctx32)),
            "formats": {k: acc(v) for k, v in fake.items()},
            "logits": {k: np.asarray(v) for k, v in fake.items()},
            "lut_max_dp": lut_dp, "port": port,
            "train": (np.asarray(x), np.asarray(y)), "test": np.asarray(xt)}


def test_jet_data_matches_reference(flows):
    for seed in (0, 9):
        jx, jy = flows["ref"].jet_data(64, seed=seed)
        tx, ty = train_jet_mlp.jet_data(64, seed=seed)
        assert np.array_equal(tx.numpy().view(np.uint32),
                              np.asarray(jx).view(np.uint32))
        assert np.array_equal(ty.numpy(), np.asarray(jy))


def test_accuracy_table_matches_reference(flows):
    port = flows["port"]
    assert list(port["formats"]) == list(flows["formats"])
    got = [port["acc_fp32"]] + list(port["formats"].values())
    want = [flows["acc_fp32"]] + list(flows["formats"].values())
    np.testing.assert_allclose(got, want, rtol=0, atol=ACC_ROWS / 4096)
    np.testing.assert_allclose(port["lut_max_dp"], flows["lut_max_dp"],
                               rtol=1e-4)


@pytest.mark.parametrize("i", range(len(JFORMATS)),
                         ids=[qt.short_name() for qt in JFORMATS])
def test_fake_quant_forward_loss_and_gradients(flows, i):
    jqt, tqt = JFORMATS[i], train_jet_mlp.FORMATS[i]
    assert tqt.short_name() == jqt.short_name()
    jctx = JCtx(mode="fake", policy=JPolicy.uniform(jqt, jqt),
                compute_dtype=jnp.float32)
    tctx = QuantContext(mode="fake", policy=PrecisionPolicy.uniform(tqt, tqt),
                        compute_dtype=torch.float32)
    jl = flows["logits"][jqt.short_name()]
    tp = params_from_numpy(jax_to_numpy(flows["params"]))
    with torch.no_grad():
        tl = mlp.forward(tp, torch.from_numpy(flows["test"]), tctx).numpy()
    ulp = np.spacing(np.float32(np.abs(jl).max()))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=4 * ulp)
    assert np.array_equal(tl.argmax(-1), jl.argmax(-1))

    x, y = flows["train"]
    ji = flows["init"]
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmlp.loss(p, b, jctx), has_aux=True))(
        ji, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    tp = params_from_numpy(jax_to_numpy(ji))
    leaves = flat(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    tloss, _ = mlp.loss(tp, {"x": torch.from_numpy(x),
                             "y": torch.from_numpy(y)}, tctx)
    grads = torch.autograd.grad(tloss, list(leaves.values()))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=2e-6)
    jflat = flat(jax_to_numpy(jg))
    for (k, _), g in zip(leaves.items(), grads):
        assert rel_l2(g.numpy(), jflat[k]) <= 2e-5, k
