"""Every family's training loss and gradients: port vs ``repro``.

From the same converted smoke weights and the same numpy batch
(``make_batch``, B 2, S 16), f32 compute: the port's
``models.api.loss_fn`` and every gradient leaf (``torch.autograd``)
against ``jax.value_and_grad(repro.models.api.loss_fn)``.  Loss and the
metrics within rtol 2e-6; each gradient leaf within relative L2 2e-5
(f32 sums in another order through two layers; the worst leaf read
3.6e-6 when this was written).  This file: gemma (dense, tied), deepseek
(MLA + MoE, the aux term), whisper (encoder-decoder) and yi under
``mode="fake"`` with weights fake-quantized to ``AC_FIXED_16_6`` and to
``E4M3`` (the straight-through gradient), then with the activations
fake-quantized too (``PrecisionPolicy.uniform(qt, qt)``).  With
fixed-point activations a last-bit difference of an f32 product (the two
packages sum in their own orders) can move an activation across a
rounding boundary of the 2^-10 quantum, and a moved code moves every
gradient behind it: that case is held to relative L2 1e-3 per leaf
(read 7.5e-4 at worst; a control that quantizes the port's weights only
reads 1.3e-3 to 1.9e-3 on every leaf and misses the loss by 2.6e-5
relative), the loss to the same 2e-6 as the rest.  ``cfg.remat`` "full"
gives the same loss and gradients bit for bit as "none".  The recurrent families
and the VLM: ``test_torch_train_recurrent.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import qtypes as jq  # noqa: E402
from repro.core.precision import PrecisionPolicy as JPolicy  # noqa: E402
from repro.data.pipeline import make_batch  # noqa: E402
from repro.nn.context import QuantContext as JCtx  # noqa: E402
from repro_torch.core import qtypes as tq  # noqa: E402
from repro_torch.core.precision import PrecisionPolicy  # noqa: E402
from repro_torch.nn.context import QuantContext  # noqa: E402
from torch_parity import contexts, smoke_params  # noqa: E402
from train_parity import (jax_loss_and_grads, rel_l2,  # noqa: E402
                          torch_loss_and_grads)

GRAD_TOL = 2e-5
LOSS_RTOL = 2e-6
#: fixed-point activations: a moved code (module docstring)
GRAD_TOL_FIXED_ACTS = 1e-3

CASES = {
    "gemma-2b": ("gemma-2b", None, False),
    "deepseek-v2-236b": ("deepseek-v2-236b", None, False),
    "whisper-base": ("whisper-base", None, False),
    "yi-6b fake AC_FIXED_16_6": ("yi-6b", "AC_FIXED_16_6", False),
    "yi-6b fake E4M3": ("yi-6b", "E4M3", False),
    "yi-6b fake AC_FIXED_16_6 acts": ("yi-6b", "AC_FIXED_16_6", True),
    "yi-6b fake E4M3 acts": ("yi-6b", "E4M3", True),
}


def _contexts(qt, acts):
    if qt is None:
        return contexts("none")
    jt, tt = getattr(jq, qt), getattr(tq, qt)
    return (JCtx(mode="fake",
                 policy=JPolicy.uniform(jt, jt if acts else None),
                 compute_dtype=jnp.float32),
            QuantContext(mode="fake",
                         policy=PrecisionPolicy.uniform(tt, tt if acts
                                                        else None),
                         compute_dtype=torch.float32))


@pytest.fixture(scope="module")
def results():
    """Each case's reference and port readings, computed once."""
    return {}


def _run(results, name):
    if name not in results:
        arch, qt, acts = CASES[name]
        cfg, jp, tp = smoke_params("none", arch=arch)
        jctx, tctx = _contexts(qt, acts)
        batch = make_batch(cfg, 0, 2, 16)
        results[name] = (jax_loss_and_grads(cfg, jp, jctx, batch),
                         torch_loss_and_grads(cfg, tp, tctx, batch))
    return results[name]


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients(results, name):
    (jl, jm, jg), (tl, tm, tg) = _run(results, name)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    for key in jm:
        np.testing.assert_allclose(tm[key], jm[key], rtol=LOSS_RTOL,
                                   atol=1e-7)
    assert set(tg) == set(_flat_keys(jg))
    worst = max((rel_l2(tg[k], v), k) for k, v in _flat_items(jg))
    fixed_acts = CASES[name][2] and CASES[name][1].startswith("AC_FIXED")
    assert worst[0] <= (GRAD_TOL_FIXED_ACTS if fixed_acts else GRAD_TOL), \
        worst


def _flat_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_items(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _flat_keys(tree):
    return [k for k, _ in _flat_items(tree)]


def test_fake_mode_moves_the_loss(results):
    """The fake-quantized losses differ from the float one (the weights
    really are quantized) and from each other."""
    (_, _, _), (base, _, _) = _run(results, "gemma-2b")
    fx = _run(results, "yi-6b fake AC_FIXED_16_6")[1][0]
    fp8 = _run(results, "yi-6b fake E4M3")[1][0]
    cfg, _, tp = smoke_params("none", arch="yi-6b")
    plain = torch_loss_and_grads(cfg, tp, contexts("none")[1],
                                 make_batch(cfg, 0, 2, 16))[0]
    assert len({plain, fx, fp8}) == 3 and base > 0


def test_remat_full_is_bitwise_none():
    """``cfg.remat`` "full" checkpoints each layer; loss and gradients are
    the same bits as without it (gemma smoke, f32)."""
    cfg, _, tp = smoke_params("none", arch="gemma-2b")
    batch = make_batch(cfg, 1, 2, 16)
    _, tctx = contexts("none")
    a = torch_loss_and_grads(cfg, tp, tctx, batch)
    b = torch_loss_and_grads(dataclasses.replace(cfg, remat="full"), tp,
                             tctx, batch)
    assert a[0] == b[0]
    for k in a[2]:
        assert np.array_equal(a[2][k], b[2][k]), k
