"""The recurrent families' and the VLM's training loss and gradients:
port vs ``repro``.

As ``test_torch_train_models.py`` (same batch, f32 compute, loss and
metrics within rtol 2e-6, each gradient leaf within relative L2 2e-5):
mamba2-370m (the SSD scan under autograd), zamba2-1.2b (mamba layers
around the shared attention block) and llama-3.2-vision-11b with the
cross gates drawn nonzero on both sides (``vlm_smoke_params``), so the
image and the cross blocks carry gradient.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import make_batch  # noqa: E402
from torch_parity import contexts, smoke_params, vlm_smoke_params  # noqa: E402
from train_parity import (flat, jax_loss_and_grads, rel_l2,  # noqa: E402
                          torch_loss_and_grads)

GRAD_TOL = 2e-5
LOSS_RTOL = 2e-6
ARCHS = ["mamba2-370m", "zamba2-1.2b", "llama-3.2-vision-11b"]


@pytest.fixture(scope="module")
def results():
    return {}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients(results, arch):
    if arch.startswith("llama"):
        cfg, jp, tp = vlm_smoke_params("none")
    else:
        cfg, jp, tp = smoke_params("none", arch=arch)
    jctx, tctx = contexts("none")
    batch = make_batch(cfg, 0, 2, 16)
    jl, jm, jg = jax_loss_and_grads(cfg, jp, jctx, batch)
    tl, tm, tg = torch_loss_and_grads(cfg, tp, tctx, batch)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    for key in jm:
        np.testing.assert_allclose(tm[key], jm[key], rtol=LOSS_RTOL,
                                   atol=1e-7)
    jflat = flat(jg)
    assert set(tg) == set(jflat)
    worst = max((rel_l2(tg[k], v), k) for k, v in jflat.items())
    assert worst[0] <= GRAD_TOL, worst
    if arch.startswith("llama"):      # the gates and the image carry grad
        assert np.abs(tg["/cross/gate_attn"]).min() > 0
        assert np.abs(tg["/cross/attn/wk/w"]).max() > 0
