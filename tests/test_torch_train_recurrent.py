"""The recurrent families' and the VLM's training loss and gradients:
port vs ``repro``.

As ``test_torch_train_models.py`` (same batch, f32 compute, loss and
metrics within rtol 2e-6, each gradient leaf within relative L2 2e-5):
mamba2-370m (the SSD scan under autograd), zamba2-1.2b (mamba layers
around the shared attention block) and llama-3.2-vision-11b with the
cross gates drawn nonzero on both sides (``vlm_smoke_params``), so the
image and the cross blocks carry gradient.

Planted for the recurrent families: a chunk whose decays overflow f32
(``test_long_chunk_gradients_stay_finite``).  The reference's gradients
are NaN there (it exps ``ca_i - ca_j`` before it masks ``i < j``); the
port's are finite and equal the reference's at a shorter chunk, where no
decay overflows (the same function, summed in other chunks: within
relative L2 ``CHUNK_TOL``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import make_batch  # noqa: E402
from torch_parity import contexts, smoke_params, vlm_smoke_params  # noqa: E402
from train_parity import (flat, jax_loss_and_grads, rel_l2,  # noqa: E402
                          torch_loss_and_grads)

GRAD_TOL = 2e-5
LOSS_RTOL = 2e-6
CHUNK_TOL = 1e-4     # the port at chunk 32 vs the reference at chunk 4
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


def _plant_dt_bias(tree, value, fill):
    """Every ``dt_bias`` leaf of a nested dict set to ``value`` (``fill`` of
    a leaf gives the new leaf)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _plant_dt_bias(v, value, fill)
        elif k == "dt_bias":
            tree[k] = fill(v, value)


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_long_chunk_gradients_stay_finite(arch):
    """One 32-token chunk with dt_bias 3.5 on every mamba layer: dt ~3.5,
    so the masked decays exp(ca_i - ca_j), i < j, reach exp(~108), past
    f32's range (mamba2-370m's own init reaches it at its chunk of 256, dt
    ~0.69).  where(mask, scores * inf, 0) is 0 forward and NaN in its
    backward: the reference's gradients are non-finite, the port's (the
    exponent masked before the exp) finite, its loss the reference's, and
    its gradients the reference's at chunk 4, where nothing overflows
    (measured: A_log 2.8e-5 / 4.1e-5, the other leaves <= 4.4e-6)."""
    import jax.numpy as jnp
    cfg, jp, tp = smoke_params("none", arch=arch)
    _plant_dt_bias(jp, 3.5, lambda v, x: jnp.full_like(v, x))
    _plant_dt_bias(tp, 3.5, lambda v, x: v.fill_(x))
    jctx, tctx = contexts("none")
    batch = make_batch(cfg, 0, 2, 32)

    def chunk(q):
        return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                                chunk=q))
    jl, _, jg = jax_loss_and_grads(chunk(32), jp, jctx, batch)
    assert not all(np.isfinite(v).all() for v in flat(jg).values())
    tl, _, tg = torch_loss_and_grads(chunk(32), tp, tctx, batch)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert all(np.isfinite(v).all() for v in tg.values())
    _, _, jg4 = jax_loss_and_grads(chunk(4), jp, jctx, batch)
    worst = max((rel_l2(tg[k], v), k) for k, v in flat(jg4).items())
    assert worst[0] <= CHUNK_TOL, worst
