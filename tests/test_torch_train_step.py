"""The train step: port vs ``repro``'s unsharded jitted step.

gemma-2b smoke, f32 compute, from the reference's ``init_state`` converted
through numpy (``convert.params_from_numpy``): three steps of
``build_train_step`` (cosine warmup, peak 1e-3, warmup 1, total 4) on
``make_batch(cfg, i, 4, 32)``, at microbatches 1 and 2, against the
reference's ``build_train_step`` under ``jax.jit`` without a mesh (its
sharded ``launch/train.py`` fails under a mesh on this JAX, ROADMAP.md
section 3).
Every step: lr within rtol 1e-6 (bitwise outside ``jit``,
``test_torch_train_ops.py``; under ``jit`` XLA folds the schedule's
constants in another order), loss, accuracy and grad_norm within rtol
1e-5.  After the steps: each parameter leaf within relative
L2 1e-4 and the moments within 1e-3 -- AdamW's first steps move every
element by about lr * sign(g), so an element whose gradient is near 0
can move either way when the two gradients differ in their last bits.
The step counter and AdamW's count are equal.  ``grad_specs`` without a
mesh changes nothing; ``int8`` and ``use_lut``, once refused, now build a
step whose gradients are finite (``test_torch_train_quant.py`` holds
them against the reference).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data.pipeline import make_batch  # noqa: E402
from repro.optim import cosine_warmup as j_cosine  # noqa: E402
from repro.train.step import build_train_step as j_build  # noqa: E402
from repro.train.step import init_state as j_init_state  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import cosine_warmup  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402
from torch_parity import contexts, jax_to_numpy  # noqa: E402
from train_parity import flat, rel_l2  # noqa: E402

STEPS = 3


def _lr_j(s):
    return j_cosine(s, peak=1e-3, warmup=1, total=4)


def _lr_t(s):
    return cosine_warmup(s, peak=1e-3, warmup=1, total=4)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("gemma-2b").smoke()
    state = j_init_state(jax.random.PRNGKey(0), cfg)
    batches = [make_batch(cfg, i, 4, 32) for i in range(STEPS)]
    return cfg, state, batches


@pytest.fixture(scope="module")
def reference(setup):
    """The reference's three steps at microbatches 1 and 2, run once."""
    cfg, state, batches = setup
    jctx, _ = contexts("none")
    out = {}
    for mb in (1, 2):
        step = jax.jit(j_build(cfg, jctx, lr_fn=_lr_j, microbatches=mb))
        s, metrics = state, []
        for b in batches:
            s, m = step(s, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: np.asarray(v) for k, v in m.items()})
        out[mb] = (jax_to_numpy(s), metrics)
    return out


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_steps_match_reference(setup, reference, microbatches):
    cfg, state, batches = setup
    _, tctx = contexts("none")
    ts = params_from_numpy(jax_to_numpy(state))
    step = build_train_step(cfg, tctx, lr_fn=_lr_t,
                            microbatches=microbatches)
    jstate, jmetrics = reference[microbatches]
    for b, jm in zip(batches, jmetrics):
        ts, tm = step(ts, b)
        np.testing.assert_allclose(tm["lr"].numpy(), jm["lr"], rtol=1e-6)
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
        if microbatches == 1:
            assert {"nll", "tokens"} <= set(tm)
        else:
            assert set(tm) == {"loss", "accuracy", "grad_norm", "lr"}
    assert int(ts["step"]) == int(jstate["step"]) == STEPS
    assert int(ts["opt"]["count"]) == int(jstate["opt"]["count"]) == STEPS
    jp = flat(jstate["params"])
    for k, t in flat(ts["params"]).items():
        assert rel_l2(t.numpy(), jp[k]) <= 1e-4, k
    for moment in ("m", "v"):
        jm_ = flat(jstate["opt"][moment])
        for k, t in flat(ts["opt"][moment]).items():
            assert rel_l2(t.numpy(), jm_[k]) <= 1e-3, (moment, k)


def test_microbatched_gradients_average(setup):
    """compute_grads at microbatches 2 is the mean of the two halves'
    gradients (f32 sums, scaled by 1/2), and the state is untouched."""
    cfg, state, batches = setup
    _, tctx = contexts("none")
    ts = params_from_numpy(jax_to_numpy(state))
    before = {k: t.clone() for k, t in flat(ts["params"]).items()}
    one = build_train_step(cfg, tctx, lr_fn=_lr_t)
    two = build_train_step(cfg, tctx, lr_fn=_lr_t, microbatches=2)
    b = batches[0]
    g2, m2 = two.compute_grads(ts["params"], b)
    ga, ma = one.compute_grads(ts["params"], {k: v[:2] for k, v in b.items()})
    gb, mb = one.compute_grads(ts["params"], {k: v[2:] for k, v in b.items()})
    for k, t in flat(g2).items():
        want = (flat(ga)[k] + flat(gb)[k]) * 0.5
        assert torch.allclose(t, want, rtol=1e-6, atol=1e-9), k
    assert float(m2["loss"]) == pytest.approx(
        (float(ma["loss"]) + float(mb["loss"])) / 2, rel=1e-6)
    for k, t in flat(ts["params"]).items():
        assert torch.equal(t, before[k])


def test_refusals(setup):
    """Nothing here is refused any more: ``grad_specs`` pins gradients under
    a mesh only (without one, under the flag, the gradients are bitwise
    the unpinned step's), and int8 and use_lut (once refused) train: one
    microbatched gradient each, finite, with the int8 weights' gradients
    nonzero only where their columns' scales come from."""
    from repro_torch.dist import PerfFlags, flags, param_specs, set_flags
    cfg, state, batches = setup
    _, tctx = contexts("none")
    ts = params_from_numpy(jax_to_numpy(state))
    plain = build_train_step(cfg, tctx, lr_fn=_lr_t, microbatches=2)
    pinned = build_train_step(cfg, tctx, lr_fn=_lr_t, microbatches=2,
                              grad_specs=param_specs(
                                  ts["params"], {"data": 1, "model": 1}))
    old = flags()
    set_flags(PerfFlags(grad_specs=True))
    try:
        gp, _ = pinned.compute_grads(ts["params"], batches[0])
    finally:
        set_flags(old)
    g0, _ = plain.compute_grads(ts["params"], batches[0])
    for k, t in flat(gp).items():
        assert torch.equal(t, flat(g0)[k]), k
    import dataclasses
    _, t8 = contexts("int8")
    for ctx in (t8, dataclasses.replace(tctx, use_lut=True)):
        g, m = build_train_step(cfg, ctx, lr_fn=_lr_t, microbatches=2) \
            .compute_grads(ts["params"], batches[0])
        assert np.isfinite(float(m["loss"]))
        for k, t in flat(g).items():
            assert torch.isfinite(t).all(), k
    w = flat(build_train_step(cfg, t8, lr_fn=_lr_t).compute_grads(
        ts["params"], batches[0])[0])["/dense/mlp/up/w"]
    # per (layer, column) the arg-max-abs element of the column
    assert 0 < int((w != 0).sum()) <= w.shape[0] * w.shape[2] * 2
