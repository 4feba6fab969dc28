"""Training under ``--quant int8``, ``--lut`` and both: port vs ``repro``'s
unsharded jitted step.

gemma-2b smoke, f32 compute, from the reference's ``init_state``
converted through numpy: three steps of ``build_train_step`` (cosine
warmup, peak 1e-3, warmup 1, total 4) on ``make_batch(cfg, i, 4, 32)``
under ``int8`` (the serve CLI's ``FixedPointType(8, 4)`` policy: every
weight quantized per column each call, the activations per row), under
``use_lut``, and under both, against the reference's ``build_train_step``
under ``jax.jit`` without a mesh -- the gates of
``test_torch_train_step.py``: lr, loss, accuracy and grad_norm within
rtol 1e-5, each parameter leaf within relative L2 1e-4, the moments
within 1e-3.  Under ``int8`` each step starts from the reference's
state (params, moments, count) before it: a weight is quantized per call,
and a code flips where ``w / sw`` lies within an ulp of a half-integer,
so two steps whose gradients differ in their last bits (f32 sums in
another order) meet different int8 weights from the second step on and
drift apart (measured: loss 2e-4 apart at step 2 with 4 of 65536 codes of
``mlp/down`` flipped); ``use_lut`` alone runs the three steps free.  The
int8 modes then also run the three steps free, where the drift is held
to a bound: every step's loss within rtol ``FREE_RTOL`` (1e-3) of the
reference's, the parameters after them within relative L2 ``FREE_RTOL``
(measured: loss 2.1e-4 / 1.2e-4 apart at step 2, parameters 6.5e-5 /
1.5e-4, under int8 / int8 with ``use_lut``; the moments of a column whose
code flipped move by up to 14% and are not held there).
Under ``int8`` with ``use_lut`` the same holds inside one step: the two
models' attention and norm sums differ in their last bits (as in every
f32 parity suite), and through the MLP's tables that moves one int8
activation code of the second layer (measured: 2-layer logits 0.027
apart, 4.8e-6 under ``int8`` alone); step 0's grad_norm then reads
1.13e-5 apart, so that one metric is held within rtol 1e-4 there, every
other gate as above.

The reference's cache-free attention has two branches: on a TPU
(``src/repro/nn/attention.py:441-445``) ``flash_attention_pallas``, whose
softmax is exact; elsewhere ``_einsum_attention``, whose softmax is the
table one under ``use_lut``.  The port follows the TPU branch (its flash
kernel, exact).  So the reference's steps here run with
``repro.nn.attention.softmax`` monkeypatched to the reference's own
softmax under ``use_lut=False``: that models the TPU branch, as
``force_paged_kernel`` models the paged kernel for the paged suites, and
edits nothing in ``src/repro``.  Likewise its ``ref`` qmatmul is the
Pallas kernel's arithmetic in plain jnp (``train_parity.
jax_qmatmul_kernel_form``: the epilogue's table indexed as
``qmatmul_pallas`` indexes it, which the port's kernels follow; the
``ref`` lowering's ``table_lookup`` rounds the interp sum twice).  The
float MLP's tables are the reference's own ``act_fn``.
"""

import dataclasses

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
from train_parity import flat, reference_tpu_branches, rel_l2  # noqa: E402

STEPS = 3
FREE_RTOL = 1e-3
MODES = [("int8", False), ("none", True), ("int8", True)]


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


def _ctxs(mode, lut):
    jctx, tctx = contexts(mode)
    return (dataclasses.replace(jctx, use_lut=lut),
            dataclasses.replace(tctx, use_lut=lut))


@pytest.fixture(scope="module")
def reference(setup):
    """The reference's three steps in each mode, run once."""
    cfg, state, batches = setup
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        reference_tpu_branches(mp)
        for mode, lut in MODES:
            jctx, _ = _ctxs(mode, lut)
            step = jax.jit(j_build(cfg, jctx, lr_fn=_lr_j))
            s, states, metrics = state, [jax_to_numpy(state)], []
            for b in batches:
                s, m = step(s, {k: jnp.asarray(v) for k, v in b.items()})
                states.append(jax_to_numpy(s))
                metrics.append({k: np.asarray(v) for k, v in m.items()})
            out[mode, lut] = (states, metrics)
    return out


@pytest.mark.parametrize("mode,lut", MODES,
                         ids=["int8", "lut", "int8-lut"])
def test_three_steps_match_reference(setup, reference, mode, lut):
    cfg, state, batches = setup
    _, tctx = _ctxs(mode, lut)
    step = build_train_step(cfg, tctx, lr_fn=_lr_t)
    jstates, jmetrics = reference[mode, lut]
    ts = params_from_numpy(jstates[0])
    for i, (b, jm) in enumerate(zip(batches, jmetrics)):
        if mode == "int8":
            ts = params_from_numpy(jstates[i])
        ts, tm = step(ts, b)
        np.testing.assert_allclose(tm["lr"].numpy(), jm["lr"], rtol=1e-6)
        for key in ("loss", "accuracy", "grad_norm"):
            rtol = 1e-4 if key == "grad_norm" and mode == "int8" and lut \
                else 1e-5
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=rtol, err_msg=key)
    jstate = jstates[-1]
    assert int(ts["step"]) == int(jstate["step"]) == STEPS
    jp = flat(jstate["params"])
    for k, t in flat(ts["params"]).items():
        assert rel_l2(t.numpy(), jp[k]) <= 1e-4, k
    for moment in ("m", "v"):
        jm_ = flat(jstate["opt"][moment])
        for k, t in flat(ts["opt"][moment]).items():
            assert rel_l2(t.numpy(), jm_[k]) <= 1e-3, (moment, k)
    if mode == "int8":                  # free-running: the drift's bound
        fs = params_from_numpy(jstates[0])
        for i, (b, jm) in enumerate(zip(batches, jmetrics)):
            fs, fm = step(fs, b)
            np.testing.assert_allclose(float(fm["loss"]), float(jm["loss"]),
                                       rtol=FREE_RTOL, err_msg=f"step {i}")
        for k, t in flat(fs["params"]).items():
            assert rel_l2(t.numpy(), jp[k]) <= FREE_RTOL, k
