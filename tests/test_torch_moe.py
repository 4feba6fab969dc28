"""``repro_torch.nn.moe.moe_apply`` against ``repro.nn.moe.moe_apply``
from the same weights (the reference's ``moe_init``, through numpy) and
the same inputs (numpy, seeded): outputs within 1e-5 of the largest
value (f32), the aux loss within 1e-6 (absolute and relative).

Cells: dropless (serving) and capacity-bound (training) dispatch, with
slots dropped to the dummy slot at a capacity below the load; top-k
renormalization on and off with ``routed_scale``; PTQ'd (QTensor) banks;
a planted router tie (identical router columns), which both packages
break toward the lower expert index; the table activation
(``use_lut``); and deepseek-like widths where a 16-token chunk at E 160,
k 6 drops under the dropless capacity too.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.quantize import ptq_params as j_ptq  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402

from torch_parity import contexts, int8_policies, jax_to_numpy  # noqa: E402

REL = 1e-5


def _dims(pkg, **kw):
    base = dict(d_model=32, d_ff=16, n_experts=8, top_k=2)
    base.update(kw)
    return pkg.MoEDims(**base)


def _weights(jd, seed=0, quant=False):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jd)
    qtype = None
    if quant:
        jpol, _, qtype = int8_policies()
        jp = j_ptq(jp, jpol)
    return jp, params_from_numpy(jax_to_numpy(jp), qtype=qtype)


def _x(b, s, d, seed=1):
    return np.random.RandomState(seed).randn(b, s, d).astype(np.float32)


def _slots(idx, e, cap):
    """(kept, dropped) slot counts of expert ids (B, S, k) at ``cap``."""
    b = idx.shape[0]
    flat = idx.reshape(b, -1)
    kept = dropped = 0
    for row in flat:
        seen = np.zeros(e, int)
        for i in row:
            if seen[i] < cap:
                kept += 1
            else:
                dropped += 1
            seen[i] += 1
    return kept, dropped


def _both(jd, td, jp, tp, x, mode="none", dropless=False, **ctx_kw):
    jctx, tctx = contexts(mode, **ctx_kw)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jd, jctx, dropless=dropless)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), td, tctx,
                              dropless=dropless)
    jy = np.asarray(jy)
    err = float(np.abs(ty.numpy() - jy).max())
    assert err <= REL * float(np.abs(jy).max()), err
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6,
                               atol=1e-6)
    return ty, taux


@pytest.mark.parametrize("dropless", [True, False],
                         ids=["dropless", "capacity"])
@pytest.mark.parametrize("s", [1, 5, 16])
def test_dispatch_matches(s, dropless):
    jd, td = _dims(jmoe), _dims(tmoe)
    jp, tp = _weights(jd)
    _both(jd, td, jp, tp, _x(2, s, 32), dropless=dropless)


def test_capacity_drops_slots_as_the_reference():
    """A capacity below the load: the routed ids show drops, and the
    output (the dropped slots' contributions zeroed) still matches."""
    jd = _dims(jmoe, capacity_factor=0.5)
    td = _dims(tmoe, capacity_factor=0.5)
    jp, tp = _weights(jd)
    x = _x(2, 16, 32, seed=3)
    _, idx, _ = tmoe.route(torch.from_numpy(x), tp["router"], td)
    kept, dropped = _slots(idx.numpy(), 8, td.capacity(16))
    assert dropped > 0 and kept > 0
    y, _ = _both(jd, td, jp, tp, x)
    y_free, _ = _both(jd, td, jp, tp, x, dropless=True)
    assert not torch.equal(y, y_free)


def test_deepseek_width_chunk_drops_under_dropless():
    """E 160, k 6: a 16-token chunk gets capacity min(16, max(6, 3)) = 6
    per expert, below what a skewed router sends one expert; the port
    drops exactly the reference's slots."""
    kw = dict(d_model=64, d_ff=8, n_experts=160, top_k=6)
    jd, td = _dims(jmoe, **kw), _dims(tmoe, **kw)
    jp, tp = _weights(jd, seed=2)
    # skew the router: every token prefers experts 0..9
    jp["router"] = jp["router"].at[:, :10].add(3.0)
    tp["router"] = torch.tensor(np.asarray(jp["router"]))
    x = _x(1, 16, 64, seed=4)
    _, idx, _ = tmoe.route(torch.from_numpy(x), tp["router"], td)
    _, dropped = _slots(idx.numpy(), 160, 6)
    assert dropped > 0
    _both(jd, td, jp, tp, x, dropless=True)


@pytest.mark.parametrize("renormalize,routed_scale",
                         [(True, 1.0), (False, 1.0), (True, 2.5),
                          (False, 0.5)])
def test_renormalize_and_routed_scale(renormalize, routed_scale):
    kw = dict(renormalize=renormalize, routed_scale=routed_scale)
    jd, td = _dims(jmoe, **kw), _dims(tmoe, **kw)
    jp, tp = _weights(jd, seed=5)
    _both(jd, td, jp, tp, _x(2, 7, 32, seed=6), dropless=True)


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_qtensor_banks(mode):
    """PTQ'd banks (int8 payload, per-(expert, column) scales) are
    dequantized in compute_dtype; the router stays float."""
    jd, td = _dims(jmoe), _dims(tmoe)
    jp, tp = _weights(jd, seed=7, quant=True)
    assert not hasattr(jp["router"], "qtype")
    assert tp["w_gate"].data.dtype == torch.int8
    _both(jd, td, jp, tp, _x(2, 6, 32, seed=8), mode=mode, dropless=True)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_planted_router_tie_breaks_to_lower_index(k):
    """Identical router columns give bit-equal probabilities: both
    packages take the lower expert ids first."""
    jd, td = _dims(jmoe, top_k=k), _dims(tmoe, top_k=k)
    jp, tp = _weights(jd, seed=9)
    col = jp["router"][:, 5]
    for j in (1, 3, 6):                   # experts 1, 3, 5, 6 tie
        jp["router"] = jp["router"].at[:, j].set(col)
    tp["router"] = torch.tensor(np.asarray(jp["router"]))
    x = _x(2, 4, 32, seed=10)
    probs = torch.softmax(torch.einsum("bsd,de->bse", torch.from_numpy(x),
                                       tp["router"]), -1)
    assert torch.equal(probs[..., 1], probs[..., 6])
    _, idx, _ = tmoe.route(torch.from_numpy(x), tp["router"], td)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.einsum(
        "bsd,de->bse", jnp.asarray(x), jp["router"]), axis=-1), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _both(jd, td, jp, tp, x, dropless=True)


def test_all_equal_router_picks_the_first_experts():
    jd, td = _dims(jmoe, top_k=3), _dims(tmoe, top_k=3)
    jp, tp = _weights(jd, seed=11)
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    x = _x(1, 3, 32, seed=12)
    _, idx, aux = tmoe.route(torch.from_numpy(x), tp["router"], td)
    assert idx.tolist() == [[[0, 1, 2]] * 3]
    y, _ = _both(jd, td, jp, tp, x, dropless=True)
    assert float(aux) == pytest.approx(8 * 3 * (1 / 8) * 1.0)


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_use_lut_activation(mode):
    """The experts' SiLU through the table (``act_fn`` under use_lut):
    the port's ``lut_activation`` plain version against the reference's
    table, and the table is in effect."""
    jd, td = _dims(jmoe), _dims(tmoe)
    jp, tp = _weights(jd, seed=13, quant=mode == "int8")
    x = _x(2, 5, 32, seed=14)
    y_lut, _ = _both(jd, td, jp, tp, x, mode=mode, dropless=True,
                     use_lut=True)
    _, tctx = contexts(mode)
    y_exact, _ = tmoe.moe_apply(tp, torch.from_numpy(x), td, tctx,
                                dropless=True)
    assert not torch.equal(y_lut, y_exact)


def test_aux_is_the_switch_loss():
    """aux = E * sum(mean probs * mean top-k counts), >= 1 at balance
    (the reference's lower bound), on both packages."""
    jd, td = _dims(jmoe), _dims(tmoe)
    jp, tp = _weights(jd, seed=15)
    x = _x(4, 8, 32, seed=16)
    _, aux = _both(jd, td, jp, tp, x, dropless=True)
    gates, idx, aux2 = tmoe.route(torch.from_numpy(x), tp["router"], td)
    assert float(aux) == float(aux2) and float(aux) >= 1.0
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_bf16_compute_matches():
    """bf16 compute: the banks and the slot buffer in bf16, the router in
    f32 on both sides."""
    jd, td = _dims(jmoe), _dims(tmoe)
    jp, tp = _weights(jd, seed=17)
    x = _x(2, 5, 32, seed=18)
    jctx, tctx = contexts("none")
    jctx = dataclasses.replace(jctx, compute_dtype=jnp.bfloat16)
    tctx = dataclasses.replace(tctx, compute_dtype=torch.bfloat16)
    jy, _ = jmoe.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), jd, jctx,
                           dropless=True)
    ty, _ = tmoe.moe_apply(tp, torch.from_numpy(x).to(torch.bfloat16), td,
                           tctx, dropless=True)
    jy = np.asarray(jy.astype(jnp.float32))
    # bf16 products of another summation order: a few bf16 ulps
    np.testing.assert_allclose(ty.float().numpy(), jy, rtol=0,
                               atol=4 * 2.0 ** -8 * float(np.abs(jy).max()))
