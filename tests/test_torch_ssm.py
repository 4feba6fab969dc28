"""``repro_torch.nn.ssm`` (the Mamba-2 SSD block) against
``repro.nn.ssm`` from the same weights (the reference's ``mamba2_init``,
with ``A_log``, ``D``, ``dt_bias``, the conv bias and the norm scale
drawn with numpy so that none is trivial) and the same inputs (numpy,
seeded), at the smoke config's dims (d_model 128, d_state 16, head_dim
32, chunk 16).

Tolerances: relative L2 error <= 1e-5 in f32 (the port writes the
reference's three-operand einsums as pairwise products and its
associative scan as a loop over chunks, so the f32 sums run in another
order); <= 1e-3 under int8 PTQ weights (a norm's last-bit difference can
move one activation code).

Cells: the whole-sequence SSD at S 8 (one chunk of q = S), 16 and 48
(three chunks), with and without an ``initial_state``; int8 and the LUT
activations; the decode step, which writes the state in place; S 40
(not a multiple of the chunk) refused on both sides.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.quantize import ptq_params as j_ptq  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402

from torch_parity import contexts, int8_policies, jax_to_numpy  # noqa: E402

F32_REL_L2 = 1e-5
INT8_REL_L2 = 1e-3
B = 2
DIMS = dict(d_model=128, d_state=16, head_dim=32, expand=2, n_groups=1,
            d_conv=4, chunk=16)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check(got, want, mode, what):
    tol = INT8_REL_L2 if mode == "int8" else F32_REL_L2
    err = _rel_l2(got, want)
    assert err <= tol, f"{what}: relative L2 err {err}"


def _weights(mode, seed=0):
    """(JAX params, port params) with every vector leaf made non-trivial."""
    jd = jssm.SSMDims(**DIMS)
    jp = jssm.mamba2_init(jax.random.PRNGKey(seed), jd)
    rs = np.random.RandomState(seed + 7)
    ph = jd.n_heads
    jp = dict(jp, A_log=jnp.asarray(rs.uniform(-1, 1, ph), jnp.float32),
              D=jnp.asarray(rs.uniform(0.5, 1.5, ph), jnp.float32),
              dt_bias=jnp.asarray(rs.uniform(-2, 0, ph), jnp.float32),
              conv_b=jnp.asarray(rs.randn(jd.conv_dim) * 0.1, jnp.float32),
              norm={"scale": jnp.asarray(rs.uniform(0.5, 1.5, jd.d_inner),
                                         jnp.float32)})
    qtype = None
    if mode == "int8":
        jpol, _, qtype = int8_policies()
        jp = j_ptq(jp, jpol)
    return jp, params_from_numpy(jax_to_numpy(jp), qtype=qtype)


def _ctxs(mode, lut=False):
    return contexts("int8" if mode == "int8" else "none", use_lut=lut)


@functools.lru_cache(maxsize=None)
def _j_apply(mode, lut):
    """The reference's SSD, jitted (one compile per shape)."""
    jctx = _ctxs(mode, lut)[0]
    return jax.jit(lambda p, x, st: jssm.mamba2_apply(
        p, x, jssm.SSMDims(**DIMS), jctx, initial_state=st))


@functools.lru_cache(maxsize=None)
def _j_decode(mode, lut):
    jctx = _ctxs(mode, lut)[0]
    return jax.jit(lambda p, x, st: jssm.mamba2_decode_step(
        p, x, st, jssm.SSMDims(**DIMS), jctx))


def _x(s, seed=1):
    return np.random.RandomState(seed).randn(B, s, DIMS["d_model"]) \
        .astype(np.float32)


def _state(seed=2):
    rs = np.random.RandomState(seed)
    d = tssm.SSMDims(**DIMS)
    return {"conv": rs.randn(B, d.d_conv - 1, d.conv_dim).astype(np.float32),
            "ssm": (rs.randn(B, d.n_heads, d.d_state, d.head_dim) * 0.5)
            .astype(np.float32)}


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("s", [8, 16, 48])
def test_apply_matches(s, seeded):
    """y and the final state (conv window, SSM state) of the chunked SSD,
    one chunk of q = S (S 8), one full chunk, three chunks."""
    jp, tp = _weights("none")
    _, tctx = _ctxs("none")
    x = _x(s)
    init = _state()["ssm"] if seeded else None
    jy, jst = _j_apply("none", False)(
        jp, jnp.asarray(x), None if init is None else jnp.asarray(init))
    ty, tst = tssm.mamba2_apply(
        tp, torch.from_numpy(x), tssm.SSMDims(**DIMS), tctx,
        initial_state=None if init is None else torch.from_numpy(init))
    _check(ty.numpy(), jy, "none", f"y S {s}")
    _check(tst["ssm"].numpy(), jst["ssm"], "none", f"ssm state S {s}")
    _check(tst["conv"].numpy(), jst["conv"], "none", f"conv window S {s}")


@pytest.mark.parametrize("mode,lut", [("int8", False), ("none", True),
                                      ("int8", True)])
def test_apply_under_int8_and_lut(mode, lut):
    """Two chunks under int8 PTQ weights (``in_proj``/``out_proj`` through
    the int8 product) and the LUT softplus / silu."""
    jp, tp = _weights(mode)
    _, tctx = _ctxs(mode, lut)
    x = _x(32)
    init = _state()["ssm"]
    jy, jst = _j_apply(mode, lut)(jp, jnp.asarray(x), jnp.asarray(init))
    ty, tst = tssm.mamba2_apply(tp, torch.from_numpy(x),
                                tssm.SSMDims(**DIMS), tctx,
                                initial_state=torch.from_numpy(init))
    _check(ty.numpy(), jy, mode, f"y {mode} lut={lut}")
    _check(tst["ssm"].numpy(), jst["ssm"], mode, f"state {mode} lut={lut}")


@pytest.mark.parametrize("mode,lut", [("none", False), ("int8", False),
                                      ("none", True)])
def test_decode_step_matches_in_place(mode, lut):
    """Three decode steps from a random state: y and the state the
    reference returns, which the port writes into the same tensors."""
    jp, tp = _weights(mode)
    _, tctx = _ctxs(mode, lut)
    st = _state()
    jstate = {k: jnp.asarray(v) for k, v in st.items()}
    tstate = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    ptrs = {k: v.data_ptr() for k, v in tstate.items()}
    x = _x(3, seed=4)
    for t in range(3):
        jy, jstate = _j_decode(mode, lut)(jp, jnp.asarray(x[:, t:t + 1]),
                                          jstate)
        ty = tssm.mamba2_decode_step(tp, torch.from_numpy(x[:, t:t + 1]),
                                     tstate, tssm.SSMDims(**DIMS), tctx)
        _check(ty.numpy(), jy, mode, f"decode y step {t}")
        _check(tstate["ssm"].numpy(), jstate["ssm"], mode,
               f"decode state step {t}")
        _check(tstate["conv"].numpy(), jstate["conv"], mode,
               f"decode conv window step {t}")
    assert {k: v.data_ptr() for k, v in tstate.items()} == ptrs


def test_prefill_state_seeds_decode():
    """The SSD's final state (conv window and SSM state) seeds decode:
    apply(S 8), then decode steps at positions 8..11, equals positions
    8..11 of apply(S 12) (q = S, one chunk each)."""
    _, tp = _weights("none")
    _, tctx = _ctxs("none")
    d = tssm.SSMDims(**DIMS)
    x = torch.from_numpy(_x(12, seed=5))
    full, _ = tssm.mamba2_apply(tp, x, d, tctx)
    _, st = tssm.mamba2_apply(tp, x[:, :8], d, tctx)
    ys = [tssm.mamba2_decode_step(tp, x[:, t:t + 1], st, d, tctx)
          for t in range(8, 12)]
    _check(torch.cat(ys, dim=1).numpy(), full[:, 8:].numpy(), "none",
           "prefill + decode vs whole")


def test_unaligned_length_refused_on_both_sides():
    """S 40 is not a multiple of the chunk (16): both assert."""
    jp, tp = _weights("none")
    jctx, tctx = _ctxs("none")
    x = _x(40)
    with pytest.raises(AssertionError):
        jssm.mamba2_apply(jp, jnp.asarray(x), jssm.SSMDims(**DIMS), jctx)
    with pytest.raises(AssertionError):
        tssm.mamba2_apply(tp, torch.from_numpy(x), tssm.SSMDims(**DIMS),
                          tctx)


def test_dims_and_init_match_the_reference():
    """SSMDims' derived widths, and the init's leaves: shapes, dtypes
    (``A_log``, ``D``, ``dt_bias`` f32 under a bf16 init)."""
    for dims in (DIMS, dict(d_model=1024, d_state=128, head_dim=64),
                 dict(d_model=2048, d_state=64, head_dim=64)):
        jd, td = jssm.SSMDims(**dims), tssm.SSMDims(**dims)
        assert (jd.d_inner, jd.n_heads, jd.conv_dim) \
            == (td.d_inner, td.n_heads, td.conv_dim)
    jp = jax_to_numpy(jssm.mamba2_init(jax.random.PRNGKey(0),
                                       jssm.SSMDims(**DIMS)))
    tp = tssm.mamba2_init(torch.Generator().manual_seed(0),
                          tssm.SSMDims(**DIMS), dtype=torch.bfloat16)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}
    assert shapes(tp) == shapes(jp)
    for k in ("A_log", "D", "dt_bias"):
        assert tp[k].dtype == torch.float32
    assert tp["in_proj"]["w"].dtype == torch.bfloat16
