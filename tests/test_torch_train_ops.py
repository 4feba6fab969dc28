"""Training's ops: port vs ``repro``, from the same numpy inputs.

* ``MiniFloatType`` / ``FixedPointType`` quantize bitwise the reference's
  over grids that hold subnormals of the format, the max finite value,
  values past it, inf and NaN, signed zeros and every tie between two
  neighbouring codes; ``fake_quant``'s straight-through gradient equal to
  ``jax.grad`` of the reference (exactly: a 0/1 mask times g).  Formats
  whose quanta reach f32 subnormals (an 8-bit exponent) are left out:
  the reference's XLA CPU flushes subnormals to zero (ROADMAP.md
  section 3).
* ``magnitude_mask`` / ``nm_mask`` identical, ties included (integer-valued
  weights make many).
* ``adamw_update`` and ``cosine_warmup`` against the reference over three
  steps, f32 and bf16 moments: lr bitwise; params within rtol 1e-6 /
  atol 1e-7, f32 moments within rtol 1e-5 / atol 1e-8 (XLA sums the
  global norm in another order, so the clip scale differs in its last
  bits, and a moment that is a difference of two near terms shows it);
  bf16 moments within one bf16 ulp, 2^-8 relative.
* gradients of the port's attention (``ops.attention`` on the CPU, the
  flash kernel's plain version under autograd) against ``jax.grad`` of the
  reference's ``_einsum_attention`` in f32: causal and not, GQA, ragged,
  D 192 with V zero-padded from 128 (MLA's naive form), relative L2
  <= 1e-5 (the two softmaxes sum in another order).
* the flash backward's plain version against autograd of the plain
  forward (relative L2 <= 1e-5; a row that sees no key has gradient 0),
  and the CUDA route's ``torch.autograd.Function`` wired on the CPU with
  the plain versions in the kernels' places: the same gradients, the
  forward asked for its log-sum-exp, the backward called once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import prune as jprune  # noqa: E402
from repro.core import qtypes as jq  # noqa: E402
from repro.core.quantize import fake_quant as j_fake_quant  # noqa: E402
from repro.nn.attention import _einsum_attention  # noqa: E402
from repro.nn.context import QuantContext as JCtx  # noqa: E402
from repro.optim import OptConfig as JOpt  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro.optim import cosine_warmup as j_cosine  # noqa: E402
from repro_torch.core import prune as tprune  # noqa: E402
from repro_torch.core import qtypes as tq  # noqa: E402
from repro_torch.core.quantize import fake_quant  # noqa: E402
from repro_torch.kernels import _cuda, ops  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.optim import OptConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.optim import cosine_warmup  # noqa: E402


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


# -- quantizers --------------------------------------------------------------
MINIFLOATS = [(4, 3, False), (5, 2, True), (3, 4, True), (3, 2, True),
              (2, 1, True), (6, 5, False), (7, 9, True)]
FIXED = [(16, 6, True, "rnd_even", "sat"), (18, 8, True, "rnd_even", "sat"),
         (8, 3, True, "rnd", "sat"), (8, 3, True, "trn", "wrap"),
         (6, 2, False, "rnd_even", "sat"), (10, 4, True, "rnd", "wrap")]


def _mini_grid(t: jq.MiniFloatType, seed: int) -> np.ndarray:
    rs = np.random.RandomState(seed)
    m = t.max_value
    codes = np.unique(t.np_quantize(np.linspace(-m, m, 20001)
                                    .astype(np.float32)))
    ties = (codes[1:].astype(np.float64) + codes[:-1]) / 2
    sub = t.min_subnormal * np.arange(0, 2 ** t.man_bits + 2)
    xs = np.concatenate([
        codes, ties, sub, -sub, sub + t.min_subnormal / 2,
        [0.0, -0.0, np.inf, -np.inf, np.nan, m, -m, m * 1.0001, m * 4,
         -m * 4, t.min_subnormal / 2, t.min_subnormal / 4, 3e38, 1e-30],
        rs.randn(3000) * m / 3,
        np.exp(rs.uniform(np.log(t.min_subnormal) - 3, np.log(m) + 1, 3000))
        * rs.choice([-1.0, 1.0], 3000)])
    return xs.astype(np.float32)


def _bits(a) -> np.ndarray:
    """f32 bits, every NaN as one pattern (payloads are not compared)."""
    a = np.asarray(a, np.float32).copy()
    nan = np.isnan(a)
    a[nan] = np.nan
    return a.view(np.uint32)


@pytest.mark.parametrize("fmt", MINIFLOATS, ids=lambda f: "e%dm%d%s" % (
    f[0], f[1], "" if f[2] else "x"))
def test_minifloat_quantize_bitwise(fmt):
    e, m, inf = fmt
    jt, tt = jq.MiniFloatType(e, m, ieee_inf=inf), tq.MiniFloatType(
        e, m, ieee_inf=inf)
    assert (tt.max_value, tt.min_subnormal, tt.width, tt.short_name()) == (
        jt.max_value, jt.min_subnormal, jt.width, jt.short_name())
    x = _mini_grid(jt, seed=e * 10 + m)
    want = np.asarray(jax.jit(jt.quantize)(jnp.asarray(x)))
    got = tt.quantize(torch.from_numpy(x)).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(tt.np_quantize(x), jt.np_quantize(x), equal_nan=True)


def test_canonical_instances():
    assert tq.E4M3 == tq.MiniFloatType(4, 3, ieee_inf=False)
    assert tq.E4M3.max_value == 448.0 and tq.E5M2.max_value == 57344.0
    assert (tq.AC_FIXED_8_3.width, tq.AC_FIXED_8_3.int_bits) == (8, 3)


@pytest.mark.parametrize("fmt", FIXED, ids=lambda f: "%d_%d_%s_%s_%s" % f)
def test_fixed_point_quantize_bitwise(fmt):
    jt, tt = jq.FixedPointType(*fmt), tq.FixedPointType(*fmt)
    assert (tt.min_value, tt.max_value, tt.frac_bits) == (
        jt.min_value, jt.max_value, jt.frac_bits)
    rs = np.random.RandomState(fmt[0])
    x = np.concatenate([rs.randn(4000) * jt.max_value * 1.5,
                        np.arange(-4 * 2 ** fmt[0], 4 * 2 ** fmt[0])
                        * jt.lsb / 2]).astype(np.float32)
    want = np.asarray(jax.jit(jt.quantize)(jnp.asarray(x)))
    got = tt.quantize(torch.from_numpy(x)).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(np.asarray(jt.to_int(jnp.asarray(x))),
                          tt.to_int(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("qt", ["AC_FIXED_16_6", "AC_FIXED_8_3", "E4M3",
                                "E5M2"])
def test_fake_quant_value_and_ste(qt):
    """Forward bitwise the round trip; the gradient of sum(g * fq(x)) is
    ``g`` inside [lo, hi] and 0 outside, exactly the reference's."""
    jt, tt = getattr(jq, qt), getattr(tq, qt)
    rs = np.random.RandomState(3)
    x = (rs.randn(4096) * jt.max_value * 0.8).astype(np.float32)
    x[:4] = [jt.max_value, -jt.max_value, jt.max_value * 1.01, 0.0]
    g = rs.randn(4096).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda a: jnp.sum(j_fake_quant(a, jt) * g))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = fake_quant(tx, tt)
    (tv,) = torch.autograd.grad(torch.sum(y * torch.from_numpy(g)), tx)
    want = np.asarray(jax.jit(lambda a: j_fake_quant(a, jt))(jnp.asarray(x)))
    assert np.array_equal(_bits(y.detach().numpy()), _bits(want))
    assert np.array_equal(tv.numpy(), np.asarray(jg))
    assert (tv.numpy() == 0).any() and (tv.numpy() == g).any()


# -- pruning -------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(16, 6), (8, 3, 4)])
def test_prune_masks_identical_with_ties(shape):
    rs = np.random.RandomState(sum(shape))
    w = np.round(rs.randn(*shape) * 2).astype(np.float32)   # many ties
    tw = torch.from_numpy(w)
    for sp in (0.1, 0.5, 0.9):
        assert np.array_equal(np.asarray(jprune.magnitude_mask(
            jnp.asarray(w), sp)), tprune.magnitude_mask(tw, sp).numpy())
    for n, m in ((2, 4), (1, 4), (3, 8)):
        if shape[0] % m == 0:
            assert np.array_equal(np.asarray(jprune.nm_mask(
                jnp.asarray(w), n, m)), tprune.nm_mask(tw, n, m).numpy())
    params = {"a": {"w": w, "b": w[0]}, "c": w * 0}
    jm = jprune.make_masks(jax.tree_util.tree_map(jnp.asarray, params),
                           structured=(2, 4))
    tm = tprune.make_masks(jax.tree_util.tree_map(torch.from_numpy, params),
                           structured=(2, 4))
    assert tm["a"]["b"] is None and jm["a"]["b"] is None
    assert np.array_equal(np.asarray(jm["a"]["w"]), tm["a"]["w"].numpy())
    masked = tprune.apply_masks(
        jax.tree_util.tree_map(torch.from_numpy, params), tm)
    jmasked = jprune.apply_masks(jax.tree_util.tree_map(jnp.asarray, params),
                                 jm)
    assert np.array_equal(masked["a"]["w"].numpy(),
                          np.asarray(jmasked["a"]["w"]))
    assert tprune.sparsity(masked) == pytest.approx(jprune.sparsity(jmasked))


# -- optimizer -----------------------------------------------------------------
@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_adamw_and_schedule(moments):
    rs = np.random.RandomState(0)
    shapes = {"blk": {"w": (3, 4, 5), "b": (5,)}, "emb": (6, 7), "s": ()}

    def tree(scale, seed):
        r = np.random.RandomState(seed)
        return jax.tree_util.tree_map(
            lambda s: np.asarray(r.randn(*s) * scale, np.float32), shapes,
            is_leaf=lambda s: isinstance(s, tuple))
    p0 = tree(1.0, 1)
    bf = moments == "bf16"
    jcfg = JOpt(m_dtype=jnp.bfloat16 if bf else None,
                v_dtype=jnp.bfloat16 if bf else None)
    tcfg = OptConfig(m_dtype=torch.bfloat16 if bf else None,
                     v_dtype=torch.bfloat16 if bf else None)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = j_adamw_init(jp, jcfg)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), p0)
    ts = adamw_init(tp, tcfg)
    for step in range(3):
        g = tree(3.0 * (step + 1), 10 + step)   # the clip engages
        jlr = j_cosine(jnp.int32(step), peak=1e-2, warmup=1, total=4)
        tlr = cosine_warmup(torch.tensor(step, dtype=torch.int32), peak=1e-2,
                            warmup=1, total=4)
        assert np.float32(jlr) == tlr.numpy()
        jp, js, jm = j_adamw_update(jax.tree_util.tree_map(jnp.asarray, g),
                                    js, jp, jlr, jcfg)
        tp, ts, tm = adamw_update(jax.tree_util.tree_map(torch.from_numpy, g),
                                  ts, tp, tlr, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts["count"]) == int(js["count"]) == 3
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    for key in ("m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(js[key]),
                        jax.tree_util.tree_leaves(ts[key])):
            tol = dict(rtol=2.0 ** -8, atol=1e-7) if bf else dict(
                rtol=1e-5, atol=1e-8)
            assert b.dtype == (torch.bfloat16 if bf else torch.float32)
            np.testing.assert_allclose(b.float().numpy(),
                                       np.asarray(a, np.float32), **tol)
    for s in (0, 1, 2, 5, 7, 8, 12):
        assert np.float32(j_cosine(jnp.int32(s), peak=3e-4, warmup=2,
                                   total=9)) == cosine_warmup(
            s, peak=3e-4, warmup=2, total=9).numpy()


# -- attention gradients -------------------------------------------------------
ATTN_CASES = [  # (B, Hq, Hkv, Sq, Skv, D, causal, V's width)
    (2, 4, 4, 16, 16, 32, True, None),
    (2, 4, 4, 16, 16, 32, False, None),
    (1, 8, 2, 12, 12, 16, True, None),
    (2, 4, 1, 7, 19, 16, True, None),
    (1, 4, 2, 19, 7, 16, False, None),
    (1, 4, 4, 10, 10, 192, True, 128),
]


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=lambda c: "%dx%d/%d_%dx%d_d%d_%s_v%s" % c)
def test_attention_gradients_vs_reference(case):
    b, hq, hkv, sq, skv, d, causal, dv = case
    rs = np.random.RandomState(sum(case[:6]))
    q = rs.randn(b, hq, sq, d).astype(np.float32)
    k = rs.randn(b, hkv, skv, d).astype(np.float32)
    v = rs.randn(b, hkv, skv, dv or d).astype(np.float32)
    do = rs.randn(b, hq, sq, dv or d).astype(np.float32)
    jctx = JCtx(compute_dtype=jnp.float32)

    def jf(q, k, v):
        return jnp.sum(_einsum_attention(q, k, v, causal=causal,
                                         ctx=jctx) * do)
    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v))
    tq_, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                   for a in (q, k, v))
    vv = tv if dv is None else torch.nn.functional.pad(tv, (0, d - dv))
    y = ops.attention(tq_, tk, vv, causal=causal)[..., :dv or d]
    tg = torch.autograd.grad(torch.sum(y * torch.from_numpy(do)),
                             (tq_, tk, tv))
    for a, b_ in zip(tg, jg):
        assert _rel(a.numpy(), b_) <= 1e-5


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_and_autograd_function(causal, monkeypatch):
    """The backward's plain version against autograd of the plain forward
    (a ragged shape with rows that see no key when causal), then the CUDA
    route's autograd function with the plain versions in the kernels'
    places: the same gradients, one forward (with lse) and one backward
    per call, and no launch counted."""
    rs = np.random.RandomState(7)
    b, hq, hkv, sq, skv, d = 2, 4, 2, 13, 9, 16
    q, k, v = (torch.from_numpy(rs.randn(*s).astype(np.float32))
               .requires_grad_(True) for s in ((b, hq, sq, d),
                                                (b, hkv, skv, d),
                                                (b, hkv, skv, d)))
    do = torch.from_numpy(rs.randn(b, hq, sq, d).astype(np.float32))
    o = tref.flash_attention_plain(q, k, v, causal=causal)
    want = torch.autograd.grad(o, (q, k, v), do)
    lse = tref.flash_attention_lse_plain(q.detach(), k.detach(),
                                         causal=causal)
    assert torch.isinf(lse).any() == causal        # Sq > Skv: empty rows
    got = tref.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                         o.detach(), lse, do, causal=causal)
    for a, w in zip(got, want):
        assert torch.isfinite(a).all() and _rel(a, w) <= 1e-5

    calls = []

    def fwd(q, k, v, *, causal=True, softmax_scale=None, with_lse=False):
        calls.append(with_lse)
        return (tref.flash_attention_plain(q, k, v, causal=causal),
                tref.flash_attention_lse_plain(q, k, causal=causal)
                if with_lse else None)
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                   o.detach(), lse, do, causal=causal)

    def bwd(*a, **kw):
        calls.append("bwd")
        return tref.flash_attention_bwd_plain(*a, **kw)
    monkeypatch.setattr(tflash, "flash_attention_fwd", fwd)
    monkeypatch.setattr(tflash, "flash_attention_bwd", bwd)
    before = _cuda.launch_counts()
    y = tflash._FlashAttention.apply(q, k, v, causal, None)
    fn = torch.autograd.grad(y, (q, k, v), do)
    assert calls == [True, "bwd"]
    assert _cuda.launch_counts() == before      # CPU: no kernel counted
    for a, w in zip(fn, want):
        assert _rel(a, w) <= 1e-5


# -- the jet MLP's loss gradients and the PTQ round trip -----------------------
@pytest.mark.parametrize("qt", [None, "AC_FIXED_8_3", "E4M3"])
def test_jet_mlp_loss_gradients(qt):
    """``models.mlp.loss`` is differentiable: its gradients against
    ``jax.grad`` of the reference's from the same weights, f32, and under
    ``mode="fake"`` with the weights fake-quantized (relative L2 <= 1e-5:
    f32 sums in another order)."""
    from repro.core.precision import PrecisionPolicy as JPolicy
    from repro.models import mlp as jmlp
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.models import mlp
    from repro_torch.nn.context import QuantContext
    from torch_parity import jax_to_numpy
    jp = jmlp.init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    x = rs.randn(64, 16).astype(np.float32)
    y = rs.randint(0, 5, 64).astype(np.int32)
    if qt is None:
        jctx, tctx = (JCtx(compute_dtype=jnp.float32),
                      QuantContext(compute_dtype=torch.float32))
    else:
        jctx = JCtx(mode="fake", policy=JPolicy.uniform(getattr(jq, qt)),
                    compute_dtype=jnp.float32)
        tctx = QuantContext(mode="fake",
                            policy=PrecisionPolicy.uniform(getattr(tq, qt)),
                            compute_dtype=torch.float32)
    (jl, _), jg = jax.value_and_grad(jmlp.loss, has_aux=True)(
        jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jctx)
    tp = params_from_numpy(jax_to_numpy(jp))
    names = [(k, n) for k, v in tp.items() for n in v]
    leaves = [tp[k][n].requires_grad_(True) for k, n in names]
    tl, _ = mlp.loss(tp, {"x": torch.from_numpy(x),
                          "y": torch.from_numpy(y.astype(np.int64))}, tctx)
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    for (k, n), g in zip(names, grads):
        assert _rel(g.numpy(), np.asarray(jg[k][n])) <= 1e-5, (k, n)


def test_ptq_minifloat_and_dequantize_params():
    """``ptq_params`` under a minifloat policy quantizes the matmul weights
    in place of a QTensor (bitwise the reference's); ``dequantize_params``
    of an int8 PTQ tree is the reference's, bitwise."""
    from repro.core.quantize import dequantize_params as j_deq
    from repro.core.quantize import ptq_params as j_ptq
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.quantize import dequantize_params, ptq_params
    from torch_parity import jax_to_numpy
    rs = np.random.RandomState(4)
    tree = {"fc0": {"w": rs.randn(16, 8).astype(np.float32),
                    "b": rs.randn(8).astype(np.float32)},
            "embed": {"table": rs.randn(10, 8).astype(np.float32)}}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = params_from_numpy(tree)
    got = ptq_params(tt, tq.E4M3)
    want = j_ptq(jt, jq.E4M3)
    assert np.array_equal(_bits(got["fc0"]["w"].numpy()),
                          _bits(want["fc0"]["w"]))
    assert got["embed"]["table"] is tt["embed"]["table"]
    q8t, q8j = tq.FixedPointType(8, 4), jq.FixedPointType(8, 4)
    jd = j_deq(j_ptq(jt, q8j))
    td = dequantize_params(params_from_numpy(jax_to_numpy(j_ptq(jt, q8j)),
                                             qtype=q8t))
    assert np.array_equal(_bits(td["fc0"]["w"].numpy()),
                          _bits(jd["fc0"]["w"]))
    assert np.array_equal(td["fc0"]["b"].numpy(), np.asarray(jd["fc0"]["b"]))
