"""``repro_torch.nn.attention.mla_apply`` against
``repro.nn.attention.mla_apply`` (deepseek-v2's multi-head latent
attention) from the same weights (the reference's ``mla_init``, through
numpy) at deepseek-v2's smoke dims, f32 within 1e-5 of the largest value.

* The naive cache-free form: the port attends through ``ops.attention``
  (the flash kernel's plain version on the CPU) with V zero-padded to
  the q/k width and sliced after; the reference's CPU branch is its
  einsum attention.  Both, and the port's plain oracle on the unpadded
  V, agree.
* The absorbed form over the dense latent rows and over the paged latent
  (a prefill chunk at ragged positions, then decode steps), the latent
  written before it is attended; also under the table softmax
  (``use_lut``), which both packages apply there.
* An int8 cache request gives a bf16 latent on both packages, and the
  outputs on it still agree.
* A PTQ'd ``wkv_b`` (a QTensor) is dequantized, not multiplied through
  ``linear``, in f32 and in int8 mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.quantize import ptq_params as j_ptq  # noqa: E402
from repro.nn import attention as jatt  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.nn import attention as tatt  # noqa: E402

from torch_parity import contexts, int8_policies, jax_to_numpy  # noqa: E402

REL = 1e-5
B, PS, WIDTH, NUM_PAGES = 2, 4, 6, 16


def _dims(pkg):
    return pkg.MLADims(d_model=128, n_heads=4, q_lora_rank=64,
                       kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16,
                       v_head_dim=32)


JD, TD = _dims(jatt), _dims(tatt)


def _weights(quant=False, seed=0):
    jp = jatt.mla_init(jax.random.PRNGKey(seed), JD)
    qtype = None
    if quant:
        jpol, _, qtype = int8_policies()
        jp = j_ptq(jp, jpol)
    return jp, params_from_numpy(jax_to_numpy(jp), qtype=qtype)


def _x(s, seed=1):
    return np.random.RandomState(seed).randn(B, s, 128).astype(np.float32)


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


@pytest.mark.parametrize("s", [1, 9, 24])
def test_naive_form_matches_reference_einsum(s):
    jp, tp = _weights()
    jctx, tctx = contexts("none")
    x = _x(s)
    jy, jc = jatt.mla_apply(jp, jnp.asarray(x), JD, jctx)
    ty, tc = tatt.mla_apply(tp, torch.from_numpy(x), TD, tctx)
    assert jc is None and tc is None
    _close(ty.numpy(), jy)


def test_padded_v_flash_plain_equals_unpadded_oracle():
    """The naive form's V padding: the flash plain version on V padded to
    qk_dim, sliced, equals the plain oracle on the unpadded V."""
    rs = np.random.RandomState(2)
    q, k = (torch.from_numpy(rs.randn(B, 4, 11, 48).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(rs.randn(B, 4, 11, 32).astype(np.float32))
    from repro_torch.kernels.ops import attention
    vp = torch.nn.functional.pad(v, (0, 16))
    got = attention(q, k, vp, causal=True, softmax_scale=48 ** -0.5)
    assert torch.equal(got[..., 32:], torch.zeros_like(got[..., 32:]))
    want = flash_attention_ref(q, k, v, causal=True,
                               softmax_scale=48 ** -0.5)
    _close(got[..., :32].numpy(), want.numpy())


def _dense_caches(max_len, jdt=jnp.float32, tdt=torch.float32):
    return (jatt.mla_cache_spec(JD, B, max_len, jdt),
            tatt.mla_cache_spec(TD, B, max_len, tdt))


def _paged_caches(jdt=jnp.float32, tdt=torch.float32):
    bt = np.full((B, WIDTH), NUM_PAGES, np.int32)
    bt[0, :4] = [3, 11, 0, 7]
    bt[1, :5] = [1, 2, 15, 5, 8]
    jc = jatt.mla_paged_cache_spec(JD, B, NUM_PAGES, PS, WIDTH, jdt)
    jc = dict(jc, block_table=jnp.asarray(bt))
    tc = tatt.mla_paged_cache_spec(TD, B, NUM_PAGES, PS, WIDTH, tdt)
    tc["block_table"].copy_(torch.from_numpy(bt))
    return jc, tc


def _latent(cache):
    store = cache["pages"] if "pages" in cache else cache
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor)
                          else v.astype(jnp.float32))
            for k, v in store.items()}


def _run_cached(jp, tp, jctx, tctx, jc, tc, rel=REL, steps=3):
    """A prefill chunk (lane 1 at position 3), then decode steps: outputs
    and the latent after each call agree."""
    x = _x(6, seed=3)
    pos = np.asarray([0, 3], np.int32)
    for step in range(steps + 1):
        xs = x if step == 0 else _x(1, seed=10 + step)
        jy, jc = jatt.mla_apply(jp, jnp.asarray(xs), JD, jctx, cache=jc,
                                cache_pos=jnp.asarray(pos))
        ty, tc2 = tatt.mla_apply(tp, torch.from_numpy(xs), TD, tctx,
                                 cache=tc, cache_pos=torch.from_numpy(pos))
        assert tc2 is tc                     # written in place
        _close(ty.float().numpy(), jy.astype(jnp.float32), rel)
        jl, tl = _latent(jc), _latent(tc)
        for name in jl:
            _close(tl[name], jl[name], rel)
        pos = pos + xs.shape[1]


@pytest.mark.parametrize("use_lut", [False, True], ids=["exact", "lut"])
@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_absorbed_decode_matches(cache, use_lut):
    jp, tp = _weights()
    jctx, tctx = contexts("none", use_lut=use_lut)
    jc, tc = _dense_caches(16) if cache == "dense" else _paged_caches()
    _run_cached(jp, tp, jctx, tctx, jc, tc)


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_int8_cache_request_is_a_bf16_latent(cache):
    jc, tc = (_dense_caches(16, jnp.int8, torch.int8) if cache == "dense"
              else _paged_caches(jnp.int8, torch.int8))
    leaves = (tc["pages"] if cache == "paged" else tc).values()
    assert {v.dtype for v in leaves} == {torch.bfloat16}
    jleaves = (jc["pages"] if cache == "paged" else jc).values()
    assert {v.dtype for v in jleaves} == {jnp.dtype(jnp.bfloat16)}
    jp, tp = _weights()
    jctx, tctx = contexts("none")
    # the latent rounds to bf16 on both sides, the same values
    _run_cached(jp, tp, jctx, tctx, jc, tc)


@pytest.mark.parametrize("mode", ["none", "int8"])
@pytest.mark.parametrize("cache", [None, "paged"])
def test_ptq_wkv_b_is_dequantized(mode, cache):
    jp, tp = _weights(quant=True)
    from repro_torch.core.qtypes import QTensor
    assert isinstance(tp["wkv_b"]["w"], QTensor)
    jctx, tctx = contexts(mode)
    if cache is None:
        x = _x(7, seed=4)
        jy, _ = jatt.mla_apply(jp, jnp.asarray(x), JD, jctx)
        ty, _ = tatt.mla_apply(tp, torch.from_numpy(x), TD, tctx)
        _close(ty.numpy(), jy, 1e-5 if mode == "none" else 1e-4)
        return
    jc, tc = _paged_caches()
    _run_cached(jp, tp, jctx, tctx, jc, tc,
                rel=1e-5 if mode == "none" else 1e-4, steps=1)


def test_verify_pass_attends_by_position():
    """``per_position_attention`` (a speculative verify pass): the
    absorbed form runs one query position a call, each at a decode
    step's shapes; its output equals the reference's fused pass."""
    import dataclasses
    jp, tp = _weights()
    jctx, tctx = contexts("none")
    vctx = dataclasses.replace(tctx, per_position_attention=True)
    jc, tc = _paged_caches()
    x = _x(4, seed=5)
    pos = np.asarray([0, 3], np.int32)
    _, jc = jatt.mla_apply(jp, jnp.asarray(x), JD, jctx, cache=jc,
                           cache_pos=jnp.asarray(pos))
    tatt.mla_apply(tp, torch.from_numpy(x), TD, tctx, cache=tc,
                   cache_pos=torch.from_numpy(pos))
    pos = pos + 4
    xv = _x(3, seed=6)
    jy, _ = jatt.mla_apply(jp, jnp.asarray(xv), JD, jctx, cache=jc,
                           cache_pos=jnp.asarray(pos))
    ty, _ = tatt.mla_apply(tp, torch.from_numpy(xv), TD, vctx, cache=tc,
                           cache_pos=torch.from_numpy(pos))
    _close(ty.numpy(), jy)
