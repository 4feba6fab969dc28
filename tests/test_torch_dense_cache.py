"""Dense and int8 KV caches: port vs ``repro``.

* The cache pieces: int8 K/V quantization bitwise, the visibility mask,
  the clamped row write, the page gather, slot invalidation.
* Model parity on the dense cache: gemma-2b smoke through one prefill
  chunk and 8 decode steps, f32 and int8 weights, f32 and int8 KV rows,
  with and without the paper's tables (``use_lut``: LUT activations and
  the table softmax).  Per-layer outputs, logits and the cache agree at
  atol 1e-4, as the paged suite's; the int8 KV rows are compared through
  their dequantized values at the same tolerance (an activation that
  differs in the last bits may round to the neighbouring int8 step).
* Engine parity: the port's ``Engine(device="cpu")`` serves the same
  greedy streams as the JAX ``Engine`` on the dense cache -- the CLI's
  default regime -- with and without ``--lut`` and ``--kv-bits 8``, and on
  int8 KV pages; dense and paged int8-KV streams are identical (as
  ``tests/test_paged_serving.py`` holds for the reference).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import api as japi  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.nn import attention as jatt  # noqa: E402
from repro.nn.blocks import dense_block_apply as j_block  # noqa: E402
from repro.nn.embedding import embed as j_embed  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.nn import attention as tatt  # noqa: E402
from repro_torch.nn.blocks import dense_block_apply as t_block  # noqa: E402
from repro_torch.nn.blocks import layer_slice  # noqa: E402
from repro_torch.nn.embedding import embed as t_embed  # noqa: E402

from torch_parity import (contexts, engine_prompts, serve_jax,  # noqa: E402
                          serve_torch, smoke_params)

ATOL = 1e-4
B, ROWS, CHUNK, STEPS = 2, 24, 7, 8


def _assert_bitwise(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    if want.dtype == jnp.bfloat16:
        want = want.astype(np.float32)
    np.testing.assert_array_equal(got, want)


# -- the cache pieces -----------------------------------------------------------
def test_quantize_kv_bitwise():
    rs = np.random.RandomState(0)
    u = (rs.randn(2, 3, 5, 32) * 2).astype(np.float32)
    u[0, 0, 0] = 0.0                       # an all-zero row: the 1e-6 floor
    jq, js = jatt._quantize_kv(jnp.asarray(u))
    tq, ts = tatt._quantize_kv(torch.from_numpy(u))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    _assert_bitwise(tq, jq)
    _assert_bitwise(ts, js)


@pytest.mark.parametrize("causal", [True, False])
def test_cache_mask_equal(causal):
    pos = np.asarray([0, 5, 17], np.int32)
    want = jatt._cache_mask(jnp.asarray(pos), 4, 24, causal)
    got = tatt._cache_mask(torch.from_numpy(pos), 4, 24, causal)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_write_clamps_like_dynamic_update_slice():
    """Rows land at each lane's position; a start past ``R - s`` clamps
    back, as ``lax.dynamic_update_slice`` does in the reference."""
    rs = np.random.RandomState(1)
    rows = rs.randn(3, 2, 10, 4).astype(np.float32)
    u = rs.randn(3, 2, 4, 4).astype(np.float32)
    pos = np.asarray([0, 3, 9], np.int32)
    want = jax.vmap(lambda c, x, i: jax.lax.dynamic_update_slice(
        c, x, (0, i, 0)))(jnp.asarray(rows), jnp.asarray(u), jnp.asarray(pos))
    got = torch.from_numpy(rows.copy())
    tatt._dense_write(got, torch.from_numpy(u), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_gather_equal():
    rs = np.random.RandomState(2)
    pages = rs.randn(9, 2, 4, 3).astype(np.float32)
    bt = np.asarray([[3, 1, 8], [0, 8, 8]], np.int32)
    want = jatt._paged_gather(jnp.asarray(pages), jnp.asarray(bt))
    got = tatt._paged_gather(torch.from_numpy(pages), torch.from_numpy(bt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_invalidate_zeroes_one_slot(dtype):
    """Dense: slot 1's rows (and scales) are zeroed in place, as the
    reference's ``invalidate_fn``; paged caches come back untouched."""
    cfg, _, _ = smoke_params("none")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jc = jlm.init_cache(cfg, 3, 8, jdt)
    jc = jax.tree_util.tree_map(lambda a: jnp.ones_like(a), jc)
    tc = tlm.init_cache(cfg, 3, 8, tdt, device="cpu")
    for leaf in tc["dense"].values():
        leaf.fill_(1)
    want = japi.invalidate_fn(jc, jnp.int32(1), cfg)
    got = tapi.invalidate_fn(tc, 1, cfg)
    assert set(got["dense"]) == set(want["dense"])
    for name, leaf in got["dense"].items():
        _assert_bitwise(leaf, want["dense"][name])
    paged = tlm.init_paged_cache(cfg, 3, 4, 4, 2, tdt, device="cpu")
    before = {k: v.clone() for k, v in paged["dense"]["pages"].items()}
    tapi.invalidate_fn(paged, 1, cfg)
    for k, v in paged["dense"]["pages"].items():
        assert torch.equal(v, before[k])


# -- model parity on the dense cache ----------------------------------------------
def _dense_caches(cfg, kv_bits):
    jc = jlm.init_cache(cfg, B, ROWS, jnp.int8 if kv_bits else jnp.float32)
    tc = tlm.init_cache(cfg, B, ROWS, torch.int8 if kv_bits else torch.float32,
                        device="cpu")
    return jc, tc


def _kv_values(cache):
    """f32 K/V values of a dense cache (int8 rows dequantized)."""
    def get(c, name):
        return np.asarray(c[name].float() if isinstance(c[name], torch.Tensor)
                          else c[name]).astype(np.float32)
    c = cache["dense"]
    if "k_scale" not in c:
        return {n: get(c, n) for n in ("k", "v")}
    return {n: get(c, n) * get(c, f"{n}_scale") for n in ("k", "v")}


@pytest.mark.parametrize("use_lut", [False, True], ids=["exact", "lut"])
@pytest.mark.parametrize("kv_bits", [None, 8], ids=["kvf32", "kv8"])
@pytest.mark.parametrize("mode", ["none", "int8"])
def test_dense_prefill_then_decode_matches(mode, kv_bits, use_lut):
    cfg, jparams, tparams = smoke_params(mode)
    jctx, tctx = contexts(mode, use_lut=use_lut)
    jcache, tcache = _dense_caches(cfg, kv_bits)
    rs = np.random.RandomState(0)
    prompt = rs.randint(0, cfg.vocab, (B, CHUNK)).astype(np.int32)
    pos = np.asarray([0, 5], np.int32)     # lane 1 continues at position 5

    def both_layers(tokens, p):
        jx = j_embed(jparams["embed"], jnp.asarray(tokens), jctx,
                     scale_by_dim=cfg.embed_scale)
        tx = t_embed(tparams["embed"], torch.from_numpy(tokens), tctx,
                     scale_by_dim=cfg.embed_scale)
        want, got = [], []
        jc = jcache
        tc = {"dense": {k: v.clone() for k, v in tcache["dense"].items()}}
        for l in range(cfg.n_layers):
            p_l = jax.tree_util.tree_map(lambda a: a[l], jparams["dense"])
            c_l = jax.tree_util.tree_map(lambda a: a[l], jc["dense"])
            jx, _ = j_block(p_l, jx, cfg, jctx, cache=c_l,
                            cache_pos=jnp.asarray(p))
            tx, _ = t_block(layer_slice(tparams["dense"], l), tx, cfg, tctx,
                            cache=layer_slice(tc["dense"], l),
                            cache_pos=torch.from_numpy(p))
            want.append(np.asarray(jx))
            got.append(tx.numpy())
        for l, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0,
                                       err_msg=f"layer {l}")

    both_layers(prompt, pos)
    j_prefill = jax.jit(lambda p, t, c, q: jlm.prefill(
        p, t, c, cfg, jctx, pos=q, full_logits=True))
    j_decode = jax.jit(lambda p, t, c, q: jlm.decode_step(p, t, c, q, cfg,
                                                          jctx))
    jl, jcache = j_prefill(jparams, jnp.asarray(prompt), jcache,
                           jnp.asarray(pos))
    tl, tcache = tlm.prefill(tparams, torch.from_numpy(prompt), tcache, cfg,
                             tctx, pos=torch.from_numpy(pos), full_logits=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    jv, tv = _kv_values(jcache), _kv_values(tcache)
    for name in ("k", "v"):
        np.testing.assert_allclose(tv[name], jv[name], atol=ATOL, rtol=0)

    pos = pos + CHUNK
    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    for step in range(STEPS):
        if step == 0:
            both_layers(tok, pos)
        jl, jcache = j_decode(jparams, jnp.asarray(tok), jcache,
                              jnp.asarray(pos))
        tl, tcache = tlm.decode_step(tparams, torch.from_numpy(tok), tcache,
                                     torch.from_numpy(pos), cfg, tctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"decode step {step}")
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        pos = pos + 1


# -- engine parity ------------------------------------------------------------------
#: (weights, use_lut, kv_bits, paged): regime (c) is int8 weights + LUT on
#: the dense cache, (d) int8 KV rows or pages
REGIMES = {"dense": ("none", False, None, False),
           "c-int8-lut": ("int8", True, None, False),
           "c-int8-lut-kv8": ("int8", True, 8, False),
           "d-kv8": ("none", False, 8, False),
           "d-kv8-paged-lut": ("int8", True, 8, True)}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_greedy_streams_identical_dense_and_int8_kv(regime):
    mode, use_lut, kv_bits, paged = REGIMES[regime]
    cfg, jparams, tparams = smoke_params(mode)
    jctx, tctx = contexts(mode, use_lut=use_lut)
    prompts = engine_prompts(cfg.vocab)
    kw = {"kv_bits": kv_bits, "paged": paged}
    want, jeng = serve_jax(cfg, jctx, jparams, prompts, kw)
    got, teng = serve_torch(cfg, tctx, tparams, prompts, kw)
    assert got == want
    st = teng.stats()
    assert (st["paged"], st["kv_bits"]) == (paged, kv_bits)
    assert st["gen_tokens"] == 3 * len(got[0]) and st["peak_live"] == 2
    if not paged:
        assert st["kv_split"] is None
        # a retired slot's rows were zeroed: lane 0 served request 0 and
        # then request 2, and its rows past request 2's tokens are zero
        assert (teng.cache["dense"]["k"][:, 0, :, teng.pos[0] + 1:] == 0).all()


@pytest.mark.parametrize("use_lut", [False, True], ids=["exact", "lut"])
def test_dense_and_paged_int8_kv_streams_identical(use_lut):
    """The port's own conformance, as the reference's
    ``test_paged_matches_dense_int8_kv``: int8 KV rows and int8 KV pages
    quantize and attend identically."""
    cfg, _, tparams = smoke_params("none")
    _, tctx = contexts("none", use_lut=use_lut)
    prompts = engine_prompts(cfg.vocab)
    dense, _ = serve_torch(cfg, tctx, tparams, prompts,
                            {"kv_bits": 8, "paged": False})
    paged, eng = serve_torch(cfg, tctx, tparams, prompts,
                              {"kv_bits": 8, "paged": True})
    assert paged == dense
    assert eng.allocator.free_pages == eng.allocator.num_pages
