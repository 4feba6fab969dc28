"""Model parity: gemma-2b smoke through one paged prefill chunk and 8
decode steps, port vs ``repro.models.lm``, from the same weights (the
reference's init, converted through numpy) and the same pages and block
tables.  Per-layer outputs and logits agree at atol 1e-4 (f32; both
sides run the same formulas in another association order, and the int8
path re-quantizes activations that already agree to ~1e-6).

Also with the paper's tables (``use_lut``) on f32 pages -- the reference
then runs its paged kernel (``force_paged_kernel``), since the port's
paged f32 path is the kernel's, with the exact softmax -- and on int8 KV
pages, where both gather, dequantize and attend with the (table)
softmax; int8 pages are compared through their dequantized values.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro.nn.blocks import dense_block_apply as j_block  # noqa: E402
from repro.nn.embedding import embed as j_embed  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.nn.blocks import dense_block_apply as t_block  # noqa: E402
from repro_torch.nn.blocks import layer_slice  # noqa: E402
from repro_torch.nn.embedding import embed as t_embed  # noqa: E402

from torch_parity import contexts, smoke_params  # noqa: E402

ATOL = 1e-4
B, PS, WIDTH, NUM_PAGES, CHUNK, STEPS = 2, 4, 8, 20, 7, 8


def _tables():
    """Disjoint pages per lane, unused entries on the trash page."""
    bt = np.full((B, WIDTH), NUM_PAGES, np.int32)
    bt[0, :5] = [3, 11, 0, 7, 15]
    bt[1, :6] = [1, 2, 19, 5, 8, 12]
    return bt


def _caches(cfg, kv_bits=None):
    jdt, tdt = ((jnp.int8, torch.int8) if kv_bits
                else (jnp.float32, torch.float32))
    jc = jlm.init_paged_cache(cfg, B, NUM_PAGES, PS, WIDTH, jdt)
    bt = _tables()
    jc = {"dense": {"pages": jc["dense"]["pages"],
                    "block_table": jnp.broadcast_to(
                        jnp.asarray(bt), jc["dense"]["block_table"].shape)}}
    tc = tlm.init_paged_cache(cfg, B, NUM_PAGES, PS, WIDTH, tdt, device="cpu")
    tc["dense"]["block_table"].copy_(torch.from_numpy(bt))
    return jc, tc


def _page_values(cache):
    """f32 K/V page values (int8 pages dequantized by their scale pages)."""
    pages = cache["dense"]["pages"]

    def get(name):
        v = pages[name]
        return np.asarray(v.float() if isinstance(v, torch.Tensor)
                          else v.astype(jnp.float32))
    if "k_scale" not in pages:
        return {n: get(n) for n in ("k", "v")}
    return {n: get(n) * get(f"{n}_scale") for n in ("k", "v")}


def _layers_jax(params, x, cfg, ctx, cache, pos):
    outs = []
    for l in range(cfg.n_layers):
        p_l = jax.tree_util.tree_map(lambda a: a[l], params["dense"])
        c_l = jax.tree_util.tree_map(lambda a: a[l], cache["dense"])
        x, _ = j_block(p_l, x, cfg, ctx, cache=c_l, cache_pos=pos)
        outs.append(np.asarray(x))
    return outs


def _layers_torch(params, x, cfg, ctx, cache, pos):
    """Per-layer outputs on a throwaway copy of the cache (the port writes
    pages in place)."""
    cache = {"dense": {"pages": {k: v.clone() for k, v in
                                 cache["dense"]["pages"].items()},
                       "block_table": cache["dense"]["block_table"]}}
    outs = []
    for l in range(cfg.n_layers):
        x, _ = t_block(layer_slice(params["dense"], l), x, cfg, ctx,
                       cache=layer_slice(cache["dense"], l), cache_pos=pos)
        outs.append(x.numpy())
    return outs


@pytest.mark.parametrize("knobs", [{}, {"kv_split": 1, "pages_per_step": 1}],
                         ids=["auto", "split1"])
@pytest.mark.parametrize("mode", ["none", "int8"])
def test_prefill_then_decode_matches(mode, knobs):
    _prefill_then_decode(mode, *contexts(mode, **knobs))


@pytest.mark.parametrize("cache", ["f32-lut", "kv8-exact", "kv8-lut"])
@pytest.mark.parametrize("mode", ["none", "int8"])
def test_lut_and_int8_pages_match(mode, cache):
    use_lut, kv_bits = cache.endswith("lut"), (8 if "kv8" in cache else None)
    jctx, tctx = contexts(mode, use_lut=use_lut,
                          force_paged_kernel=kv_bits is None)
    _prefill_then_decode(mode, jctx, tctx, kv_bits)
    if use_lut:
        # the tables are in effect: the exact path gives other logits
        cfg, _, tparams = smoke_params(mode)
        tokens = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab, (B, CHUNK)).astype(np.int32))
        lut, exact = (tlm.prefill(tparams, tokens, _caches(cfg, kv_bits)[1],
                                  cfg, c, full_logits=True)[0]
                      for c in (tctx, dataclasses.replace(tctx,
                                                          use_lut=False)))
        assert not torch.equal(lut, exact)


def _prefill_then_decode(mode, jctx, tctx, kv_bits=None):
    cfg, jparams, tparams = smoke_params(mode)
    jcache, tcache = _caches(cfg, kv_bits)
    rs = np.random.RandomState(0)
    prompt = rs.randint(0, cfg.vocab, (B, CHUNK)).astype(np.int32)
    pos = np.asarray([0, 5], np.int32)     # lane 1 continues at position 5

    def both_layers(tokens, p):
        jx = j_embed(jparams["embed"], jnp.asarray(tokens), jctx,
                     scale_by_dim=cfg.embed_scale)
        tx = t_embed(tparams["embed"], torch.from_numpy(tokens), tctx,
                     scale_by_dim=cfg.embed_scale)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=0, rtol=0)
        want = _layers_jax(jparams, jx, cfg, jctx, jcache, jnp.asarray(p))
        got = _layers_torch(tparams, tx, cfg, tctx, tcache,
                            torch.from_numpy(p))
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
    jv, tv = _page_values(jcache), _page_values(tcache)
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
