"""Model parity: gemma-2b smoke through one paged prefill chunk and 8
decode steps, port vs ``repro.models.lm``, from the same weights (the
reference's init, converted through numpy) and the same pages and block
tables.  Per-layer outputs and logits agree at atol 1e-4 (f32; both
sides run the same formulas in another association order, and the int8
path re-quantizes activations that already agree to ~1e-6).
"""

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


def _caches(cfg):
    jc = jlm.init_paged_cache(cfg, B, NUM_PAGES, PS, WIDTH, jnp.float32)
    bt = _tables()
    jc = {"dense": {"pages": jc["dense"]["pages"],
                    "block_table": jnp.broadcast_to(
                        jnp.asarray(bt), jc["dense"]["block_table"].shape)}}
    tc = tlm.init_paged_cache(cfg, B, NUM_PAGES, PS, WIDTH, torch.float32)
    tc["dense"]["block_table"].copy_(torch.from_numpy(bt))
    return jc, tc


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
    cfg, jparams, tparams = smoke_params(mode)
    jctx, tctx = contexts(mode, **knobs)
    jcache, tcache = _caches(cfg)
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
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache["dense"]["pages"][name].numpy(),
                                   np.asarray(jcache["dense"]["pages"][name]),
                                   atol=ATOL, rtol=0)

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
