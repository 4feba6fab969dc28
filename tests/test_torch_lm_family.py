"""The rest of the ``lm`` family on the port, held against
``repro.models.lm`` from the same weights (the reference's init,
converted through numpy): yi-6b, glm4-9b (qkv bias, half rotary),
command-r-35b (parallel block, LayerNorm), olmoe-1b-7b (MoE) and
deepseek-v2-236b (a dense layer, then MoE with MLA and shared experts),
smoke size.

* Per-layer outputs (the dense and the MoE stack alike; each layer fed
  the reference's input of that layer) and logits of the cache-free
  forward, of a paged prefill chunk and of decode steps:
  f32 within 1e-5 of the largest value (command-r's LayerNorm within a
  few f32 ulps of it: XLA's reductions sum in another order); int8 PTQ
  logits within 1e-4 absolute, int8 per-layer outputs within 1e-3
  relative L2 (a norm's last-bit difference can move an activation's
  int8 code); the MoE aux loss within 1e-6.
* The reference's ``test_serving_chunked_vs_monolithic`` cells on the
  port (prefill(S) + decode(k) == prefill(S + k), err < 1e-3), every
  config, dense cache.
* The reference's ``test_n_params_analytic_vs_actual`` on the port's
  own init, and the port's parameter counts equal the reference's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.nn import blocks as jblocks  # noqa: E402
from repro.nn.embedding import embed as j_embed  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.nn import blocks as tblocks  # noqa: E402
from repro_torch.nn.embedding import embed as t_embed  # noqa: E402

from torch_parity import contexts, smoke_params  # noqa: E402

ARCHS = ["yi-6b", "glm4-9b", "command-r-35b", "olmoe-1b-7b",
         "deepseek-v2-236b"]
#: f32 tolerance, relative to the largest |value| of the tensor
REL = 1e-5
INT8_ATOL = 1e-4
#: int8 per-layer outputs: relative L2 error (see ``_close``)
INT8_LAYER_REL_L2 = 1e-3
B, PS, WIDTH, NUM_PAGES, CHUNK, STEPS = 2, 4, 8, 20, 7, 3

_PARAMS = {}


def _params(arch, mode):
    if (arch, mode) not in _PARAMS:
        _PARAMS[arch, mode] = smoke_params(mode, arch=arch)
    return _PARAMS[arch, mode]


def _close(got, want, mode, what, layer=False):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    if mode == "int8" and layer:
        # the norms' f32 statistics are not bitwise XLA's (another
        # summation order); an int8 projection after them can move one
        # activation code, an O(scale) step in a few outputs
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert rel <= INT8_LAYER_REL_L2, f"{what}: relative L2 err {rel}"
    elif mode == "int8":
        assert err <= INT8_ATOL, f"{what}: max abs err {err}"
    else:
        scale = float(np.abs(want).max())
        assert err <= REL * scale, f"{what}: max abs err {err} of {scale}"


def _tables():
    """Disjoint pages per lane, unused entries on the trash page."""
    bt = np.full((B, WIDTH), NUM_PAGES, np.int32)
    bt[0, :5] = [3, 11, 0, 7, 15]
    bt[1, :6] = [1, 2, 19, 5, 8, 12]
    return bt


def _paged_caches(cfg):
    jc = jlm.init_paged_cache(cfg, B, NUM_PAGES, PS, WIDTH, jnp.float32)
    bt = _tables()
    jc = {k: {"pages": v["pages"], "block_table": jnp.broadcast_to(
        jnp.asarray(bt), v["block_table"].shape)} for k, v in jc.items()}
    tc = tlm.init_paged_cache(cfg, B, NUM_PAGES, PS, WIDTH, torch.float32,
                              device="cpu")
    for v in tc.values():
        v["block_table"].copy_(torch.from_numpy(bt))
    return jc, tc


def _stacks(cfg):
    n_dense, n_moe = tlm._split_layers(cfg)
    return [(key, n) for key, n in (("dense", n_dense), ("moe", n_moe)) if n]


def _layers_jax(params, x, cfg, ctx, cache, pos):
    """Per-layer (input, output) of the reference's blocks, and aux."""
    ins, outs, auxes = [], [], []
    for key, n in _stacks(cfg):
        for l in range(n):
            p_l = jax.tree_util.tree_map(lambda a: a[l], params[key])
            c_l = (None if cache is None else
                   jax.tree_util.tree_map(lambda a: a[l], cache[key]))
            ins.append(np.asarray(x))
            if key == "dense":
                x, _ = jblocks.dense_block_apply(p_l, x, cfg, ctx, cache=c_l,
                                                 cache_pos=pos)
            else:
                x, _, a = jblocks.moe_block_apply(p_l, x, cfg, ctx,
                                                  cache=c_l, cache_pos=pos)
                auxes.append(float(a))
            outs.append(np.asarray(x))
    return ins, outs, auxes


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _layers_torch(params, ins, cfg, ctx, cache, pos):
    """Per-layer outputs of the port's blocks, each fed the reference's
    input of that layer (an int8 projection turns a last-bit difference
    of its input into a code step, which later layers would carry on),
    on a throwaway copy of the cache (the port writes it in place)."""
    cache = None if cache is None else _clone(cache)
    outs, auxes = [], []
    for key, n in _stacks(cfg):
        for l in range(n):
            x = torch.from_numpy(ins[len(outs)])
            p_l = tblocks.layer_slice(params[key], l)
            c_l = (None if cache is None
                   else tblocks.layer_slice(cache[key], l))
            if key == "dense":
                x, _ = tblocks.dense_block_apply(p_l, x, cfg, ctx, cache=c_l,
                                                 cache_pos=pos)
            else:
                x, _, a = tblocks.moe_block_apply(p_l, x, cfg, ctx,
                                                  cache=c_l, cache_pos=pos)
                auxes.append(float(a))
            outs.append(x.numpy())
    return outs, auxes


def _both_layers(arch, mode, tokens, jcache, tcache, pos):
    cfg, jparams, tparams = _params(arch, mode)
    jctx, tctx = contexts(mode)
    jx = j_embed(jparams["embed"], jnp.asarray(tokens), jctx,
                 scale_by_dim=cfg.embed_scale)
    tx = t_embed(tparams["embed"], torch.from_numpy(tokens), tctx,
                 scale_by_dim=cfg.embed_scale)
    jpos = None if pos is None else jnp.asarray(pos)
    tpos = None if pos is None else torch.from_numpy(pos)
    ins, want, jaux = _layers_jax(jparams, jx, cfg, jctx, jcache, jpos)
    np.testing.assert_array_equal(tx.numpy(), ins[0])
    got, taux = _layers_torch(tparams, ins, cfg, tctx, tcache, tpos)
    for l, (g, w) in enumerate(zip(got, want)):
        _close(g, w, mode, f"{arch} {mode} layer {l}", layer=True)
    # int8: the routers see inputs that a moved code may have shifted
    np.testing.assert_allclose(taux, jaux, rtol=1e-3 if mode == "int8"
                               else 0, atol=1e-6)


@pytest.mark.parametrize("mode", ["none", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_free_forward_matches(arch, mode):
    """Per-layer outputs, logits and the aux loss of the cache-free
    forward (the MoE capacity is the training one: slots may drop)."""
    cfg, jparams, tparams = _params(arch, mode)
    jctx, tctx = contexts(mode)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab, (B, 12)).astype(np.int32)
    _both_layers(arch, mode, tokens, None, None, None)
    jl, _, jaux = jlm.forward(jparams, jnp.asarray(tokens), cfg, jctx)
    tl, cache, taux = tlm.forward(tparams, torch.from_numpy(tokens), cfg,
                                  tctx)
    assert cache is None
    _close(tl.numpy(), jl, mode, f"{arch} {mode} logits")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)
    assert (float(taux) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("mode", ["none", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_then_decode_matches(arch, mode):
    """A paged prefill chunk (lane 1 continues at position 5) and
    ``STEPS`` decode steps: per-layer outputs of the chunk and the first
    step, logits of each, and the page values after the chunk."""
    cfg, jparams, tparams = _params(arch, mode)
    jctx, tctx = contexts(mode)
    jcache, tcache = _paged_caches(cfg)
    rs = np.random.RandomState(0)
    prompt = rs.randint(0, cfg.vocab, (B, CHUNK)).astype(np.int32)
    pos = np.asarray([0, 5], np.int32)
    _both_layers(arch, mode, prompt, jcache, tcache, pos)
    j_prefill = jax.jit(lambda p, t, c, q: jlm.prefill(
        p, t, c, cfg, jctx, pos=q, full_logits=True))
    j_decode = jax.jit(lambda p, t, c, q: jlm.decode_step(p, t, c, q, cfg,
                                                          jctx))
    jl, jcache = j_prefill(jparams, jnp.asarray(prompt), jcache,
                           jnp.asarray(pos))
    tl, tcache = tlm.prefill(tparams, torch.from_numpy(prompt), tcache, cfg,
                             tctx, pos=torch.from_numpy(pos),
                             full_logits=True)
    _close(tl.numpy(), jl, mode, f"{arch} {mode} prefill logits")
    for key in jcache:
        for name, leaf in jcache[key]["pages"].items():
            _close(tcache[key]["pages"][name].numpy(), leaf, mode,
                   f"{arch} {mode} pages {key}/{name}")
    pos = pos + CHUNK
    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    for step in range(STEPS):
        if step == 0:
            _both_layers(arch, mode, tok, jcache, tcache, pos)
        jl, jcache = j_decode(jparams, jnp.asarray(tok), jcache,
                              jnp.asarray(pos))
        tl, tcache = tlm.decode_step(tparams, torch.from_numpy(tok), tcache,
                                     torch.from_numpy(pos), cfg, tctx)
        _close(tl.numpy(), jl, mode, f"{arch} {mode} decode step {step}")
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_chunked_vs_monolithic(arch):
    """prefill(S) + decode(k) equals prefill(S + k) on the port (the
    reference's cell, dense cache: GQA rows or the MLA latent)."""
    cfg, _, tparams = _params(arch, "none")
    _, ctx = contexts("none")
    bsz, s, dec = 2, 8, 3
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (bsz, s + dec)).astype(np.int32))

    def run_prefill(upto):
        cache = tlm.init_cache(cfg, bsz, s + dec, torch.float32,
                               device="cpu")
        return tlm.prefill(tparams, toks[:, :upto], cache, cfg, ctx)

    ref_last, _ = run_prefill(s + dec)
    lg, cache = run_prefill(s)
    pos = torch.full((bsz,), s, dtype=torch.int32)
    for t in range(dec):
        lg, cache = tlm.decode_step(tparams, toks[:, s + t:s + t + 1], cache,
                                    pos + t, cfg, ctx)
    err = float((lg[:, 0] - ref_last[:, 0]).abs().max())
    assert err < 1e-3, err


def _count(tree):
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    return tree.numel()


@pytest.mark.parametrize("arch", ARCHS + ["gemma-2b"])
def test_n_params_analytic_vs_actual(arch):
    """``n_params`` within 2% of the port's own init (the reference's
    cell), and every count equal to the reference config's."""
    cfg = get_config(arch).smoke()
    params = tlm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    actual = _count(params)
    assert abs(actual - cfg.n_params()) / actual < 0.02, \
        (arch, actual, cfg.n_params())
    for c, jc in ((get_config(arch), j_config(arch)),
                  (cfg, j_config(arch).smoke())):
        assert (c.n_params(), c.active_params(), c.flop_params()) \
            == (jc.n_params(), jc.active_params(), jc.flop_params())


def test_configs_equal_the_reference():
    """Every ported config, and its smoke reduction, field for field."""
    def fields(c):
        d = dataclasses.asdict(c)
        return {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                    else v) for k, v in d.items()}
    for arch in ARCH_IDS:
        assert fields(get_config(arch)) == fields(j_config(arch)), arch
        if arch != "jet-mlp":
            assert fields(get_config(arch).smoke()) \
                == fields(j_config(arch).smoke()), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_accept_every_config(arch):
    """init, forward, prefill, decode_step and both caches take the
    config at smoke size (int8 MLA caches come back bf16)."""
    cfg = get_config(arch).smoke()
    params = tlm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert ("head" in params) == (not cfg.tie_embeddings)
    assert ("moe" in params) == (cfg.moe is not None)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    for cache in (tlm.init_cache(cfg, 1, 8, torch.int8, device="cpu"),
                  tlm.init_paged_cache(cfg, 1, 4, 4, 3, torch.int8,
                                       device="cpu")):
        leaves = [v for s in cache.values() for v in
                  (s["pages"] if "pages" in s else s).values()]
        if cfg.attn_kind == "mla":
            assert {v.dtype for v in leaves} == {torch.bfloat16}
        lg, cache = tlm.prefill(params, toks, cache, cfg, full_logits=True)
        assert lg.shape == (1, 4, cfg.vocab)
        lg, _ = tlm.decode_step(params, toks[:, :1], cache,
                                torch.full((1,), 4, dtype=torch.int32), cfg)
        assert torch.isfinite(lg).all()
