"""llama-3.2-vision-11b (the ``vlm`` family) on the port, held against
``repro.models.vlm`` from the same weights (the reference's init,
converted through numpy), smoke size: 4 layers in 2 groups of one self
layer and one gated cross layer, 16 image tokens, 4 heads on 1 KV head.
The gates are drawn nonzero from a seed on both sides
(``torch_parity.vlm_smoke_params``): at the reference's init they are 0
and the cross layers add nothing.

* The config, its smoke reduction and parameter counts equal the
  reference's; ``make_batch``'s ``img_embed`` is bitwise.
* ``cross_block_apply`` (text-only: the text attends to itself,
  non-causally, with RoPE) and ``_cross_with_cached`` (K/V projected from
  the image), f32 and int8 weights.
* ``forward`` with the image and text-only: every unit's output (each self
  layer and each cross block fed the reference's input of that unit) and
  the logits.  f32 within a relative L2 error of 1e-5; int8 within 1e-3
  (a norm's last-bit difference can move one activation code; at this
  seed none moves, and int8 agrees within 1e-6).
* ``prefill`` and 3 ``decode_step``s: logits, the self rows and the cross
  K/V the cache holds, at those tolerances; prefill(S) + decode(k) ==
  prefill(S + k) (the reference's ``test_serving_chunked_vs_monolithic``
  for the VLM); the cache's tensors keep their addresses (the cross K/V
  are copied into the cache's own buffers); one slot invalidated.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import vlm as jvlm  # noqa: E402
from repro.nn import attention as jatt  # noqa: E402
from repro.nn import blocks as jblocks  # noqa: E402
from repro.nn.embedding import embed as j_embed  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import vlm as tvlm  # noqa: E402
from repro_torch.nn import attention as tatt  # noqa: E402
from repro_torch.nn import blocks as tblocks  # noqa: E402
from repro_torch.nn.embedding import embed as t_embed  # noqa: E402
from repro_torch.train.graphs import _addresses  # noqa: E402

from torch_parity import contexts, vlm_smoke_params  # noqa: E402

ARCH = "llama-3.2-vision-11b"
F32_REL_L2 = 1e-5
INT8_REL_L2 = 1e-3
B, PLEN, STEPS, MAX_LEN = 2, 6, 3, 16
MODES = ["none", "int8"]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close(got, want, mode, what):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    err = _rel(got, want)
    tol = F32_REL_L2 if mode == "none" else INT8_REL_L2
    assert err <= tol, f"{what}: relative L2 error {err} > {tol}"


def _batch(cfg, seq=PLEN):
    """(JAX batch, port batch): a ``seq``-token prompt and the stub image
    from the reference's ``make_batch``."""
    nb = jpipe.make_batch(cfg, 0, B, seq)
    nb = {"tokens": nb["tokens"], "img_embed": nb["img_embed"]}
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _jslice(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


# -- the pieces -------------------------------------------------------------
def test_config_and_parameter_counts_are_the_reference_copy():
    for cfg, ref in ((get_config(ARCH), j_config(ARCH)),
                     (get_config(ARCH).smoke(), j_config(ARCH).smoke())):
        mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(ref)
        assert mine == {k: theirs[k] for k in mine}
        for count in ("n_params", "active_params", "flop_params"):
            assert getattr(cfg, count)() == getattr(ref, count)()
    cfg = get_config(ARCH)
    assert tvlm._group_structure(cfg) == (8, 4)
    # the tied unembedding: no head counted (hazard of the reference's
    # ``tie_embeddings=False``)
    assert not cfg.tie_embeddings
    assert cfg.n_params() - cfg.flop_params() == cfg.vocab * cfg.d_model


@pytest.mark.parametrize("smoke,seq", [(False, 3), (True, 9)])
def test_make_batch_img_embed_bitwise(smoke, seq):
    cfg, ref = get_config(ARCH), j_config(ARCH)
    if smoke:
        cfg, ref = cfg.smoke(), ref.smoke()
    got = tpipe.make_batch(cfg, 2, 2, seq, seed=3)
    want = jpipe.make_batch(ref, 2, 2, seq, seed=3)
    assert sorted(got) == sorted(want)
    assert got["img_embed"].shape == (2, cfg.n_img_tokens, cfg.d_model)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_init_shapes_match_the_reference():
    cfg, jp, _ = vlm_smoke_params("none")
    mine = tvlm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    flat_j = {jax.tree_util.keystr(p): np.shape(a) for p, a in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in
              jax.tree_util.tree_flatten_with_path(mine)[0]}
    assert flat_t == flat_j
    # the gates start at 0, as the reference's
    assert not mine["cross"]["gate_attn"].any()
    assert not mine["cross"]["gate_mlp"].any()


@pytest.mark.parametrize("mode", MODES)
def test_cross_blocks_match_reference(mode):
    """Text-only ``cross_block_apply`` (self-attention of the text, non-
    causal, RoPE) and ``_cross_with_cached`` on K/V projected from the
    image, group 1's block."""
    cfg, jp, tp = vlm_smoke_params(mode)
    jctx, tctx = contexts(mode)
    rs = np.random.RandomState(4)
    x = rs.randn(B, PLEN, cfg.d_model).astype(np.float32)
    img = (rs.randn(B, cfg.n_img_tokens, cfg.d_model) * 0.5).astype(
        np.float32)
    pj, pt = _jslice(jp["cross"], 1), tblocks.layer_slice(tp["cross"], 1)
    want = jblocks.cross_block_apply(pj, jnp.asarray(x), None, cfg, jctx)
    got = tblocks.cross_block_apply(pt, torch.from_numpy(x), None, cfg, tctx)
    _close(got, want, mode, "cross_block_apply, text-only")
    dims = cfg.attn_dims(causal=False)
    jkv = jatt.gqa_project_kv(pj["attn"], jnp.asarray(img), dims, jctx)
    tkv = tatt.gqa_project_kv(pt["attn"], torch.from_numpy(img), dims, tctx)
    for a, b in zip(tkv, jkv):
        _close(a, b, mode, "image K/V")
    want = jvlm._cross_with_cached(pj, jnp.asarray(x), jkv, cfg, jctx)
    got = tvlm._cross_with_cached(pt, torch.from_numpy(x), tkv, cfg, tctx)
    _close(got, want, mode, "_cross_with_cached")
    # the gates act: the block differs from its ungated self
    ungated = {k: v for k, v in pt.items() if not k.startswith("gate")}
    plain = tblocks.cross_block_apply(ungated, torch.from_numpy(x), None,
                                      cfg, tctx)
    assert _rel(plain.numpy(), np.asarray(
        jblocks.cross_block_apply(pj, jnp.asarray(x), None, cfg,
                                  jctx))) > 1e-2


# -- the model ----------------------------------------------------------------
def _units_jax(params, x, img, cfg, ctx):
    """(input, output) of every unit of the reference's cache-free
    forward: each self layer, then the group's cross block."""
    n_groups, k_self = jvlm._group_structure(cfg)
    ins, outs = [], []
    for g in range(n_groups):
        for l in range(k_self):
            ins.append(np.array(x))
            x, _ = jblocks.dense_block_apply(
                _jslice(_jslice(params["groups"], g), l), x, cfg, ctx)
            outs.append(np.asarray(x))
        p_x = _jslice(params["cross"], g)
        ins.append(np.array(x))
        if img is None:
            x = jblocks.cross_block_apply(p_x, x, None, cfg, ctx)
        else:
            kv = jatt.gqa_project_kv(p_x["attn"], img,
                                     cfg.attn_dims(causal=False), ctx)
            x = jvlm._cross_with_cached(p_x, x, kv, cfg, ctx)
        outs.append(np.asarray(x))
    return ins, outs


def _units_torch(params, ins, img, cfg, ctx):
    """Every unit of the port fed the reference's input of that unit (an
    int8 projection turns a last-bit difference of its input into a code
    step, which later units would carry on)."""
    n_groups, k_self = tvlm._group_structure(cfg)
    outs = []
    for g in range(n_groups):
        for l in range(k_self):
            x = torch.from_numpy(ins[len(outs)])
            x, _ = tblocks.dense_block_apply(tblocks.layer_slice(
                tblocks.layer_slice(params["groups"], g), l), x, cfg, ctx)
            outs.append(x.numpy())
        p_x = tblocks.layer_slice(params["cross"], g)
        x = torch.from_numpy(ins[len(outs)])
        if img is None:
            x = tblocks.cross_block_apply(p_x, x, None, cfg, ctx)
        else:
            kv = tatt.gqa_project_kv(p_x["attn"], img,
                                     cfg.attn_dims(causal=False), ctx)
            x = tvlm._cross_with_cached(p_x, x, kv, cfg, ctx)
        outs.append(x.numpy())
    return outs


@pytest.mark.parametrize("image", [True, False], ids=["image", "text-only"])
@pytest.mark.parametrize("mode", MODES)
def test_forward_units_and_logits_match_reference(mode, image):
    cfg, jp, tp = vlm_smoke_params(mode)
    jctx, tctx = contexts(mode)
    jb, tb = _batch(cfg)
    jimg = jb["img_embed"] if image else None
    timg = tb["img_embed"] if image else None
    x0 = j_embed(jp["embed"], jb["tokens"], jctx)
    np.testing.assert_array_equal(
        t_embed(tp["embed"], tb["tokens"], tctx).numpy(), np.asarray(x0))
    ins, want = _units_jax(jp, x0, jimg, cfg, jctx)
    got = _units_torch(tp, ins, timg, cfg, tctx)
    assert len(got) == cfg.n_layers
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, mode, f"unit {i}")
    jl, _ = jvlm.forward(jp, jb["tokens"], jimg, cfg, jctx)
    tl, cache = tvlm.forward(tp, tb["tokens"], timg, cfg, tctx)
    assert cache is None and tl.shape == (B, PLEN, cfg.vocab)
    _close(tl, jl, mode, "logits")


def _prefill_decode(mode):
    """Logits and caches of the reference's and the port's prefill, then
    STEPS decode steps on the reference's greedy tokens."""
    cfg, jp, tp = vlm_smoke_params(mode)
    jctx, tctx = contexts(mode)
    jb, tb = _batch(cfg)
    jcache = jvlm.init_cache(cfg, B, MAX_LEN, jnp.float32)
    tcache = tvlm.init_cache(cfg, B, MAX_LEN, torch.float32, device="cpu")
    before = _addresses(tcache)
    jl, jcache = jvlm.prefill(jp, jb, jcache, cfg, jctx, full_logits=True)
    tl, tcache2 = tvlm.prefill(tp, tb, tcache, cfg, tctx, full_logits=True)
    assert tcache2 is tcache and _addresses(tcache) == before
    logits = [(tl, jl)]
    caches = [(tcache["cross_kv"][n].clone(), jcache["cross_kv"][i])
              for i, n in enumerate(("k", "v"))]
    pos = np.full((B,), PLEN, np.int32)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    for _ in range(STEPS):
        jl, jcache = jvlm.decode_step(jp, jnp.asarray(tok), jcache,
                                      jnp.asarray(pos), cfg, jctx)
        tl, tcache = tvlm.decode_step(tp, torch.from_numpy(tok), tcache,
                                      torch.from_numpy(pos), cfg, tctx)
        logits.append((tl, jl))
        pos = pos + 1
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    assert _addresses(tcache) == before
    caches += [(tcache["self"][n], jcache["self"][n]) for n in ("k", "v")]
    return cfg, logits, caches, tcache


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_steps_match_reference(mode):
    cfg, logits, caches, tcache = _prefill_decode(mode)
    for i, (tl, jl) in enumerate(logits):
        _close(tl, jl, mode, "prefill" if i == 0 else f"decode step {i}")
    # the cross K/V the prefill left in the cache (the image's projections,
    # every group), then the self rows after the decode steps
    for i, (t, j) in enumerate(caches):
        assert tuple(t.shape) == np.shape(j)
        _close(t, j, mode, ["cross k", "cross v", "self k", "self v"][i])
    assert tcache["cross_kv"]["k"].abs().sum() > 0
    # invalidating a slot zeroes its lanes of every leaf (the self rows'
    # batch axis is 2), and nothing of the other slot
    other = {n: t[:, :, 0].clone() for n, t in tcache["self"].items()}
    tapi.invalidate_fn(tcache, 1, cfg)
    for n in ("k", "v"):
        assert not tcache["self"][n][:, :, 1].any()
        assert not tcache["cross_kv"][n][:, 1].any()
        assert torch.equal(tcache["self"][n][:, :, 0], other[n])
        assert tcache["cross_kv"][n][:, 0].any()


@pytest.mark.parametrize("mode", MODES)
def test_serving_chunked_vs_monolithic(mode):
    """prefill(S) + decode(k) == prefill(S + k) (err < 1e-3), the
    reference's ``test_serving_chunked_vs_monolithic`` for the VLM, on
    the port; the monolithic logits also against the reference's."""
    cfg, jp, tp = vlm_smoke_params(mode)
    jctx, tctx = contexts(mode)
    k = 3
    jb, tb = _batch(cfg, PLEN + k)
    full, _ = tvlm.prefill(tp, tb, tvlm.init_cache(cfg, B, MAX_LEN,
                                                   torch.float32, "cpu"),
                           cfg, tctx, full_logits=True)
    jfull, _ = jvlm.prefill(jp, jb, jvlm.init_cache(cfg, B, MAX_LEN,
                                                    jnp.float32),
                            cfg, jctx, full_logits=True)
    _close(full, jfull, mode, "monolithic prefill")
    cache = tvlm.init_cache(cfg, B, MAX_LEN, torch.float32, device="cpu")
    head = {"tokens": tb["tokens"][:, :PLEN], "img_embed": tb["img_embed"]}
    _, cache = tvlm.prefill(tp, head, cache, cfg, tctx)
    for i in range(k):
        lg, cache = tvlm.decode_step(
            tp, tb["tokens"][:, PLEN + i:PLEN + i + 1], cache,
            torch.full((B,), PLEN + i, dtype=torch.int32), cfg, tctx)
        err = (lg[:, 0] - full[:, PLEN + i]).abs().max().item()
        assert err < 1e-3, f"decode step {i}: max abs err {err}"


def test_int8_and_paged_caches_are_refused():
    cfg = get_config(ARCH).smoke()
    with pytest.raises(NotImplementedError, match="int8"):
        tvlm.init_cache(cfg, 2, 16, torch.int8, device="cpu")
    with pytest.raises(NotImplementedError, match="int8"):
        tapi.init_cache_fn(cfg, 2, 16, torch.int8, device="cpu")
    with pytest.raises(NotImplementedError, match="paged"):
        tapi.init_paged_cache_fn(cfg, 2, 8, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="img_embed"):
        tvlm.prefill({}, {"tokens": torch.zeros((2, 3), dtype=torch.int32)},
                     None, cfg)
