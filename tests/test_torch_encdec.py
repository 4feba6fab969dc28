"""whisper-base (the ``encdec`` family) and the cache-free forward: port vs
``repro``.

* The pieces: the config, ``sinusoidal_table`` and ``make_batch``'s
  ``enc_input`` bitwise; ``layernorm`` at one f32 rounding (XLA reduces
  the mean in windows of 32 and its ``rsqrt`` differs from torch's in
  the last bit, so the two cannot agree bit for bit); the cross-attention
  projection and the unmasked einsum attention.
* The model, whisper-base smoke (2 + 2 layers, d_model 128), weights from
  the reference's ``init(PRNGKey(0))`` through numpy, f32 compute, f32
  and int8 weights: ``encode``, ``forward`` logits, ``prefill`` and 4
  ``decode_step`` logits and caches at atol 1e-4 with f32 weights (the
  reference's CPU branch runs ``_einsum_attention`` where the port runs
  the flash kernel's plain version: the same function, summed in another
  order) and at relative L2 1e-2 with int8 weights (:func:`_close_mode`);
  greedy streams from ``build_prefill_step`` + ``build_decode_loop``
  identical to the JAX builders' (batch 2, two blocks of 4).
* gemma-2b smoke ``lm.forward`` without a cache (causal, GQA 4 on 1),
  logits at atol 1e-4.
* The flash path's count: one call per encoder layer per ``encode``,
  none in a decode step.
* Refusals by name: the Engine and the CLI with whisper-base, and an
  int8 KV cache for ``encdec``.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import encdec as jenc  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.common import sinusoidal_table as j_table  # noqa: E402
from repro.nn import attention as jatt  # noqa: E402
from repro.nn.norms import layernorm as j_layernorm  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import encdec as tenc  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.common import sinusoidal_table  # noqa: E402
from repro_torch.nn import attention as tatt  # noqa: E402
from repro_torch.nn.norms import layernorm  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

from torch_parity import contexts, smoke_params  # noqa: E402

ATOL = 1e-4
B, ENC, PLEN, MAX_LEN, STEPS, BLOCKS = 2, 24, 6, 16, 4, 2


@functools.lru_cache(maxsize=None)
def _whisper(mode: str):
    return smoke_params(mode, arch="whisper-base")


def _batch(cfg):
    """(JAX batch, port batch): a PLEN-token prompt and ENC stub encoder
    frames from the reference's ``make_batch``."""
    nb = jpipe.make_batch(cfg, 0, B, ENC)
    nb = {"tokens": nb["tokens"][:, :PLEN], "enc_input": nb["enc_input"]}
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _close(got: torch.Tensor, want, atol=ATOL) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


#: int8 weights: relative L2 error of a model output (see _close_mode)
INT8_REL = 1e-2


def _close_mode(got: torch.Tensor, want, mode: str) -> None:
    """f32 weights: atol 1e-4.  int8 weights: every projection quantizes
    its input rows to int8 on the fly, and ``layernorm`` differs from the
    reference's in the last f32 bit, so an input on a rounding boundary
    lands one int8 step away; the outputs then differ by ~0.3% (relative
    L2; max 0.017 over 2 encoder layers), the same with the einsum
    (``backend="ref"``) as with the flash path.  The gate is relative L2
    <= 1e-2; a wiring fault gives errors of order 1."""
    if mode == "none":
        _close(got, want)
        return
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert rel <= INT8_REL, f"relative L2 error {rel}"


# -- the pieces -------------------------------------------------------------
def test_config_is_the_reference_copy():
    mine = dataclasses.asdict(get_config("whisper-base"))
    ref = dataclasses.asdict(j_get_config("whisper-base"))
    assert mine == {k: ref[k] for k in mine}
    assert get_config("whisper-base").smoke().enc_layers == 2


@pytest.mark.parametrize("length,d", [(1500, 512), (24, 128), (7, 6)])
def test_sinusoidal_table_bitwise(length, d):
    np.testing.assert_array_equal(sinusoidal_table(length, d),
                                  j_table(length, d))


@pytest.mark.parametrize("arch,seq", [("whisper-base", 1500),
                                      ("whisper-base", 24),
                                      ("gemma-2b", 16)])
def test_make_batch_bitwise(arch, seq):
    cfg = get_config(arch)
    got = tpipe.make_batch(cfg, 3, 2, seq, seed=1)
    want = jpipe.make_batch(j_get_config(arch), 3, 2, seq, seed=1)
    assert sorted(got) == sorted(k for k in want if k != "img_embed")
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rs = np.random.RandomState(0)
    x = (rs.randn(3, 17, 512) * 3 + 1).astype(np.float32)
    p = {"scale": rs.randn(512).astype(np.float32),
         "bias": rs.randn(512).astype(np.float32)}
    want = j_layernorm({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x).astype(dtype))
    got = layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        # one rounding of the statistics: a few f32 ulps of |y| <= ~10
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=4e-6)
    else:
        # both round f32 values a few ulps apart to bf16: one bf16 ulp
        a = np.maximum(np.abs(want), 2.0 ** -126)
        ulp = np.exp2(np.floor(np.log2(a)) - 7)
        assert (np.abs(got - want) <= ulp).all()


def test_cross_projection_and_unmasked_attention():
    cfg, jp, tp = _whisper("none")
    jctx, tctx = contexts("none")
    dims_j = j_get_config("whisper-base").smoke().attn_dims(causal=False)
    dims_t = cfg.attn_dims(causal=False)
    rs = np.random.RandomState(2)
    enc = rs.randn(B, ENC, cfg.d_model).astype(np.float32)
    p_j = jax.tree_util.tree_map(lambda a: a[0], jp["decoder"]["cross"])
    p_t = {k: {"w": v["w"][0]} for k, v in tp["decoder"]["cross"].items()}
    jk, jv = jatt.gqa_project_kv(p_j, jnp.asarray(enc), dims_j, jctx)
    tk, tv = tatt.gqa_project_kv(p_t, torch.from_numpy(enc), dims_t, tctx)
    _close(tk, jk, 1e-5)
    _close(tv, jv, 1e-5)
    q = rs.randn(B, 4, 5, 32).astype(np.float32)
    want = jatt._einsum_attention(jnp.asarray(q), jk, jv, causal=False,
                                  ctx=jctx)
    got = tatt._einsum_attention(torch.from_numpy(q), tk, tv, ctx=tctx)
    _close(got, want, 1e-5)


# -- the model ----------------------------------------------------------------
@pytest.mark.parametrize("mode", ["none", "int8"])
def test_encode_and_forward_match_reference(mode):
    cfg, jp, tp = _whisper(mode)
    jctx, tctx = contexts(mode)
    jb, tb = _batch(cfg)
    jcfg = j_get_config("whisper-base").smoke()
    _close_mode(tenc.encode(tp, tb["enc_input"], cfg, tctx),
                jenc.encode(jp, jb["enc_input"], jcfg, jctx), mode)
    got = tenc.forward(tp, tb, cfg, tctx)
    assert got.shape == (B, PLEN, cfg.vocab)
    _close_mode(got, jenc.forward(jp, jb, jcfg, jctx), mode)


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_prefill_and_decode_steps_match_reference(mode):
    cfg, jp, tp = _whisper(mode)
    jcfg = j_get_config("whisper-base").smoke()
    jctx, tctx = contexts(mode)
    jb, tb = _batch(cfg)
    jcache = jenc.init_cache(jcfg, B, MAX_LEN, jnp.float32)
    tcache = tenc.init_cache(cfg, B, MAX_LEN, torch.float32, device="cpu")
    assert tuple(tcache["cross_kv"]["k"].shape) == jcache["cross_kv"][0].shape
    jl, jcache = jenc.prefill(jp, jb, jcache, jcfg, jctx, full_logits=True)
    tl, tcache = tenc.prefill(tp, tb, tcache, cfg, tctx, full_logits=True)
    _close_mode(tl, jl, mode)
    # the cross K/V are replaced at the encoder's actual length
    assert tcache["cross_kv"]["k"].shape[3] == ENC
    for i, name in enumerate(("k", "v")):
        _close_mode(tcache["cross_kv"][name], jcache["cross_kv"][i], mode)
    pos = np.full((B,), PLEN, np.int32)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    for _ in range(STEPS):
        jl, jcache = jenc.decode_step(jp, jnp.asarray(tok), jcache,
                                      jnp.asarray(pos), jcfg, jctx)
        tl, tcache = tenc.decode_step(tp, torch.from_numpy(tok), tcache,
                                      torch.from_numpy(pos), cfg, tctx)
        _close_mode(tl, jl, mode)
        pos = pos + 1
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    for name in ("k", "v"):
        _close_mode(tcache["layers"]["self"][name],
                    jcache["layers"]["self"][name], mode)
    # invalidate zeroes one slot of every leaf, as the reference does
    jcache = japi.invalidate_fn(jcache, 1, jcfg)
    tcache = tapi.invalidate_fn(tcache, 1, cfg)
    for name in ("k", "v"):
        assert not tcache["layers"]["self"][name][:, 1].any()
        assert not np.asarray(jcache["layers"]["self"][name][:, 1]).any()
        _close_mode(tcache["layers"]["self"][name],
                    jcache["layers"]["self"][name], mode)
        assert not tcache["cross_kv"][name][:, 1].any()


def _streams_jax(cfg, ctx, params, batch):
    prefill = jstep.build_prefill_step(cfg, ctx)
    loop = jstep.build_decode_loop(cfg, ctx, STEPS)
    cache = jenc.init_cache(cfg, B, MAX_LEN, jnp.float32)
    logits, cache = prefill(params, batch, cache)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    pos = jnp.full((B,), PLEN, jnp.int32)
    live = jnp.ones((B,), bool)
    stop = jnp.full((B,), PLEN + STEPS * BLOCKS, jnp.int32)
    sp = {"temperature": jnp.zeros((B,), jnp.float32),
          "top_k": jnp.zeros((B,), jnp.int32)}
    out = []
    for i in range(BLOCKS):
        cache, tok, pos, live, bt, _, fault = loop(params, cache, tok, pos,
                                                   live, stop, sp, None,
                                                   i * STEPS, -1)
        assert not np.asarray(fault).any()
        out.append(np.asarray(bt))
    return np.concatenate(out).T


def _streams_torch(cfg, ctx, params, batch):
    prefill = tstep.build_prefill_step(cfg, ctx)
    loop = tstep.build_decode_loop(cfg, ctx, STEPS)
    cache = tapi.init_cache_fn(cfg, B, MAX_LEN, torch.float32, device="cpu")
    logits, cache = prefill(params, batch, cache)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = torch.full((B,), PLEN, dtype=torch.int32)
    live = torch.ones((B,), dtype=torch.bool)
    stop = torch.full((B,), PLEN + STEPS * BLOCKS, dtype=torch.int32)
    sp = {"temperature": torch.zeros((B,), dtype=torch.float32),
          "top_k": torch.zeros((B,), dtype=torch.int32)}
    out = []
    for i in range(BLOCKS):
        cache, tok, pos, live, bt, _, fault = loop(params, cache, tok, pos,
                                                   live, stop, sp, None,
                                                   i * STEPS, -1)
        assert not fault.any()
        out.append(bt.numpy())
    return np.concatenate(out).T


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_greedy_streams_from_the_step_builders_match(mode):
    cfg, jp, tp = _whisper(mode)
    jctx, tctx = contexts(mode)
    jb, tb = _batch(cfg)
    want = _streams_jax(j_get_config("whisper-base").smoke(), jctx, jp, jb)
    got = _streams_torch(cfg, tctx, tp, tb)
    assert got.shape == (B, STEPS * BLOCKS)
    np.testing.assert_array_equal(got, want)


def test_flash_path_runs_once_per_encoder_layer(monkeypatch):
    """On the CPU the wrapper runs its plain version: count those calls.
    The encoder's layers take the flash path; the decoder attends over
    its caches (the dense self-cache, the cached cross K/V)."""
    cfg, _, tp = _whisper("none")
    _, tctx = contexts("none")
    _, tb = _batch(cfg)
    calls = []
    plain = tflash.flash_attention_plain

    def counted(*a, **kw):
        calls.append(kw["causal"])
        return plain(*a, **kw)

    monkeypatch.setattr(tflash, "flash_attention_plain", counted)
    cache = tenc.init_cache(cfg, B, MAX_LEN, torch.float32, device="cpu")
    _, cache = tenc.prefill(tp, tb, cache, cfg, tctx)
    assert calls == [False] * cfg.enc_layers
    tenc.decode_step(tp, tb["tokens"][:, :1], cache,
                     torch.full((B,), PLEN, dtype=torch.int32), cfg, tctx)
    assert len(calls) == cfg.enc_layers
    # the cache-free forward: encoder, then per decoder layer causal self-
    # and non-causal cross-attention
    tenc.forward(tp, tb, cfg, tctx)
    assert calls[cfg.enc_layers:] == ([False] * cfg.enc_layers
                                      + [True, False] * cfg.n_layers)


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_gemma_cache_free_forward_matches_reference(mode):
    cfg, jp, tp = smoke_params(mode)
    jctx, tctx = contexts(mode)
    src = tpipe.SyntheticLM(cfg.vocab, seed=0)
    tokens = src.tokens(0, 2, 12)[:, :-1].astype(np.int32)
    want, _, _ = jlm.forward(jp, jnp.asarray(tokens),
                             j_get_config("gemma-2b").smoke(), jctx)
    got, cache, _ = tlm.forward(tp, torch.from_numpy(tokens), cfg, tctx)
    assert cache is None
    _close(got, want)


# -- refusals ------------------------------------------------------------
def test_engine_and_cli_refuse_whisper(capsys):
    from repro_torch.launch import serve
    cfg, _, tp = _whisper("none")
    _, tctx = contexts("none")
    with pytest.raises(NotImplementedError, match="encdec"):
        serve.Engine(cfg, tctx, tp, batch=2, max_len=16, device="cpu")
    with pytest.raises(SystemExit):
        serve.main(["--arch", "whisper-base", "--smoke", "--device", "cpu"])
    assert "encdec" in capsys.readouterr().err


def test_int8_kv_cache_refused_for_encdec():
    cfg = get_config("whisper-base").smoke()
    with pytest.raises(NotImplementedError, match="int8"):
        tenc.init_cache(cfg, 2, 16, torch.int8, device="cpu")
    with pytest.raises(NotImplementedError, match="paged"):
        tapi.init_paged_cache_fn(cfg, 2, 8, 4, 4)
