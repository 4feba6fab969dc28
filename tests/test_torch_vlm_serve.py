"""llama-3.2-vision-11b served through the port's step builders, held
against the JAX step builders, smoke size with the gates nonzero on both
sides (``torch_parity.vlm_smoke_params``); and the port's refusals.

* Greedy streams of ``build_prefill_step`` (the image's cross K/V
  projected once, into the cache's own buffers) then ``build_decode_loop``
  (batch 2, two blocks of 4) are byte-identical to the JAX builders', f32
  and int8 weights; so are the streams of ``train/graphs.DecodeBlocks``
  run eagerly after the same prefill, and the prefill leaves every cache
  tensor at its address (a captured decode graph stays valid).
* The flash path's count: the cache-free forward launches it once per
  self layer (causal) and, text-only, once per cross layer (non-causal);
  a prefill and a decode step attend over the dense cache and the cached
  cross K/V, never through it.
* Refusals by name: the Engine, the CLI and ``--spec-draft`` on ``vlm``
  (the reference Engine never passes the image), a ``vlm`` draft model in
  ``build_spec_decode_loop``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import vlm as jvlm  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import vlm as tvlm  # noqa: E402
from repro_torch.train import graphs  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.graphs import _addresses  # noqa: E402

from torch_parity import contexts, smoke_params, vlm_smoke_params  # noqa: E402

B, PLEN, STEPS, BLOCKS = 2, 6, 4, 2
MAX_LEN = PLEN + STEPS * BLOCKS
MODES = ["none", "int8"]


def _batch(cfg):
    nb = jpipe.make_batch(cfg, 0, B, PLEN)
    nb = {"tokens": nb["tokens"], "img_embed": nb["img_embed"]}
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


@functools.lru_cache(maxsize=None)
def _jax_streams(mode: str) -> np.ndarray:
    """Greedy (B, STEPS * BLOCKS) streams of the JAX step builders, built
    once per module and mode."""
    cfg, jp, _ = vlm_smoke_params(mode)
    jctx, _ = contexts(mode)
    jb, _ = _batch(cfg)
    prefill = jstep.build_prefill_step(cfg, jctx)
    loop = jstep.build_decode_loop(cfg, jctx, STEPS)
    cache = jvlm.init_cache(cfg, B, MAX_LEN, jnp.float32)
    logits, cache = prefill(jp, jb, cache)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    pos = jnp.full((B,), PLEN, jnp.int32)
    live = jnp.ones((B,), bool)
    stop = jnp.full((B,), MAX_LEN, jnp.int32)
    sp = {"temperature": jnp.zeros((B,), jnp.float32),
          "top_k": jnp.zeros((B,), jnp.int32)}
    out = []
    for i in range(BLOCKS):
        cache, tok, pos, live, bt, _, fault = loop(jp, cache, tok, pos, live,
                                                   stop, sp, None,
                                                   i * STEPS, -1)
        assert not np.asarray(fault).any()
        out.append(np.asarray(bt))
    return np.concatenate(out).T


def _prefill_torch(mode):
    """The port's prefill step into a fresh dense cache: (cfg, ctx,
    params, cache, first token), the cache's addresses checked."""
    cfg, _, tp = vlm_smoke_params(mode)
    _, tctx = contexts(mode)
    _, tb = _batch(cfg)
    cache = tapi.init_cache_fn(cfg, B, MAX_LEN, torch.float32, device="cpu")
    before = _addresses(cache)
    logits, cache = tstep.build_prefill_step(cfg, tctx)(tp, tb, cache)
    assert _addresses(cache) == before
    assert cache["cross_kv"]["k"].abs().sum() > 0
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    return cfg, tctx, tp, cache, tok


@pytest.mark.parametrize("mode", MODES)
def test_greedy_streams_from_the_step_builders_match(mode):
    cfg, tctx, tp, cache, tok = _prefill_torch(mode)
    before = _addresses(cache)
    loop = tstep.build_decode_loop(cfg, tctx, STEPS)
    pos = torch.full((B,), PLEN, dtype=torch.int32)
    live = torch.ones((B,), dtype=torch.bool)
    stop = torch.full((B,), MAX_LEN, dtype=torch.int32)
    sp = {"temperature": torch.zeros((B,), dtype=torch.float32),
          "top_k": torch.zeros((B,), dtype=torch.int32)}
    out = []
    for i in range(BLOCKS):
        cache, tok, pos, live, bt, _, fault = loop(tp, cache, tok, pos, live,
                                                   stop, sp, None,
                                                   i * STEPS, -1)
        assert not fault.any()
        out.append(bt.numpy())
    assert _addresses(cache) == before
    got = np.concatenate(out).T
    assert got.shape == (B, STEPS * BLOCKS)
    np.testing.assert_array_equal(got, _jax_streams(mode))


@pytest.mark.parametrize("mode", MODES)
def test_decode_blocks_eager_streams_match(mode):
    """``DecodeBlocks`` (the graphs' static buffer, run eagerly on the CPU)
    after the prefill step gives the JAX builders' streams."""
    cfg, tctx, tp, cache, tok = _prefill_torch(mode)
    blocks = graphs.DecodeBlocks(cfg, tctx, B, "cpu", graphs=False)
    tok, pos = tok.numpy(), np.full((B,), PLEN, np.int32)
    live = np.ones((B,), bool)
    out = []
    for i in range(BLOCKS):
        state = blocks.pack(tok, pos, live, np.full((B,), MAX_LEN, np.int32),
                            np.zeros((B,), np.float32),
                            np.zeros((B,), np.int32), i * STEPS, -1)
        block, _, tok, pos, live, fault = blocks.unpack(
            blocks(tp, cache, state, None, STEPS), STEPS)
        assert not fault.any()
        out.append(block)
    np.testing.assert_array_equal(np.concatenate(out).T, _jax_streams(mode))
    assert blocks.captures == 0


def test_flash_path_counts(monkeypatch):
    """On the CPU the wrapper runs its plain version: count those calls."""
    cfg, _, tp = vlm_smoke_params("none")
    _, tctx = contexts("none")
    _, tb = _batch(cfg)
    calls = []
    plain = tflash.flash_attention_plain

    def counted(*a, **kw):
        calls.append(kw["causal"])
        return plain(*a, **kw)

    monkeypatch.setattr(tflash, "flash_attention_plain", counted)
    n_groups, k_self = tvlm._group_structure(cfg)
    tvlm.forward(tp, tb["tokens"], tb["img_embed"], cfg, tctx)
    assert calls == [True] * (n_groups * k_self)
    calls.clear()
    tvlm.forward(tp, tb["tokens"], None, cfg, tctx)
    assert calls == ([True] * k_self + [False]) * n_groups
    calls.clear()
    cache = tvlm.init_cache(cfg, B, MAX_LEN, torch.float32, device="cpu")
    _, cache = tvlm.prefill(tp, tb, cache, cfg, tctx)
    tvlm.decode_step(tp, tb["tokens"][:, :1], cache,
                     torch.full((B,), PLEN, dtype=torch.int32), cfg, tctx)
    assert calls == []


# -- refusals ------------------------------------------------------------
def test_engine_cli_and_spec_draft_refuse_the_vlm(capsys):
    from repro_torch.launch import serve
    cfg, _, tp = vlm_smoke_params("none")
    _, tctx = contexts("none")
    with pytest.raises(NotImplementedError, match="vlm family.*img_embed"):
        serve.Engine(cfg, tctx, tp, batch=2, max_len=16, device="cpu")
    with pytest.raises(SystemExit):
        serve.main(["--arch", "llama-3.2-vision-11b", "--smoke", "--device",
                    "cpu"])
    assert "vlm family" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                    "--spec-draft", "llama-3.2-vision-11b"])
    assert "cannot draft" in capsys.readouterr().err
    gcfg, _, gp = smoke_params("none")
    assert gcfg.vocab == cfg.vocab
    with pytest.raises(NotImplementedError, match="vlm family"):
        serve.Engine(gcfg, tctx, gp, batch=2, max_len=16, device="cpu",
                     spec=True, spec_draft=(cfg, tp, None))
    with pytest.raises(NotImplementedError, match="vlm model cannot draft"):
        tstep.build_spec_decode_loop(gcfg, tctx, 2, 3, drafter="model",
                                     draft_cfg=cfg)
