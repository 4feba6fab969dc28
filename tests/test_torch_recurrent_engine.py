"""The recurrent families served by the port's Engine, held against the
JAX Engine: mamba2-370m (``ssm``) and zamba2-1.2b (``hybrid``) smoke.

* Greedy streams of the port's CPU Engine against ``torch_parity.
  serve_jax`` (batch 2, pages of 4, three prompts of 13, a lane refilled
  mid-flight), f32 and int8 weights, dense and paged caches:
  byte-identical.  Both engines take the looped prefill (one full-batch
  decode step per prompt token, the other lanes put back after each
  slot's loop).
* The port's own invariants: n-gram speculation and a recurrent draft
  model (per-position state checkpoints, rolled back per lane) give the
  plain streams; a hybrid lane preempted to the host and resumed gives
  the uninterrupted stream, bitwise; a recycled lane starts clean;
  ``prefix_cache=True`` is accepted and inert; invalidation zeroes a
  hybrid's dense SSM lane beside its paged attention pages; and the cache
  tensors keep their addresses across prefill, decode, a speculative
  round, invalidation, preemption and resumption.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (ENGINE_GEN, ENGINE_KW, contexts,  # noqa: E402
                          drain, engine_prompts, rand_prompts, serve_jax,
                          serve_torch, smoke_params)
# every reference Engine of the module reuses the XLA executables of
# the ones before it (torch_parity.reuse_xla_executables)
from torch_parity import reuse_executables  # noqa: E402,F401

from repro_torch.launch.serve import Engine  # noqa: E402
from repro_torch.models.api import (invalidate_fn,  # noqa: E402
                                    lane_leaves_fn)
from repro_torch.train.graphs import _addresses  # noqa: E402

ARCHS = ["mamba2-370m", "zamba2-1.2b"]

_PARAMS = {}
_PLAIN = {}


def _params(arch, mode):
    if (arch, mode) not in _PARAMS:
        _PARAMS[arch, mode] = smoke_params(mode, arch=arch)
    return _PARAMS[arch, mode]


def _streams(got):
    return [list(map(int, t)) for t in got]


def _plain(arch, mode="none", paged=True):
    """The port's plain greedy streams (``ENGINE_KW``), memoized."""
    if (arch, mode, paged) not in _PLAIN:
        cfg, _, tparams = _params(arch, mode)
        _, tctx = contexts(mode)
        got, _ = serve_torch(cfg, tctx, tparams, engine_prompts(cfg.vocab),
                             dict(paged=paged))
        _PLAIN[arch, mode, paged] = _streams(got)
    return _PLAIN[arch, mode, paged]


@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["none", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_match_jax_engine(arch, mode, cache):
    cfg, jparams, _ = _params(arch, mode)
    jctx, _ = contexts(mode)
    kw = dict(paged=cache == "paged")
    want, jeng = serve_jax(cfg, jctx, jparams, engine_prompts(cfg.vocab), kw)
    assert _plain(arch, mode, cache == "paged") == _streams(want)
    assert jeng.counters["gen_tokens"] == 3 * ENGINE_GEN


def _engine(arch, mode="none", **kw):
    cfg, _, tparams = _params(arch, mode)
    _, tctx = contexts(mode)
    return Engine(cfg, tctx, tparams, device="cpu", **{**ENGINE_KW, **kw})


def _serve(eng, prompts, block=4):
    ids = [eng.submit(p, gen_len=ENGINE_GEN) for p in prompts]
    eng.try_admit()
    drain(eng, block)
    return [eng.results[i]["tokens"] for i in ids]


@pytest.mark.parametrize("arch", ARCHS)
def test_ngram_spec_streams_equal_plain(arch):
    """Prompt-lookup speculation (k 3) on tiled prompts, whose drafts are
    accepted, and on the parity prompts: the plain streams."""
    cfg, _, _ = _params(arch, "none")
    eng = _engine(arch, spec=True, spec_k=3)
    got = _serve(eng, engine_prompts(cfg.vocab))
    assert _streams(got) == _plain(arch)
    assert eng.counters["verify_steps"] > 0
    tiled = [np.tile(p[:4], 4)[:13] for p in engine_prompts(cfg.vocab)]
    spec = _serve(_engine(arch, spec=True, spec_k=3), tiled)
    plain = _serve(_engine(arch), tiled)
    assert _streams(spec) == _streams(plain)


@pytest.mark.parametrize("arch,draft", [("zamba2-1.2b", "mamba2-370m"),
                                        ("mamba2-370m", "mamba2-370m")],
                         ids=["zamba2-by-mamba2", "mamba2-by-itself"])
def test_recurrent_model_drafter_streams_equal_plain(arch, draft):
    """A recurrent draft model (its own dense state, looped prefill,
    per-position checkpoints rolled back per lane): the plain streams;
    the target as its own drafter accepts every draft."""
    cfg, _, _ = _params(arch, "none")
    dcfg, _, dparams = _params(draft, "none")
    eng = _engine(arch, spec=True, spec_k=3, spec_draft=(dcfg, dparams,
                                                         None))
    got = _serve(eng, engine_prompts(cfg.vocab))
    assert _streams(got) == _plain(arch)
    if arch == draft:
        # every draft accepted: 7 tokens after the first in 2 rounds each
        assert eng.counters["verify_steps"] == 3 * 2


def test_preempted_hybrid_lane_resumes_bitwise():
    """zamba2, three lanes over a pool of 9 pages, less than the three
    budgets: a lane is spilled (its pages and its SSM lane to the host)
    and resumed; every stream is the uninterrupted one, bitwise."""
    cfg, _, _ = _params("zamba2-1.2b", "none")
    prompts = rand_prompts(cfg.vocab, (9, 7, 11, 5), seed=3)
    eng = _engine("zamba2-1.2b", batch=3, preempt=True, preempt_after=1,
                  num_pages=9)
    got = _serve(eng, prompts, block=2)
    assert eng.counters["preemptions"] > 0
    ref = _serve(_engine("zamba2-1.2b", batch=3), prompts, block=2)
    assert _streams(got) == _streams(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_recycled_lane_and_inert_prefix_cache(arch):
    """One lane serves three requests in turn (a dirty lane is zeroed at
    admission), each equal to its solo stream; ``prefix_cache=True`` is
    accepted and inert (no hits, the same streams)."""
    cfg, _, _ = _params(arch, "none")
    prompts = engine_prompts(cfg.vocab)
    one = _serve(_engine(arch, batch=1), prompts)
    solo = [_serve(_engine(arch, batch=1), [p])[0] for p in prompts[1:]]
    assert _streams(one[1:]) == _streams(solo)
    eng = _engine(arch, prefix_cache=True)
    assert not eng.prefix_cache
    got = _serve(eng, prompts + prompts[:1])
    assert _streams(got[:3]) == _plain(arch)
    assert eng.counters["prefix_hits"] == 0


def test_invalidate_zeroes_the_hybrids_paged_ssm_lane():
    """The paged hybrid cache keeps dense SSM lanes: ``invalidate_fn``
    zeroes one slot's lane in every group and tail layer and leaves the
    other lane and the attention pages as they were."""
    cfg, _, _ = _params("zamba2-1.2b", "none")
    eng = _engine("zamba2-1.2b")
    for p in engine_prompts(cfg.vocab)[:2]:
        eng.submit(p, gen_len=ENGINE_GEN)
    eng.try_admit()
    eng.step_many(2)
    lanes = lane_leaves_fn(eng.cache, cfg)
    assert lanes and all(t.select(ax, 0).abs().sum() > 0
                         for t, ax in lanes)
    pages = eng.cache["attn"]["pages"]["k"].clone()
    other = [t.select(ax, 1).clone() for t, ax in lanes]
    invalidate_fn(eng.cache, 0, cfg)
    assert all(t.select(ax, 0).abs().sum() == 0 for t, ax in lanes)
    assert all(torch.equal(t.select(ax, 1), o)
               for (t, ax), o in zip(lanes, other))
    assert torch.equal(eng.cache["attn"]["pages"]["k"], pages)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_edits_keep_tensor_addresses(arch):
    """Prefill, decode, a speculative round, invalidation, preemption and
    resumption write the cache in place (captured graphs stay valid)."""
    cfg, _, _ = _params(arch, "none")
    prompts = rand_prompts(cfg.vocab, (9, 7, 11), seed=5)
    eng = _engine(arch, batch=3, spec=True, spec_k=3, preempt=True,
                  preempt_after=1, num_pages=9)
    addrs = _addresses(eng.cache)
    for p in prompts:
        eng.submit(p, gen_len=ENGINE_GEN)
    eng.try_admit()
    assert _addresses(eng.cache) == addrs
    drain(eng, 2)
    assert eng.counters["verify_steps"] > 0
    assert eng.counters["preemptions"] > 0
    invalidate_fn(eng.cache, 0, cfg)
    assert _addresses(eng.cache) == addrs
