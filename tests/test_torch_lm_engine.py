"""The rest of the ``lm`` family served by the port's Engine, held against
the JAX Engine.

Greedy streams of the port's CPU Engine against ``torch_parity.
serve_jax`` (batch 2, pages of 4, prefill chunk 5, three prompts, a lane
refilled mid-flight) for yi-6b, glm4-9b, command-r-35b, olmoe-1b-7b and
deepseek-v2-236b smoke, f32 and int8 weights, dense and paged caches:
byte-identical.  On the MoE configs (deepseek with MLA's latent pages,
which have no head axis) also n-gram speculation (k 3, paged), the
prefix cache with a copy-on-write of the boundary page, preempt-and-spill
of sharers, and a snapshot restored mid-run: streams and counters equal
the JAX Engine's, and the port's own cold streams.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (auto_mesh, contexts, drain,  # noqa: E402
                          engine_prompts, lifecycle_makers, rand_prompts,
                          serve_engine, serve_jax, serve_torch,
                          shared_prompts, smoke_params)
# every reference Engine of the module reuses the XLA executables of
# the ones before it (torch_parity.reuse_xla_executables)
from torch_parity import reuse_executables  # noqa: E402,F401

from repro.dist.constrain import use_mesh  # noqa: E402

ARCHS = ["yi-6b", "glm4-9b", "command-r-35b", "olmoe-1b-7b",
         "deepseek-v2-236b"]
MOE_ARCHS = ["olmoe-1b-7b", "deepseek-v2-236b"]
GEOM = dict(paged=True, page_size=4, prefill_chunk=5)

_PARAMS = {}


def _params(arch, mode):
    if (arch, mode) not in _PARAMS:
        _PARAMS[arch, mode] = smoke_params(mode, arch=arch)
    return _PARAMS[arch, mode]


@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["none", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_match_jax_engine(arch, mode, cache):
    cfg, jparams, tparams = _params(arch, mode)
    jctx, tctx = contexts(mode)
    prompts = engine_prompts(cfg.vocab)
    kw = dict(paged=cache == "paged")
    want, jeng = serve_jax(cfg, jctx, jparams, prompts, kw)
    got, teng = serve_torch(cfg, tctx, tparams, prompts, kw)
    assert [list(map(int, t)) for t in got] \
        == [list(map(int, t)) for t in want]
    for k in ("gen_tokens", "admitted", "peak_live"):
        assert teng.counters[k] == jeng.counters[k], k
    if cache == "paged":
        assert (teng.kv_split, teng.pages_per_step) \
            == (jeng.kv_split, jeng.pages_per_step)


def _tiled(vocab, seed):
    """Prompts that repeat a short motif: the n-gram drafter proposes
    (and the target accepts) some of its drafts."""
    rs = np.random.RandomState(seed)
    return [np.tile(rs.randint(0, vocab, (n,)), 4)[:13] for n in (3, 4, 5)]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ngram_spec_matches_jax_and_plain(arch):
    cfg, make = lifecycle_makers("none", arch)
    prompts = _tiled(cfg.vocab, 1)
    kw = dict(GEOM, max_len=32, gen_len=8, spec=True, spec_k=3)
    with use_mesh(auto_mesh()):
        jspec = serve_engine(make["jax"], prompts, **kw)
    spec = serve_engine(make["torch"], prompts, **kw)
    plain = serve_engine(make["torch"], prompts, **dict(kw, spec=False))
    assert spec.done == jspec.done
    # requests finish in another order under speculation
    assert sorted(spec.done) == sorted(plain.done)
    for k in ("verify_steps", "draft_accepted", "gen_tokens"):
        assert spec.counters[k] == jspec.counters[k], k
    assert spec.counters["verify_steps"] > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefix_cache_copy_on_write_matches_jax(arch):
    """An exact repeat of an indexed prompt hits every page and copies
    the boundary page (every page-pool leaf, the latent's too)."""
    cfg, make = lifecycle_makers("none", arch)
    prompt = rand_prompts(cfg.vocab, (8,), seed=3)[0]
    kw = dict(GEOM, batch=1, max_len=24)
    with use_mesh(auto_mesh()):
        jwarm = serve_engine(make["jax"], [prompt, prompt],
                             prefix_cache=True, **kw)
    warm = serve_engine(make["torch"], [prompt, prompt], prefix_cache=True,
                        **kw)
    cold = serve_engine(make["torch"], [prompt, prompt], **kw)
    assert warm.done == jwarm.done == cold.done
    assert warm.counters["prefix_hits"] == jwarm.counters["prefix_hits"] == 1
    assert warm.counters["cow_copies"] == jwarm.counters["cow_copies"] == 1
    assert warm.allocator.state() == jwarm.allocator.state()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_preempt_and_spill_matches_jax(arch):
    """Batch 3 over 9 pages: sharers are spilled to the host and resumed
    on private pages; the streams stay the cold ones."""
    cfg, make = lifecycle_makers("int8", arch)
    prompts = shared_prompts(cfg.vocab, 8, (2, 3, 4), seed=7)
    kw = dict(GEOM, batch=3, max_len=24, gen_len=8, prefix_cache=True,
              preempt=True, preempt_after=1, num_pages=9)
    with use_mesh(auto_mesh()):
        jwarm = serve_engine(make["jax"], prompts, **kw)
    warm = serve_engine(make["torch"], prompts, **kw)
    cold = serve_engine(make["torch"], prompts, **dict(
        kw, prefix_cache=False, preempt=False, num_pages=None))
    assert warm.done == jwarm.done
    assert sorted(warm.done) == sorted(cold.done)
    for k in ("preemptions", "spilled_pages", "prefix_hits", "cow_copies"):
        assert warm.counters[k] == jwarm.counters[k], k
    assert warm.counters["preemptions"] > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_snapshot_restore_round_trips_pages(arch):
    """A snapshot taken mid-run and restored after the run diverged
    gives the uninterrupted streams (every page leaf written back)."""
    cfg, make = lifecycle_makers("none", arch)
    prompts = rand_prompts(cfg.vocab, (7, 9, 5), seed=2)
    kw = dict(GEOM, batch=2, max_len=24)
    ref = serve_engine(make["torch"], prompts, gen_len=6, **kw)
    eng = make["torch"](**kw)
    for p in prompts:
        eng.submit(p, gen_len=6)
    eng.try_admit()
    eng.step_many(2)
    snap = eng.snapshot()
    eng.step_many(4)
    eng.restore(snap)
    drain(eng)
    assert eng.done == ref.done
