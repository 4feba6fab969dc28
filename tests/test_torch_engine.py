"""Engine parity: the port's ``Engine(device="cpu")`` serves the same greedy
streams as the JAX ``Engine`` on gemma-2b smoke, paged, ``none`` and
``int8``, batch 2 with three requests (so a lane is refilled mid-flight),
at the auto knobs, at ``(1, 1)`` and at an explicit split; the resolved
knobs are equal too.  With the paper's tables (``use_lut``) the paged f32
cache still attends through the paged kernel with the exact softmax, so
the reference runs its paged kernel too (``force_paged_kernel``, interpret
mode).  Greedy streams are compared exactly, never loosened.  The dense
and int8 KV caches' cells are in ``tests/test_torch_dense_cache.py``.

Sampled streams (temperature 0.8, ``top_k`` 0 and 5, and a batch that
mixes greedy and sampled requests; f32 and int8 weights; paged and dense)
equal the JAX Engine's from the same seed, or first part where the
perturbed logits' top-2 margin is below MARGIN_BOUND: the Gumbel noise
of the two CPU ``log``s differs by about an ulp
(``tests/test_torch_sampling.py``).

``fake`` weights (the serve CLI's ``--quant fake``: every weight
fake-quantized to ``FixedPointType(8, 4)`` at each call) stream the JAX
Engine's greedy tokens byte for byte, and ``reuse_factor`` 2 (the
reference's compile knob, ``--reuse-factor``) changes no token: both
port runs are held against one reference run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (ENGINE_GEN, ENGINE_KW, auto_mesh,  # noqa: E402
                          contexts, engine_prompts, serve_jax, serve_torch,
                          smoke_params)
# every reference Engine of the module reuses the XLA executables of
# the ones before it (torch_parity.reuse_xla_executables)
from torch_parity import reuse_executables  # noqa: E402,F401

GEN = ENGINE_GEN

KNOBS = {"auto": {}, "unsplit": {"kv_split": 1, "pages_per_step": 1},
         "split2": {"kv_split": 2}}


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("mode", ["none", "int8"])
def test_greedy_streams_identical(mode, knobs):
    cfg, jparams, tparams = smoke_params(mode)
    jctx, tctx = contexts(mode)
    prompts = engine_prompts(cfg.vocab)
    want, jeng = serve_jax(cfg, jctx, jparams, prompts, KNOBS[knobs])
    got, teng = serve_torch(cfg, tctx, tparams, prompts, KNOBS[knobs])
    assert got == want
    assert all(len(t) == GEN for t in got)
    assert (teng.kv_split, teng.pages_per_step) == \
        (jeng.kv_split, jeng.pages_per_step)
    st = teng.stats()
    assert st["requests"] == 3 and st["admitted"] == 3
    assert st["gen_tokens"] == 3 * GEN and st["peak_live"] == 2
    assert st["kv_split"] == jeng.stats()["kv_split"]
    if knobs == "unsplit":
        assert (teng.kv_split, teng.pages_per_step) == (1, 1)
    if knobs == "split2":
        assert teng.kv_split == 2


@pytest.mark.parametrize("mode", ["none", "int8"],
                         ids=["a-lut-paged", "b-int8-lut-paged"])
def test_greedy_streams_identical_lut_paged(mode):
    """Regime (a): float weights, every gated GELU through the
    ``lut_activation`` op; regime (b): int8 weights, the table fused into
    qmatmul's epilogue.  Both on the paged f32 cache."""
    cfg, jparams, tparams = smoke_params(mode)
    jctx, _ = contexts(mode, use_lut=True, force_paged_kernel=True)
    _, tctx = contexts(mode, use_lut=True)
    prompts = engine_prompts(cfg.vocab)
    want, _ = serve_jax(cfg, jctx, jparams, prompts, {})
    got, teng = serve_torch(cfg, tctx, tparams, prompts, {})
    assert got == want
    assert all(len(t) == GEN for t in got)
    st = teng.stats()
    assert st["paged"] and st["gen_tokens"] == 3 * GEN
    assert st["decode_steps"] > 0 and st["prefill_chunks"] > 0


#: the reference Engine's fake-quantized streams, served once per process
_FAKE = {}


@pytest.mark.parametrize("reuse", [1, 2], ids=["reuse1", "reuse2"])
def test_greedy_streams_identical_fake(reuse):
    import dataclasses
    cfg, jparams, tparams = smoke_params("fake")
    jctx, tctx = contexts("fake")
    prompts = engine_prompts(cfg.vocab)
    if not _FAKE:
        _FAKE["want"] = serve_jax(cfg, jctx, jparams, prompts, {})[0]
    got, teng = serve_torch(cfg, dataclasses.replace(
        tctx, reuse_factor=reuse), tparams, prompts, {})
    assert got == _FAKE["want"]
    assert all(len(t) == GEN for t in got)
    assert teng.ctx.mode == "fake" and teng.ctx.reuse_factor == reuse


def test_block_size_invariance_and_stop_rules():
    """Blocks of 1, 3 and 8 steps give the same streams; an EOS id stops a
    lane early, exactly as the reference engine does."""
    cfg, jparams, tparams = smoke_params("none")
    jctx, tctx = contexts("none")
    prompts = engine_prompts(cfg.vocab)
    from repro_torch.launch.serve import Engine
    streams = []
    for block in (1, 3, 8):
        eng = Engine(cfg, tctx, tparams, device="cpu", **ENGINE_KW)
        ids = [eng.submit(p, gen_len=GEN) for p in prompts]
        eng.try_admit()
        while eng.live.any() or eng.waiting:
            eng.step_many(block)
        eng.retire_finished()
        streams.append([eng.results[i]["tokens"] for i in ids])
    assert streams[0] == streams[1] == streams[2]
    eos = streams[0][0][2]
    eng = Engine(cfg, tctx, tparams, device="cpu", eos_id=int(eos),
                 **ENGINE_KW)
    eng.add_requests({0: prompts[0]}, gen_len=GEN)
    while eng.live.any():
        eng.step_many(4)
    # the step that samples EOS kills the lane; EOS itself is never emitted
    full = streams[0][0]
    assert eng.outputs[0] == full[:full.index(eos)]


def test_refusals(tmp_path):
    """Bad values are refused by name (an unknown autotune mode, int4 KV,
    an unknown numeric mode; ``fake`` is a mode since training was
    ported); the autotuner, the journal, the fleet and class
    quotas are accepted, by the Engine and the CLI; ``--lut``,
    ``--kv-bits 8`` and the dense cache (no ``--paged``) are served."""
    from repro_torch.launch.serve import Engine, main
    cfg, _, tparams = smoke_params("none")
    _, tctx = contexts("none")
    with pytest.raises(ValueError, match="autotune"):
        Engine(cfg, tctx, tparams, device="cpu", batch=2, max_len=8,
               autotune="fast")
    tuned = Engine(cfg, tctx, tparams, device="cpu", batch=2, max_len=8,
                   autotune="analytic")
    assert tuned.stats()["autotune_source"] == "analytic"
    assert tuned.decode_block == 8
    with pytest.raises(ValueError, match="kv_bits"):
        Engine(cfg, tctx, tparams, device="cpu", batch=2, max_len=8,
               kv_bits=4)
    assert contexts("fake")[1].mode == "fake"
    with pytest.raises(ValueError, match="mode"):
        contexts("int4")
    eng = Engine(cfg, tctx, tparams, device="cpu", batch=2, max_len=8)
    assert not eng.paged and eng.kv_split is None
    # a sampled request is served; a negative top_k is a caller bug
    rid = eng.submit(np.arange(4), gen_len=2, temperature=0.7, top_k=3)
    eng.try_admit()
    assert eng.temperature[0] == np.float32(0.7) and eng.top_k[0] == 3
    while eng.live.any():
        eng.step_many(2)
    eng.retire_finished()
    assert len(eng.results[rid]["tokens"]) == 2
    assert eng.temperature[0] == 0 and eng.top_k[0] == 0
    with pytest.raises(ValueError, match="top_k"):
        eng.submit(np.arange(4), gen_len=2, temperature=0.7, top_k=-1)
    with pytest.raises(ValueError, match="out-of-vocab"):
        eng.submit(np.asarray([cfg.vocab]), gen_len=2)
    base = ["--arch", "gemma-2b", "--smoke", "--paged", "--device", "cpu",
            "--requests", "2", "--batch", "2", "--prompt-len", "5",
            "--gen-len", "3"]
    for flags in (["--durable-dir", str(tmp_path / "d"),
                   "--snapshot-every", "1"],
                  ["--replicas", "2", "--standby-dir", str(tmp_path / "s")],
                  ["--class-quota", "realtime:floor=0.25",
                   "--autotune", "fitted"]):
        out = main(base + flags)
        assert len(out) == 2 and all(len(r if isinstance(r, list)
                                         else r["tokens"]) == 3
                                     for r in (out.values()
                                               if isinstance(out, dict)
                                               else out))
    for flags in (["--autotune", "fast"], ["--snapshot-every", "-1"],
                  ["--class-quota", "realtime:floor"],
                  ["--class-quota", "batch:floor=0.8",
                   "--class-quota", "batch:cap=0.5"]):
        with pytest.raises((SystemExit, ValueError)):
            main(base + flags)
    with pytest.raises(SystemExit):
        main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
              "--kv-bits", "4"])
    for flags in (["--lut"], ["--kv-bits", "8"], [],
                  ["--quant", "fake", "--reuse-factor", "2"]):
        done = main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                     "--requests", "2", "--batch", "2", "--prompt-len", "5",
                     "--gen-len", "3", *flags])
        assert len(done) == 2 and all(len(t) == 3 for t in done)


def test_cli_serves_on_cpu(capsys):
    from repro_torch.launch.serve import main
    done = main(["--arch", "gemma-2b", "--smoke", "--paged", "--quant",
                 "int8", "--device", "cpu", "--requests", "3", "--batch",
                 "2", "--prompt-len", "6", "--gen-len", "4"])
    assert len(done) == 3 and all(len(t) == 4 for t in done)
    assert "served 3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--paged", "--lut"],
                                   ["--quant", "int8", "--lut", "--kv-bits",
                                    "8"]],
                         ids=["a-lut-paged", "c-int8-lut-kv8"])
def test_cli_serves_lut_regimes_on_cpu(capsys, flags):
    from repro_torch.launch.serve import main
    done = main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                 "--requests", "3", "--batch", "2", "--prompt-len", "6",
                 "--gen-len", "4", *flags])
    assert len(done) == 3 and all(len(t) == 4 for t in done)
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "lut=True" in out
    assert ("paged(" in out) == ("--paged" in flags)


# -- sampled streams ---------------------------------------------------------
#: sampled streams may part from the JAX Engine's only where the perturbed
#: logits' top-2 margin (logits / temperature + Gumbel noise, candidates
#: only) is below this bound (the card-vs-CPU greedy gate of
#: ``tests/test_torch_cuda.py``): the noise differs by about an ulp
MARGIN_BOUND = 1e-3
SEED = 3

SAMPLING = {"top_k 0": ([0.8] * 3, [0] * 3),
            "top_k 5": ([0.8] * 3, [5] * 3),
            "mixed": ([0.0, 0.8, 1.3], [0, 40, 3])}


def _serve_sampled_jax(cfg, ctx, params, prompts, kw, temps, top_ks):
    from repro.dist.constrain import use_mesh
    from repro.launch.serve import Engine
    with use_mesh(auto_mesh()):
        eng = Engine(cfg, ctx, params, auto_mesh(), seed=SEED,
                     **{**ENGINE_KW, **kw})
        ids = [eng.submit(p, gen_len=GEN, temperature=t, top_k=k)
               for p, t, k in zip(prompts, temps, top_ks)]
        eng.try_admit()
        while eng.live.any() or eng.waiting:
            eng.step_many(4)
        eng.retire_finished()
    return [eng.results[i]["tokens"] for i in ids]


def _serve_sampled_torch(cfg, ctx, params, prompts, kw, temps, top_ks,
                         first=()):
    """The port's streams, and for every request the (global step, slot)
    at which each of its tokens was emitted: blocks of the lengths in
    ``first``, then of 4 steps."""
    from repro_torch.launch.serve import Engine
    eng = Engine(cfg, ctx, params, device="cpu", seed=SEED,
                 **{**ENGINE_KW, **kw})
    ids = [eng.submit(p, gen_len=GEN, temperature=t, top_k=k)
           for p, t, k in zip(prompts, temps, top_ks)]
    eng.try_admit()
    emitted = {i: [] for i in ids}
    n = 0
    while eng.live.any() or eng.waiting:
        owner = {s: m["id"] for s, m in eng._req_meta.items()}
        step0 = eng._gen_step
        _, block_live = eng.step_many(first[n] if n < len(first) else 4)
        n += 1
        for s, rid in owner.items():
            emitted[rid] += [(step0 + t, s)
                             for t in np.where(block_live[:, s])[0]]
    eng.retire_finished()
    return [eng.results[i]["tokens"] for i in ids], \
        [emitted[i] for i in ids]


def _perturbed_margin(cfg, ctx, params, prompt, prefix, temp, top_k,
                      step_slot):
    """Top-2 margin of the draw that chose the token after ``prefix``: the
    greedy logits' for the prefill's token or a greedy slot, else the
    perturbed logits' of the step and slot that sampled it."""
    from repro_torch.kernels.prng import PRNGKey, fold_in
    from repro_torch.kernels.sampling import gumbel_noise
    from repro_torch.models import lm
    tokens = torch.tensor(np.concatenate([prompt, prefix])[None],
                          dtype=torch.int32)
    logits = lm.forward(params, tokens, cfg, ctx)[0][0, -1].float()
    if step_slot is not None and temp > 0:
        step, slot = step_slot
        order = torch.argsort(-logits, stable=True)
        keep = order[:top_k] if top_k > 0 else order
        noise = gumbel_noise(fold_in(PRNGKey(SEED), int(step)),
                             (ENGINE_KW["batch"], cfg.vocab))[slot]
        logits = torch.full_like(logits, -torch.inf).index_copy(
            0, keep, logits[keep] / max(temp, 1e-6)) + noise
    top2 = logits.topk(2).values
    return (top2[0] - top2[1]).item()


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("cache", ["paged", "dense"])
@pytest.mark.parametrize("mode", ["none", "int8"])
def test_sampled_streams_match_reference(mode, cache, sampling):
    cfg, jparams, tparams = smoke_params(mode)
    jctx, tctx = contexts(mode)
    prompts = engine_prompts(cfg.vocab)
    kw = {} if cache == "paged" else {"paged": False}
    temps, top_ks = SAMPLING[sampling]
    want = _serve_sampled_jax(cfg, jctx, jparams, prompts, kw, temps, top_ks)
    got, emitted = _serve_sampled_torch(cfg, tctx, tparams, prompts, kw,
                                        temps, top_ks)
    assert all(len(t) == GEN for t in got)
    assert all(0 <= x < cfg.vocab for t in got for x in t)
    for r, (w, g) in enumerate(zip(want, got)):
        i = next((i for i, (x, y) in enumerate(zip(w, g)) if x != y), None)
        if i is None:
            continue
        margin = _perturbed_margin(cfg, tctx, tparams, prompts[r], w[:i],
                                   temps[r], top_ks[r],
                                   emitted[r][i - 1] if i else None)
        print(f"{mode} {cache} {sampling}: request {r} parts at token {i} "
              f"of {GEN}, perturbed top-2 margin {margin:.6g}")
        assert margin < MARGIN_BOUND, (r, i, margin)
    if sampling != "mixed":
        # the draws spread: a sampled stream is not the greedy one
        greedy, _ = serve_torch(cfg, tctx, tparams, prompts, kw)
        assert got != greedy


def test_sampled_block_split_invariance():
    """Steps are keyed by the engine's global step counter, so blocks of
    2 + 3 draw what one block of 5 draws (and one step at a time), and
    the rest of the streams follow (mixed greedy and sampled slots; the
    third request refills a lane after step 8 in every split, as the
    reference admits only at block boundaries)."""
    cfg, _, tparams = smoke_params("int8")
    _, tctx = contexts("int8")
    prompts = engine_prompts(cfg.vocab)
    temps, top_ks = SAMPLING["mixed"]
    runs = [_serve_sampled_torch(cfg, tctx, tparams, prompts, {}, temps,
                                 top_ks, first=first)
            for first in ((2, 3), (5,), (1, 1, 1, 1, 1))]
    assert runs[0] == runs[1] == runs[2]
    assert runs[0][1][2][0][0] >= GEN          # admitted after the first 8


def test_cli_serves_sampled_on_cpu(capsys):
    from repro_torch.launch.serve import main
    done = main(["--arch", "gemma-2b", "--smoke", "--paged", "--device",
                 "cpu", "--requests", "3", "--batch", "2", "--prompt-len",
                 "6", "--gen-len", "4", "--temperature", "0.8", "--top-k",
                 "40", "--seed", "5"])
    assert len(done) == 3 and all(len(t) == 4 for t in done)
    out = capsys.readouterr().out
    assert "temperature=0.8 top_k=40 graphs=False" in out
    with pytest.raises(ValueError, match="CUDA graphs"):
        main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
              "--graphs"])


def test_engine_graphs_need_a_card():
    """Graphs default to off on the CPU; asking for them there raises."""
    from repro_torch.launch.serve import Engine
    from repro_torch.train import step
    cfg, _, tparams = smoke_params("none")
    _, tctx = contexts("none")
    with pytest.raises(ValueError, match="CUDA graphs"):
        Engine(cfg, tctx, tparams, device="cpu", batch=2, max_len=8,
               graphs=True)
    eng = Engine(cfg, tctx, tparams, device="cpu", batch=2, max_len=16)
    st = eng.stats()
    assert st["graphs"] is False and st["graph_captures"] == 0
    builds = step.LOOP_BUILDS["decode"]
    eng.add_requests({0: np.arange(4)}, gen_len=6)
    for n in (2, 2, 1, 2):
        eng.step_many(n)
    # one loop per block length, however many blocks
    assert step.LOOP_BUILDS["decode"] - builds == 2
