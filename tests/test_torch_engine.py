"""Engine parity: the port's ``Engine(device="cpu")`` serves the same greedy
streams as the JAX ``Engine`` on gemma-2b smoke, paged, ``none`` and
``int8``, batch 2 with three requests (so a lane is refilled mid-flight),
at the auto knobs, at ``(1, 1)`` and at an explicit split; the resolved
knobs are equal too.  With the paper's tables (``use_lut``) the paged f32
cache still attends through the paged kernel with the exact softmax, so
the reference runs its paged kernel too (``force_paged_kernel``, interpret
mode).  Streams are compared exactly, never loosened.  The dense and int8
KV caches' cells are in ``tests/test_torch_dense_cache.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (ENGINE_GEN, ENGINE_KW, contexts,  # noqa: E402
                          engine_prompts, serve_jax, serve_torch,
                          smoke_params)

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


def test_refusals():
    """Out-of-slice options are refused by name; ``--lut``, ``--kv-bits 8``
    and the dense cache (no ``--paged``) are served."""
    from repro_torch.launch.serve import Engine, main
    cfg, _, tparams = smoke_params("none")
    _, tctx = contexts("none")
    with pytest.raises(NotImplementedError, match="autotune"):
        Engine(cfg, tctx, tparams, device="cpu", batch=2, max_len=8,
               autotune="analytic")
    with pytest.raises(ValueError, match="kv_bits"):
        Engine(cfg, tctx, tparams, device="cpu", batch=2, max_len=8,
               kv_bits=4)
    with pytest.raises(NotImplementedError, match="fake"):
        contexts("fake")
    eng = Engine(cfg, tctx, tparams, device="cpu", batch=2, max_len=8)
    assert not eng.paged and eng.kv_split is None
    with pytest.raises(NotImplementedError, match="sampled"):
        eng.submit(np.arange(4), gen_len=2, temperature=0.7)
    with pytest.raises(ValueError, match="out-of-vocab"):
        eng.submit(np.asarray([cfg.vocab]), gen_len=2)
    for flag in ("--spec", "--prefix-cache", "--preempt", "--replicas",
                 "--durable-dir"):
        with pytest.raises(SystemExit):
            main(["--arch", "gemma-2b", "--smoke", "--paged", "--device",
                  "cpu", flag, "8"])
    with pytest.raises(SystemExit):
        main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
              "--kv-bits", "4"])
    for flags in (["--lut"], ["--kv-bits", "8"], []):
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
