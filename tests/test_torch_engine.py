"""Engine parity: the port's ``Engine(device="cpu")`` serves the same greedy
streams as the JAX ``Engine`` on gemma-2b smoke, paged, ``none`` and
``int8``, batch 2 with three requests (so a lane is refilled mid-flight),
at the auto knobs, at ``(1, 1)`` and at an explicit split; the resolved
knobs are equal too.  Streams are compared exactly, never loosened.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import auto_mesh, contexts, smoke_params  # noqa: E402

GEN, MAX_LEN, PLEN = 8, 24, 13
ENGINE_KW = dict(batch=2, max_len=MAX_LEN, paged=True, page_size=4,
                 prefill_chunk=5)


def _prompts(vocab):
    from repro.data.pipeline import SyntheticLM
    src = SyntheticLM(vocab, seed=0)
    return [src.tokens(i, 1, PLEN + 1)[0, :-1] for i in range(3)]


def _serve_jax(cfg, ctx, params, prompts, knobs):
    from repro.dist.constrain import use_mesh
    from repro.launch.serve import Engine
    mesh = auto_mesh()
    with use_mesh(mesh):
        eng = Engine(cfg, ctx, params, mesh, **ENGINE_KW, **knobs)
        ids = [eng.submit(p, gen_len=GEN) for p in prompts]
        eng.try_admit()
        while eng.live.any() or eng.waiting:
            eng.step_many(4)
        eng.retire_finished()
    return [eng.results[i]["tokens"] for i in ids], eng


def _serve_torch(cfg, ctx, params, prompts, knobs):
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import Engine
    eng = Engine(cfg, ctx, params, device="cpu", **ENGINE_KW, **knobs)
    ids = [eng.submit(p, gen_len=GEN) for p in prompts]
    eng.try_admit()
    while eng.live.any() or eng.waiting:
        eng.step_many(4)
    eng.retire_finished()
    assert launch_counts() == {k: 0 for k in launch_counts()}   # CPU: plain
    return [eng.results[i]["tokens"] for i in ids], eng


KNOBS = {"auto": {}, "unsplit": {"kv_split": 1, "pages_per_step": 1},
         "split2": {"kv_split": 2}}


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("mode", ["none", "int8"])
def test_greedy_streams_identical(mode, knobs):
    cfg, jparams, tparams = smoke_params(mode)
    jctx, tctx = contexts(mode)
    prompts = _prompts(cfg.vocab)
    want, jeng = _serve_jax(cfg, jctx, jparams, prompts, KNOBS[knobs])
    got, teng = _serve_torch(cfg, tctx, tparams, prompts, KNOBS[knobs])
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


def test_block_size_invariance_and_stop_rules():
    """Blocks of 1, 3 and 8 steps give the same streams; an EOS id stops a
    lane early, exactly as the reference engine does."""
    cfg, jparams, tparams = smoke_params("none")
    jctx, tctx = contexts("none")
    prompts = _prompts(cfg.vocab)
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
    from repro_torch.launch.serve import Engine, main
    cfg, _, tparams = smoke_params("none")
    _, tctx = contexts("none")
    with pytest.raises(NotImplementedError, match="dense"):
        Engine(cfg, tctx, tparams, device="cpu", batch=2, max_len=8,
               paged=False)
    with pytest.raises(NotImplementedError, match="autotune"):
        Engine(cfg, tctx, tparams, device="cpu", batch=2, max_len=8,
               autotune="analytic")
    eng = Engine(cfg, tctx, tparams, device="cpu", batch=2, max_len=8)
    with pytest.raises(NotImplementedError, match="sampled"):
        eng.submit(np.arange(4), gen_len=2, temperature=0.7)
    with pytest.raises(ValueError, match="out-of-vocab"):
        eng.submit(np.asarray([cfg.vocab]), gen_len=2)
    for flag in ("--spec", "--prefix-cache", "--preempt", "--lut",
                 "--kv-bits", "--replicas", "--durable-dir"):
        with pytest.raises(SystemExit):
            main(["--arch", "gemma-2b", "--smoke", "--paged", "--device",
                  "cpu", flag, "8"])
    with pytest.raises(SystemExit):
        main(["--arch", "gemma-2b", "--smoke", "--device", "cpu"])


def test_cli_serves_on_cpu(capsys):
    from repro_torch.launch.serve import main
    done = main(["--arch", "gemma-2b", "--smoke", "--paged", "--quant",
                 "int8", "--device", "cpu", "--requests", "3", "--batch",
                 "2", "--prompt-len", "6", "--gen-len", "4"])
    assert len(done) == 3 and all(len(t) == 4 for t in done)
    assert "served 3 requests" in capsys.readouterr().out
