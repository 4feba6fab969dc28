"""Speculative decoding, port vs ``repro`` (gemma-2b smoke, the CPU).

* Ops: ``prng.split`` bitwise ``jax.random.split``; ``verify_noise``'s
  uniforms bitwise and its Gumbel noise within ``GUMBEL_ULPS``;
  ``ops.verify_tokens`` through ``ref`` and ``cuda`` (its CPU path) equal
  to both reference lowerings (``verify_tokens_ref``,
  ``verify_tokens_fused``), greedy and sampled, ties included;
  ``draft_ngram`` bitwise.
* Engine: the port's greedy spec streams, ``pos`` and ``live`` equal the
  JAX spec Engine's and the port's plain Engine's (f32 and int8 weights,
  dense and paged at page 8, random and repetitive prompts); the
  adversarial drafter (full rejection) and the model drafter (the target
  itself, and a second model) change no stream; blocks of 4 rounds equal
  blocks of 1; an EOS inside accepted drafts stops a stream where plain
  decode does; refusals.
* Sampled spec streams equal the JAX Engine's, or first part where the
  round's acceptance test ``u < p(draft)`` is within ``ACCEPT_BOUND`` of
  a tie (``torch.softmax`` and XLA's differ in the last ulp) or a
  Gumbel-max draw's perturbed top-2 margin is below ``MARGIN_BOUND``;
  the test prints where.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import verify_tokens_ref as j_verify_ref  # noqa: E402
from repro.kernels import speculative as jspec  # noqa: E402
from repro_torch.kernels import ops, prng  # noqa: E402
from repro_torch.kernels import speculative as tspec  # noqa: E402
from torch_parity import auto_mesh, contexts, smoke_params  # noqa: E402
# every reference Engine of the module reuses the XLA executables of
# the ones before it (torch_parity.reuse_xla_executables)
from torch_parity import reuse_executables  # noqa: E402,F401

K, GEN, MAX_LEN = 3, 10, 32
#: sampled streams may part only at an acceptance within this of a tie...
ACCEPT_BOUND = 1e-6
#: ...or at a Gumbel-max draw whose perturbed top-2 margin is below this
#: (``tests/test_torch_engine.py``'s bound: the noise differs by an ulp)
MARGIN_BOUND = 1e-3
GUMBEL_ULPS = 4


def _tkey(jkey):
    return torch.from_numpy(np.asarray(jkey).view(np.int32).copy())


# -- prng.split and verify_noise ---------------------------------------------
@pytest.mark.parametrize("num", [1, 2, 3, 8])
@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_split_bitwise(seed, num):
    for jk in (jax.random.PRNGKey(seed),
               jax.random.fold_in(jax.random.PRNGKey(seed), 123456)):
        want = np.asarray(jax.random.split(jk, num)).view(np.uint32)
        got = prng.split(_tkey(jk), num).numpy().view(np.uint32)
        assert got.shape == (num, 2) and (got == want).all()


@pytest.mark.parametrize("b,k,v", [(1, 1, 7), (8, 4, 1001)])
def test_verify_noise(b, k, v):
    jk = jax.random.fold_in(jax.random.PRNGKey(3), 9)
    want = [np.asarray(a) for a in jspec.verify_noise(jk, b, k, v)]
    got = [a.numpy() for a in tspec.verify_noise(_tkey(jk), b, k, v)]
    assert (got[0].view(np.uint32) == want[0].view(np.uint32)).all()
    for g, w in zip(got[1:], want[1:]):
        bound = GUMBEL_ULPS * np.finfo(np.float32).eps \
            * np.maximum(np.abs(w), 1.0)
        assert g.shape == w.shape and (np.abs(g - w) <= bound).all()


# -- verify_tokens -----------------------------------------------------------
def _verify_case(seed, b, k, v, ties):
    rs = np.random.RandomState(seed)
    logits = (rs.randint(-3, 3, (b, k + 1, v)) if ties
              else rs.randn(b, k + 1, v) * 2).astype(np.float32)
    draft = rs.randint(0, v, (b, k)).astype(np.int32)
    # half the slots propose the argmax chain (a prefix of it survives)
    chain = logits[:, :k].argmax(-1)
    cut = rs.randint(0, k + 1, (b,))
    keep = (np.arange(k)[None, :] < cut[:, None]) & (rs.rand(b) < 0.5)[:,
                                                                      None]
    draft = np.where(keep, chain, draft).astype(np.int32)
    temp = np.where(rs.rand(b) < 0.4, 0.0,
                    rs.rand(b) * 1.5 + 0.1).astype(np.float32)
    top_k = rs.randint(0, v + 1, (b,)).astype(np.int32)
    return logits, draft, temp, top_k, jax.random.PRNGKey(seed)


@pytest.mark.parametrize("ties", [False, True], ids=["randn", "ties"])
@pytest.mark.parametrize("b,k,v", [(1, 1, 4), (3, 4, 17), (5, 6, 40),
                                   (8, 4, 300)])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_verify_tokens_matches_reference(seed, b, k, v, ties):
    logits, draft, temp, top_k, jk = _verify_case(seed, b, k, v, ties)
    jargs = (jnp.asarray(logits), jnp.asarray(draft), jnp.asarray(temp),
             jnp.asarray(top_k))
    targs = (torch.from_numpy(logits), torch.from_numpy(draft),
             torch.from_numpy(temp), torch.from_numpy(top_k))
    for jkey, tkey in ((jk, _tkey(jk)), (None, None)):
        wants = [[np.asarray(a) for a in fn(*jargs, jkey)]
                 for fn in (j_verify_ref, jspec.verify_tokens_fused)]
        for backend in ("ref", "cuda"):
            nxt, n_adv = ops.verify_tokens(*targs, tkey, backend=backend)
            assert nxt.dtype == n_adv.dtype == torch.int32
            assert ((n_adv >= 1) & (n_adv <= k + 1)).all()
            for w in wants:
                np.testing.assert_array_equal(nxt.numpy(), w[0])
                np.testing.assert_array_equal(n_adv.numpy(), w[1])
    # greedy: the committed prefix is the argmax chain
    nxt, n_adv = tspec.verify_tokens_fused(*targs)
    chain = logits.argmax(-1)
    for i in range(b):
        n = int(n_adv[i])
        assert (draft[i, :n - 1] == chain[i, :n - 1]).all()
        assert int(nxt[i]) == chain[i, n - 1]


@pytest.mark.parametrize("ngram", [1, 2, 3])
@pytest.mark.parametrize("seed", range(6))
def test_draft_ngram_bitwise(seed, ngram):
    rs = np.random.RandomState(seed)
    b, h = 4, 24
    for k in (1, 3, 5):
        hist = rs.randint(0, 3, (b, h)).astype(np.int32)
        tok = rs.randint(0, 3, (b, 1)).astype(np.int32)
        pos = rs.randint(0, h - k - 1, (b,)).astype(np.int32)
        pos[0] = 0
        h0 = hist.copy()
        wd, wh = jspec.draft_ngram(jnp.asarray(hist), jnp.asarray(tok),
                                   jnp.asarray(pos), k, ngram)
        gd, gh = tspec.draft_ngram(torch.from_numpy(hist),
                                   torch.from_numpy(tok),
                                   torch.from_numpy(pos), k, ngram)
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
        np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
        assert gd.dtype == torch.int32
        assert (hist == h0).all()        # the caller's buffer is not written


# -- the Engine ----------------------------------------------------------------
_PARAMS, _JAX = {}, {}


def _setup(mode):
    if mode not in _PARAMS:
        cfg, jp, tp = smoke_params(mode)
        _PARAMS[mode] = (cfg, jp, tp) + contexts(mode)
    return _PARAMS[mode]


def _prompts(vocab, seed=2, repetitive=False):
    rs = np.random.RandomState(seed)
    if repetitive:
        pat = rs.randint(0, vocab, (4,))
        return {0: np.tile(pat, 3), 1: np.tile(pat[::-1], 2)}
    return {0: rs.randint(0, vocab, (9,)), 1: rs.randint(0, vocab, (5,))}


def _cache_kw(cache):
    return dict(paged=True, page_size=8) if cache == "paged" else {}


def _run(eng, prompts, *, block=2, gen_len=GEN, **kw):
    eng.add_requests(prompts, gen_len=gen_len, **kw)
    while eng.live.any():
        eng.step_many(block)
    return eng


def _torch_engine(mode, cache="dense", **kw):
    from repro_torch.launch.serve import Engine
    cfg, _, tp, _, tctx = _setup(mode)
    return Engine(cfg, tctx, tp, device="cpu", batch=2, max_len=MAX_LEN,
                  **{**_cache_kw(cache), **kw})


def _jax_run(tag, mode, cache, prompts, *, block=2, **kw):
    """The JAX Engine's (outputs, pos, live, stats), once per module."""
    if tag not in _JAX:
        from repro.dist.constrain import use_mesh
        from repro.launch.serve import Engine
        cfg, jp, _, jctx, _ = _setup(mode)
        with use_mesh(auto_mesh()):
            eng = Engine(cfg, jctx, jp, auto_mesh(), batch=2,
                         max_len=MAX_LEN, **{**_cache_kw(cache), **kw})
            _run(eng, prompts, block=block)
        _JAX[tag] = ([list(o) for o in eng.outputs], eng.pos.copy(),
                     eng.live.copy(), eng.stats())
    return _JAX[tag]


def _same(eng, want):
    assert [list(o) for o in eng.outputs] == want[0]
    np.testing.assert_array_equal(eng.pos, want[1])
    np.testing.assert_array_equal(eng.live, want[2])


@pytest.mark.parametrize("rep", [False, True], ids=["random", "repetitive"])
@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["none", "int8"])
def test_greedy_spec_streams_match_reference_and_plain(mode, cache, rep):
    cfg = _setup(mode)[0]
    prompts = _prompts(cfg.vocab, repetitive=rep)
    want = _jax_run(("spec", mode, cache, rep), mode, cache, prompts,
                    spec=True, spec_k=K)
    spec = _run(_torch_engine(mode, cache, spec=True, spec_k=K), prompts)
    _same(spec, want)
    assert all(len(o) == GEN for o in spec.outputs)
    base = _torch_engine(mode, cache)
    base.add_requests(prompts, gen_len=GEN)
    base.step_many(GEN)
    _same(base, want)
    st, jst = spec.stats(), want[3]
    assert (st["verify_steps"], st["accepted_per_step"]) == \
        (jst["verify_steps"], jst["accepted_per_step"])
    assert st["gen_tokens"] == 2 * GEN and st["spec_k"] == K
    if rep:
        assert st["accepted_per_step"] > 0.5


def _wrong(hist, tok, pos, k=K, vocab=512):
    """Shift-by-prime proposals: essentially never the argmax."""
    j = torch.arange(1, k + 1, dtype=torch.int32)[None, :]
    return (tok + 7919 * j) % vocab


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_full_rejection_degrades_to_plain_decode(cache):
    cfg = _setup("none")[0]
    prompts = _prompts(cfg.vocab, seed=5)
    base = _torch_engine("none", cache)
    base.add_requests(prompts, gen_len=8)
    base.step_many(8)
    spec = _torch_engine("none", cache, spec=True, spec_k=K,
                         drafter_fn=_wrong)
    rounds = 0
    spec.add_requests(prompts, gen_len=8)
    while spec.live.any():
        spec.step_many(1)
        rounds += 1
    assert spec.outputs == base.outputs
    st = spec.stats()
    assert st["gen_tokens"] >= st["verify_steps"]
    assert st["accepted_per_step"] <= 0.25 and rounds <= 8


@pytest.mark.parametrize("drafter", ["self", "other"])
def test_model_drafter(drafter):
    """The target as its own drafter (every greedy draft survives: the
    bonus-token path) and a second model with other weights (partial
    acceptance): the JAX Engine's streams and acceptance, dense target."""
    cfg, jp, tp, jctx, tctx = _setup("none")
    if drafter == "self":
        jd, td = jp, tp
    else:
        _, jd, td = smoke_params("none", seed=11)
    prompts = _prompts(cfg.vocab, seed=7)
    want = _jax_run(("model", drafter), "none", "dense", prompts, spec=True,
                    spec_k=K, spec_draft=(cfg, jd, jctx))
    spec = _run(_torch_engine("none", spec=True, spec_k=K,
                              spec_draft=(cfg, td, tctx)), prompts)
    _same(spec, want)
    st = spec.stats()
    assert st["accepted_per_step"] == want[3]["accepted_per_step"]
    if drafter == "self":
        # every round commits k + 1, but the budget's last one
        assert st["verify_steps"] == 2 * -(-GEN // (K + 1))
    base = _torch_engine("none")
    base.add_requests(prompts, gen_len=GEN)
    base.step_many(GEN)
    assert spec.outputs == base.outputs


def test_model_drafter_recycled_slot_and_paged_target():
    """A model-drafted engine on the paged target refills a retired lane
    (its draft rows zeroed at finish) and serves it as a fresh engine
    would."""
    cfg, _, tp, _, tctx = _setup("int8")
    rs = np.random.RandomState(6)
    p_old, p_live, p_new = (rs.randint(0, cfg.vocab, (n,)) for n in (7, 6, 8))
    kw = dict(spec=True, spec_k=K, spec_draft=(cfg, tp, tctx))
    eng = _torch_engine("int8", "paged", **kw)
    eng.add_requests({0: p_old, 1: p_live}, gen_len=12)
    eng.step_many(2)
    eng.finish(0)
    assert not eng.draft_cache["dense"]["k"][:, 0].any()
    eng.add_requests({0: p_new}, gen_len=6)
    while eng.live.any():
        eng.step_many(2)
    solo = _run(_torch_engine("int8", "paged", **kw), {0: p_new}, gen_len=6)
    undisturbed = _run(_torch_engine("int8", "paged", **kw),
                       {0: p_old, 1: p_live}, gen_len=12)
    assert eng.outputs[0] == solo.outputs[0]
    assert eng.outputs[1] == undisturbed.outputs[1]


def test_block_split_invariance_greedy():
    from repro_torch.train import step
    cfg = _setup("none")[0]
    prompts = _prompts(cfg.vocab, seed=4, repetitive=True)
    before = step.LOOP_BUILDS["spec"]
    a = _run(_torch_engine("none", spec=True, spec_k=K), prompts, block=4,
             gen_len=12)
    b = _run(_torch_engine("none", spec=True, spec_k=K), prompts, block=1,
             gen_len=12)
    assert a.outputs == b.outputs
    # one loop per (engine, block length)
    assert step.LOOP_BUILDS["spec"] - before == 2


def test_eos_inside_accepted_drafts_kills_slot():
    cfg = _setup("none")[0]
    prompts = _prompts(cfg.vocab, repetitive=True)
    probe = _run(_torch_engine("none", spec=True, spec_k=K), {0: prompts[0]},
                 gen_len=12)
    stream = probe.outputs[0]
    cut = next(i for i in range(1, len(stream)) if stream[i] not in
               stream[:i])
    eos = stream[cut]
    base = _torch_engine("none", eos_id=eos)
    base.add_requests({0: prompts[0]}, gen_len=12)
    base.step_many(12)
    spec = _run(_torch_engine("none", spec=True, spec_k=K, eos_id=eos),
                {0: prompts[0]}, gen_len=12)
    assert spec.outputs[0] == base.outputs[0] == stream[:cut]
    assert not spec.live[0]
    # the EOS came as an accepted draft: a round committed past it
    assert spec.stats()["accepted_per_step"] > 0


def test_spec_state_hooks_are_kv_only():
    """The ported families keep KV only: nothing to checkpoint per block
    position (the reference's ``lm`` answer), and restoring is the
    identity, on the dense and the paged cache."""
    from repro.models.api import spec_state_fn as j_state
    from repro_torch.models import api
    cfg = _setup("none")[0]
    for cache in (api.init_cache_fn(cfg, 2, 8, torch.float32, "cpu"),
                  api.init_paged_cache_fn(cfg, 2, 4, 4, 3, torch.float32,
                                          "cpu")):
        assert api.spec_state_fn(cache, cfg) is None
        assert api.spec_restore_fn(cache, None, cfg) is cache
    assert j_state({}, cfg) is None


def test_refusals_and_cli(capsys):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main
    from repro_torch.train.step import build_spec_decode_loop
    cfg, _, tp, _, tctx = _setup("none")
    with pytest.raises(ValueError, match="spec"):
        _torch_engine("none", drafter_fn=_wrong)
    with pytest.raises(ValueError, match="spec"):
        _torch_engine("none", spec_draft=(cfg, tp, None))
    with pytest.raises(ValueError, match="vocab"):
        _torch_engine("none", spec=True, spec_draft=(
            dataclasses.replace(cfg, vocab=cfg.vocab + 1), tp, None))
    whisper = get_config("whisper-base").smoke()
    assert whisper.vocab == cfg.vocab
    with pytest.raises(NotImplementedError, match="encdec"):
        _torch_engine("none", spec=True, spec_draft=(whisper, tp, None))
    with pytest.raises(NotImplementedError, match="encdec"):
        build_spec_decode_loop(cfg, tctx, 2, K, drafter="model",
                               draft_cfg=whisper)
    with pytest.raises(SystemExit):
        main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
              "--spec-draft", "whisper-base"])
    for flags in (["--spec", "--spec-k", "3"], ["--paged", "--spec-draft",
                                                "gemma-2b"]):
        done = main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                     "--requests", "3", "--batch", "2", "--prompt-len", "6",
                     "--gen-len", "5", *flags])
        assert len(done) == 3 and all(len(t) == 5 for t in done)
        out = capsys.readouterr().out
        assert "served 3 requests" in out and "spec(k=" in out
        assert '"accepted_per_step"' in out


# -- sampled streams -----------------------------------------------------------
SAMPLED = dict(temperature={0: 0.9, 1: 1.2}, top_k={0: 7, 1: 0})
SEED = 13


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _round_margins(eng, snap):
    """The round that starts from ``snap`` recomputed on the port's side:
    the smallest |u - p(draft)| over the sampled slots' judged drafts and
    the smallest perturbed top-2 margin of their Gumbel-max draws."""
    from repro_torch.models.api import decode_fn
    from repro_torch.kernels.speculative import _topk_restricted
    tokens, pos, hist, step, cache = snap
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    drafts, _ = tspec.draft_ngram(t(hist), t(tokens), t(pos), K)
    seq = torch.cat([t(tokens), drafts], dim=1)
    logits, _ = decode_fn(eng.params, seq, cache, t(pos), eng.cfg, eng.ctx)
    logits = logits.float()
    b, _, v = logits.shape
    temp, top_k = t(eng.temperature), t(eng.top_k)
    scaled = torch.where(_topk_restricted(logits, top_k),
                         logits / torch.clamp_min(temp, 1e-6)[:, None, None],
                         -torch.inf)
    probs = torch.softmax(scaled, dim=-1)
    key = prng.fold_in(prng.PRNGKey(SEED), step)
    u, g_res, g_bonus = tspec.verify_noise(key, b, K, v)
    p = torch.gather(probs[:, :K], -1, drafts[..., None].long())[..., 0]
    sampled = temp > 0
    res = scaled[:, :K].scatter(-1, drafts[..., None].long(), -torch.inf) \
        + g_res
    draws = torch.cat([res, (scaled[:, K] + g_bonus)[:, None]], dim=1)
    top2 = draws.topk(2, dim=-1).values
    return ((u - p).abs()[sampled].min().item(),
            (top2[..., 0] - top2[..., 1])[sampled].min().item())


@pytest.mark.parametrize("mode,cache", [("none", "dense"), ("int8", "paged")])
def test_sampled_spec_streams_match_reference(mode, cache):
    """Rounds one at a time on both sides; the port's state before each
    round is kept, so a first difference can be read off that round."""
    from repro.dist.constrain import use_mesh
    from repro.launch.serve import Engine as JEngine
    cfg, jp, _, jctx, _ = _setup(mode)
    prompts = _prompts(cfg.vocab, seed=8, repetitive=True)
    with use_mesh(auto_mesh()):
        jeng = JEngine(cfg, jctx, jp, auto_mesh(), batch=2, max_len=MAX_LEN,
                       spec=True, spec_k=K, seed=SEED, **_cache_kw(cache))
        jeng.add_requests(prompts, gen_len=GEN, **SAMPLED)
        want = []
        while jeng.live.any():
            jeng.step_many(1)
            want.append(([list(o) for o in jeng.outputs], jeng.pos.copy()))
    eng = _torch_engine(mode, cache, spec=True, spec_k=K, seed=SEED)
    eng.add_requests(prompts, gen_len=GEN, **SAMPLED)
    closest = (np.inf, np.inf)
    for r, (w_out, w_pos) in enumerate(want):
        snap = (eng.tokens.copy(), eng.pos.copy(), eng.hist.copy(),
                eng._gen_step, _clone(eng.cache))
        eng.step_many(1)
        up, margin = _round_margins(eng, snap)
        closest = (min(closest[0], up), min(closest[1], margin))
        if [list(o) for o in eng.outputs] == w_out and \
                (eng.pos == w_pos).all():
            continue
        print(f"{mode} {cache}: sampled spec streams part in round {r}: "
              f"min |u - p(draft)| {up:.3g}, min perturbed top-2 margin "
              f"{margin:.3g}")
        assert up < ACCEPT_BOUND or margin < MARGIN_BOUND, (r, up, margin)
        return
    print(f"{mode} {cache}: sampled spec streams identical over "
          f"{len(want)} rounds; closest acceptance |u - p| {closest[0]:.3g}, "
          f"closest perturbed top-2 margin {closest[1]:.3g}")
    assert not eng.live.any()
    assert all(len(o) == GEN for o in eng.outputs)
    assert all(0 <= x < cfg.vocab for o in eng.outputs for x in o)
    # the draws spread: a sampled stream is not the greedy one
    greedy = _run(_torch_engine(mode, cache, spec=True, spec_k=K), prompts)
    assert eng.outputs != greedy.outputs


def test_sampled_spec_block_split_invariance():
    """Round ``i`` of the engine draws ``fold_in(key, i)``: blocks of 4,
    of 1 and of 2 + 2 give the same sampled streams."""
    cfg = _setup("none")[0]
    prompts = _prompts(cfg.vocab, seed=8, repetitive=True)
    outs = []
    for blocks in ([4], [1, 1, 1, 1], [2, 2]):
        eng = _torch_engine("none", spec=True, spec_k=K, seed=SEED)
        eng.add_requests(prompts, gen_len=GEN, **SAMPLED)
        for nb in blocks:
            eng.step_many(nb)
        while eng.live.any():
            eng.step_many(1)
        outs.append(eng.outputs)
    assert outs[0] == outs[1] == outs[2]
