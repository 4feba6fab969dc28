"""The autotuner on the port, held against the JAX package.

``launch.autotune``'s resolver gives the reference's knob vector over the
reference suite's shape grid and over more than a thousand random shapes,
with the analytic and with fitted weights; ``fit_rows`` fits the same
weights from the same rows (within 1e-12); ``SpecKAdapter`` proposes the
same k over the same observation sequences; the artifact is the port's
own (``AUTOTUNE_H100.json``, never the reference's ``AUTOTUNE.json`` or
``BENCH_calibrate.json``), and without it ``fitted`` falls back to the
analytic weights.  The Engine cells of ``tests/test_autotune.py``: ``off``,
``analytic`` and ``fitted`` streams equal; the resolved knobs in
``stats()``; the adaptive ``spec_k`` walking down on rejected drafts with
the stream unchanged and one loop per distinct k, and holding on
accepted drafts; the dense Engine resolving the block length only; each
on the JAX Engine and the port's CPU Engine, which agree.
"""

import itertools
import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from torch_parity import (auto_mesh, lifecycle_makers,  # noqa: E402
                          rand_prompts)

from repro.dist.constrain import use_mesh  # noqa: E402
from repro.launch import autotune as jat  # noqa: E402
from repro_torch.launch import autotune as tat  # noqa: E402

#: the reference suite's grid: pages x page_size x hkv x batch
GRID = list(itertools.product((1, 3, 8, 16, 64, 200, 512), (4, 8, 16, 32),
                              (1, 2, 8), (1, 4, 64, 511, 512)))


def _shapes(mod, pages, ps, hkv, batch, gen_len=64, spec=False):
    return mod.WorkloadShape(pages=pages, page_size=ps, hkv=hkv, batch=batch,
                             gen_len=gen_len, spec=spec)


def _fit_rows(weights, shapes):
    rows = []
    for pages, ps, hkv, batch in shapes:
        s = _shapes(jat, pages, ps, hkv, batch)
        for t, split in jat.kv_candidates(s):
            f = jat.feature_vector(pages, ps, hkv, batch, split, t)
            rows.append({"pages": pages, "page_size": ps, "hkv": hkv,
                         "batch": batch, "kv_split": split,
                         "pages_per_step": t,
                         "us_per_call": float(f @ np.asarray(weights))})
    return rows


FIT_SHAPES = [(64, 8, 1, 4), (32, 8, 2, 2), (16, 16, 1, 8)]


# ===========================================================================
def test_resolve_matches_reference_over_the_grid():
    for est_t, est_j in ((tat.analytic_estimator(), jat.analytic_estimator()),
                         (tat.fit_rows(_fit_rows((4.0, 0.05, 1.5, 0.2, 10.0,
                                                  2.0), FIT_SHAPES)),
                          jat.fit_rows(_fit_rows((4.0, 0.05, 1.5, 0.2, 10.0,
                                                  2.0), FIT_SHAPES)))):
        for pages, ps, hkv, batch in GRID:
            got = tat.resolve(_shapes(tat, pages, ps, hkv, batch), est_t)
            want = jat.resolve(_shapes(jat, pages, ps, hkv, batch), est_j)
            assert got.as_dict() == want.as_dict(), (pages, ps, hkv, batch)
            assert tat.kv_candidates(_shapes(tat, pages, ps, hkv, batch)) \
                == jat.kv_candidates(_shapes(jat, pages, ps, hkv, batch))


def test_analytic_resolver_equals_the_cost_model():
    """The analytic estimator picks exactly ``_resolve_knobs``' auto
    knobs, for every shape of the grid."""
    from repro_torch.kernels.flash_attention import _resolve_knobs
    est = tat.analytic_estimator()
    for pages, ps, hkv, batch in GRID:
        kv = tat.resolve(_shapes(tat, pages, ps, hkv, batch), est)
        assert (kv.pages_per_step, kv.kv_split) == \
            _resolve_knobs(pages, ps, hkv, batch, None, None)


@settings(max_examples=1200, deadline=None)
@given(st.integers(0, 1024), st.sampled_from([1, 2, 4, 8, 16, 32, 64]),
       st.integers(1, 16), st.integers(1, 1024), st.integers(1, 4096),
       st.sampled_from([False, True]), st.integers(0, 2))
def test_resolve_matches_reference_on_random_shapes(pages, ps, hkv, batch,
                                                    gen_len, spec, wi):
    weights = [None, (4.0, 0.05, 1.5, 0.2, 10.0, 2.0),
               (0.5, 0.3, 9.0, 0.0, 1.0, 0.0)][wi]
    if weights is None:
        est_t, est_j = tat.analytic_estimator(), jat.analytic_estimator()
    else:
        est_t = tat.LatencyEstimator(weights=weights, source="fit")
        est_j = jat.LatencyEstimator(weights=weights, source="fit")
    got = tat.resolve(_shapes(tat, pages, ps, hkv, batch, gen_len, spec),
                      est_t)
    want = jat.resolve(_shapes(jat, pages, ps, hkv, batch, gen_len, spec),
                       est_j)
    assert got.as_dict() == want.as_dict()


def test_pinned_vectors_and_spec_k_ranking():
    assert tat.resolve(_shapes(tat, 64, 8, 1, 4)) == tat.KnobVector(
        kv_split=4, pages_per_step=16, decode_block=32, spec_k=4)
    dense = tat.resolve(_shapes(tat, 0, 8, 1, 4))
    assert (dense.kv_split, dense.pages_per_step) == (1, 1)
    assert tat.resolve(_shapes(tat, 0, 8, 1, 1, gen_len=1)).decode_block == 1
    # path 1's geometry on the card: a 12-page table of 16 rows, batch 8,
    # max_len 161
    path1 = tat.resolve(_shapes(tat, 12, 16, 1, 8, gen_len=161))
    assert (path1.pages_per_step, path1.kv_split, path1.decode_block) == \
        (8, 2, 32)
    assert tat.rank_spec_k(tat._ACCEPT_PRIOR, 8) == 4
    for p in np.linspace(0.0, 0.999, 41):
        for k in (1, 3, 8):
            assert tat.rank_spec_k(p, k) == jat.rank_spec_k(p, k)


# ===========================================================================
def test_fit_rows_matches_reference():
    rows = _fit_rows((4.0, 0.05, 1.5, 0.2, 10.0, 2.0), FIT_SHAPES)
    noisy = [dict(r) for r in rows]
    rs = np.random.RandomState(0)
    for r in noisy:
        r["us_per_call"] *= float(rs.uniform(0.7, 1.6))
    for data in (rows, noisy, noisy[: len(noisy) // 2]):
        got, want = tat.fit_rows(data), jat.fit_rows(data)
        assert got.source == want.source == "fit"
        assert got.n_rows == want.n_rows
        np.testing.assert_allclose(got.weights, want.weights, rtol=0,
                                   atol=1e-12)
        assert abs(got.residual - want.residual) <= 1e-12
        assert all(w >= 0 for w in got.weights)
        assert got.cost_constants() == pytest.approx(want.cost_constants(),
                                                     abs=1e-12)
    with pytest.raises(ValueError, match="calibration rows"):
        tat.fit_rows(rows[: len(tat.FEATURES) - 1])


def test_analytic_weights_and_install():
    from repro_torch.kernels.flash_attention import (choose_kv_split,
                                                     get_cost_constants)
    assert tat.analytic_estimator().weights == jat.analytic_estimator().weights
    base = get_cost_constants()
    c = tat.analytic_estimator().cost_constants()
    assert c["tile_cost"] == pytest.approx(base["tile_cost"])
    assert c["combine_cost"] == pytest.approx(base["combine_cost"])
    try:
        tat.install(tat.LatencyEstimator(weights=(1.0, 0.0, 1e9, 0, 0, 0),
                                         source="fit"))
        assert choose_kv_split(512 * 8, 512, 1, batch=1,
                               pages_per_step=8) == 1
    finally:
        tat.install(tat.analytic_estimator())
    assert get_cost_constants() == base
    assert choose_kv_split(512 * 8, 512, 1, batch=1, pages_per_step=8) > 1


def test_artifact_is_the_ports_own(tmp_path, monkeypatch):
    """``fitted`` reads only the port's artifact (the card's name and
    power limit in it), else falls back to the analytic weights; the
    reference's files are never read."""
    assert tat.ARTIFACT_NAME == "AUTOTUNE_H100.json"
    est = tat.fit_rows(_fit_rows((4.0, 0.05, 1.5, 0.2, 10.0, 2.0),
                                 FIT_SHAPES))
    dev = {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    p = tat.save_artifact(est, tmp_path / "a.json", device=dev, rows=[])
    d = json.loads(p.read_text())
    assert d["device"] == dev and d["features"] == list(tat.FEATURES)
    back = tat.load_estimator("fitted", path=p)
    assert back.source == "artifact" and back.weights == pytest.approx(
        est.weights)
    # a repo root holding only the reference's files: the fallback
    for name in ("AUTOTUNE.json", "BENCH_calibrate.json"):
        (tmp_path / name).write_text(json.dumps(est.to_json()))
    monkeypatch.setattr(tat, "_REPO_ROOT", tmp_path)
    monkeypatch.delenv(tat.ARTIFACT_ENV, raising=False)
    fb = tat.load_estimator("fitted")
    assert fb.source == "analytic-fallback"
    assert fb.weights == tat.analytic_estimator().weights
    monkeypatch.setenv(tat.ARTIFACT_ENV, str(p))
    assert tat.load_estimator("fitted").source == "artifact"
    bad = dict(d, features=["chain", "other"])
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="feature basis"):
        tat.load_artifact(tmp_path / "bad.json")


# ===========================================================================
OBS = st.lists(st.tuples(st.integers(0, 40), st.integers(0, 200)),
               min_size=1, max_size=30)


@settings(max_examples=150, deadline=None)
@given(st.integers(1, 8), st.integers(1, 8), st.integers(1, 64),
       st.integers(1, 16), st.integers(1, 4), OBS)
def test_spec_k_adapter_matches_reference(k_init, k_max, window, min_rounds,
                                          cooldown, obs):
    kw = dict(k_max=max(k_init, k_max), window=window,
              min_rounds=min_rounds, cooldown=cooldown)
    ta, ja = tat.SpecKAdapter(k_init, **kw), jat.SpecKAdapter(k_init, **kw)
    for rounds, acc in obs:
        acc = min(acc, rounds * ta.k)
        ta.observe(rounds, acc)
        ja.observe(rounds, acc)
        assert ta.acceptance() == ja.acceptance()
        assert ta.propose() == ja.propose()
        assert ta.switches == ja.switches


def test_spec_k_adapter_cases():
    ad = tat.SpecKAdapter(k_init=4)
    assert ad.propose() == 4 and ad.switches == 0
    ad = tat.SpecKAdapter(k_init=4, min_rounds=4, cooldown=1)
    ad.observe(rounds=8, accepted=0)
    assert ad.propose() == 1 and ad.switches == 1
    ad = tat.SpecKAdapter(k_init=4, min_rounds=1, cooldown=3)
    ad.observe(rounds=8, accepted=0)
    assert ad.propose() == 1
    for want in (1, 1):
        ad.observe(rounds=8, accepted=8)
        assert ad.propose() == want             # the cooldown holds
    ad.observe(rounds=8, accepted=8)
    assert ad.propose() > 1


# ===========================================================================
def _both(scenario):
    cfg, make = lifecycle_makers()
    with use_mesh(auto_mesh()):
        want = scenario(make["jax"], "jax", cfg)
    got = scenario(make["torch"], "torch", cfg)
    assert got == want
    return got


def _streams(eng, prompts, gen_len=8, block=4):
    eng.add_requests(prompts, gen_len=gen_len)
    while eng.live.any():
        eng.step_many(block)
    return [list(eng.outputs[s] or []) for s in range(len(prompts))]


def test_engine_modes_give_equal_streams():
    def scenario(make, pkg, cfg):
        prompts = dict(enumerate(rand_prompts(cfg.vocab, (6, 5), seed=1)))
        outs, stats = {}, {}
        for mode in ("off", "analytic", "fitted"):
            eng = make(batch=2, max_len=24, paged=True, page_size=4,
                       autotune=mode)
            outs[mode] = _streams(eng, prompts)
            st_ = eng.stats()
            source = st_.get("autotune_source")
            knobs = (st_["kv_split"], st_["pages_per_step"])
            if mode == "fitted":
                # the reference reads its own CPU fit, the port its card
                # fit if the tree holds one, else the analytic weights:
                # their knobs may differ, their streams may not
                assert source in (("artifact", "analytic-fallback")
                                  if pkg == "torch" else ("artifact",))
                if pkg == "torch":
                    kv = tat.resolve(tat.WorkloadShape(
                        pages=eng.block_tables.shape[1], page_size=4, hkv=1,
                        batch=2, gen_len=24), tat.load_estimator("fitted"))
                    assert knobs == (kv.kv_split, kv.pages_per_step)
                source = knobs = None
            stats[mode] = (st_["autotune"], source, st_.get("decode_block"),
                           knobs)
        assert outs["analytic"] == outs["off"] == outs["fitted"]
        return outs, stats

    _, stats = _both(scenario)
    assert stats["off"][1:3] == (None, None)
    assert stats["analytic"][:2] == ("analytic", "analytic")
    assert 1 <= stats["analytic"][2] <= 24


def test_dense_engine_resolves_decode_block_only():
    def scenario(make, pkg, cfg):
        eng = make(batch=2, max_len=24, autotune="analytic")
        assert eng.kv_split is None and eng.pages_per_step is None
        return eng.decode_block

    assert 1 <= _both(scenario) <= 24


def test_adaptive_spec_k_stream_invariant_and_bounded_rebuilds():
    """Drafts that never verify: the adapter walks k down, the greedy
    stream does not move, and one spec loop is built per distinct k."""
    def scenario(make, pkg, cfg):
        prompts = dict(enumerate(rand_prompts(cfg.vocab, (6, 5), seed=2)))
        outs, info = {}, {}
        for mode in ("off", "analytic"):
            holder = {}

            def mismatched(hist, tok, pos):
                k = holder["eng"].spec_k
                if pkg == "jax":
                    import jax.numpy as jnp
                    return jnp.broadcast_to((tok + 7) % cfg.vocab,
                                            (tok.shape[0], k))
                return ((tok + 7) % cfg.vocab).expand(tok.shape[0], k)

            eng = make(batch=2, max_len=32, spec=True, spec_k=4,
                       autotune=mode, drafter_fn=mismatched)
            holder["eng"] = eng
            if eng._spec_adapter is not None:
                eng._spec_adapter = type(eng._spec_adapter)(
                    k_init=4, k_max=4, min_rounds=4, cooldown=1)
            outs[mode] = _streams(eng, prompts, gen_len=16)
            st_ = eng.stats()
            info[mode] = (st_["spec_k"], st_["spec_k_init"],
                          st_["spec_k_rejits"], st_["verify_steps"])
            if pkg == "torch":
                ks = {k for (_, k) in eng.blocks._loops}
                assert len(ks) == st_["spec_k_rejits"] + 1 or mode == "off"
        assert outs["analytic"] == outs["off"]
        return outs, info

    _, info = _both(scenario)
    k, k0, rejits, _ = info["analytic"]
    assert k < 4 and k0 == 4 and rejits >= 1
    assert info["off"][2] == 0


def test_adaptive_spec_k_holds_on_verifying_drafts():
    def scenario(make, pkg, cfg):
        pat = np.tile(np.random.RandomState(3).randint(0, cfg.vocab, (5,)),
                      4).astype(np.int32)
        eng = make(batch=1, max_len=40, spec=True, spec_k=4,
                   autotune="analytic")
        out = _streams(eng, {0: pat}, gen_len=16)
        st_ = eng.stats()
        return out, st_["spec_k"], st_["spec_k_rejits"]

    _, k, rejits = _both(scenario)
    assert k == 4 and rejits == 0


def test_decode_block_default_is_resolved_by_the_cli(capsys):
    """The CLI's ``--autotune`` defaults to ``analytic`` and its block to
    the resolved one (max_len 11 here: 11); ``--autotune off`` keeps 8;
    the streams are the same."""
    from repro_torch.launch.serve import main
    base = ["--arch", "gemma-2b", "--smoke", "--paged", "--device", "cpu",
            "--requests", "2", "--batch", "2", "--prompt-len", "6",
            "--gen-len", "4"]
    want = tat.resolve(_shapes(tat, 0, 16, 1, 2, gen_len=11)).decode_block
    assert want == 11
    done = main(base)
    out = capsys.readouterr().out
    assert "autotune=analytic" in out and f"decode_block={want} " in out
    off = main(base + ["--autotune", "off"])
    assert "decode_block=8 " in capsys.readouterr().out
    assert off == done
