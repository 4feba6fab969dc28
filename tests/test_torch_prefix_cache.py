"""Prefix caching on the port's Engine, held against the JAX Engine.

The port's ``PageAllocator`` (reference counts, share, transfer, spill,
adopt, state) and ``PrefixIndex`` run the same operation sequences as the
JAX classes (hypothesis, ``deadline=None``) and end in equal states.  The
Engine cells are those of ``tests/test_prefix_cache.py`` on gemma-2b
smoke (page 4, prefill chunk 5 unless the cell says otherwise): the
port's prefix-cached streams equal the JAX prefix-cached Engine's and the
port's own cold Engine's, byte for byte, and the prefix counters,
copy-on-write counts, allocator and index states equal the JAX Engine's.
``copy_pages_fn`` and the spill payload's gather and scatter are held
against the reference's functions, bitwise, and write in place.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from torch_parity import (auto_mesh, drain, lifecycle_makers,  # noqa: E402
                          rand_prompts, serve_engine, shared_prompts)
# every reference Engine of the module reuses the XLA executables of
# the ones before it (torch_parity.reuse_xla_executables)
from torch_parity import reuse_executables  # noqa: E402,F401

from repro.dist.constrain import use_mesh  # noqa: E402

PREFIX_KEYS = ("prefix_hits", "prefix_hit_pages", "prefix_tokens_saved",
               "cow_copies")
GEOM = dict(paged=True, page_size=4, prefill_chunk=5)


def _poison_pages(eng, pages):
    """Fill physical ``pages`` of every page-pool leaf with garbage (127
    in int8 leaves, 1e4 in float ones), on either Engine."""
    if hasattr(eng, "device"):
        from repro_torch.models.api import page_leaves
        for _, leaf in page_leaves(eng.cache):
            ids = torch.as_tensor(pages, dtype=torch.int64)
            leaf[:, ids] = 127 if leaf.dtype == torch.int8 else 1e4
        return
    import jax
    import jax.numpy as jnp
    dst = jnp.asarray(pages, jnp.int32)

    def poison(path, leaf):
        if any(getattr(k, "key", None) == "pages" for k in path):
            fill = jnp.full(leaf[:, dst].shape,
                            127 if leaf.dtype == jnp.int8 else 1e4,
                            leaf.dtype)
            return leaf.at[:, dst].set(fill)
        return leaf

    eng.cache = jax.tree_util.tree_map_with_path(poison, eng.cache)


def _prefix_state(eng):
    return ({k: eng.counters[k] for k in PREFIX_KEYS},
            eng.allocator.state(), eng.prefix_index.state())


def _same_index(a, b):
    """Two ``PrefixIndex.state()`` dicts are equal (tokens as lists)."""
    def norm(s):
        return dict(s, entries=[dict(e, tokens=np.asarray(e["tokens"])
                                     .tolist()) for e in s["entries"]])
    return norm(a) == norm(b)


def _assert_same_prefix_state(jeng, teng):
    jc, ja, ji = _prefix_state(jeng)
    tc, ta, ti = _prefix_state(teng)
    assert tc == jc
    assert ta == ja
    assert _same_index(ti, ji)


# ===========================================================================
@pytest.mark.parametrize("mode,spec", [("none", False), ("none", True),
                                       ("int8", False), ("int8", True)])
def test_shared_preamble_matches_cold_and_jax(mode, spec):
    cfg, make = lifecycle_makers(mode)
    prompts = shared_prompts(cfg.vocab, 12, (5, 3, 7), seed=1)
    kw = dict(GEOM, max_len=32, spec=spec)
    with use_mesh(auto_mesh()):
        jwarm = serve_engine(make["jax"], prompts, prefix_cache=True, **kw)
    warm = serve_engine(make["torch"], prompts, prefix_cache=True, **kw)
    cold = serve_engine(make["torch"], prompts, **kw)
    assert warm.done == jwarm.done == cold.done
    assert warm.counters["prefix_hits"] >= 1
    assert warm.counters["prefix_tokens_saved"] >= 4
    _assert_same_prefix_state(jwarm, warm)
    # after the drain the only referenced pages are the index's
    from repro_torch.launch.prefix import PREFIX_OWNER
    assert warm.allocator.used_pages == len(warm.prefix_index)
    assert sorted(warm.allocator.pages_of(PREFIX_OWNER)) \
        == sorted(warm.prefix_index.pages())
    st_ = warm.stats()
    assert st_["prefix_hits"] == jwarm.stats()["prefix_hits"]
    # a hit prefills only its suffix
    assert st_["prefill_tokens"] == sum(len(p) for p in prompts) \
        - warm.counters["prefix_tokens_saved"]


def test_full_prompt_match_copies_boundary_page():
    """An exact repeat of an indexed prompt hits every page and
    duplicates the boundary page, where decode writes."""
    cfg, make = lifecycle_makers()
    prompt = rand_prompts(cfg.vocab, (8,), seed=3)[0]
    kw = dict(GEOM, batch=1, max_len=24)
    with use_mesh(auto_mesh()):
        jwarm = serve_engine(make["jax"], [prompt, prompt],
                             prefix_cache=True, **kw)
    warm = serve_engine(make["torch"], [prompt, prompt], prefix_cache=True,
                        **kw)
    cold = serve_engine(make["torch"], [prompt, prompt], **kw)
    assert warm.done == jwarm.done == cold.done
    assert warm.done[0] == warm.done[1]
    assert warm.counters["prefix_hits"] == 1
    assert warm.counters["cow_copies"] == 1
    assert warm.counters["prefix_tokens_saved"] == len(prompt) - 1
    _assert_same_prefix_state(jwarm, warm)


@pytest.mark.parametrize("chunk", [5, 16])
def test_page_size_misaligned_with_prefill_chunk(chunk):
    """A hit's suffix starts off the chunk grid (page 4, chunk 5 or 16)."""
    cfg, make = lifecycle_makers()
    prompts = shared_prompts(cfg.vocab, 12, (6, 2, 9), seed=4)
    kw = dict(GEOM, prefill_chunk=chunk, max_len=32)
    with use_mesh(auto_mesh()):
        jwarm = serve_engine(make["jax"], prompts, prefix_cache=True, **kw)
    warm = serve_engine(make["torch"], prompts, prefix_cache=True, **kw)
    cold = serve_engine(make["torch"], prompts, **kw)
    assert warm.done == jwarm.done == cold.done
    assert warm.counters["prefix_hits"] >= 1
    _assert_same_prefix_state(jwarm, warm)


def test_int8_kv_pages_share_and_cow_scales_too():
    """int8 KV pages: payload and scale pages share and copy together."""
    cfg, make = lifecycle_makers()
    prompt = rand_prompts(cfg.vocab, (8,), seed=5)[0]
    kw = dict(GEOM, batch=1, kv_bits=8, max_len=24)
    with use_mesh(auto_mesh()):
        jwarm = serve_engine(make["jax"], [prompt, prompt],
                             prefix_cache=True, **kw)
    warm = serve_engine(make["torch"], [prompt, prompt], prefix_cache=True,
                        **kw)
    cold = serve_engine(make["torch"], [prompt, prompt], **kw)
    assert warm.done == jwarm.done == cold.done
    assert warm.counters["cow_copies"] == 1
    _assert_same_prefix_state(jwarm, warm)


# ===========================================================================
def _midblock_finish(make, prompts):
    kw = dict(GEOM, batch=2, max_len=24)
    cold = make(**kw)
    cold.add_requests({0: prompts[0], 1: prompts[1]}, gen_len={0: 2, 1: 9})
    drain(cold)
    eng = make(prefix_cache=True, **kw)
    eng.submit(prompts[0][:8], gen_len=2)     # index the preamble first
    eng.try_admit()
    drain(eng)
    shared_before = eng.allocator.shared_pages()
    eng.add_requests({0: prompts[0], 1: prompts[1]}, gen_len={0: 2, 1: 9})
    hits = eng.counters["prefix_hits"]
    assert eng.allocator.shared_pages() >= shared_before
    eng.step_many(4)                          # slot 0 finishes inside it
    assert not eng.live[0] and eng.live[1]
    eng.retire_finished()                     # drops slot 0's shared holds
    held = [eng.allocator.refcount(p) for p in eng.prefix_index.pages()]
    drain(eng)
    return (cold.done, eng.done, hits, held, eng.allocator.used_pages,
            len(eng.prefix_index), eng.allocator.state())


def test_midblock_finish_of_one_sharer():
    cfg, make = lifecycle_makers()
    prompts = shared_prompts(cfg.vocab, 8, (2, 3), seed=6)
    with use_mesh(auto_mesh()):
        want = _midblock_finish(make["jax"], prompts)
    got = _midblock_finish(make["torch"], prompts)
    assert got == want
    cold, done, hits, held, used, n_index, _ = got
    assert hits == 2
    assert all(r >= 1 for r in held)
    assert done[-2:] == cold
    assert used == n_index


@pytest.mark.parametrize("batch,num_pages,spills", [(2, 10, False),
                                                     (3, 9, True)])
def test_preempt_spills_sharer_and_resumes(batch, num_pages, spills):
    """A preempted sharer drops its shared holds (payload copied to the
    host) and resumes on private pages; streams stay the cold ones.  The
    reference's cell (batch 2, 10 pages) fits without spilling; at batch
    3 over 9 pages sharers are spilled and resumed."""
    cfg, make = lifecycle_makers()
    prompts = shared_prompts(cfg.vocab, 8, (2, 3, 4), seed=7)
    kw = dict(GEOM, batch=batch, max_len=24, gen_len=8, prefix_cache=True,
              preempt=True, preempt_after=1, num_pages=num_pages)
    with use_mesh(auto_mesh()):
        jwarm = serve_engine(make["jax"], prompts, **kw)
    warm = serve_engine(make["torch"], prompts, **kw)
    cold = serve_engine(make["torch"], prompts, **dict(
        kw, prefix_cache=False, preempt=False, num_pages=None))
    assert warm.done == jwarm.done
    assert sorted(warm.done) == sorted(cold.done)
    for k in ("preemptions", "spilled_pages") + PREFIX_KEYS:
        assert warm.counters[k] == jwarm.counters[k], k
    assert (warm.counters["preemptions"] > 0) == spills
    _assert_same_prefix_state(jwarm, warm)


def _snapshot_round_trip(make, prompts):
    kw = dict(GEOM, batch=2, max_len=24, prefix_cache=True)
    ref = make(**kw)
    for p in prompts:
        ref.submit(p, gen_len=6)
    ref.try_admit()
    drain(ref)
    eng = make(**kw)
    for p in prompts:
        eng.submit(p, gen_len=6)
    eng.try_admit()
    eng.step_many(2)
    snap = eng.snapshot()
    eng.step_many(4)                          # diverge past the snapshot
    eng.restore(snap)
    n_index = len(eng.prefix_index)
    assert n_index == len(snap["prefix_index"]["entries"])
    drain(eng)
    return (ref.done, eng.done, ref.counters["prefix_hits"],
            eng.counters["prefix_hits"], n_index)


def test_snapshot_restore_round_trips_prefix_state():
    cfg, make = lifecycle_makers()
    prompts = shared_prompts(cfg.vocab, 8, (3, 2, 5), seed=8)
    with use_mesh(auto_mesh()):
        want = _snapshot_round_trip(make["jax"], prompts)
    got = _snapshot_round_trip(make["torch"], prompts)
    assert got == want
    assert got[0] == got[1] and got[2] == got[3]


# ===========================================================================
def _poisoned_original(make, prompt):
    kw = dict(GEOM, batch=1, max_len=24)
    solo = make(**kw)
    solo.submit(prompt, gen_len=6)
    solo.try_admit()
    drain(solo)
    eng = make(prefix_cache=True, **kw)
    eng.submit(prompt, gen_len=6)
    eng.try_admit()
    drain(eng)
    depth, pages, _ = eng.prefix_index.match(prompt)
    eng.submit(prompt, gen_len=6)             # a full-prompt hit: COW
    eng.try_admit()
    boundary = pages[-1]
    facts = (depth, eng.counters["cow_copies"],
             eng.allocator.refcount(boundary))
    _poison_pages(eng, [boundary])
    drain(eng)
    return solo.done, eng.done, facts


def test_poisoned_original_is_never_observed_after_divergence():
    cfg, make = lifecycle_makers()
    prompt = rand_prompts(cfg.vocab, (8,), seed=9)[0]
    with use_mesh(auto_mesh()):
        want = _poisoned_original(make["jax"], prompt)
    got = _poisoned_original(make["torch"], prompt)
    assert got == want
    solo, done, facts = got
    assert facts == (2, 1, 1)                 # index holds the original
    assert done == [solo[0], solo[0]]


def _poisoned_pages(make, prompts):
    kw = dict(GEOM, batch=1, max_len=24)
    eng = make(prefix_cache=True, **kw)
    eng.submit(prompts[0], gen_len=4)
    eng.try_admit()
    drain(eng)
    _poison_pages(eng, list(eng.allocator._free))   # unmapped pages
    eng.submit(prompts[1], gen_len=4)
    eng.try_admit()
    hits = eng.counters["prefix_hits"]
    drain(eng)
    ref = make(**kw)
    for p in prompts:
        ref.submit(p, gen_len=4)
    ref.try_admit()
    drain(ref)
    bad = make(prefix_cache=True, **kw)
    bad.submit(prompts[0], gen_len=4)
    bad.try_admit()
    drain(bad)
    _poison_pages(bad, bad.prefix_index.pages())    # mapped prefix pages
    bad.submit(prompts[1], gen_len=4)
    bad.try_admit()
    drain(bad)
    return eng.done, ref.done, bad.done, hits


def test_poisoned_free_pages_never_leak_into_warm_stream():
    """Garbage in unmapped pages changes nothing; garbage in a mapped
    prefix page does (so the suite would catch a sharing fault)."""
    cfg, make = lifecycle_makers()
    prompts = shared_prompts(cfg.vocab, 8, (3, 3), seed=10)
    with use_mesh(auto_mesh()):
        want = _poisoned_pages(make["jax"], prompts)
    got = _poisoned_pages(make["torch"], prompts)
    assert got == want
    warm, ref, bad, hits = got
    assert hits == 1 and warm == ref and bad[1] != ref[1]


def test_cache_edits_keep_tensor_addresses():
    """Copy-on-write, spill and resume, restore and the chaos poison write
    into the cache's tensors: their addresses (which the captured decode
    graphs hold) never change."""
    from repro_torch.train.graphs import _addresses
    cfg, make = lifecycle_makers()
    prompts = shared_prompts(cfg.vocab, 8, (2, 3, 4), seed=7)
    eng = make["torch"](**GEOM, batch=3, max_len=24, prefix_cache=True,
                        preempt=True, preempt_after=1, num_pages=9)
    before = _addresses(eng.cache)
    snap = eng.snapshot()
    for p in prompts + prompts[:1]:
        eng.submit(p, gen_len=8)
    eng.try_admit()
    drain(eng)
    assert eng.counters["preemptions"] > 0
    eng._poison_cache(float("nan"))
    eng.restore(snap)
    assert _addresses(eng.cache) == before
    assert not any(torch.isnan(t).any() for t in
                   (eng.cache["dense"]["pages"]["k"],
                    eng.cache["dense"]["pages"]["v"]))


# ===========================================================================
def _numpy_paged_cache(seed, kv8):
    """A gemma-smoke-shaped paged cache as numpy: (L, P+1, Hkv, ps, D)
    pages (int8 payload and f32 scales with ``kv8``) and block tables."""
    rs = np.random.RandomState(seed)
    shape = (2, 7, 1, 4, 8)
    pages = {"k": rs.randn(*shape).astype(np.float32),
             "v": rs.randn(*shape).astype(np.float32)}
    if kv8:
        pages = {"k": rs.randint(-127, 128, shape).astype(np.int8),
                 "v": rs.randint(-127, 128, shape).astype(np.int8),
                 "k_scale": rs.rand(*shape[:-1], 1).astype(np.float32),
                 "v_scale": rs.rand(*shape[:-1], 1).astype(np.float32)}
    bt = rs.randint(0, 7, (2, 2, 3)).astype(np.int32)
    return {"dense": {"pages": pages, "block_table": bt}}


@pytest.mark.parametrize("kv8", [False, True], ids=["f32", "int8"])
def test_copy_pages_fn_matches_reference_in_place(kv8):
    import jax
    import jax.numpy as jnp
    from repro.models.api import copy_pages_fn as jcopy
    from repro_torch.models.api import copy_pages_fn, page_leaves
    from repro_torch.train.graphs import _addresses
    host = _numpy_paged_cache(0, kv8)
    want = jcopy(jax.tree_util.tree_map(jnp.asarray, host), [1, 5], [3, 0])

    def to_torch(t):
        return {k: to_torch(v) for k, v in t.items()} if isinstance(t, dict) \
            else torch.from_numpy(t.copy())
    cache = to_torch(host)
    before = _addresses(cache)
    copy_pages_fn(cache, [1, 5], [3, 0])
    assert _addresses(cache) == before
    for k, v in want["dense"]["pages"].items():
        assert np.array_equal(cache["dense"]["pages"][k].numpy(),
                              np.asarray(v)), k
    assert np.array_equal(cache["dense"]["block_table"].numpy(),
                          host["dense"]["block_table"])
    # a scalar pair, then the spill payload's host gather and scatter
    copy_pages_fn(cache, 2, 6)
    assert torch.equal(cache["dense"]["pages"]["k"][:, 6],
                       cache["dense"]["pages"]["k"][:, 2])
    assert [p for p, _ in page_leaves(cache)] == sorted(
        f"/dense/pages/{k}" for k in host["dense"]["pages"])


def test_page_payload_gather_and_scatter_round_trip():
    """``_page_payload`` copies pages to the host; ``_write_pages`` puts
    them into other physical pages in place, bitwise."""
    cfg, make = lifecycle_makers()
    eng = make["torch"](**GEOM, batch=2, max_len=24, kv_bits=8)
    from repro_torch.models.api import page_leaves
    from repro_torch.train.graphs import _addresses
    g = torch.Generator().manual_seed(0)
    for _, leaf in page_leaves(eng.cache):
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g))
        else:
            leaf.copy_(torch.rand(leaf.shape, generator=g))
    before = _addresses(eng.cache)
    payload = eng._page_payload([2, 4])
    assert all(t.device.type == "cpu" for t in payload.values())
    eng._write_pages(payload, [7, 1])
    assert _addresses(eng.cache) == before
    for _, leaf in page_leaves(eng.cache):
        assert torch.equal(leaf[:, [7, 1]], leaf[:, [2, 4]])


# ===========================================================================
OPS = st.lists(st.tuples(st.sampled_from(["alloc", "share", "free",
                                          "transfer", "spill", "adopt"]),
                         st.integers(0, 2 ** 16)), min_size=1, max_size=40)


@settings(max_examples=40, deadline=None)
@given(st.integers(2, 24), OPS)
def test_allocator_matches_reference_ops(num_pages, ops):
    """The same random op sequence on both allocators: equal states,
    refcounts and per-owner pages after every op, and equal refusals."""
    from repro.launch.paging import PageAllocator as JAlloc
    from repro_torch.launch.paging import PageAllocator
    ja, ta = JAlloc(num_pages, 4), PageAllocator(num_pages, 4)
    owners = [0, 1, "__prefix__"]
    for op, seed in ops:
        rs = np.random.RandomState(seed)
        held = sorted(ja._owner)
        owner = owners[rs.randint(len(owners))]
        if op == "alloc":
            args = (int(rs.randint(1, num_pages + 1)),)
            kw = {"owner": owner}
        elif op in ("share", "free", "transfer"):
            pick = [p for p in held if rs.rand() < 0.5]
            if rs.rand() < 0.2 and held:
                pick = pick + [held[0]]           # maybe a duplicate
            if rs.rand() < 0.1:
                pick = pick + [num_pages + 3]     # never allocated
            args, kw = ((pick, owner) if op == "transfer" else (pick,)), {}
        elif op == "spill":
            args, kw = (owner,), {}
        else:
            free = sorted(ja._free)
            args = ([p for p in free if rs.rand() < 0.3],)
            kw = {"owner": owner}
        outs = []
        for a in (ja, ta):
            try:
                outs.append(("ok", getattr(a, op)(*args, **kw)))
            except (MemoryError, ValueError) as e:
                outs.append((type(e).__name__, None))
        assert outs[0] == outs[1], (op, args)
        assert ta.state() == ja.state()
        for p in range(num_pages):
            assert ta.refcount(p) == ja.refcount(p)
        for o in owners:
            assert ta.pages_of(o) == ja.pages_of(o)
        assert (ta.free_pages, ta.used_pages, ta.shared_pages()) \
            == (ja.free_pages, ja.used_pages, ja.shared_pages())
    clone = PageAllocator(num_pages, 4)
    clone.load_state(ja.state())
    assert clone.state() == ja.state()


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 3), st.lists(st.tuples(
    st.sampled_from(["put", "match", "touch", "evict"]),
    st.integers(0, 2 ** 16)), min_size=1, max_size=30))
def test_prefix_index_matches_reference_ops(page_size, ops):
    """The same puts, matches, touches and evictions (with protect and a
    class floor) on both indexes over twin allocators: equal results and
    equal states."""
    from repro.launch.paging import PageAllocator as JAlloc
    from repro.launch.prefix import PREFIX_OWNER as JOWN
    from repro.launch.prefix import PrefixIndex as JIndex
    from repro_torch.launch.paging import PageAllocator
    from repro_torch.launch.prefix import PREFIX_OWNER, PrefixIndex
    assert JOWN == PREFIX_OWNER
    sides = [(JIndex(page_size), JAlloc(32, page_size)),
             (PrefixIndex(page_size), PageAllocator(32, page_size))]
    corpus = np.random.RandomState(0).randint(0, 3, (6, 4 * page_size))
    classes = [None, "realtime", "batch"]
    for op, seed in ops:
        rs = np.random.RandomState(seed)
        toks = corpus[rs.randint(len(corpus))][:rs.randint(0, 4 * page_size)]
        u, want = rs.rand(40), int(rs.randint(0, 4))   # drawn once for both
        outs = []
        for idx, alloc in sides:
            if op == "put":
                keys = idx.keys_for(toks)
                g = next((g for g, k in enumerate(keys) if k not in idx),
                         None)
                if g is None or not alloc.free_pages:
                    outs.append(None)
                    continue
                page = alloc.alloc(1, owner=PREFIX_OWNER)[0]
                idx.put(keys[g], keys[g - 1] if g else b"",
                        toks[g * page_size:(g + 1) * page_size], page, g,
                        cls=classes[seed % 3])
                outs.append(page)
            elif op == "match":
                outs.append(idx.match(toks))
            elif op == "touch":
                keys = idx.keys_for(toks)
                outs.append(idx.touch(keys[0]) if keys else None)
            else:
                pages = sorted(idx.pages())
                if pages and u[0] < 0.5:
                    alloc.share([pages[0]])       # a slot maps one page
                protect = {p for i, p in enumerate(pages) if u[1 + i] < 0.2}
                outs.append(idx.evict(alloc, want, protect=protect,
                                      floor=classes[seed % 3]))
        assert outs[0] == outs[1], op
        assert _same_index(sides[1][0].state(), sides[0][0].state())
        assert sides[1][1].state() == sides[0][1].state()
    clone = PrefixIndex(page_size)
    clone.load_state(sides[0][0].state())
    assert _same_index(clone.state(), sides[0][0].state())
