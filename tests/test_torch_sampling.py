"""Sampling parity: the port's threefry noise and token draws against
``jax.random`` and ``repro.kernels.{sampling,ref}`` on the CPU.

* ``prng.PRNGKey``/``fold_in``/``random_bits``/``uniform`` are bitwise
  ``jax.random``'s (partitionable threefry, jax 0.9's default) over
  seeds, steps and shapes, an odd V and (2, 256000) among them.
* ``prng.gumbel`` is ``-log(-log(u))`` of a bitwise uniform; XLA's CPU
  ``log`` is not torch's (neither is correctly rounded), so the noise is
  held at a few float32 ulps of ``max(|g|, 1)``: GUMBEL_ULPS.
* ``sample_tokens_fused`` and ``sample_tokens_ref`` give the reference
  lowerings' tokens, exactly, on shared numpy logits and keys: greedy,
  negative temperature, ``top_k`` 0 and past V, and logits tied at the
  k-th rank.
* The decode loop of ``build_decode_loop`` samples the JAX loop's
  tokens with the reference's signature, and ``build_serve_step`` is the
  model's decode step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import sampling as jsampling  # noqa: E402
from repro_torch.kernels import ops, prng  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import sampling as tsampling  # noqa: E402

#: |port gumbel - jax gumbel| <= GUMBEL_ULPS * eps32 * max(|g|, 1): the
#: two CPU logs differ by about an ulp, twice over (measured: 9.5e-7 at
#: most over 1.5M draws, i.e. 1 ulp of g in [8, 16))
GUMBEL_ULPS = 4

SEEDS = [0, 42, -1, 2**31 - 1]
STEPS = [0, 1, 7, 123456]
SHAPES = [(1,), (5,), (3, 1001), (2, 256000)]


def _keys(seed, step):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    tk = prng.fold_in(prng.PRNGKey(seed), step)
    return jk, tk


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS + [2**33 + 7])
def test_prng_key_is_jax_key(seed):
    assert (_u32(prng.PRNGKey(seed)) == np.asarray(
        jax.random.PRNGKey(seed))).all()


@pytest.mark.parametrize("step", STEPS + [2**31 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_is_jax_fold_in(seed, step):
    """An int step and a 0-d int32 tensor step (what a captured block
    folds in) give JAX's key."""
    jk, tk = _keys(seed, step)
    assert (_u32(tk) == np.asarray(jk)).all()
    tt = prng.fold_in(prng.PRNGKey(seed), torch.tensor(step,
                                                       dtype=torch.int32))
    assert torch.equal(tt, tk)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_folds_a_block_of_steps_at_once(seed):
    """A tensor of steps (what a decode block folds in, one pass) gives
    each step's key."""
    steps = torch.tensor(STEPS + [2**31 - 1], dtype=torch.int32)
    keys = prng.fold_in(prng.PRNGKey(seed), steps)
    assert keys.shape == (len(steps), 2)
    for k, step in zip(keys, steps.tolist()):
        assert (_u32(k) == np.asarray(jax.random.fold_in(
            jax.random.PRNGKey(seed), step))).all()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_bitwise(seed, step, shape):
    jk, tk = _keys(seed, step)
    assert (_u32(prng.random_bits(tk, shape))
            == np.asarray(jax.random.bits(jk, shape))).all()
    got = prng.uniform(tk, shape).numpy()
    want = np.asarray(jax.random.uniform(jk, shape))
    assert (got.view(np.uint32) == want.view(np.uint32)).all()
    tiny = float(np.finfo(np.float32).tiny)
    got = prng.uniform(tk, shape, tiny, 1.0).numpy()
    want = np.asarray(jax.random.uniform(jk, shape, minval=tiny, maxval=1.0))
    assert (got.view(np.uint32) == want.view(np.uint32)).all()
    assert got.min() >= tiny and got.max() < 1.0


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_ulps(seed, shape):
    for step in (0, 5):
        jk, tk = _keys(seed, step)
        got = tsampling.gumbel_noise(tk, shape).numpy()
        want = np.asarray(jsampling.gumbel_noise(jk, shape))
        assert got.dtype == np.float32 and np.isfinite(got).all()
        bound = GUMBEL_ULPS * np.finfo(np.float32).eps \
            * np.maximum(np.abs(want), 1.0)
        assert (np.abs(got - want) <= bound).all()


def test_random_bits_refuses_counts_past_int32():
    with pytest.raises(ValueError, match="2\\*\\*31"):
        prng.random_bits(prng.PRNGKey(0), (2**16, 2**15))


def _case(name, b, v, seed):
    """Logits and per-slot params of one sampling case."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    temp = np.full((b,), 0.8, np.float32)
    top_k = np.full((b,), 5, np.int32)
    if name == "greedy":
        temp[:] = 0.0
    elif name == "negative temperature":
        temp[::2] = -1.0
    elif name == "top_k 0":
        top_k[:] = 0
    elif name == "top_k past V":
        top_k[:] = v + 7
    elif name == "tied at the k-th rank":
        # ten equal top logits: rank order (index) decides which 5 remain
        logits[:, 3:13] = logits.max() + 1.0
        top_k[:] = 5
        temp[:] = 50.0
    elif name == "mixed":
        temp[1::3] = 0.0
        top_k[2::3] = 0
    return logits, temp, top_k


CASES = ["greedy", "negative temperature", "top_k 0", "top_k past V",
         "tied at the k-th rank", "mixed"]


@pytest.mark.parametrize("bv", [(4, 37), (8, 1001), (2, 256000)], ids=str)
@pytest.mark.parametrize("name", CASES)
def test_sampled_tokens_match_reference(name, bv):
    """Both port lowerings give both reference lowerings' tokens over
    several steps' keys; key None is the greedy argmax."""
    b, v = bv
    logits, temp, top_k = _case(name, b, v, seed=len(name) + v)
    tl = torch.from_numpy(logits)
    for step in range(3):
        jk, tk = _keys(11, step)
        want = np.asarray(jsampling.sample_tokens_fused(
            jnp.asarray(logits), temp, top_k, jk))
        assert (np.asarray(jref.sample_tokens_ref(
            jnp.asarray(logits), temp, top_k, jk)) == want).all()
        for fn in (tsampling.sample_tokens_fused, tref.sample_tokens_ref):
            got = fn(tl, torch.from_numpy(temp), torch.from_numpy(top_k), tk)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
        if name == "tied at the k-th rank":
            assert set(want.tolist()) <= set(range(3, 8))
        if name == "greedy":
            np.testing.assert_array_equal(want, logits.argmax(-1))
    greedy = logits.argmax(-1)
    for fn in (tsampling.sample_tokens_fused, tref.sample_tokens_ref):
        np.testing.assert_array_equal(fn(tl, temp, top_k).numpy(), greedy)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_ops_sample_tokens_dispatch(backend):
    """``ops.sample_tokens`` takes the reference's signature on both
    backends (the ``cuda`` lowering runs its torch ops on the CPU)."""
    logits, temp, top_k = _case("mixed", 6, 300, seed=3)
    jk, tk = _keys(5, 9)
    want = np.asarray(jsampling.sample_tokens_fused(
        jnp.asarray(logits), temp, top_k, jk))
    got = ops.sample_tokens(torch.from_numpy(logits), temp, top_k, tk,
                            backend=backend)
    np.testing.assert_array_equal(got.numpy(), want)
    got = ops.sample_tokens(torch.from_numpy(logits), temp, top_k,
                            backend=backend)
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_sampled_decode_loop_matches_reference(mode):
    """gemma-2b smoke on the dense cache: two blocks of the port's
    ``build_decode_loop`` with a key and a step offset emit the JAX loop's
    tokens (mixed greedy and sampled slots), and ``build_serve_step``'s
    logits are the reference's."""
    from torch_parity import contexts, smoke_params
    from repro.models import api as japi
    from repro.train import step as jstep
    from repro_torch.models import api as tapi
    from repro_torch.train import step as tstep
    cfg, jp, tp = smoke_params(mode)
    jctx, tctx = contexts(mode)
    b, plen, steps, max_len = 3, 6, 4, 16
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (b, plen)).astype(np.int32)
    temp = np.array([0.8, 0.0, 1.3], np.float32)
    top_k = np.array([0, 0, 7], np.int32)

    jcache = japi.get_family(cfg).init_cache(cfg, b, max_len, jnp.float32)
    jl, jcache = jstep.build_prefill_step(cfg, jctx)(
        jp, {"tokens": jnp.asarray(prompt)}, jcache)
    tcache = tapi.init_cache_fn(cfg, b, max_len, torch.float32, "cpu")
    tl, tcache = tstep.build_prefill_step(cfg, tctx)(
        tp, {"tokens": torch.from_numpy(prompt)}, tcache)
    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    assert (tl[:, -1].argmax(-1).numpy() == tok[:, 0]).all()
    pos = np.full((b,), plen, np.int32)

    jloop = jstep.build_decode_loop(cfg, jctx, steps)
    tloop = tstep.build_decode_loop(cfg, tctx, steps)
    jsp = {"temperature": jnp.asarray(temp), "top_k": jnp.asarray(top_k)}
    tsp = {"temperature": torch.from_numpy(temp),
           "top_k": torch.from_numpy(top_k)}
    jkey, tkey = jax.random.PRNGKey(3), prng.PRNGKey(3)
    jt, tt = jnp.asarray(tok), torch.from_numpy(tok)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    jlive, tlive = jnp.ones((b,), bool), torch.ones((b,), dtype=torch.bool)
    stop = np.full((b,), max_len, np.int32)
    for blk in range(2):
        step0 = blk * steps
        jcache, jt, jpos, jlive, jblock, _, _ = jloop(
            jp, jcache, jt, jpos, jlive, jnp.asarray(stop), jsp, jkey,
            jnp.int32(step0), jnp.int32(-1))
        tcache, tt, tpos, tlive, tblock, _, tfault = tloop(
            tp, tcache, tt, tpos, tlive, torch.from_numpy(stop), tsp, tkey,
            torch.tensor(step0, dtype=torch.int32), -1)
        np.testing.assert_array_equal(tblock.numpy(), np.asarray(jblock))
        assert not tfault.any()
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # the serve step: one decode step's logits from the same cache state
    # (f32 compute; the model suites' tolerance)
    jlog, _ = jstep.build_serve_step(cfg, jctx)(jp, jcache, jt, jpos)
    tlog, _ = tstep.build_serve_step(cfg, tctx)(tp, tcache, tt, tpos)
    assert tlog.shape == (b, 1, cfg.vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=0)
