"""Shared helpers of the ``test_torch_*`` parity suites.

They hand the same numpy data to the JAX reference (``repro``) and the
PyTorch port (``repro_torch``).  Only tests import both packages.
"""

from __future__ import annotations

import contextlib

import numpy as np


def auto_mesh():
    """A 1x1 mesh with Auto axes.  ``repro.launch.mesh.make_local_mesh``
    gets Explicit axes from jax 0.9, under which the reference's sharding
    constraints raise; the parity suites build their own mesh instead."""
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def jax_to_numpy(tree):
    """JAX params -> nested dict of numpy; a QTensor -> {"data", "scale"}."""
    from repro.core.qtypes import QTensor
    if isinstance(tree, QTensor):
        return {"data": np.asarray(tree.data), "scale": np.asarray(tree.scale)}
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def int8_policies():
    """The serve CLI's int8 policy (``FixedPointType(8, 4)``) on both sides."""
    from repro.core.precision import PrecisionPolicy as JPolicy
    from repro.core.qtypes import FixedPointType as JFixed
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    return (JPolicy.uniform(JFixed(8, 4)),
            PrecisionPolicy.uniform(FixedPointType(8, 4)), FixedPointType(8, 4))


#: the reference's f32 init per (arch, seed, depth), shared by both modes
_INIT = {}


def smoke_params(mode: str, seed: int = 0, arch: str = "gemma-2b",
                 n_layers=None):
    """``arch`` smoke params from the reference's init, (cfg, JAX tree,
    port tree on the CPU); ``mode="int8"`` quantizes with the reference's
    ``quantize_for_serving`` before converting.  ``n_layers`` replaces the
    smoke config's depth (the hybrid at 5 layers has a tail).  The init
    runs once per process for each (arch, seed, depth); each call converts
    afresh, so callers may edit the port's tensors."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch.serve import quantize_for_serving
    from repro.models.api import get_family
    from repro.nn.context import QuantContext as JCtx
    from repro_torch.convert import params_from_numpy

    key = (arch, seed, n_layers)
    if key not in _INIT:
        cfg = get_config(arch).smoke()
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        _INIT[key] = (cfg, get_family(cfg).init(jax.random.PRNGKey(seed),
                                                cfg))
    cfg, params = _INIT[key]
    # fresh containers over the shared (immutable) arrays
    params = jax.tree_util.tree_map(lambda a: a, params)
    qtype = None
    if mode == "int8":
        jpol, _, qtype = int8_policies()
        params = quantize_for_serving(
            params, JCtx(mode="int8", policy=jpol, compute_dtype=jnp.float32))
    return cfg, params, params_from_numpy(jax_to_numpy(params), qtype=qtype)


#: the VLM's smoke params per weight mode (cfg, JAX tree, port tree)
_VLM = {}


def vlm_smoke_params(mode: str, seed: int = 0):
    """llama-3.2-vision-11b smoke params (:func:`smoke_params`) with the
    cross blocks' gates drawn nonzero from ``seed`` (uniform in +-[0.3,
    1.0]) and set on both trees: the reference's init leaves them at 0,
    where ``tanh(0) = 0`` makes every cross layer add nothing, so a
    parity test could not see the image or the cross-attention.  The
    trees are built once per process; callers get fresh containers."""
    import jax.numpy as jnp
    import torch
    if mode not in _VLM:
        cfg, jp, tp = smoke_params(mode, seed=seed,
                                   arch="llama-3.2-vision-11b")
        rs = np.random.RandomState(seed + 7)
        for name in ("gate_attn", "gate_mlp"):
            g = (rs.uniform(0.3, 1.0, jp["cross"][name].shape)
                 * rs.choice([-1.0, 1.0], jp["cross"][name].shape)
                 ).astype(np.float32)
            jp["cross"][name] = jnp.asarray(g)
            tp["cross"][name] = torch.from_numpy(g)
        _VLM[mode] = (cfg, jp, tp)
    cfg, jp, tp = _VLM[mode]
    return cfg, _fresh(jp), _fresh(tp)


def _fresh(tree):
    if isinstance(tree, dict):
        return {k: _fresh(v) for k, v in tree.items()}
    return tree


def contexts(mode: str, **knobs):
    """Matching f32 QuantContexts (JAX, port) for ``mode``; ``int8`` and
    ``fake`` under the serve CLI's ``FixedPointType(8, 4)`` policy (without
    a weight type a ``fake`` layer runs as ``none``)."""
    import jax.numpy as jnp
    import torch
    from repro.core.precision import PrecisionPolicy as JPolicy
    from repro.nn.context import QuantContext as JCtx
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.nn.context import QuantContext
    if mode in ("int8", "fake"):
        jpol, pol, _ = int8_policies()
    else:
        jpol, pol = JPolicy(), PrecisionPolicy()
    return (JCtx(mode=mode, policy=jpol, compute_dtype=jnp.float32, **knobs),
            QuantContext(mode=mode, policy=pol, compute_dtype=torch.float32,
                         **knobs))


#: the engine parity suites' geometry: batch 2 with three requests (a lane
#: is refilled mid-flight), small pages, a ragged prefill chunk
ENGINE_GEN, ENGINE_MAX_LEN, ENGINE_PLEN = 8, 24, 13
ENGINE_KW = dict(batch=2, max_len=ENGINE_MAX_LEN, paged=True, page_size=4,
                 prefill_chunk=5)


def engine_prompts(vocab):
    from repro.data.pipeline import SyntheticLM
    src = SyntheticLM(vocab, seed=0)
    return [src.tokens(i, 1, ENGINE_PLEN + 1)[0, :-1] for i in range(3)]


def serve_jax(cfg, ctx, params, prompts, kw):
    """Greedy streams of the reference ``Engine`` (``ENGINE_KW`` updated
    by ``kw``) on an Auto mesh."""
    from repro.dist.constrain import use_mesh
    from repro.launch.serve import Engine
    with use_mesh(auto_mesh()):
        eng = Engine(cfg, ctx, params, auto_mesh(), **{**ENGINE_KW, **kw})
        ids = [eng.submit(p, gen_len=ENGINE_GEN) for p in prompts]
        eng.try_admit()
        while eng.live.any() or eng.waiting:
            eng.step_many(4)
        eng.retire_finished()
    return [eng.results[i]["tokens"] for i in ids], eng


def serve_torch(cfg, ctx, params, prompts, kw):
    """Greedy streams of the port's ``Engine(device="cpu")``; on the CPU no
    kernel launches (the wrappers run their plain versions)."""
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import Engine
    eng = Engine(cfg, ctx, params, device="cpu", **{**ENGINE_KW, **kw})
    ids = [eng.submit(p, gen_len=ENGINE_GEN) for p in prompts]
    eng.try_admit()
    while eng.live.any() or eng.waiting:
        eng.step_many(4)
    eng.retire_finished()
    assert launch_counts() == {k: 0 for k in launch_counts()}
    return [eng.results[i]["tokens"] for i in ids], eng


#: (cfg, JAX ctx, JAX params, port ctx, port params) per (weight mode, arch)
_LIFECYCLE = {}


def lifecycle_makers(mode: str = "none", arch: str = "gemma-2b"):
    """``(cfg, {"jax": make, "torch": make})`` for the lifecycle suites:
    ``make(**kw)`` builds the reference Engine (on :func:`auto_mesh`; call
    it and drive it inside ``use_mesh(auto_mesh())``) or the port's Engine
    on the CPU, over the same ``arch`` smoke weights (``mode`` "none" or
    "int8"), with f32 compute."""
    if (mode, arch) not in _LIFECYCLE:
        cfg, jparams, tparams = smoke_params(mode, arch=arch)
        jctx, tctx = contexts(mode)
        _LIFECYCLE[mode, arch] = (cfg, jctx, jparams, tctx, tparams)
    cfg, jctx, jparams, tctx, tparams = _LIFECYCLE[mode, arch]

    def make_jax(**kw):
        from repro.launch.serve import Engine
        return Engine(cfg, jctx, jparams, auto_mesh(), **kw)

    def make_torch(**kw):
        from repro_torch.launch.serve import Engine
        return Engine(cfg, tctx, tparams, device="cpu", **kw)

    return cfg, {"jax": make_jax, "torch": make_torch}


def drain(eng, block: int = 4):
    """Run blocks until nothing is live or queued, then retire."""
    while eng.live.any() or eng.waiting:
        eng.step_many(block)
    eng.retire_finished()
    return eng


def serve_engine(make, prompts, *, gen_len=6, block=4, batch=2, max_len=32,
                 **kw):
    """Submit ``prompts`` to ``make(batch=, max_len=, **kw)``, drain it."""
    eng = make(batch=batch, max_len=max_len, **kw)
    for p in prompts:
        eng.submit(p, gen_len=gen_len)
    eng.try_admit()
    return drain(eng, block)


def rand_prompts(vocab, lens, seed=0):
    """Prompts of ``lens`` tokens drawn with numpy from ``seed``."""
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (n,)) for n in lens]


def shared_prompts(vocab, pre_len, tail_lens, seed=0):
    """Prompts opening with one shared ``pre_len``-token preamble."""
    rs = np.random.RandomState(seed)
    pre = rs.randint(0, vocab, (pre_len,))
    return [np.concatenate([pre, rs.randint(0, vocab, (n,))])
            for n in tail_lens]


class FakeClock:
    """A deterministic engine clock: ``tick`` added per read."""

    def __init__(self, t=0.0, tick=0.0):
        self.t = float(t)
        self.tick = float(tick)

    def __call__(self):
        self.t += self.tick
        return self.t

    def advance(self, dt):
        self.t += float(dt)


#: hits and misses of :func:`reuse_xla_executables`' table (a process's)
XLA_REUSE = {"hits": 0, "misses": 0}
_EXECUTABLES = {}


@contextlib.contextmanager
def reuse_xla_executables():
    """Within the block, an XLA compilation of a program that this process
    compiled before -- the same MLIR text, compile options and devices --
    returns the executable compiled then instead of compiling again.

    The reference Engine jits its steps as closures of each instance, so
    every Engine a suite builds traced, lowered and compiled the same
    programs anew; the compile was most of a reference run's time.  The
    hook wraps ``jax._src.compiler.backend_compile_and_load`` (nothing in
    ``src/repro`` changes); programs with host callbacks always compile.
    An executable is a pure function of its program, options and devices,
    so the results are the ones a fresh compile gives.  The executables
    are dropped when the block ends."""
    import hashlib

    from jax._src import compiler
    real = compiler.backend_compile_and_load

    def cached(backend, module, executable_devices, options, host_callbacks):
        if host_callbacks:
            return real(backend, module, executable_devices, options,
                        host_callbacks)
        key = (id(backend),
               hashlib.sha256(str(module).encode()).hexdigest(),
               options.SerializeAsString(),
               tuple(d.id for d in executable_devices))
        exe = _EXECUTABLES.get(key)
        if exe is None:
            XLA_REUSE["misses"] += 1
            exe = _EXECUTABLES[key] = real(backend, module,
                                           executable_devices, options,
                                           host_callbacks)
        else:
            XLA_REUSE["hits"] += 1
        return exe

    compiler.backend_compile_and_load = cached
    try:
        yield
    finally:
        compiler.backend_compile_and_load = real
        _EXECUTABLES.clear()


try:
    import pytest as _pytest
except ImportError:                      # the helpers outside pytest
    _pytest = None

if _pytest is not None:
    @_pytest.fixture(autouse=True, scope="module")
    def reuse_executables():
        """A suite that imports this fixture runs under
        :func:`reuse_xla_executables`, module by module."""
        with reuse_xla_executables():
            yield
