"""Shared helpers of the ``test_torch_*`` parity suites.

They hand the same numpy data to the JAX reference (``repro``) and the
PyTorch port (``repro_torch``).  Only tests import both packages.
"""

from __future__ import annotations

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


def smoke_params(mode: str, seed: int = 0, arch: str = "gemma-2b"):
    """``arch`` smoke params from the reference's init, (cfg, JAX tree,
    port tree on the CPU); ``mode="int8"`` quantizes with the reference's
    ``quantize_for_serving`` before converting."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch.serve import quantize_for_serving
    from repro.models.api import get_family
    from repro.nn.context import QuantContext as JCtx
    from repro_torch.convert import params_from_numpy

    cfg = get_config(arch).smoke()
    params = get_family(cfg).init(jax.random.PRNGKey(seed), cfg)
    qtype = None
    if mode == "int8":
        jpol, _, qtype = int8_policies()
        params = quantize_for_serving(
            params, JCtx(mode="int8", policy=jpol, compute_dtype=jnp.float32))
    return cfg, params, params_from_numpy(jax_to_numpy(params), qtype=qtype)


def contexts(mode: str, **knobs):
    """Matching f32 QuantContexts (JAX, port) for ``mode``."""
    import jax.numpy as jnp
    import torch
    from repro.core.precision import PrecisionPolicy as JPolicy
    from repro.nn.context import QuantContext as JCtx
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.nn.context import QuantContext
    if mode == "int8":
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
