"""The port's sharding rules vs ``repro.dist``, exactly, and what runs in
one process.

* ``param_specs`` (f32 and int8 ``ptq_params`` trees), ``batch_specs``
  and ``cache_specs`` (dense and paged) of every arch in ``ARCH_IDS`` at
  full width, on the (1, 1), (4, 2), (16, 16) and (2, 16, 16) meshes:
  the JAX side on ``jax.eval_shape`` structs and ``AbstractMesh``\\ es,
  the port on meta tensors of the same shapes and ``{axis: size}``
  dicts; the specs must be equal.
* Under a fake process group of 256 and of 512 ranks, each leaf's local
  shard shape from ``named`` (``make_production_mesh``) equals
  ``NamedSharding(AbstractMesh, spec).shard_shape``, and equals what
  DTensor computes for those placements.
* ``guard_spec`` against the reference's on random dims and meshes (the
  reference's hypothesis test); ``constrain`` is the identity without a
  mesh; the mesh builders refuse what they cannot build.
* ``moe_einsum`` without a mesh: olmoe-1b-7b smoke loss and gradients
  with the flag set on both packages (relative L2 1e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamed  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCH_IDS, get_config as j_get_config  # noqa: E402
from repro.core.qtypes import FixedPointType as JFixed  # noqa: E402
from repro.core.qtypes import QTensor as JQTensor  # noqa: E402
from repro.core.quantize import ptq_params as j_ptq  # noqa: E402
from repro.data.pipeline import batch_struct as j_batch_struct  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models.api import get_family as j_family  # noqa: E402
from repro_torch.core.qtypes import FixedPointType, QTensor  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from train_parity import flat, rel_l2  # noqa: E402

MESHES = {(1, 1): ("data", "model"), (4, 2): ("data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}


def _jax_trees(arch):
    """(params, int8 params, batch, dense cache, paged cache or None) as
    eval_shape structs of the full-width config."""
    cfg = j_get_config(arch)
    key = jax.random.PRNGKey(0)
    if cfg.family == "mlp":
        from repro.models import mlp
        params = jax.eval_shape(lambda: mlp.init(key))
        q = jax.eval_shape(lambda: j_ptq(mlp.init(key), JFixed(8, 4)))
        return params, q, None, None, None
    fam = j_family(cfg)
    params = jax.eval_shape(lambda: fam.init(key, cfg))
    q = jax.eval_shape(lambda: j_ptq(fam.init(key, cfg), JFixed(8, 4)))
    batch = j_batch_struct(cfg, 32, 64)
    cache = jax.eval_shape(lambda: fam.init_cache(cfg, 32, 64))
    paged = (jax.eval_shape(lambda: fam.init_paged_cache(cfg, 32, 64, 16, 8))
             if hasattr(fam, "init_paged_cache") else None)
    return params, q, batch, cache, paged


_TREES = {}


def trees(arch):
    if arch not in _TREES:
        _TREES[arch] = _jax_trees(arch)
    return _TREES[arch]


def _meta(tree):
    """A JAX struct tree -> the port's tree of meta tensors (a QTensor ->
    the port's QTensor of meta payload and scale)."""
    if isinstance(tree, JQTensor):
        return QTensor(_meta(tree.data), _meta(tree.scale),
                       FixedPointType(8, 4))
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_meta(v) for v in tree)
    return torch.empty(tuple(tree.shape), device="meta")


def _jspecs(tree):
    """A JAX spec tree -> {path: tuple} (a QTensor of specs -> two)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, (JP, JQTensor)))[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        if isinstance(leaf, JQTensor):
            out[key + "#data"] = tuple(leaf.data)
            out[key + "#scale"] = tuple(leaf.scale)
        else:
            out[key] = tuple(leaf)
    return out


def _tspecs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tspecs(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, QTensor):
        return {prefix + "#data": tuple(tree.data),
                prefix + "#scale": tuple(tree.scale)}
    if isinstance(tree, tuple) and not isinstance(tree, tsh.P):
        out = {}
        for i, v in enumerate(tree):
            out.update(_tspecs(v, f"{prefix}/[{i}]"))
        return out
    return {prefix: tuple(tree)}


@pytest.mark.parametrize("shape", list(MESHES), ids=str)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_match_reference(arch, shape):
    jmesh = AbstractMesh(shape, MESHES[shape])
    tmesh = dict(zip(MESHES[shape], shape))
    params, q, batch, cache, paged = trees(arch)
    cases = [(jsh.param_specs, tsh.param_specs, params),
             (jsh.param_specs, tsh.param_specs, q)]
    if batch is not None:
        cases += [(jsh.batch_specs, tsh.batch_specs, batch),
                  (jsh.cache_specs, tsh.cache_specs, cache)]
    if paged is not None:
        cases.append((jsh.cache_specs, tsh.cache_specs, paged))
    for jrule, trule, tree in cases:
        want = _jspecs(jrule(tree, jmesh))
        got = _tspecs(trule(_meta(tree), tmesh))
        assert got == want


@pytest.fixture
def fake_world(request):
    """A fake process group of ``request.param`` ranks in this process
    (torch's test-only backend), torn down after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = request.param
    dist.init_process_group("fake", store=FakeStore(), rank=world - 3,
                            world_size=world)
    try:
        yield world
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("fake_world", [256, 512], indirect=True)
def test_shard_shapes_match_named_sharding(fake_world):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.launch.mesh import make_production_mesh
    multi = fake_world == 512
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    shape = (2, 16, 16) if multi else (16, 16)
    jmesh = AbstractMesh(shape, MESHES[shape])
    n = 0
    for arch in ("gemma-2b", "deepseek-v2-236b", "zamba2-1.2b",
                 "whisper-base"):
        params, q, batch, cache, paged = trees(arch)
        for tree, rule in ((params, tsh.param_specs), (q, tsh.param_specs),
                           (batch, tsh.batch_specs),
                           (cache, tsh.cache_specs)):
            specs = _tspecs(rule(_meta(tree), mesh))
            leaves = {}
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda x: isinstance(x, JQTensor))[0]:
                key = "/".join(str(getattr(k, "key", k)) for k in path)
                if isinstance(leaf, JQTensor):
                    leaves[key + "#data"] = leaf.data.shape
                    leaves[key + "#scale"] = leaf.scale.shape
                else:
                    leaves[key] = leaf.shape
            for key, gshape in leaves.items():
                spec = specs[key]
                sh = tsh.NamedSharding(mesh, spec)
                local = tsh._local_shard(torch.empty(gshape, device="meta"),
                                         mesh, sh.placements).shape
                want = JNamed(jmesh, JP(*spec)).shard_shape(gshape)
                assert tuple(local) == tuple(want) == sh.shard_shape(gshape)
                dt_shape, _ = compute_local_shape_and_global_offset(
                    gshape, mesh, sh.placements)
                assert tuple(dt_shape) == tuple(want), (arch, key)
                n += 1
    assert n > 100


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(1, 64), min_size=1, max_size=4),
       st.sampled_from(sorted(MESHES)))
def test_guard_spec_matches_reference(dims, shape):
    names = MESHES[shape]
    axes = [tuple(names[:2]) if len(names) == 3 else "data", "model", None,
            "data"][:len(dims)]
    want = jsh.guard_spec(JP(*axes), dims, AbstractMesh(shape, names))
    got = tsh.guard_spec(tsh.P(*axes), dims, dict(zip(names, shape)))
    assert tuple(got) == tuple(want)
    sizes = dict(zip(names, shape))
    for a, d in zip(got, dims):
        if a is not None:
            n = int(np.prod([sizes[x] for x in (a if isinstance(a, tuple)
                                                 else (a,))]))
            assert d % n == 0


def test_constrain_without_mesh_and_mesh_refusals():
    from repro_torch.dist import constrain, current_mesh
    from repro_torch.launch.mesh import make_local_mesh
    assert current_mesh() is None
    t = torch.randn(4, 8, 16)
    assert constrain(t, "dp", None, "tp") is t
    with pytest.raises(RuntimeError, match="process group"):
        make_local_mesh(1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_local_mesh(1)          # the card by default, never the CPU
    spec = tsh.NamedSharding({"data": 2, "model": 2},
                             tsh.P(("model", "data")))
    with pytest.raises(ValueError, match="order"):
        spec.placements


def test_moe_einsum_matches_reference_without_mesh():
    from repro.dist.options import PerfFlags as JFlags
    from repro.dist.options import flags as j_flags
    from repro.dist.options import set_flags as j_set
    from repro_torch.dist import PerfFlags, flags, set_flags
    from repro.data.pipeline import make_batch
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_family
    from torch_parity import contexts
    from train_parity import jax_loss_and_grads, torch_loss_and_grads
    cfg = j_get_config("olmoe-1b-7b").smoke()
    tcfg = get_config("olmoe-1b-7b").smoke()
    tp = get_family(tcfg).init(torch.Generator().manual_seed(0), tcfg,
                               dtype=torch.float32, device="cpu")
    jp = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), tp)
    jctx, tctx = contexts("none")
    batch = make_batch(cfg, 0, 2, 16)
    jold, told = j_flags(), flags()
    j_set(JFlags(moe_einsum=True))
    set_flags(PerfFlags(moe_einsum=True))
    try:
        jl, jm, jg = jax_loss_and_grads(cfg, jp, jctx, batch)
        tl, tm, tg = torch_loss_and_grads(cfg, tp, tctx, batch)
    finally:
        j_set(jold)
        set_flags(told)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tm["moe_aux"], jm["moe_aux"], rtol=1e-5)
    jf = flat(jg)
    assert set(tg) == set(jf)
    for k, g in tg.items():
        assert rel_l2(g, jf[k]) <= 1e-5, k


def test_single_process_step_makes_no_dtensor_and_no_collective(
        monkeypatch):
    """Without a process group the train step (olmoe smoke, microbatches
    2, ``grad_specs`` under the flag) keeps plain tensors everywhere and
    calls no collective."""
    import torch.distributed as dist
    from repro.data.pipeline import make_batch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.dist import PerfFlags, flags, param_specs, set_flags
    from repro_torch.nn.context import QuantContext
    from repro_torch.optim import cosine_warmup
    from repro_torch.train.step import build_train_step, init_state
    assert not dist.is_initialized()

    def refuse(*a, **kw):
        raise AssertionError("a collective ran without a process group")
    for name in ("all_reduce", "all_gather", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "broadcast", "barrier"):
        monkeypatch.setattr(dist, name, refuse)
    cfg = get_config("olmoe-1b-7b").smoke()
    state = init_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    step = build_train_step(
        cfg, QuantContext(compute_dtype=torch.float32),
        lr_fn=lambda s: cosine_warmup(s, peak=1e-3, warmup=1, total=4),
        microbatches=2, grad_specs=param_specs(state["params"],
                                               {"data": 1, "model": 1}))
    old = flags()
    set_flags(PerfFlags(grad_specs=True, moe_local=True))
    try:
        state, metrics = step(state, make_batch(cfg, 0, 4, 16))
    finally:
        set_flags(old)
    for t in tree_leaves(state) + list(metrics.values()):
        assert type(t) is torch.Tensor
    assert np.isfinite(float(metrics["loss"]))
