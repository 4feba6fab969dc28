"""The gated MLP's table pass, port vs ``repro``.

``lut_gated_mul(g, up, spec)`` computes ``((g * T(g)).to(dt)) * up``: the
LUT ``act_fn`` of a gated GELU or SiLU and the product with ``up`` that
the reference's ``mlp_apply`` applies after it.  Its ``ref`` lowering
(the reference's ``/ step`` indexing) and its plain version (the kernel's
``* step_inv`` indexing, what the wrapper runs on CPU tensors) are held
bitwise against the reference, for every indexing mode: the whole f32
``mlp_apply`` under ``use_lut`` (``ref`` against ``ref``, the plain
version against the Pallas kernel in interpret mode), and the pass alone
in f32 and bf16.  A float gate projection routes through the op once, an
int8 one keeps the table in qmatmul's epilogue.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import tables as jt  # noqa: E402
from repro.nn import activations as jact  # noqa: E402
from repro.nn import blocks as jblocks  # noqa: E402
from repro.nn.context import QuantContext as JCtx  # noqa: E402
from repro_torch.core import tables as tt  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.lut_activation import lut_gated_mul  # noqa: E402
from repro_torch.kernels.ref import (lut_gated_mul_plain,  # noqa: E402
                                     lut_gated_mul_ref)
from repro_torch.nn import blocks as tblocks  # noqa: E402
from repro_torch.nn.context import QuantContext  # noqa: E402

INDEXING = ["trunc", "nearest", "interp"]
#: (activation, its gated table, the table's domain)
GATED = [("gelu", "gelu_gate", -8.0, 8.0), ("silu", "silu_gate", -10.0, 10.0)]


def _mlp(seed, d=24, f=40, t=6):
    rs = np.random.RandomState(seed)
    p = {name: {"w": (rs.randn(*shape) * 0.6).astype(np.float32),
                "b": rs.randn(shape[1]).astype(np.float32)}
         for name, shape in (("up", (d, f)), ("gate", (d, f)),
                             ("down", (f, d)))}
    x = (rs.randn(2, t, d) * 2.0).astype(np.float32)
    return p, x


def _bits(a):
    a = np.asarray(a, dtype=np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()
    return a.view(np.int32)


@pytest.mark.parametrize("backend", [None, "ref"])
@pytest.mark.parametrize("indexing", INDEXING)
@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_mlp_apply_lut_matches_reference(act, indexing, backend):
    """f32 gated MLP under ``use_lut``: the port (through
    ``lut_gated_mul``) is bitwise the reference's ``mlp_apply``.  The
    default backend (the kernel's plain version on the CPU) against the
    reference's Pallas kernel in interpret mode, ``ref`` against ``ref``."""
    p, x = _mlp(seed=len(act) + INDEXING.index(indexing))
    jbackend = "pallas" if backend is None else "ref"
    got = tblocks.mlp_apply(
        {k: {n: torch.from_numpy(v) for n, v in d.items()}
         for k, d in p.items()}, torch.from_numpy(x), act,
        QuantContext(use_lut=True, table_indexing=indexing, backend=backend,
                     compute_dtype=torch.float32))
    want = jblocks.mlp_apply(
        {k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in p.items()},
        jnp.asarray(x), act,
        JCtx(use_lut=True, table_indexing=indexing, backend=jbackend,
             compute_dtype=jnp.float32))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("indexing", INDEXING)
@pytest.mark.parametrize("act,fn,lo,hi", GATED)
def test_lut_gated_mul_matches_reference_act_times_up(act, fn, lo, hi,
                                                      indexing, dtype):
    """The pass alone: ``act_fn(g) * up`` of the reference, on inputs that
    reach past the table's domain; the plain version against the Pallas
    kernel (interpret mode), the ``ref`` lowering against ``ref``."""
    rs = np.random.RandomState(7)
    g = (rs.randn(5, 70) * 7.0).astype(np.float32)
    up = (rs.randn(5, 70) * 3.0).astype(np.float32)
    tg, tu = torch.from_numpy(g), torch.from_numpy(up)
    jg, ju = jnp.asarray(g), jnp.asarray(up)
    if dtype == "bfloat16":
        tg, tu = tg.bfloat16(), tu.bfloat16()
        jg, ju = jg.astype(jnp.bfloat16), ju.astype(jnp.bfloat16)
    spec = tt.TableSpec(fn, 1024, lo, hi, None, indexing)
    for backend, jbackend in ((None, "pallas"), ("ref", "ref")):
        got = ops.lut_gated_mul(tg, tu, spec, backend=backend)
        want = jact.act_fn(act, jg, JCtx(use_lut=True, table_indexing=indexing,
                                         backend=jbackend)) * ju
        assert got.dtype == tg.dtype and got.shape == tg.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert torch.equal(lut_gated_mul(tg, tu, spec),
                       lut_gated_mul_plain(tg, tu, spec))
    assert torch.equal(ops.lut_gated_mul(tg, tu, spec, backend="ref"),
                       lut_gated_mul_ref(tg, tu, spec))
    js = jt.TableSpec(fn, 1024, lo, hi, None, indexing)
    assert tt.get_table(spec).np_values.tobytes() == \
        jt.get_table(js).np_values.tobytes()


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_gated_mlp_routes_the_table(mode, monkeypatch):
    """Float gate: one ``lut_gated_mul``, no standalone lookup; int8 gate:
    the table in qmatmul's epilogue, neither op; an ungated MLP keeps the
    standalone lookup."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    calls = {"lut_gated_mul": 0, "lut_activation": 0}
    for name in calls:
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(ops, name, spy)
    policy = (PrecisionPolicy.uniform(FixedPointType(8, 4)) if mode == "int8"
              else PrecisionPolicy())
    ctx = QuantContext(mode=mode, policy=policy, use_lut=True,
                       compute_dtype=torch.float32)
    p, x = _mlp(seed=11)
    tp = {k: {n: torch.from_numpy(v) for n, v in d.items()}
          for k, d in p.items()}
    y = tblocks.mlp_apply(tp, torch.from_numpy(x), "gelu", ctx)
    assert torch.isfinite(y).all()
    assert calls == ({"lut_gated_mul": 0, "lut_activation": 0}
                     if mode == "int8"
                     else {"lut_gated_mul": 1, "lut_activation": 0})
    del tp["gate"]
    calls.update(lut_gated_mul=0, lut_activation=0)
    tblocks.mlp_apply(tp, torch.from_numpy(x), "gelu", ctx)
    assert calls == ({"lut_gated_mul": 0, "lut_activation": 0}
                     if mode == "int8"
                     else {"lut_gated_mul": 0, "lut_activation": 1})
