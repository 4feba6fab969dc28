"""core parity: the port's quantizers and tables equal the reference's
bit for bit on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import quantize as jq  # noqa: E402
from repro.core import tables as jt  # noqa: E402
from repro.core.qtypes import FixedPointType as JFixed  # noqa: E402
from repro.core.qtypes import QTensor as JQTensor  # noqa: E402
from repro_torch.core import quantize as tq  # noqa: E402
from repro_torch.core import tables as tt  # noqa: E402
from repro_torch.core.qtypes import FixedPointType, QTensor  # noqa: E402

from torch_parity import int8_policies, jax_to_numpy, smoke_params  # noqa: E402


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bitwise(got: torch.Tensor, want) -> None:
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("shape,axes", [((64, 48), (1,)), ((64, 48), (0,)),
                                        ((3, 32, 40), (0, 2)), ((17,), ()),
                                        ((5, 7), (0, 1))])
@pytest.mark.parametrize("width", [8, 6])
def test_calibrate_and_quantize_bitwise(shape, axes, width):
    x = (np.random.RandomState(sum(shape) + width).randn(*shape) * 3
         ).astype(np.float32)
    x.flat[0] = 0.0
    jt_, tt_ = JFixed(width, width // 2), FixedPointType(width, width // 2)
    _assert_bitwise(tq.calibrate_scale(torch.from_numpy(x), tt_, axes),
                    jq.calibrate_scale(jnp.asarray(x), jt_, axes))
    got = tq.quantize_dynamic(torch.from_numpy(x), tt_, axes)
    want = jq.quantize_dynamic(jnp.asarray(x), jt_, axes)
    _assert_bitwise(got.data, want.data)
    _assert_bitwise(got.scale, want.scale)
    assert got.data.dtype == torch.int8 and tt_.int_min == jt_.int_min \
        and tt_.int_max == jt_.int_max


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 40), st.integers(1, 40), st.integers(0, 2 ** 16),
       st.floats(1e-3, 1e3))
def test_quantize_dynamic_property(m, n, seed, mag):
    """Random shapes and magnitudes, halfway cases included: payloads and
    scales stay bitwise equal (half-to-even on both sides)."""
    x = (np.random.RandomState(seed).randn(m, n) * mag).astype(np.float32)
    got = tq.quantize_dynamic(torch.from_numpy(x), FixedPointType(8, 4), (1,))
    want = jq.quantize_dynamic(jnp.asarray(x), JFixed(8, 4), (1,))
    _assert_bitwise(got.data, want.data)
    _assert_bitwise(got.scale, want.scale)


@pytest.mark.parametrize("mode", ["int8"])
def test_ptq_params_bitwise_on_smoke_model(mode):
    """Same weights through both ``ptq_params``: identical int8 payloads
    and f32 scales for every matmul leaf, stacked (L, ...) leaves kept;
    embedding table and norms stay float."""
    cfg, jparams, _ = smoke_params("none")
    jpol, pol, _ = int8_policies()
    want = jax_to_numpy(jq.ptq_params(jparams, jpol))
    from repro_torch.convert import params_from_numpy
    got = tq.ptq_params(params_from_numpy(jax_to_numpy(jparams)), pol)

    def walk(g, w, path):
        if isinstance(g, QTensor):
            assert set(w) == {"data", "scale"}, path
            _assert_bitwise(g.data, w["data"])
            _assert_bitwise(g.scale, w["scale"])
            assert g.data.shape[0] == cfg.n_layers, path
            return 1
        if isinstance(g, dict):
            assert set(g) == set(w), path
            return sum(walk(g[k], w[k], path + (k,)) for k in g)
        assert not isinstance(w, dict), path
        _assert_bitwise(g, w)
        return 0

    assert walk(got, want, ()) == 7           # wq wk wv wo up gate down
    assert not isinstance(got["embed"]["table"], QTensor)


def test_ptq_params_predicate_rules():
    pol = FixedPointType(8, 4)
    jpol = JFixed(8, 4)
    rs = np.random.RandomState(3)
    tree = {"embed": {"w": rs.randn(8, 4).astype(np.float32)},
            "router": {"w": rs.randn(8, 4).astype(np.float32)},
            "mlp": {"w_up": rs.randn(2, 8, 6).astype(np.float32),
                    "b": rs.randn(6).astype(np.float32),
                    "scale": rs.randn(4, 4).astype(np.float32)}}
    got = tq.ptq_params({k: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
                         for k, v in tree.items()}, pol)
    want = jq.ptq_params({k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
                          for k, v in tree.items()}, jpol)
    for k in tree:
        for kk in tree[k]:
            assert isinstance(got[k][kk], QTensor) == \
                isinstance(want[k][kk], JQTensor), (k, kk)
    _assert_bitwise(got["mlp"]["w_up"].data, want["mlp"]["w_up"].data)
    _assert_bitwise(got["mlp"]["w_up"].scale, want["mlp"]["w_up"].scale)


_SPECS = [
    ("gelu_gate", 1024, -8.0, 8.0, None, "interp"),
    ("silu_gate", 512, -10.0, 10.0, None, "trunc"),
    ("sigmoid", 256, -8.0, 8.0, None, "nearest"),
    ("tanh", 1000, -6.0, 6.0, "fx16_6", "interp"),
    ("exp", 1024, -16.0, 0.0, "fx18_8", "trunc"),
    ("softplus", 64, -16.0, 16.0, None, "interp"),
    ("erf", 300, -4.0, 4.0, "fx8_3", "nearest"),
    ("gelu", 2048, -8.0, 8.0, None, "interp"),
]


def _qt(name, cls):
    if name is None:
        return None
    w, i = name[2:].split("_")
    return cls(int(w), int(i))


@pytest.mark.parametrize("spec", _SPECS, ids=lambda s: f"{s[0]}-{s[1]}")
def test_tables_bitwise(spec):
    fn, n, lo, hi, q, idx = spec
    got = tt.get_table(tt.TableSpec(fn, n, lo, hi, _qt(q, FixedPointType), idx))
    want = jt.get_table(jt.TableSpec(fn, n, lo, hi, _qt(q, JFixed), idx))
    assert got.np_values.dtype == want.np_values.dtype == np.float32
    np.testing.assert_array_equal(got.np_values.view(np.int32),
                                  want.np_values.view(np.int32))


@pytest.mark.parametrize("indexing", ["trunc", "nearest", "interp"])
def test_table_lookup_matches(indexing):
    spec = ("silu_gate", 512, -10.0, 10.0)
    vals = jt.get_table(jt.TableSpec(*spec, None, indexing)).np_values
    x = (np.random.RandomState(5).randn(40, 30) * 6).astype(np.float32)
    got = tt.table_lookup(torch.from_numpy(x), torch.from_numpy(vals.copy()),
                          spec[2], spec[3], indexing)
    want = jt.table_lookup(jnp.asarray(x), jnp.asarray(vals), spec[2],
                           spec[3], indexing)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
