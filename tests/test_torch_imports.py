"""The port stands alone: no JAX, nothing of ``repro``, no silent fallback."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "chip_ab.py"]


def test_import_leaves_jax_out():
    """Importing the port and every submodule loads no ``jax*`` module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0].startswith('jax')"
        " or n.split('.')[0] == 'repro')\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25      # every submodule was imported


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    """AST scan: no ``import jax*`` and no ``import repro`` anywhere."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            assert not top.startswith("jax"), f"{path}: imports {name}"
            assert top != "repro", f"{path}: imports {name}"


def test_cuda_lookup_never_falls_back_to_ref():
    from repro_torch.core.registry import get_impl, register_op
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.qmatmul import qmatmul

    assert ops is not None
    assert get_impl("qmatmul", "cuda") is qmatmul
    assert get_impl("qmatmul", "ref") is ref.qmatmul_ref
    from repro_torch.kernels.lut_activation import lut_activation
    assert get_impl("lut_activation", "cuda") is lut_activation
    assert get_impl("lut_activation", "ref") is ref.lut_activation_ref
    register_op("only_ref_op_for_test", "ref")(lambda x: x)
    with pytest.raises(KeyError, match="never falls back"):
        get_impl("only_ref_op_for_test", "cuda")
    with pytest.raises(KeyError):
        get_impl("qmatmul", "pallas")


def test_wrappers_refuse_other_devices():
    """A non-CPU tensor never reaches a plain version: the wrappers take
    the plain path for CPU tensors only."""
    from repro_torch.kernels.flash_attention import (paged_attention_split,
                                                     paged_attention_unsplit)
    from repro_torch.kernels.qmatmul import qmatmul
    meta = dict(device="meta")
    a = torch.empty((4, 8), dtype=torch.int8, **meta)
    b = torch.empty((8, 4), dtype=torch.int8, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        qmatmul(a, b, 1.0, 1.0)
    q = torch.empty((1, 2, 1, 8), **meta)
    pages = torch.empty((3, 1, 4, 8), **meta)
    bt = torch.zeros((1, 2), dtype=torch.int32, **meta)
    qpos = torch.zeros((1,), dtype=torch.int32, **meta)
    for fn in (paged_attention_unsplit, paged_attention_split):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, pages, pages, bt, qpos)
    from repro_torch.core.tables import TableSpec
    from repro_torch.kernels.lut_activation import lut_activation
    with pytest.raises(ValueError, match="unsupported device"):
        lut_activation(q, TableSpec("gelu_gate"))


def test_entry_points_default_to_the_card():
    """No device given: cuda when there is one, else an error -- never a
    quiet CPU run."""
    from repro_torch.launch.serve import resolve_device
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)


def test_nothing_built_at_import():
    """Importing the kernel modules compiles and loads nothing."""
    from repro_torch.kernels import _cuda
    assert _cuda._LIBS == {}
